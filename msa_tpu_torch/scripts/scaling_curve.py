"""Scaling over devices: score-fill throughput, the e2e pipeline, schedule balance.

The port's counterpart of ``scripts/scaling_curve.py``, with its three
sections, each record one JSON line (printed, and appended to ``--out``):

(a) ``sharded_scores``: ``parallel/engine.py::sharded_pair_scores`` on ``--k``
    random sequences of ``--min-len`` to ``--max-len`` characters (numpy
    ``default_rng(1)``, as the JAX script) over 1, 2, 4, ... devices up to
    ``--devices``: the best of ``--reps`` walls, cells a second and the
    efficiency (cells/s at N over N times cells/s at 1). On a card the
    devices are the host's first N cards; on the CPU (``--platform cpu``)
    N threads on the one CPU device, which measure the split and its cost,
    not a speed-up (the JAX script used N virtual CPU devices the same way).
(c) ``e2e_local_devices``, for each count of ``--e2e-devices``: the k-way
    pipeline in a fresh process with ``MSA_TPU_TORCH_LOCAL_DEVICES`` set,
    the device pairs split over that many devices (``models/kway.py``), one
    warm run then one timed, gated on the golden: pod64 (``gen_workload
    --k 64``, ``goldens/pod64.json``) on the card; on the CPU mseq1 at small
    geometry through the plain versions, N threads standing in for N devices.
(b) ``schedule_balance`` (host arithmetic): the largest shard's m * n load
    over the mean, LPT against block, for 2 to 32 shards of a k = ``--pod-k``
    workload of lengths log-uniform over 1,000-30,000 (``default_rng(2)``,
    the JAX script's numbers exactly).

::

    python -m msa_tpu_torch.scripts.scaling_curve --e2e-devices 1,2,4
    python -m msa_tpu_torch.scripts.scaling_curve --platform cpu --devices 4 \\
        --k 8 --min-len 40 --max-len 120 --e2e-devices 1,2

The exit code is 1 when an e2e run is not golden or (a)'s scores differ
between device counts.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from msa_tpu_torch.scripts.conformance import REPO

COUNTS = (1, 2, 4, 8, 16)
# The CPU's e2e geometry: every mseq1 pair through the plain versions.
CPU_E2E_ENV = {"MSA_TPU_TORCH_HOST_THRESHOLD": "0", "MSA_TPU_TORCH_RB": "16",
               "MSA_TPU_TORCH_SNAP_K": "8", "MSA_TPU_TORCH_RB_CONVEYOR": "16"}


def random_genes(k: int, min_len: int, max_len: int) -> List[str]:
    """The JAX script's sequences: numpy ``default_rng(1)``."""
    rng = np.random.default_rng(1)
    return ["".join(rng.choice(list("ACGT"), rng.integers(min_len, max_len))) for _ in range(k)]


def devices_for(platform: str, count: int):
    """``count`` devices of the platform, or None when the host has fewer cards."""
    import torch

    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.parallel.mesh import local_devices

    if platform == "cpu":
        return [torch.device("cpu")] * count
    cards = local_devices(TorchConfig(device="cuda"))
    return cards[:count] if count <= len(cards) else None


def sharded_scores(genes: Sequence[str], platform: str, max_devices: int,
                   reps: int) -> Tuple[List[Dict], Dict[int, np.ndarray]]:
    """Section (a): (records, {device count: scores by task id})."""
    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.parallel.engine import sharded_pair_scores

    config = TorchConfig(device=platform)
    k = len(genes)
    cells = sum(len(genes[i]) * len(genes[j]) for i in range(1, k) for j in range(i))
    records, scores, base_rate = [], {}, None
    for nd in [d for d in COUNTS if d <= max_devices]:
        devices = devices_for(platform, nd)
        if devices is None:
            break
        scores[nd] = sharded_pair_scores(genes, 3, 2, devices=devices, config=config)  # warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            sharded_pair_scores(genes, 3, 2, devices=devices, config=config)
            best = min(best, time.perf_counter() - t0)
        rate = cells / best
        base_rate = base_rate or rate
        records.append({
            "metric": "sharded_scores", "devices": nd, "device_names": [str(d) for d in devices],
            "pairs": k * (k - 1) // 2, "cells": cells, "walltime_s": round(best, 4),
            "mcells_per_s": round(rate / 1e6, 2),
            "scaling_efficiency": round(rate / (nd * base_rate), 4),
        })
        print(json.dumps(records[-1]), flush=True)
    return records, scores


def e2e_run(platform: str) -> None:
    """One process of section (c): the workload aligned twice (warm, then
    timed) on ``config.local_devices`` devices; prints one JSON line."""
    import torch

    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.models.kway import align_kway
    from msa_tpu_torch.parallel import mesh
    from msa_tpu_torch.scripts.conformance import golden_table, matches

    config = TorchConfig.from_env(device=platform)
    if platform == "cpu":
        from msa_tpu_torch.utils.msaio import parse_file

        count = config.local_devices or 1
        mesh.local_devices = lambda cfg: [torch.device("cpu")] * count
        problem = parse_file(os.path.join(REPO, "data", "mseq1.dat"))
        golden = golden_table()["data/mseq1.dat"]
    else:
        from msa_tpu_torch.goldens import pod

        golden = pod.load(64)
        problem = pod.problem_of(golden)
    align_kway(problem, config=config)
    t0 = time.perf_counter()
    result = align_kway(problem, config=config)
    seconds = time.perf_counter() - t0
    print(json.dumps({"seconds": seconds, "pairs": problem.num_pairs,
                      "hash": result.chain_hash[:16],
                      "golden": matches(golden, result.chain_hash, result.penalties),
                      "devices": [str(d) for d in mesh.local_devices(config)]}), flush=True)


def e2e_local_devices(platform: str, counts: Sequence[int]) -> List[Dict]:
    """Section (c): one fresh process per device count."""
    records = []
    for nd in counts:
        env = dict(os.environ, MSA_TPU_TORCH_LOCAL_DEVICES=str(nd))
        if platform == "cpu":
            env.update(CPU_E2E_ENV)
        code = ("import sys; from msa_tpu_torch.scripts.scaling_curve import e2e_run;"
                " e2e_run(sys.argv[1])")
        out = subprocess.run([sys.executable, "-c", code, platform], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=1800)
        try:
            run = json.loads(out.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            run = {"error": out.stderr[-800:] or "empty stdout"}
        rec = {"metric": "e2e_local_devices", "devices": nd, "pairs": run.get("pairs"),
               "device_names": run.get("devices"), "walltime_s": run.get("seconds"),
               "hash_ok": bool(run.get("golden")), "rc": out.returncode}
        if "error" in run:
            rec["error"] = run["error"]
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


def schedule_balance(pod_k: int) -> List[Dict]:
    """Section (b): max shard load over the mean, LPT against block."""
    from msa_tpu_torch.parallel.schedule import pair_costs, schedule_for

    rng = np.random.default_rng(2)
    lens = np.exp(rng.uniform(np.log(1000), np.log(30000), size=pod_k)).astype(int)
    genes = ["A" * int(n) for n in lens]
    costs = {t.task_id: c for t, c in pair_costs(genes)}
    records = []
    for nd in (2, 4, 8, 16, 32):
        for policy in ("lpt", "block"):
            loads = [sum(costs[t.task_id] for t in s) for s in schedule_for(genes, nd, policy=policy)]
            records.append({"metric": "schedule_balance", "policy": policy, "shards": nd,
                            "pod_k": pod_k, "imbalance": round(max(loads) / (sum(loads) / nd), 4)})
            print(json.dumps(records[-1]), flush=True)
    return records


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8, help="most devices of section (a)")
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--min-len", type=int, default=512)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--pod-k", type=int, default=256, help="section (b)'s k")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--e2e-devices", default="",
                    help="comma list of device counts for section (c), e.g. 1,2,4")
    ap.add_argument("--platform", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--out", default="scaling_curve.jsonl")
    args = ap.parse_args(argv)

    genes = random_genes(args.k, args.min_len, args.max_len)
    records, scores = sharded_scores(genes, args.platform, args.devices, args.reps)
    ok = all(np.array_equal(s, scores[1]) for s in scores.values())
    if args.e2e_devices:
        e2e = e2e_local_devices(args.platform, [int(d) for d in args.e2e_devices.split(",")])
        ok = ok and all(r["hash_ok"] for r in e2e)
        records += e2e
    records += schedule_balance(args.pod_k)
    with open(args.out, "a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
