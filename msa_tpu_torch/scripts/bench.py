"""Benchmark of the port: big13 end to end on one card, in GCUPS.

The port's counterpart of the root ``bench.py`` (the JAX package's). The
workload is the reference's headline benchmark, ``data/mseq-big13-example.txt``
(k = 13, 78 pairwise Needleman-Wunsch alignments, 2.785e11 DP cells), run
through ``align_kway`` with ``backend="cuda"``: the banded fill and the
traceback walk on the card, the decode and the hashes on the host. The
baseline is the reference's best cluster result (12 nodes, 192 cores,
15,672,995 us: 17.77 GCUPS).

Method, as ``bench.py``'s: two warm-up passes (they also absorb the CUDA
context and the kernels' build at first use), then five timed reps, each
timed by the host clock around ``align_kway`` alone (parsing stays outside;
``align_kway`` returns host strings, so the device work ends inside the
window). Every warm-up and every rep must give the reference's full chain
hash and all 78 penalties; the first that departs ends the run with exit
code 1 and an error line, and no value is reported. On the card::

    python -m msa_tpu_torch.scripts.bench

The last line is one JSON object: ``metric`` ``big13_e2e_gcups``, ``value``
(cells over the best rep, in GCUPS), ``unit``, ``vs_baseline``, ``reps``
(GCUPS of each rep), ``seconds`` (each rep) and ``card`` (the name and power
limit of the card the run used, as ``nvidia-smi`` gives them).
``--platform cpu`` runs the kernels' plain versions on the CPU, for tests;
without it and without a card the script raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

from msa_tpu_torch.scripts.conformance import BIG13_HASH, BIG13_PENALTIES, REPO

BIG13 = "data/mseq-big13-example.txt"
METRIC = "big13_e2e_gcups"
BASELINE_GCUPS = 17.77  # 2.785e11 cells / 15.672995 s / 1e9
REPS = 5
WARMUPS = 2


def workload_cells(genes: Sequence[str]) -> int:
    """DP cells of all pairs: the sum of len(x) * len(y)."""
    return sum(len(genes[i]) * len(genes[j]) for i in range(1, len(genes)) for j in range(i))


def error_record(message: str) -> Dict:
    return {"metric": METRIC, "value": 0.0, "unit": "GCUPS", "vs_baseline": 0.0,
            "error": message}


def run(problem, golden_hash: str, golden_penalties: List[int], config, backend: str,
        reps: int = REPS, warmups: int = WARMUPS) -> Tuple[int, Dict]:
    """(exit code, record) of ``warmups`` gated passes and ``reps`` timed,
    gated reps of ``align_kway(problem, backend=backend, config=config)``."""
    from msa_tpu_torch.models import kway

    cells = workload_cells(problem.genes)

    def departs(result) -> bool:
        return (result.chain_hash != golden_hash
                or list(result.penalties) != list(golden_penalties))

    for w in range(warmups):
        if departs(kway.align_kway(problem, backend=backend, config=config)):
            return 1, error_record(f"warm-up {w}: hash/penalties mismatch vs golden")
    seconds = []
    for rep in range(reps):
        t0 = time.perf_counter()
        result = kway.align_kway(problem, backend=backend, config=config)
        seconds.append(time.perf_counter() - t0)
        if departs(result):
            return 1, error_record(f"rep {rep}: hash/penalties mismatch vs golden")
    gcups = cells / min(seconds) / 1e9
    return 0, {"metric": METRIC, "value": round(gcups, 2), "unit": "GCUPS",
               "vs_baseline": round(gcups / BASELINE_GCUPS, 2),
               "reps": [round(cells / t / 1e9, 2) for t in seconds], "seconds": seconds}


def card_name(index: int) -> str:
    """``name, power.limit`` of the card torch numbers ``index``, from
    ``nvidia-smi``, which ignores ``CUDA_VISIBLE_DEVICES`` and takes the
    index, UUID or bus id that it lists."""
    visible = [v.strip() for v in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")]
    card = visible[index] if index < len(visible) and visible[index] else str(index)
    return subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default): the kernels on the card; cpu: their plain versions")
    args = ap.parse_args(argv)

    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.utils.msaio import parse_file

    config = TorchConfig.from_env()
    card = None
    if args.platform == "cpu":
        config.device, backend = "cpu", "auto"
    else:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("the benchmark runs on a CUDA device and none is available;"
                               " --platform cpu runs the kernels' plain versions")
        from msa_tpu_torch.models.pairwise import pipeline_device

        backend = "cuda"
        card = card_name(pipeline_device(backend, config).index or 0)
    problem = parse_file(os.path.join(REPO, BIG13))
    rc, record = run(problem, BIG13_HASH, BIG13_PENALTIES, config, backend)
    record["card"] = card
    print(json.dumps(record), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
