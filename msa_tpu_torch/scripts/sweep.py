"""Benchmark sweep on the local card: the band-height ladder and the e2e knob grid.

The port's counterpart of ``scripts/sweep.py``; records are JSON lines,
printed and appended to ``--out`` (tabled by ``plot_bench.py``).

- **The band ladder** (default): one pair of ``--m`` x ``--n`` characters
  (90,000 x 85,000 from numpy ``default_rng(0)``, as the JAX script)
  filled with snapshots off (``ops/band_fill.py::nw_score``) at each band
  height of ``--rbs``, the best of ``--reps`` walls after a warm-up, and
  GCUPS. The JAX ladder's 8,192-32,768 are TPU vector lengths; the port's
  kernel takes rb + 1 lanes in one block, so its legal heights run up to
  8,191 (``config.MAX_RB``). Every height must give the same score.
- **The e2e grid** (``--e2e``): for each combination of ``--fill-modes``,
  ``--snap-ks``, ``--rbs``, ``--fill-segments`` and ``--conveyors``, a fresh
  CLI process per rep with those ``MSA_TPU_TORCH_*`` settings on
  ``--dataset`` (big13 by default), gated on its golden
  (``conformance.golden_table``); GCUPS from the ``Time:`` line. An ``--rbs``
  entry is the banded pipeline's tallest height (``ops/band_fill.py::
  band_height`` narrows it on a card when a call's bands leave SMs idle; on
  one card big13's 497 bands keep every rung from 2047 up). The conveyor's
  band height is the largest multiple of snap_k whose lanes fit one block.
  The JAX grid's ``p_group``, ``rb_align`` and ``walk_scan_groups`` are TPU
  knobs without a counterpart here.

::

    python -m msa_tpu_torch.scripts.sweep
    python -m msa_tpu_torch.scripts.sweep --e2e --fill-modes banded,conveyor

The exit code is 1 when a ladder score differs from the others or an e2e
run is not golden.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from msa_tpu_torch.config import MAX_RB
from msa_tpu_torch.scripts.conformance import REPO

DEFAULT_RBS = "1023,2047,4095,8191"


def pair(m: int, n: int):
    """The JAX script's pair: numpy ``default_rng(0)``."""
    import numpy as np

    rng = np.random.default_rng(0)
    return "".join(rng.choice(list("ACGT"), m)), "".join(rng.choice(list("ACGT"), n))


def band_ladder(x: str, y: str, rbs: List[int], reps: int, device) -> List[Dict]:
    """One record per band height: best wall of ``reps``, GCUPS and the score."""
    from msa_tpu_torch.ops.band_fill import nw_score

    records = []
    for rb in rbs:
        nw_score([x, y], [(0, 1)], 3, 2, device=device, rb=rb)  # build, load, warm
        best, score = float("inf"), None
        for _ in range(reps):
            t0 = time.perf_counter()
            score = int(nw_score([x, y], [(0, 1)], 3, 2, device=device, rb=rb)[0])
            best = min(best, time.perf_counter() - t0)
        records.append({"kernel": "band_score", "rb": rb, "m": len(x), "n": len(y),
                        "walltime_s": round(best, 4),
                        "gcups": round(len(x) * len(y) / best / 1e9, 2), "score": score,
                        "device": str(device)})
        print(json.dumps(records[-1]), flush=True)
    return records


def e2e_grid(args) -> List[Dict]:
    """One record per configuration of the grid, each rep a fresh CLI process."""
    from msa_tpu_torch.scripts.conformance import golden_table, matches
    from msa_tpu_torch.utils.msaio import parse_file

    golden = golden_table()[args.dataset]
    genes = parse_file(os.path.join(REPO, args.dataset)).genes
    cells = sum(len(genes[i]) * len(genes[j]) for i in range(1, len(genes)) for j in range(i))
    ints = lambda spec: [int(v) for v in spec.split(",")]  # noqa: E731
    grid = itertools.product(args.fill_modes.split(","), ints(args.snap_ks), ints(args.rbs),
                             ints(args.fill_segments), ints(args.conveyors))
    records = []
    for fill_mode, snap_k, rb, segments, conveyors in grid:
        knobs = {"fill_mode": fill_mode, "snap_k": snap_k, "rb": rb,
                 "rb_conveyor": (MAX_RB // snap_k) * snap_k, "fill_segments": segments,
                 "conveyors": conveyors}
        env = dict(os.environ, **{f"MSA_TPU_TORCH_{k.upper()}": str(v) for k, v in knobs.items()})
        if args.platform:
            env["MSA_TPU_TORCH_DEVICE"] = args.platform
        gcups, rcs, errors = [], [], []
        for _ in range(args.reps):
            out = subprocess.run([sys.executable, "-m", "msa_tpu_torch.cli", "--input",
                                  os.path.join(REPO, args.dataset)],
                                 cwd=REPO, env=env, capture_output=True, text=True, timeout=3600)
            lines = out.stdout.split("\n")
            rcs.append(out.returncode)
            if out.returncode != 0 or len(lines) < 3:
                errors.append(out.stderr[-800:] or "empty stdout")
                gcups.append(0.0)
            elif not matches(golden, lines[1], [int(v) for v in lines[2].split()]):
                errors.append(f"hash {lines[1][:16]} is not the golden's")
                gcups.append(0.0)
            else:
                gcups.append(cells / int(lines[0].split()[1]) / 1e3)
        rec = {"kernel": "e2e", "dataset": args.dataset, **knobs, "gcups_reps": gcups,
               "gcups_best": max(gcups), "rcs": rcs}
        if errors:
            rec["errors"] = errors
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=90000)
    ap.add_argument("--n", type=int, default=85000)
    ap.add_argument("--rbs", default=None,
                    help=f"band heights (default {DEFAULT_RBS}; the e2e grid: {MAX_RB})")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="bench_sweep.jsonl")
    ap.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                    help="torch device (config.device; default the card)")
    ap.add_argument("--e2e", action="store_true", help="the knob grid, a process per run")
    ap.add_argument("--dataset", default="data/mseq-big13-example.txt")
    ap.add_argument("--fill-modes", default="banded,conveyor")
    ap.add_argument("--snap-ks", default="1024")
    ap.add_argument("--fill-segments", default="4")
    ap.add_argument("--conveyors", default="0")
    args = ap.parse_args(argv)

    if args.e2e:
        args.rbs = args.rbs or str(MAX_RB)
        records = e2e_grid(args)
        ok = not any("errors" in r for r in records)
    else:
        from msa_tpu_torch.config import TorchConfig
        from msa_tpu_torch.parallel.mesh import local_devices

        device = local_devices(TorchConfig(device=args.platform or ""))[0]
        x, y = pair(args.m, args.n)
        records = band_ladder(x, y, [int(r) for r in (args.rbs or DEFAULT_RBS).split(",")],
                              args.reps, device)
        ok = len({r["score"] for r in records}) == 1
    with open(args.out, "a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
