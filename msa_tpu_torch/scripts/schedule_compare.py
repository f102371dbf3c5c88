"""``lpt`` against ``calibrated`` scheduling: each shard's measured time.

The port's counterpart of ``scripts/schedule_compare.py``. On the skewed
workload (``data/xulin_adversarial.dat``: pairs of 5-30 characters beside
pairs of 30,000-70,000), derive the ``--nproc`` shard schedule under each
policy (``parallel/schedule.py::schedule_for``; ``calibrated`` with the
cost model that ``parallel/costmodel.py::calibrate`` measures on the card),
run every shard's tasks alone through ``KWayAligner.align_tasks``, the best
of ``--reps``, one card standing in for ``--nproc`` processes, and record
the makespan (the longest shard), the sum and each shard's time and pairs.
Each shard's time as the cost model predicts it is printed beside the
measured one (not recorded): whether the one-pair probe fits the pipeline.
Without a card there is no calibration, and the exit code is 1::

    python -m msa_tpu_torch.scripts.schedule_compare [--nproc 12] [--reps 2]

Every shard's results under each policy, joined, must give the dataset's
golden (``conformance.golden_table``, where it has one): chain hash and
penalties; otherwise the exit code is 1. ``--out`` gets the record, with
the keys of the JAX script's; the last line is one JSON object: the
winner, both makespans, and whether the output was golden.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

POLICIES = ("lpt", "calibrated")


def run_shards(aligner, genes: Sequence[str], shards, reps: int, model, policy: str):
    """(each shard's best time in seconds, every task's result by task id);
    prints each shard's time beside the cost model's prediction."""
    times: List[float] = []
    results: Dict[int, object] = {}
    for s, tasks in enumerate(shards):
        if not tasks:
            times.append(0.0)
            continue
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = aligner.align_tasks(genes, tasks)
            best = min(best, time.perf_counter() - t0)
        results.update((r.task_id, r) for r in out)
        times.append(best)
        predicted = sum(model.cost_us(len(genes[t.i]), len(genes[t.j])) for t in tasks) / 1e6
        print(f"{policy} shard {s}: {len(tasks)} pairs, measured {best:.3f} s,"
              f" predicted {predicted:.3f} s", flush=True)
    return times, results


def compare(problem, nproc: int, reps: int, model, config) -> Tuple[Dict, Dict[str, Dict]]:
    """({policy: record}, {policy: results by task id}) for both policies."""
    from msa_tpu_torch.models.kway import KWayAligner
    from msa_tpu_torch.parallel.schedule import schedule_for

    aligner = KWayAligner(problem.pxy, problem.pgap, config=config)
    records, results = {}, {}
    for policy in POLICIES:
        shards = schedule_for(problem.genes, nproc, policy=policy,
                              cost_model=model if policy == "calibrated" else None)
        times, results[policy] = run_shards(aligner, problem.genes, shards, reps, model, policy)
        records[policy] = {
            "makespan_s": round(max(times), 3),
            "sum_s": round(sum(times), 3),
            "shard_s": [round(t, 3) for t in times],
            "shard_pairs": [len(t) for t in shards],
        }
        print(f"{policy}: makespan {records[policy]['makespan_s']} s", flush=True)
    return records, results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=12)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--dataset", default="data/xulin_adversarial.dat")
    ap.add_argument("--out", default="schedule_compare.json")
    ap.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                    help="torch device of the aligner (config.device)")
    args = ap.parse_args(argv)

    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.parallel.costmodel import calibrate
    from msa_tpu_torch.scripts.conformance import REPO, golden_table, matches
    from msa_tpu_torch.utils.hashing import chain_hashes
    from msa_tpu_torch.utils.msaio import parse_file

    config = TorchConfig.from_env()
    if args.platform:
        config.device = args.platform
    problem = parse_file(args.dataset)
    t0 = time.perf_counter()
    model = calibrate()
    t_cal = time.perf_counter() - t0
    if model is None:
        print("calibration unavailable (no card): aborting", file=sys.stderr)
        return 1
    print(f"calibrated in {t_cal:.1f} s: {model.gcups:.2f} GCUPS, {model.fixed_us:.0f} us fixed",
          flush=True)
    records, results = compare(problem, args.nproc, args.reps, model, config)

    golden = golden_table().get(os.path.relpath(os.path.abspath(args.dataset), REPO))
    golden_ok = True
    for policy, by_id in results.items():
        ordered = [by_id[t] for t in range(problem.num_pairs)]
        out = (chain_hashes(r.problem_hash for r in ordered), [r.penalty for r in ordered])
        if golden is not None and not matches(golden, *out):
            print(f"{policy}: the shards' union gives hash {out[0][:16]}, not the golden's",
                  file=sys.stderr, flush=True)
            golden_ok = False

    lpt_s, cal_s = (records[p]["makespan_s"] for p in POLICIES)
    winner = "calibrated" if cal_s < lpt_s else "lpt"
    record = {
        "dataset": args.dataset,
        "nproc": args.nproc,
        "calibration": {"gcups": round(model.gcups, 2), "fixed_us": round(model.fixed_us, 1),
                        "calibrate_s": round(t_cal, 1)},
        "policies": records,
        "winner": winner,
        "decision": ("calibrated, the default, wins on this workload" if winner == "calibrated"
                     else "lpt wins on this workload; the default stays calibrated"),
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"winner": winner, "lpt_makespan_s": lpt_s, "calibrated_makespan_s": cal_s,
                      "golden": golden is not None and golden_ok}), flush=True)
    return 0 if golden_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
