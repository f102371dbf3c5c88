"""The control of the comparison that decides ``correct``: it has to fail.

    python3 benchmark/control.py --workload speccap-closed1 --seeds 11,12,13

The system states no precision: its answers are exact integers and exact
strings. So the control breaks one guarantee the configuration states, the
traceback's tie-break (match, diagonal, up, left): it is the plain reference
itself with left taken before up (``reference/nw.py``, ``left_first``), an
alignment as optimal as the reference's, with the same penalty, that a
faster traceback could be tempted to give. It is put in the program's place
for the pairs a run of the cell would check: for each seed, the problems and
the sample that ``run.py`` would make and draw (a window as long as the
pool), answered by the control and compared with the reference by
``judge.compare``. One line of JSON a seed: the numbers compared, their
limits and whether the control failed them, as it must.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _path in (ROOT, HERE):
    if _path not in sys.path:
        sys.path.insert(0, _path)

from msabench import generate, judge, spec  # noqa: E402
from reference import nw  # noqa: E402


def control(cell: spec.Cell, seed: int, device) -> dict:
    _, pool = generate.problems(cell.config, cell.traffic, seed)
    done = list(range(len(pool)))
    picks = judge.draw(seed, done, pool[0], cell.config["check_pairs"])
    pairs = judge.sampled_pairs(picks, done, pool)
    pxy, pgap = cell.config["pxy"], cell.config["pgap"]
    t0 = time.perf_counter()
    answers = nw.align(pairs, pxy, pgap, device, left_first=True)
    expected = nw.align(pairs, pxy, pgap, device)
    pen, ali = judge.compare(answers, expected)
    compared = {"penalties_wrong": pen, "alignments_wrong": ali}
    return {"workload": cell.name, "seed": seed, "pairs": len(pairs),
            "seconds": time.perf_counter() - t0,
            "failed_the_check": any(v > judge.LIMITS[k] for k, v in compared.items()),
            "compared": {k: {"value": v, "limit": judge.LIMITS[k]} for k, v in compared.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--benchmark", default=os.path.join(ROOT, "BENCHMARK.json"))
    args = ap.parse_args(argv)
    import torch

    if args.platform == "cuda" and not torch.cuda.is_available():
        print("the control runs on a CUDA card; none is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0) if args.platform == "cuda" else torch.device("cpu")
    cell = spec.cell(args.benchmark, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control(cell, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
