"""Alternating A/B runs of ``TorchConfig`` settings in one process.

The port's counterpart of ``scripts/ab_compare.py``. A card's speed drifts
between processes and between minutes, so configs compared in separate
processes or one after another differ by more than small effects. This
harness warms every config once, then runs them round-robin ``--reps``
times in one process, so that drift hits each config alike. Each config is
a ``TorchConfig`` passed to ``align_kway`` (nothing module-level is
patched), built from the environment's settings (``MSA_TPU_TORCH_*``) and
the fields that ``--config name:field=value,...`` names; an unknown field
raises. The workload is a dataset (``--input``) or a generated one
(``--gen k=64,min_len=1000,...``, the arguments of
``gen_workload.make_problem``)::

    python -m msa_tpu_torch.scripts.ab_compare --gen k=64 --reps 3 \
        --config banded:fill_mode=banded --config conveyor:fill_mode=conveyor

Every run's chain hash and penalties must equal the first run's, and the
workload's golden where it has one (a bundled dataset's, from
``conformance.golden_table``; a generated workload's, from the pod golden
of the same arguments, ``goldens/pod<k>.json``); otherwise the exit code
is 1. The last line is one JSON object: for each config its reps in
seconds, their median and best, and GCUPS at the median.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

from msa_tpu_torch.config import TorchConfig


def parse_config(spec: str, base: TorchConfig) -> Tuple[str, TorchConfig]:
    """``name:field=value,...`` -> (name, ``base`` with those fields set)."""
    name, _, body = spec.partition(":")
    fields = {f.name: f for f in dataclasses.fields(TorchConfig)}
    values = {}
    for kv in filter(None, body.split(",")):
        key, _, value = kv.partition("=")
        if key not in fields:
            raise ValueError(f"config {name!r}: TorchConfig has no field {key!r}")
        values[key] = int(value) if isinstance(getattr(base, key), int) else value
    return name, dataclasses.replace(base, **values)


def parse_gen(spec: str) -> Dict:
    """``k=64,min_len=1000,dist=uniform`` -> ``make_problem``'s arguments."""
    from msa_tpu_torch.goldens.pod import DEFAULTS

    args = dict(DEFAULTS)
    for kv in filter(None, spec.split(",")):
        key, _, value = kv.partition("=")
        if key not in args:
            raise ValueError(f"--gen: make_problem has no argument {key!r}")
        args[key] = value if key == "dist" else int(value)
    return args


def workload_golden(args) -> Tuple[object, Optional[Dict]]:
    """(problem, golden or None) of the command line's workload."""
    from msa_tpu_torch.goldens import pod
    from msa_tpu_torch.scripts.conformance import REPO, golden_table
    from msa_tpu_torch.scripts.gen_workload import make_problem
    from msa_tpu_torch.utils.msaio import parse_file

    if args.gen is not None:
        gen = parse_gen(args.gen)
        golden = pod.load(gen["k"]) if os.path.exists(pod.golden_path(gen["k"])) else None
        if golden is not None and golden["generator"] != gen:
            golden = None  # another workload's
        return make_problem(**gen), golden
    rel = os.path.relpath(os.path.abspath(args.input), REPO)
    return parse_file(args.input), golden_table().get(rel)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--input", help="a dataset in the reference's input format")
    src.add_argument("--gen", help="a generated workload: make_problem's arguments, k=...,...")
    ap.add_argument("--config", action="append", required=True,
                    help="name:field=value,... (TorchConfig fields; none = the base)")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                    help="torch device of every config (config.device)")
    args = ap.parse_args(argv)

    from msa_tpu_torch.models.kway import align_kway
    from msa_tpu_torch.scripts.conformance import matches

    base = TorchConfig.from_env()
    if args.platform:
        base.device = args.platform
    configs = [parse_config(spec, base) for spec in args.config]
    problem, golden = workload_golden(args)
    genes = problem.genes
    cells = sum(len(genes[i]) * len(genes[j]) for i in range(1, problem.k) for j in range(i))
    first: List = []

    def run_one(name, config) -> Optional[float]:
        t0 = time.perf_counter()
        result = align_kway(problem, config=config)
        seconds = time.perf_counter() - t0
        out = (result.chain_hash, result.penalties)
        if not first:
            first.append(out)
        if out != first[0] or (golden is not None and not matches(golden, *out)):
            print(f"{name}: hash {out[0][:16]} differs from the first run's {first[0][0][:16]}"
                  f" or the golden's", file=sys.stderr, flush=True)
            return None
        return seconds

    reps: Dict[str, List[float]] = {name: [] for name, _ in configs}
    order = [(name, cfg, None) for name, cfg in configs]  # the warm-up
    order += [(name, cfg, rep) for rep in range(args.reps) for name, cfg in configs]
    for name, cfg, rep in order:
        seconds = run_one(name, cfg)
        if seconds is None:
            return 1
        print(f"{'warm' if rep is None else f'rep{rep}'} {name}: {seconds:.3f} s,"
              f" {cells / seconds / 1e9:.1f} GCUPS", flush=True)
        if rep is not None:
            reps[name].append(seconds)

    summary = {"cells": cells, "golden": golden is not None, "hash": first[0][0][:16]}
    for name, vals in reps.items():
        median = statistics.median(vals) if vals else None
        summary[name] = {"reps": vals, "median": median, "best": min(vals, default=None),
                         "gcups": cells / median / 1e9 if median else None}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
