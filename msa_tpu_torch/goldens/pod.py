"""Goldens of the pod-scale workloads that ``scripts/gen_workload.py`` makes.

The workload is the port's ``scripts/gen_workload.py::make_problem`` (the
same bytes as the JAX package's script for the same arguments). Its oracle
aligns every pair with the port's C++ host kernel
(``native.py::nw_align_native``, the full-matrix fill and traceback) in a
process pool, journals each pair as it finishes (``utils/checkpoint.py``),
so that a derivation that was cut resumes where it stopped, and folds the
pairs' hashes in task-id order into the chain. The JSON beside this file
holds the generator's arguments, k, the pair count, the DP cells, the chain
hash, every penalty, the oracle's name, the seconds and the cores.

    python -m msa_tpu_torch.goldens.pod --k 64       # pod64.json
    python -m msa_tpu_torch.goldens.pod              # pod256.json, the defaults

The defaults are the README's: ``--k 256 --min-len 1000 --max-len 30000
--dist loguniform --seed 0``, pxy 3, pgap 2. The host kernel holds 4 bytes
a DP cell while a pair runs (3.5 GB for 30,000 x 30,000), so the pool
starts a pair only while the pairs it runs stay under ``--mem-gb``.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import multiprocessing
import os
import sys
import time
from typing import Dict

from msa_tpu_torch.utils.tasks import pair_task_list

HERE = os.path.dirname(os.path.abspath(__file__))
ORACLE = "msa_tpu_torch.native.nw_align_native"
DEFAULTS = {"k": 256, "min_len": 1000, "max_len": 30000, "dist": "loguniform", "seed": 0,
            "pxy": 3, "pgap": 2}

_GENES = None
_PEN = None


def golden_path(k: int) -> str:
    return os.path.join(HERE, f"pod{k}.json")


def load(k: int) -> Dict:
    with open(golden_path(k)) as f:
        return json.load(f)


def problem_of(golden: Dict):
    """The workload a golden was derived on, from its generator arguments."""
    from msa_tpu_torch.scripts.gen_workload import make_problem

    return make_problem(**golden["generator"])


def pair_bytes(m: int, n: int) -> int:
    """Bytes the host kernel holds for one pair: its int32 DP matrix."""
    return 4 * (m + 1) * (n + 1)


def _init(genes, pxy, pgap):
    global _GENES, _PEN
    _GENES, _PEN = genes, (pxy, pgap)


def _align(tid: int, i: int, j: int):
    from msa_tpu_torch.native import nw_align_native
    from msa_tpu_torch.utils.hashing import pair_hash

    penalty, a1, a2 = nw_align_native(_GENES[i], _GENES[j], *_PEN)
    return tid, penalty, pair_hash(a1, a2)


def derive(generator: Dict, journal_path: str, workers: int, mem_bytes: int,
           log=sys.stderr) -> Dict:
    """The golden of ``make_problem(**generator)``.

    Pairs already in the journal are taken from it. The pool is fed in
    task-id order while the pairs in flight stay under ``mem_bytes`` (one
    pair always runs, whatever its size).
    """
    from msa_tpu_torch.native import build
    from msa_tpu_torch.scripts.gen_workload import make_problem
    from msa_tpu_torch.utils.checkpoint import PairJournal, problem_key
    from msa_tpu_torch.utils.hashing import chain_hashes

    build()  # once, before the workers load it
    problem = make_problem(**generator)
    genes = problem.genes
    tasks = pair_task_list(problem.k)
    t0 = time.time()
    journal = PairJournal(journal_path, problem_key(problem.pxy, problem.pgap, genes))
    done = journal.load()
    from_journal = len(done)
    todo = [t for t in tasks if t.task_id not in done]
    size = {t.task_id: pair_bytes(len(genes[t.i]), len(genes[t.j])) for t in todo}
    # Spawned workers: a fork of a process that runs threads (torch's) can deadlock.
    with journal, cf.ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                                         initializer=_init,
                                         initargs=(genes, problem.pxy, problem.pgap)) as pool:
        pending, in_flight, nxt = set(), 0, 0
        while nxt < len(todo) or pending:
            while nxt < len(todo) and (not pending or in_flight + size[todo[nxt].task_id] <= mem_bytes):
                t = todo[nxt]
                pending.add(pool.submit(_align, t.task_id, t.i, t.j))
                in_flight += size[t.task_id]
                nxt += 1
            finished, pending = cf.wait(pending, return_when=cf.FIRST_COMPLETED)
            for fut in finished:
                tid, penalty, h = fut.result()
                journal.record(tid, penalty, h)
                done[tid] = (penalty, h)
                in_flight -= size[tid]
                if len(done) % 1000 == 0:
                    print(f"{len(done)}/{len(tasks)} pairs, {time.time() - t0:.0f} s", file=log,
                          flush=True)
    return {
        "generator": dict(generator),
        "k": problem.k,
        "pairs": len(tasks),
        "cells": sum(len(genes[t.i]) * len(genes[t.j]) for t in tasks),
        "chain_hash": chain_hashes(done[t.task_id][1] for t in tasks),
        "penalties": [done[t.task_id][0] for t in tasks],
        "oracle": ORACLE,
        "seconds": round(time.time() - t0, 1),
        "pairs_from_journal": from_journal,
        "cores": workers,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=DEFAULTS["k"])
    ap.add_argument("--min-len", type=int, default=DEFAULTS["min_len"])
    ap.add_argument("--max-len", type=int, default=DEFAULTS["max_len"])
    ap.add_argument("--dist", default=DEFAULTS["dist"])
    ap.add_argument("--seed", type=int, default=DEFAULTS["seed"])
    ap.add_argument("--pxy", type=int, default=DEFAULTS["pxy"])
    ap.add_argument("--pgap", type=int, default=DEFAULTS["pgap"])
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--mem-gb", type=float, default=16.0,
                    help="host bytes the pairs in flight may hold (default 16)")
    ap.add_argument("--out", default=None, help="default: pod<k>.json beside this file")
    ap.add_argument("--journal", default=None, help="default: <out>.journal.jsonl")
    a = ap.parse_args(argv)
    generator = {"k": a.k, "min_len": a.min_len, "max_len": a.max_len, "dist": a.dist,
                 "seed": a.seed, "pxy": a.pxy, "pgap": a.pgap}
    out = a.out or golden_path(a.k)
    golden = derive(generator, a.journal or out + ".journal.jsonl", a.workers,
                    int(a.mem_gb * 2**30))
    with open(out, "w") as f:
        json.dump(golden, f, indent=None, separators=(",", ":"))
        f.write("\n")
    print(json.dumps({k: v for k, v in golden.items() if k != "penalties"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
