"""Synthetic workload generator (pod-scale inputs in the reference format).

The port's own copy of ``scripts/gen_workload.py``: the same arguments, the
same random stream and byte for byte the same output, so a workload made
here and one made by the JAX package's script are one input. The bundled
datasets stop at k = 13; a pod-scale run needs hundreds of sequences, with
a length distribution that is balanced (``uniform``, ``loguniform``) or
adversarially skewed (``skew``, a few huge among many tiny). Writes the
reference's stdin format (pxy, pgap, k, then the k sequences)::

    python -m msa_tpu_torch.scripts.gen_workload --k 256 --min-len 1000 \
        --max-len 30000 --dist loguniform --seed 0 > pod256.dat

``make_problem`` makes the same workload in the process, as a ``Problem``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence, TextIO

import numpy as np

from msa_tpu_torch.utils.msaio import Problem

ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)
DISTS = ("uniform", "loguniform", "skew")


def gen_lengths(rng, k, lo, hi, dist):
    if dist == "uniform":
        return rng.integers(lo, hi + 1, size=k)
    if dist == "loguniform":
        return np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size=k)).astype(np.int64)
    if dist == "skew":
        # Mostly tiny sequences, one in 16 huge.
        lens = rng.integers(lo, max(lo + 1, hi // 100), size=k)
        big = rng.choice(k, size=max(1, k // 16), replace=False)
        lens[big] = rng.integers(hi // 2, hi + 1, size=big.size)
        return lens
    raise ValueError(f"unknown dist {dist!r}")


def make_problem(k: int = 256, min_len: int = 1000, max_len: int = 30000,
                 dist: str = "loguniform", seed: int = 0, pxy: int = 3,
                 pgap: int = 2) -> Problem:
    """The workload that ``main`` writes for the same arguments."""
    rng = np.random.default_rng(seed)
    lens = gen_lengths(rng, k, min_len, max_len, dist)
    genes = tuple(ALPHA[rng.integers(0, 4, size=int(n))].tobytes().decode("ascii") for n in lens)
    return Problem(pxy=pxy, pgap=pgap, genes=genes)


def write_problem(problem: Problem, out: TextIO) -> None:
    out.write(f"{problem.pxy}\n{problem.pgap}\n{problem.k}\n")
    for g in problem.genes:
        out.write(g)
        out.write("\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--min-len", type=int, default=1000)
    ap.add_argument("--max-len", type=int, default=30000)
    ap.add_argument("--dist", default="loguniform", choices=DISTS)
    ap.add_argument("--pxy", type=int, default=3)
    ap.add_argument("--pgap", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    write_problem(make_problem(a.k, a.min_len, a.max_len, a.dist, a.seed, a.pxy, a.pgap),
                  sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
