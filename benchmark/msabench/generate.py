"""The problems of one run, made from the configuration, the traffic and the seed.

A configuration fixes the shape of a job: k, each sequence's length (listed,
or drawn once from ``lengths_seed`` by the arithmetic of
``msa_tpu_torch/scripts/gen_workload.py``, so that every run seed gets the
same sizes), the alphabet and the penalties. The run's seed fixes the
letters: each problem has a seed sequence of its own, (seed, role, index),
and draws its sequences one after another from it, uniform over the
alphabet, as ``gen_workload.py`` does. The traffic fixes how many problems a
run makes: ``warmup_jobs`` for the set-up and a pool of ``pool`` that the
window cycles through, and how many answers the run keeps whole for the
check: one job in each block of ``keep_every`` at a place drawn from the
seed (and the last job).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from reference import tasks

WARMUP, POOL, SAMPLE, KEEP = 0, 1, 2, 3  # roles of a seed sequence


@dataclasses.dataclass(frozen=True)
class Problem:
    pxy: int
    pgap: int
    genes: Tuple[str, ...]

    def text(self) -> str:
        """The reference program's standard input: pxy, pgap, k, the sequences."""
        return "\n".join([str(self.pxy), str(self.pgap), str(len(self.genes)), *self.genes, ""])

    def cells(self) -> int:
        return tasks.cells([len(g) for g in self.genes])


def seed_sequence(seed: int, role: int, index: int = 0) -> np.random.SeedSequence:
    """Any whole number is a seed; negative ones and those past 64 bits wrap."""
    return np.random.SeedSequence(seed % (1 << 64), spawn_key=(role, index))


def draw_lengths(rng: np.random.Generator, k: int, lo: int, hi: int, dist: str) -> np.ndarray:
    """``gen_workload.py::gen_lengths``."""
    if dist == "uniform":
        return rng.integers(lo, hi + 1, size=k)
    if dist == "loguniform":
        return np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size=k)).astype(np.int64)
    if dist == "skew":
        lens = rng.integers(lo, max(lo + 1, hi // 100), size=k)
        big = rng.choice(k, size=max(1, k // 16), replace=False)
        lens[big] = rng.integers(hi // 2, hi + 1, size=big.size)
        return lens
    raise ValueError(f"unknown length distribution {dist!r}")


def lengths(config: Dict) -> List[int]:
    if "lengths" in config:
        out = [int(n) for n in config["lengths"]]
    else:
        rng = np.random.default_rng(config["lengths_seed"])
        out = draw_lengths(rng, config["k"], config["min_len"], config["max_len"],
                           config["dist"]).tolist()
    if len(out) != config["k"] or min(out) < 1:
        raise ValueError(f"configuration {config['name']}: k = {config['k']}, lengths {out}")
    return out


def problem(config: Dict, sizes: Sequence[int], seq: np.random.SeedSequence) -> Problem:
    rng = np.random.default_rng(seq)
    alpha = np.frombuffer(config["alphabet"].encode("ascii"), np.uint8)
    genes = tuple(alpha[rng.integers(0, alpha.size, size=n)].tobytes().decode("ascii")
                  for n in sizes)
    return Problem(config["pxy"], config["pgap"], genes)


def problems(config: Dict, traffic: Dict, seed: int) -> Tuple[List[Problem], List[Problem]]:
    """(warm-up problems, the window's pool) of a run."""
    sizes = lengths(config)
    warm = [problem(config, sizes, seed_sequence(seed, WARMUP, i))
            for i in range(traffic["warmup_jobs"])]
    pool = [problem(config, sizes, seed_sequence(seed, POOL, i)) for i in range(traffic["pool"])]
    return warm, pool


def sample_rng(seed: int) -> np.random.Generator:
    """The generator that draws which answers the reference checks."""
    return np.random.default_rng(seed_sequence(seed, SAMPLE))


def kept_places(seed: int, every: int, blocks: int = 1 << 16) -> np.ndarray:
    """For each block of ``every`` jobs, the place of the job whose whole
    answer the run keeps."""
    return np.random.default_rng(seed_sequence(seed, KEEP)).integers(every, size=blocks)
