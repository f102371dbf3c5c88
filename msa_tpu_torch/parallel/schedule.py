"""Deterministic static pair scheduling.

Port of ``msa_tpu/parallel/schedule.py`` (that package imports jax at the
top). The DP cost m * n is exact, since the fill does not depend on the
data, so every process derives the same assignment from the sequence
lengths alone: no dispatcher and no messages. The multi-process engine
splits the pairs over processes with it, ``models/kway.py`` the device pairs
over a process's devices, and the conveyor over its concurrent sweeps.
"""

from __future__ import annotations

import heapq
from typing import List, Sequence, Tuple

from msa_tpu_torch.utils.tasks import PairTask, pair_task_list


def pair_costs(genes: Sequence[str]) -> List[Tuple[PairTask, int]]:
    """(task, cost) for every pair; cost = m * n, the exact DP cell count."""
    return [(t, len(genes[t.i]) * len(genes[t.j])) for t in pair_task_list(len(genes))]


def pair_costs_calibrated(genes: Sequence[str], model=None) -> List[Tuple[PairTask, float]]:
    """(task, cost) under a measured wall-clock model (``costmodel.CalibratedCost``).

    Its fixed per-pair term is what m * n cannot say: many small pairs cost
    more than their cells.
    """
    from msa_tpu_torch.parallel.costmodel import CalibratedCost

    if model is None:
        model = CalibratedCost()
    return [
        (t, model.cost_us(len(genes[t.i]), len(genes[t.j])))
        for t in pair_task_list(len(genes))
    ]


def lpt_schedule(
    costs: Sequence[Tuple[PairTask, int]], num_shards: int
) -> List[List[PairTask]]:
    """Greedy longest-processing-time assignment, deterministic.

    Sort tasks by descending cost (ties broken by task id so every process
    computes the identical schedule), then repeatedly give the heaviest task
    to the least-loaded shard (ties by shard index).
    """
    if num_shards <= 0:
        raise ValueError("num_shards must be positive")
    order = sorted(costs, key=lambda tc: (-tc[1], tc[0].task_id))
    heap = [(0, shard) for shard in range(num_shards)]
    heapq.heapify(heap)
    shards: List[List[PairTask]] = [[] for _ in range(num_shards)]
    for task, cost in order:
        load, shard = heapq.heappop(heap)
        shards[shard].append(task)
        heapq.heappush(heap, (load + cost, shard))
    return shards


def block_schedule(tasks: Sequence[PairTask], num_shards: int) -> List[List[PairTask]]:
    """The reference's first layout: contiguous task-id blocks.

    Shard r takes ids [tpp * r, tpp * (r + 1)) with tpp = total // shards,
    and the last shard also takes the remainder.
    """
    if num_shards <= 0:
        raise ValueError("num_shards must be positive")
    tpp = len(tasks) // num_shards
    return [
        list(tasks[tpp * r : tpp * (r + 1) if r < num_shards - 1 else len(tasks)])
        for r in range(num_shards)
    ]


def schedule_for(
    genes: Sequence[str], num_shards: int, policy: str = "lpt", cost_model=None,
) -> List[List[PairTask]]:
    """Deterministic pair schedule.

    ``lpt`` (cost m * n), ``calibrated`` (LPT over a ``CalibratedCost``;
    every process must pass the same one) or ``block``.
    """
    if policy == "lpt":
        return lpt_schedule(pair_costs(genes), num_shards)
    if policy == "calibrated":
        return lpt_schedule(pair_costs_calibrated(genes, cost_model), num_shards)
    if policy == "block":
        return block_schedule(pair_task_list(len(genes)), num_shards)
    raise ValueError(f"unknown schedule policy {policy!r}")
