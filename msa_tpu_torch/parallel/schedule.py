"""Deterministic static LPT scheduling.

Copied from ``msa_tpu/parallel/schedule.py:52`` (that package imports jax
at the top). The conveyor uses it to split the device pairs over its
concurrent sweeps by the planner's own cost.
"""

from __future__ import annotations

import heapq
from typing import List, Sequence, Tuple

from msa_tpu.utils.tasks import PairTask


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
