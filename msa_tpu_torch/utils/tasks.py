"""Canonical pair-task enumeration.

The reference enumerates pairs ``i = 1..k-1, j = 0..i-1`` with
``task_id(i, j) = i*(i-1)/2 + j`` (``seqalign-mpi-skeleton.cpp:122-123``;
``submit/xuliny-seqalkway.cpp:280-287``). This ordering defines the canonical
output: penalties are printed and hashes chained in task-id order, so results
must be indexed by task id regardless of how work is sharded.

The port's own copy of ``msa_tpu/utils/tasks.py``; the port imports nothing of the JAX
package. The tests hold the two copies equal.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple


class PairTask(NamedTuple):
    task_id: int
    i: int  # first gene index (the larger one)
    j: int  # second gene index


def num_pairs(k: int) -> int:
    return k * (k - 1) // 2


def task_id(i: int, j: int) -> int:
    if not i > j:
        raise ValueError("task_id requires i > j")
    return i * (i - 1) // 2 + j


def pair_tasks(k: int) -> Iterator[PairTask]:
    tid = 0
    for i in range(1, k):
        for j in range(i):
            yield PairTask(tid, i, j)
            tid += 1


def pair_task_list(k: int) -> List[PairTask]:
    return list(pair_tasks(k))
