"""The canonical pair order: task t = i(i-1)/2 + j for i = 1..k-1, j < i.

``seqalign-mpi-skeleton.cpp:122-123``. Pair t aligns sequence i (the rows
of its DP) against sequence j (the columns).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def pairs(k: int) -> List[Tuple[int, int]]:
    """(i, j) of each task, in task-id order."""
    return [(i, j) for i in range(1, k) for j in range(i)]


def cells(lengths: Sequence[int]) -> int:
    """DP cells of all pairs: the sum of len(i) * len(j)."""
    return sum(lengths[i] * lengths[j] for i, j in pairs(len(lengths)))
