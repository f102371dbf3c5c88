"""The two aligned strings of a traceback, as the reference program builds them.

``moves`` is the walk from (m, n) backward until i == 0 or j == 0
(``seqalign-mpi-skeleton.cpp:236-262``): DIAG consumes a character of both
sequences, UP one of x (a gap in y), LEFT one of y (a gap in x). The strings
are l = m + n wide and filled from the right: the walk's columns, then the
rest of each sequence's prefix, then '_' (:263-272). Then the gap trim keeps
what lies right of the last column where both strings hold '_' (:135-144).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

DIAG, UP, LEFT = 0, 1, 2
GAP = ord("_")


def strings(x: str, y: str, moves: Sequence[int]) -> Tuple[str, str]:
    m, n = len(x), len(y)
    mv = np.asarray(moves, dtype=np.uint8)[::-1]  # forward order
    takes_x, takes_y = mv != LEFT, mv != UP
    i0, j0 = m - int(takes_x.sum()), n - int(takes_y.sum())
    if i0 and j0:
        raise ValueError(f"the walk stops at ({i0}, {j0}), not on a border")
    xb = np.frombuffer(x.encode("latin-1"), np.uint8)
    yb = np.frombuffer(y.encode("latin-1"), np.uint8)
    width = m + n
    a1 = np.full(width, GAP, np.uint8)
    a2 = np.full(width, GAP, np.uint8)
    start = width - mv.size  # the walk's first column (0-based)
    a1[start:][takes_x] = xb[i0:]
    a2[start:][takes_y] = yb[j0:]
    a1[start - i0:start] = xb[:i0]
    a2[start - j0:start] = yb[:j0]
    both = np.flatnonzero((a1 == GAP) & (a2 == GAP))
    cut = int(both[-1]) + 1 if both.size else 0
    return a1[cut:].tobytes().decode("latin-1"), a2[cut:].tobytes().decode("latin-1")
