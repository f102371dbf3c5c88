"""NumPy golden oracle for the Needleman–Wunsch minimum-penalty DP.

Semantics mirror the reference's sequential oracle
(``seqalign-mpi-skeleton.cpp:186-280``):

- border: ``dp[i][0] = i*pgap``, ``dp[0][j] = j*pgap``;
- recurrence: ``dp[i][j] = dp[i-1][j-1]`` on character match, else
  ``min(dp[i-1][j-1]+pxy, dp[i-1][j]+pgap, dp[i][j-1]+pgap)``;
- traceback tie-break order: match -> diagonal -> up -> left.

Implementation is vectorized per row: the left-to-right dependency
``dp[i][j] = min(t[i][j], dp[i][j-1]+pgap)`` (where ``t`` folds the diagonal
and up candidates) unrolls to a prefix-min of ``t[i][j] - j*pgap``, so each
row is O(n) NumPy work instead of a Python inner loop. The match shortcut is
absorbed exactly: when chars match, ``dp[i-1][j-1]`` is <= every gap
candidate (adjacent DP cells differ by at most pgap), so min-of-three with a
zero substitution cost equals the reference's unconditional diagonal copy.

The port's own copy of ``msa_tpu/ops/reference.py``; the port imports nothing of the JAX
package. The tests hold the two copies equal.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from msa_tpu_torch.utils.alignment import moves_to_alignment

DIAG_MATCH, DIAG_SUB, UP, LEFT = 0, 1, 2, 3


def seq_to_codes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("latin-1"), dtype=np.uint8)


def nw_dp_matrix(x: str, y: str, pxy: int, pgap: int) -> np.ndarray:
    """Full (m+1, n+1) int32 DP matrix, bit-identical to the reference."""
    xv = seq_to_codes(x)
    yv = seq_to_codes(y)
    m, n = len(xv), len(yv)
    dp = np.empty((m + 1, n + 1), dtype=np.int32)
    jj = np.arange(n + 1, dtype=np.int32)
    dp[0] = jj * pgap
    jpgap = jj[1:] * pgap  # j*pgap for j = 1..n
    for i in range(1, m + 1):
        prev = dp[i - 1]
        sub = np.where(xv[i - 1] == yv, 0, pxy).astype(np.int32)
        t = np.minimum(prev[:-1] + sub, prev[1:] + pgap)
        # dp[i][j] = min(t[j], dp[i][j-1] + pgap)  ==  prefix-min form
        u = np.minimum.accumulate(
            np.concatenate(([np.int32(i * pgap)], t - jpgap))
        )
        row = u + np.concatenate(([np.int32(0)], jpgap))
        dp[i] = row
    return dp


def nw_score_numpy(x: str, y: str, pxy: int, pgap: int) -> int:
    """Minimum penalty only (O(n) memory)."""
    xv = seq_to_codes(x)
    yv = seq_to_codes(y)
    m, n = len(xv), len(yv)
    jj = np.arange(n + 1, dtype=np.int32)
    prev = jj * pgap
    jpgap = jj[1:] * pgap
    for i in range(1, m + 1):
        sub = np.where(xv[i - 1] == yv, 0, pxy).astype(np.int32)
        t = np.minimum(prev[:-1] + sub, prev[1:] + pgap)
        u = np.minimum.accumulate(
            np.concatenate(([np.int32(i * pgap)], t - jpgap))
        )
        prev = u + np.concatenate(([np.int32(0)], jpgap))
    return int(prev[n])


def nw_dirs(dp: np.ndarray, x: str, y: str, pxy: int, pgap: int) -> np.ndarray:
    """(m, n) int8 matrix of traceback moves for cells (i, j), 1-based.

    Encodes the reference tie-break (``seqalign-mpi-skeleton.cpp:236-262``):
    0 = diag (match), 1 = diag (substitution), 2 = up, 3 = left.
    """
    xv = seq_to_codes(x)
    yv = seq_to_codes(y)
    match = xv[:, None] == yv[None, :]
    cur = dp[1:, 1:]
    diag = dp[:-1, :-1]
    up = dp[:-1, 1:]
    dirs = np.where(
        match,
        np.int8(DIAG_MATCH),
        np.where(
            diag + pxy == cur,
            np.int8(DIAG_SUB),
            np.where(up + pgap == cur, np.int8(UP), np.int8(LEFT)),
        ),
    ).astype(np.int8)
    return dirs


def walk_dirs(dirs: np.ndarray, m: int, n: int) -> List[int]:
    """Walk the move matrix from (m, n) to a border; returns backward moves."""
    i, j = m, n
    moves: List[int] = []
    while i != 0 and j != 0:
        mv = int(dirs[i - 1, j - 1])
        moves.append(mv)
        if mv <= DIAG_SUB:
            i -= 1
            j -= 1
        elif mv == UP:
            i -= 1
        else:
            j -= 1
    return moves


# Above this many cells, nw_align_numpy switches to the blocked
# checkpoint/recompute path: the full dp+dirs materialization is ~5 B/cell
# (10+ GB for one 30k x 70k pair — the r2 conformance timeout), while the
# blocked path peaks at ~5 B * block * n.
FULL_MATRIX_CELL_CAP = 64_000_000
BLOCK_ROWS = 1024


def nw_align_numpy(
    x: str, y: str, pxy: int, pgap: int
) -> Tuple[int, str, str]:
    """Penalty + trimmed alignment strings, bit-identical to the reference.

    Memory-bounded: large pairs route through the blocked
    checkpoint-row/recompute traceback (same cells, same tie-break — an
    exact-equality fuzz test covers the seam).
    """
    m, n = len(x), len(y)
    if m * n > FULL_MATRIX_CELL_CAP and m > 2 * BLOCK_ROWS:
        return nw_align_numpy_blocked(x, y, pxy, pgap)
    dp = nw_dp_matrix(x, y, pxy, pgap)
    dirs = nw_dirs(dp, x, y, pxy, pgap)
    moves = walk_dirs(dirs, m, n)
    a1, a2 = moves_to_alignment(x, y, moves)
    return int(dp[m, n]), a1, a2


def _advance_row(prev: np.ndarray, xc: int, yv: np.ndarray, pxy: int,
                 pgap: int, i: int, jpgap: np.ndarray) -> np.ndarray:
    """One DP row from the previous row (vectorized prefix-min form)."""
    sub = np.where(xc == yv, 0, pxy).astype(np.int32)
    t = np.minimum(prev[:-1] + sub, prev[1:] + pgap)
    u = np.minimum.accumulate(
        np.concatenate(([np.int32(i * pgap)], t - jpgap))
    )
    return u + np.concatenate(([np.int32(0)], jpgap))


def nw_align_numpy_blocked(
    x: str, y: str, pxy: int, pgap: int, block: int = BLOCK_ROWS
) -> Tuple[int, str, str]:
    """Exact alignment with O(block * n) peak memory.

    Forward pass saves every ``block``-th DP row; the traceback recomputes
    one block of rows at a time (checkpoint row -> block's dirs) and walks
    it with the reference tie-break — the host-side analog of the device
    walk's checkpoint-diagonal + windowed-recompute scheme
    (``ops/pallas_walk.py``). Reference semantics:
    ``seqalign-mpi-skeleton.cpp:186-280``.
    """
    xv = seq_to_codes(x)
    yv = seq_to_codes(y)
    m, n = len(xv), len(yv)
    jj = np.arange(n + 1, dtype=np.int32)
    jpgap = jj[1:] * pgap

    # Forward fill, checkpointing rows 0, block, 2*block, ...
    ckpts = {0: (jj * pgap).astype(np.int32)}
    prev = ckpts[0]
    for i in range(1, m + 1):
        prev = _advance_row(prev, xv[i - 1], yv, pxy, pgap, i, jpgap)
        if i % block == 0:
            ckpts[i] = prev
    score = int(prev[n])

    # Traceback, one block of rows at a time.
    i, j = m, n
    moves: List[int] = []
    while i != 0 and j != 0:
        i0 = (i - 1) // block * block  # checkpointed row above i
        rows = np.empty((i - i0 + 1, n + 1), dtype=np.int32)
        rows[0] = ckpts[i0]
        for r in range(1, i - i0 + 1):
            rows[r] = _advance_row(
                rows[r - 1], xv[i0 + r - 1], yv, pxy, pgap, i0 + r, jpgap
            )
        dirs = nw_dirs(rows, x[i0:i], y, pxy, pgap)
        while i > i0 and j > 0:
            mv = int(dirs[i - i0 - 1, j - 1])
            moves.append(mv)
            if mv <= DIAG_SUB:
                i -= 1
                j -= 1
            elif mv == UP:
                i -= 1
            else:
                j -= 1
    a1, a2 = moves_to_alignment(x, y, moves)
    return score, a1, a2
