"""Anti-diagonal Needleman-Wunsch sweep in plain torch ops.

Port of ``msa_tpu/ops/nw_jax.py``, the jnp (not Pallas) device path: one
step per anti-diagonal d updates a vector indexed by row i, the cells
(i, j = d - i), and can emit each diagonal's traceback moves. The
``lax.scan`` becomes a Python loop of torch ops on the tensors' device.
Bucket padding (``ops/buckets.py``), which bounded XLA's recompiles, is
dropped: ``_prep_pair`` sizes the buffers to the pair. The sweep still takes
padded buffers, so the tests can feed it the JAX package's own.

Neighbours of cell (i, j) on diagonal d:

    left (i, j-1)   -> diagonal d-1, index i
    up   (i-1, j)   -> diagonal d-1, index i-1
    diag (i-1, j-1) -> diagonal d-2, index i-1
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from msa_tpu_torch.ops.band_fill import NEG_FILL, X_SENTINEL, Y_SENTINEL

DIAG_MATCH, DIAG_SUB, UP, LEFT = 0, 1, 2, 3


def _shift1(v: torch.Tensor, fill: int = NEG_FILL) -> torch.Tensor:
    """shift(v)[i] = v[i - 1]; index 0 gets ``fill``."""
    return torch.cat([v.new_full((1,), fill), v[:-1]])


def _diag_step(d, prev1, prev2, xpad, ybuf, m, n, pxy, pgap, ii, y_off, swap):
    """One anti-diagonal update; returns (cur, dirs) vectors of length V.

    ``xpad[i]`` = code(x[i-1]) (index 0 is a sentinel); ``ybuf`` holds y
    reversed so that ``ybuf[y_off - d + i]`` = code(y[d-i-1]).
    """
    V = prev1.shape[0]
    yd = ybuf[y_off - d : y_off - d + V]
    match = xpad == yd
    cand_diag = _shift1(prev2) + (~match).to(torch.int32) * pxy
    cand_up = _shift1(prev1) + pgap
    cand_left = prev1 + pgap
    cur = torch.minimum(cand_diag, torch.minimum(cand_up, cand_left))

    # Tie-break match > diag > up > left (nw_jax.py:78-97). swap = 1 marks a
    # transposed pair, whose up and left are exchanged: ties then prefer
    # LEFT, so the swapped-back alignment is the untransposed one.
    dirs = torch.where(
        match,
        DIAG_MATCH,
        torch.where(
            cand_diag == cur,
            DIAG_SUB,
            torch.where((cand_up == cur) & (cand_up + swap <= cand_left), UP, LEFT),
        ),
    ).to(torch.int8)

    # Borders dp[i][0] = i * pgap (cell i == d) and dp[0][j] = j * pgap (i == 0).
    cur = torch.where((ii == 0) | (ii == d), d * pgap, cur)
    # Lanes outside the m x n rectangle never win a later min.
    valid = (ii <= min(d, m)) & (ii >= max(0, d - n))
    return torch.where(valid, cur, NEG_FILL), dirs


def diag_sweep(
    xpad: torch.Tensor,  # (Mp+1,) int32
    ybuf: torch.Tensor,  # (2 * (Mp+1) + Np + 1,) int32, reversed y
    m: int,
    n: int,
    pxy: int,
    pgap: int,
    *,
    swap: int = 0,
    emit_dirs: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], None]:
    """Run the full sweep; returns (score, dirs_diag, None) like the JAX one.

    - score: dp[m][n], an int32 tensor of one element;
    - dirs_diag: (D, V) int8 with dirs_diag[d-1, i] the move of cell
      (i, d-i), or None.
    """
    V = xpad.shape[0]
    Np = ybuf.shape[0] - 2 * V - 1
    y_off = V + Np
    D = (V - 1) + Np
    i32 = dict(dtype=torch.int32, device=xpad.device)
    ii = torch.arange(V, **i32)
    # Diagonal d = 0 holds dp[0][0] = 0; the dummy diagonal d = -1 is all +inf.
    prev1 = torch.where(ii == 0, 0, NEG_FILL).to(torch.int32)
    prev2 = torch.full((V,), NEG_FILL, **i32)
    dirs_all = torch.empty((D, V), dtype=torch.int8, device=xpad.device) if emit_dirs else None
    score = torch.zeros(1, **i32)
    for d in range(1, D + 1):
        cur, dirs = _diag_step(d, prev1, prev2, xpad, ybuf, m, n, pxy, pgap, ii, y_off, swap)
        if emit_dirs:
            dirs_all[d - 1] = dirs
        if d == m + n:
            score = cur[m : m + 1]
        prev2, prev1 = prev1, cur
    return score, dirs_all, None


def _encode(seq: str, length: int, sentinel: int) -> np.ndarray:
    codes = np.full(length, sentinel, np.int32)
    codes[: len(seq)] = np.frombuffer(seq.encode("latin-1"), np.uint8)
    return codes


def _prep_pair(x: str, y: str, Mp: Optional[int] = None, Np: Optional[int] = None):
    """Host packing of one pair into sweep inputs (numpy, as nw_jax._prep_pair).

    ``Mp`` and ``Np`` default to the lengths themselves: no bucket padding.
    """
    m, n = len(x), len(y)
    Mp = m if Mp is None else Mp
    Np = n if Np is None else Np
    V = Mp + 1
    xpad = np.concatenate([[X_SENTINEL], _encode(x, Mp, X_SENTINEL)]).astype(np.int32)
    # [V sentinels | y reversed (Np) | V + 1 sentinels]: with y_off = V + Np,
    # ybuf[y_off - d + i] = y[d-i-1] and every slice start y_off - d >= 1.
    ybuf = np.concatenate([
        np.full(V, Y_SENTINEL, np.int32),
        _encode(y, Np, Y_SENTINEL)[::-1],
        np.full(V + 1, Y_SENTINEL, np.int32),
    ]).astype(np.int32)
    return xpad, ybuf, m, n, Mp, Np


def _sweep(x: str, y: str, pxy: int, pgap: int, device, **kwargs):
    xpad, ybuf, m, n, _, _ = _prep_pair(x, y)
    device = torch.device("cpu") if device is None else device
    return diag_sweep(
        torch.from_numpy(xpad).to(device), torch.from_numpy(ybuf).to(device),
        m, n, pxy, pgap, **kwargs,
    )


def nw_score_torch(x: str, y: str, pxy: int, pgap: int,
                   device: Optional[torch.device] = None) -> int:
    """Minimum penalty through the diagonal sweep (O(diagonal) memory)."""
    return int(_sweep(x, y, pxy, pgap, device)[0].item())


def nw_align_torch(x: str, y: str, pxy: int, pgap: int,
                   device: Optional[torch.device] = None) -> Tuple[int, str, str]:
    """Penalty and alignment through the sweep's full per-diagonal dirs.

    The dirs are (m + n) x (m + 1) int8 with x the SHORT side, so a skewed
    pair runs transposed with the swap tie-break and its alignments are
    swapped back (nw_jax.py:204-230).
    """
    from msa_tpu_torch.utils.alignment import moves_to_alignment

    swapped = len(x) > len(y)
    xs, ys = (y, x) if swapped else (x, y)
    score, dirs_diag, _ = _sweep(xs, ys, pxy, pgap, device, swap=int(swapped), emit_dirs=True)
    moves = _walk_diag(dirs_diag.cpu().numpy(), len(xs), len(ys))
    a1, a2 = moves_to_alignment(xs, ys, moves)
    if swapped:
        a1, a2 = a2, a1
    return int(score.item()), a1, a2


def _walk_diag(dirs_diag: np.ndarray, m: int, n: int):
    """Walk dirs stored per diagonal: the move of (i, j) at [i + j - 1, i]."""
    i, j = m, n
    moves = []
    while i != 0 and j != 0:
        mv = int(dirs_diag[i + j - 1, i])
        moves.append(mv)
        if mv <= DIAG_SUB:
            i -= 1
            j -= 1
        elif mv == UP:
            i -= 1
        else:
            j -= 1
    return moves
