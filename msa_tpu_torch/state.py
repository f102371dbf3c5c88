"""The state that crosses from the JAX package to the port: the fill's output.

There are no learned weights. What one implementation hands the other is the
banded fill's result (score, band boundary rows, wavefront snapshots), and
``fill_state_from_jax`` maps the arrays of
``msa_tpu/ops/pallas_nw.py::_band_sweep_call`` into the port's layout
(``ops/band_fill.py``) for one pair, so that the JAX fill can feed the
port's walk.

JAX layouts read here:
- ``rows`` (num_bands, 8, Yp): row 0 of band b holds dp[(b+1)*rb][j] at
  index j - 1;
- ``snaps`` (num_bands * s_max, 3, 128, R): snapshot s of band b at
  [b * s_max + s], each of the three (128, R) planes read row-major in
  flat-q order (pallas_nw.py:160-174), v_len = 128 * R lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from msa_tpu_torch.ops.band_fill import FillState, Plan, plan_pairs


def fill_state_from_jax(score, rows, snaps, *, m, n, rb, v_len, snap_k) -> FillState:
    """One pair's JAX fill output in the port's flat layout (P = 1).

    Only the snapshots the port's fill writes are carried (s * snap_k <
    rows_b + n); other slots are 0, as the port leaves them.
    """
    plan = plan_pairs([m, n], [(0, 1)], rb, snap_k)
    nb, S = int(plan.params[0, 4]), int(plan.params[0, 5])
    lanes = rb + 1
    rows = np.asarray(rows)
    snaps = np.asarray(snaps)
    s_max = snaps.shape[0] // rows.shape[0]
    flat = snaps.reshape(snaps.shape[0], 3, v_len)[:, :, :lanes]
    out = np.zeros((nb, S, 3, lanes), np.int32)
    for b in range(nb):
        written = (min(rb, m - b * rb) + n - 1) // snap_k + 1
        out[b, :written] = flat[b * s_max : b * s_max + written]
    return FillState(
        score=torch.tensor([int(np.asarray(score).reshape(-1)[0])], dtype=torch.int32),
        rows=torch.from_numpy(
            np.ascontiguousarray(rows[: nb - 1, 0, :n]).reshape(-1)
            if nb > 1 else np.zeros(1, np.int32)
        ),
        snaps=torch.from_numpy(out.reshape(-1)),
    )


def pair_rows(fill: FillState, plan: Plan, p: int) -> torch.Tensor:
    """(nb - 1, n) bottom rows of pair p."""
    m, n, _, _, nb, _, _, off, _ = plan.params[p].tolist()
    return fill.rows[off : off + (nb - 1) * n].reshape(nb - 1, n)


def pair_snaps(fill: FillState, plan: Plan, p: int) -> torch.Tensor:
    """(nb, S, 3, rb + 1) snapshots of pair p."""
    _, _, _, _, nb, S, off, _, _ = plan.params[p].tolist()
    lanes = plan.rb + 1
    return fill.snaps[off : off + nb * S * 3 * lanes].reshape(nb, S, 3, lanes)


def valid_snapshot_cells(plan: Plan, p: int) -> np.ndarray:
    """(nb, S, 3, rb + 1) bool: the snapshot entries that are DP cells.

    Snapshot s of band b is diagonal d = s * snap_k. Plane 0 (p1) at lane q
    is cell (q, d - q); planes 1 and 2 (p1s, p2s) at lane q are cells
    (q - 1, d - q + 1) and (q - 1, d - q). An entry is valid when the cell
    lies in the band (row 0 .. rows_b) and in the matrix (column 0 .. n),
    and the fill wrote the snapshot. Other entries carry arbitrary values.
    """
    m, n, _, _, nb, S, _, _, _ = plan.params[p].tolist()
    rb, K = plan.rb, plan.snap_k
    q = np.arange(rb + 1)[None, :]
    s = np.arange(S)[:, None]
    d = s * K
    out = np.zeros((nb, S, 3, rb + 1), bool)
    for b in range(nb):
        nrows = min(rb, m - b * rb)
        written = d < nrows + n
        for plane, (row, col) in enumerate(
            [(q, d - q), (q - 1, d - q + 1), (q - 1, d - q)]
        ):
            out[b, :, plane] = (
                written & (row >= 0) & (row <= nrows) & (col >= 0) & (col <= n)
            )
    return out
