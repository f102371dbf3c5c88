"""The state that crosses from the JAX package to the port: the fills' output.

There are no learned weights. What one implementation hands the other is a
fill's result (scores, band boundary rows, wavefront snapshots), and
``fill_state_from_jax`` maps the arrays of
``msa_tpu/ops/pallas_nw.py::_band_sweep_call`` into the port's banded layout
(``ops/band_fill.py``) for one pair, ``conveyor_state_from_jax`` those of
``msa_tpu/ops/conveyor.py``'s fill into the port's conveyor layout
(``ops/conveyor.py``) for one sweep, so that either JAX fill can feed the
port's walk.

JAX layouts read here:
- ``rows`` (num_bands, 8, Yp): row 0 of band b holds dp[(b+1)*rb][j] at
  index j - 1;
- ``snaps`` (num_bands * s_max, 3, 128, R): snapshot s of band b at
  [b * s_max + s], each of the three (128, R) planes read row-major in
  flat-q order (pallas_nw.py:160-174), v_len = 128 * R lanes;
- conveyor ``snaps`` (n_chunks, 3, 128, R): chunk c in flat-q order, written
  as ``cur.T`` like the banded ones (conveyor.py:532-534);
- conveyor ``brow`` (n_slots, 1, ymax): column j of a slot at index j;
- conveyor ``scores`` (pairs, 1), by conveyor slot.
"""

from __future__ import annotations

import numpy as np
import torch

from msa_tpu_torch.ops.band_fill import FillState, Plan, plan_pairs
from msa_tpu_torch.ops.conveyor import (
    S_CHUNKS,
    S_FIRST,
    S_SNAP_OFF,
    ConveyorPlan,
    ConveyorState,
    Workload,
)


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
    m, n, _, _, nb, _, _, off = plan.params[p].tolist()
    return fill.rows[off : off + (nb - 1) * n].reshape(nb - 1, n)


def pair_snaps(fill: FillState, plan: Plan, p: int) -> torch.Tensor:
    """(nb, S, 3, rb + 1) snapshots of pair p."""
    _, _, _, _, nb, S, off, _ = plan.params[p].tolist()
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
    m, n, _, _, nb, S, _, _ = plan.params[p].tolist()
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


def conveyor_state_from_jax(scores, snaps, brow, *, plan: ConveyorPlan, rb, v_len) -> ConveyorState:
    """One JAX conveyor sweep's output in the port's layout (one sweep).

    The JAX arrays are padded (chunks to its compile granularity, lanes to
    v_len, brow rows to its ymax plus a trash slot); the port keeps the
    plan's n_chunks, rb + 1 lanes, n_slots and ymax of them.
    """
    lanes = rb + 1
    snaps = np.asarray(snaps)
    flat = snaps.reshape(snaps.shape[0], 3, v_len)[: plan.n_chunks, :, :lanes]
    rows = np.asarray(brow)[: plan.n_slots, 0, : plan.ymax]
    return ConveyorState(
        score=torch.from_numpy(
            np.asarray(scores).reshape(-1)[: len(plan.pair_ready)].astype(np.int32)
        ),
        brow=torch.from_numpy(np.ascontiguousarray(rows).reshape(-1)),
        snaps=torch.from_numpy(np.ascontiguousarray(flat).reshape(-1)),
        carry=torch.zeros(5 * lanes, dtype=torch.int32),
        progress=torch.zeros(1, dtype=torch.int32),
    )


def valid_conveyor_cells(wl: Workload) -> np.ndarray:
    """(snaps_len,) bool: the snapshot entries that are DP cells.

    Chunk c of a sweep is global step t = c * K. For each band of the sweep
    with start <= t, local dl = t - start; plane 0 (p1) at lane q is its cell
    (q, dl - q), planes 1 and 2 (p1s, p2s) the cells (q - 1, dl - q + 1) and
    (q - 1, dl - q). An entry is valid when the cell lies in the band (row
    0 .. its rows) and in the matrix (column 0 .. n). The bands' regions on
    a sweep are disjoint (the planner's stagger >= previous n + K), so each
    entry belongs to at most one band.
    """
    rb, K = wl.rb, wl.snap_k
    lanes = rb + 1
    q = np.arange(lanes)[None, :]
    out = np.zeros((wl.snaps_len // (3 * lanes), 3, lanes), bool)
    for bp in wl.plan.bands:
        first, chunks, snap_off = wl.sweep_table[bp.sweep, [S_FIRST, S_CHUNKS, S_SNAP_OFF]]
        rows = bp.q_last if bp.is_last else rb
        c0 = -(-bp.start // K)
        c1 = min(chunks, (bp.start + rb + bp.n) // K + 1)
        dl = (np.arange(c0, c1) * K - bp.start)[:, None]
        at = snap_off // (3 * lanes) + np.arange(c0, c1) - first
        for plane, (row, col) in enumerate(
            [(q, dl - q), (q - 1, dl - q + 1), (q - 1, dl - q)]
        ):
            out[at, plane] |= (row >= 0) & (row <= rows) & (col >= 0) & (col <= bp.n)
    return out.reshape(-1)


def valid_brow_cells(wl: Workload) -> np.ndarray:
    """(brow_len,) bool: brow entries that are DP cells.

    A band that is not its pair's last has a bottom row dp[i0 + rb][j],
    j = 0 .. n, in its brow_out slot; the other slots and columns carry
    arbitrary values.
    """
    out = np.zeros((wl.plan.n_slots, wl.ymax), bool)
    for bp in wl.plan.bands:
        if not bp.is_last:
            out[bp.brow_out, : bp.n + 1] = True
    return out.reshape(-1)
