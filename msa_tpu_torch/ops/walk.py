"""Exact traceback walk: the CUDA kernel, its plain version, and the decode.

Port of ``msa_tpu/ops/pallas_walk.py::_walk_call``. From (m, n) each pair's
walk goes back segment by segment: it recomputes the current segment's
steps, up to snap_k diagonals, in a window of W = min(snap_k, rb + 1)
lanes that follows the cone the walk can reach (``segment``), seeded by the
fill's snapshot (``band_fill``), and follows the moves until it leaves the
segment or the band. It stops at the first cell with i == 0 or j == 0.

Move codes are 0 match, 1 substitution, 2 up, 3 left, with the tie-break
match -> diagonal -> up -> left (left before up for a pair with ``swap`` = 1,
which the conveyor planner transposed); move c of a pair rides bits
2*(c % 16) of word c // 16 of the pair's slice of ``moves`` (at column
W_MOVES_OFF), and ``counts[p]`` says how many moves the pair has.

A ``WalkPlan`` says where each pair's bands lie in the fill's output: band b
of pair p is row ``pairs[p, W_BAND0] + b`` of ``bands``, whose snapshot
segment s starts at ``snaps[snap_base + s * 3 * (rb + 1)]`` and whose top
row holds column j at ``rows[row_base + j]`` (band 0's top is analytic).
``banded_walk_plan`` lays out the banded fill's output this way, and
``ops/conveyor.py`` the conveyor's, so one walk serves both fills.

``walk`` launches ``csrc/walk.cu`` for CUDA tensors and runs ``walk_ref``
for CPU tensors; any other device raises. The kernel keeps a segment's
reachable directions in shared memory (``walk_shared_bytes``), so a snap_k
whose cone does not fit a block raises on every device.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from msa_tpu_torch.ops.band_fill import NEG_FILL, X_SENTINEL, Y_SENTINEL, Plan, to_card

# Columns of the per-pair table and of the band table (csrc/walk.cu keeps
# the same order).
W_M, W_N, W_XG, W_YG, W_BAND0, W_MOVES_OFF, W_SWAP = range(7)
WCOL = 7
B_SNAP, B_ROW = range(2)
# Lanes each thread of the walk kernel owns, threads of one walk block at
# most (csrc/walk.cu, WALK_CELLS and WALK_THREADS), and the bytes of its
# static shared arrays: two double-buffered int arrays of WALK_THREADS and
# the broadcast (i, j).
WALK_CELLS = 4
WALK_THREADS = 512
WALK_STATIC_SHARED = 2 * 2 * WALK_THREADS * 4 + 16
# Shared memory a block may take on an H100 (sm_90), static and dynamic.
BLOCK_SHARED_MAX = 232_448


@dataclasses.dataclass
class WalkPlan:
    """Per-pair walk table, band table and move-buffer size of one walk call."""

    pairs: np.ndarray  # (P, WCOL) int64
    bands: np.ndarray  # (total bands, 2) int64: snap_base, row_base
    rb: int
    snap_k: int
    moves_len: int

    @property
    def num_pairs(self) -> int:
        return int(self.pairs.shape[0])


def make_walk_plan(pairs: Sequence, rb: int, snap_k: int) -> WalkPlan:
    """``pairs``: (m, n, x gene, y gene, swap, [(snap_base, row_base), ...])."""
    rows, bands = [], []
    moves_off = 0
    for m, n, xg, yg, swap, band_rows in pairs:
        rows.append([m, n, xg, yg, len(bands), moves_off, swap])
        bands.extend(band_rows)
        moves_off += -(-(m + n) // 16)
    return WalkPlan(
        np.array(rows, np.int64).reshape(-1, WCOL),
        np.array(bands, np.int64).reshape(-1, 2), rb, snap_k, moves_off,
    )


def banded_walk_plan(plan: Plan) -> WalkPlan:
    """The walk's view of a banded fill (``ops/band_fill.py``) output."""
    lanes = plan.rb + 1
    pairs = []
    for m, n, xg, yg, nb, S, snap_off, rows_off in plan.params.tolist():
        bands = [
            (snap_off + b * S * 3 * lanes, rows_off + (b - 1) * n - 1 if b else 0)
            for b in range(nb)
        ]
        pairs.append((m, n, xg, yg, 0, bands))
    return make_walk_plan(pairs, plan.rb, plan.snap_k)


def window(plan) -> int:
    """Lanes the walk recomputes per segment: the entry lane and the lanes
    below it that the walk can reach, at most."""
    return min(plan.snap_k, plan.rb + 1)


def segment(i: int, j: int, rb: int, snap_k: int, lanes: int, win: int):
    """(band, i0, q, dl0, w0, steps) of the segment holding cell (i, j).

    The window starts ``steps - 1`` lanes below the entry lane q: the walk
    drops at most a lane a step and the error of the unknown lanes below w0
    climbs a lane a step, so at 0-based step t the walk reads lanes
    >= w0 + t, which are exact (``msa_tpu/ops/pallas_walk.py:44-53``). It
    is lowered if need be so that its ``win`` lanes stay in the band.
    """
    b = (i - 1) // rb
    i0 = b * rb
    q = i - i0
    dl = q + j
    dl0 = (dl - 1) // snap_k * snap_k
    steps = dl - dl0
    w0 = min(max(q - steps + 1, 0), lanes - win)
    return b, i0, q, dl0, w0, steps


def cone_row(u: int) -> int:
    """First granule of row u of the kernel's shared cone.

    A granule holds a thread's directions on one step, 2 bits for each of
    its WALK_CELLS lanes. Row u (u steps back from a segment's entry step)
    holds the u // WALK_CELLS + 2 granules of the threads that own lanes
    q - u .. q; rows 0 .. u - 1 come before it (csrc/walk.cu, cone_row).
    """
    a = u // WALK_CELLS
    return 2 * u + WALK_CELLS * a * (a - 1) // 2 + a * (u % WALK_CELLS)


def walk_shared_bytes(snap_k: int) -> int:
    """Dynamic shared memory of one walk block: the cone of a full segment."""
    return WALK_CELLS // 4 * cone_row(snap_k)


def check_walk_geometry(rb: int, snap_k: int) -> None:
    """Raise unless the kernel takes this band height and segment length."""
    if snap_k < 1 or rb < 1:
        raise ValueError(f"the walk needs positive rb and snap_k, got {rb}, {snap_k}")
    need = walk_shared_bytes(snap_k) + WALK_STATIC_SHARED
    if need > BLOCK_SHARED_MAX:
        raise ValueError(
            f"the walk's cone at snap_k={snap_k} needs {need} bytes of shared memory"
            f" a block, over the {BLOCK_SHARED_MAX} an H100 block may take"
        )


def walk(
    table: torch.Tensor, plan: WalkPlan, rows: torch.Tensor,
    snaps: torch.Tensor, pxy: int, pgap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trace every pair of ``plan``; returns (moves words, counts)."""
    check_walk_geometry(plan.rb, plan.snap_k)
    if table.device.type == "cpu":
        return walk_ref(table, plan, rows, snaps, pxy, pgap)
    if table.device.type != "cuda":
        raise ValueError(f"walk runs on cuda or cpu, not {table.device}")
    from msa_tpu_torch.ops import _build

    lib = _build.load("walk")
    dev = table.device
    table = table.contiguous()
    for t in (rows, snaps):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("fill state must be contiguous int32 on the table's device")
    params = to_card(plan.pairs, dev)
    bands = to_card(plan.bands, dev)
    moves = torch.zeros(max(plan.moves_len, 1), dtype=torch.int32, device=dev)
    counts = torch.zeros(plan.num_pairs, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.walk(
        table.data_ptr(), table.stride(0), params.data_ptr(), bands.data_ptr(),
        plan.num_pairs, plan.rb, plan.snap_k, pxy, pgap, rows.data_ptr(),
        snaps.data_ptr(), moves.data_ptr(),
        counts.data_ptr(), ctypes.c_void_p(stream),
    )
    _build.check("walk", err)
    _build.count(walk, plan.num_pairs)
    return moves, counts


walk.launches = 0  # kernel launches (plain-version runs not counted)
walk.pairs = 0  # pairs those launches traced


def pack_moves(moves: np.ndarray) -> np.ndarray:
    """Backward move stream -> int32 words, 16 moves each (decode_moves' inverse)."""
    words = -(-len(moves) // 16)
    padded = np.zeros(words * 16, np.uint32)
    padded[: len(moves)] = moves
    shifts = 2 * np.arange(16, dtype=np.uint32)
    packed = (padded.reshape(words, 16) << shifts).sum(axis=1, dtype=np.uint32)
    return packed.view(np.int32)


def walk_ref(
    table: torch.Tensor, plan: WalkPlan, rows: torch.Tensor,
    snaps: torch.Tensor, pxy: int, pgap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch walk: one Python step per diagonal, then a host walk."""
    dev = table.device
    rb, K = plan.rb, plan.snap_k
    lanes = rb + 1
    win = window(plan)
    i32 = dict(dtype=torch.int32, device=dev)
    neg = torch.full((1,), NEG_FILL, **i32)
    lane = torch.arange(win, **i32)
    moves_out = np.zeros(max(plan.moves_len, 1), np.int32)
    counts = np.zeros(plan.num_pairs, np.int32)

    def codes(seq, idx, sentinel):
        ok = (idx >= 0) & (idx < seq.numel())
        return torch.where(ok, seq[idx.clamp(0, seq.numel() - 1)], sentinel)

    for p, (m, n, xg, yg, band0, moves_off, swap) in enumerate(plan.pairs.tolist()):
        x = table[xg, :m].to(torch.int32)
        y = table[yg, :n].to(torch.int32)
        moves = []
        i, j = m, n
        while i > 0 and j > 0:
            b, i0, q, dl0, w0, steps = segment(i, j, rb, K, lanes, win)
            nrows = min(rb, m - i0)
            snap_base, row_base = plan.bands[band0 + b].tolist()
            base = snap_base + (dl0 // K) * 3 * lanes + w0
            p1 = snaps[base : base + win]
            p1s = snaps[base + lanes : base + lanes + win]
            p2s = snaps[base + 2 * lanes : base + 2 * lanes + win]
            qq = w0 + lane
            xv = torch.where(
                (qq >= 1) & (qq <= nrows),
                x[(i0 + qq - 1).clamp(0, m - 1)],
                X_SENTINEL,
            )
            yd = codes(y, dl0 - qq - 1, Y_SENTINEL)
            top = None
            if w0 == 0:
                top = torch.full((steps + dl0 + 1,), NEG_FILL, **i32)
                jj = min(n, steps + dl0)
                if b == 0:
                    top[1 : jj + 1] = torch.arange(1, jj + 1, **i32) * pgap
                else:
                    top[1 : jj + 1] = rows[row_base + 1 : row_base + jj + 1]
            yfeed = codes(y, dl0 + torch.arange(steps, **i32) - w0, Y_SENTINEL)
            dirs = torch.empty((steps, win), dtype=torch.int8, device=dev)
            for t in range(1, steps + 1):
                d = dl0 + t
                yd = torch.cat([yfeed[t - 1 : t], yd[:-1]])
                match = xv == yd
                t1 = p2s + torch.where(match, 0, pxy).to(torch.int32)
                t2 = torch.minimum(p1, p1s) + pgap
                cur = torch.minimum(t1, t2)
                if top is not None:
                    cur[0] = top[d]
                if 0 <= d - w0 < win:
                    cur[d - w0] = (i0 + d) * pgap
                dirs[t - 1] = torch.where(
                    match, 0,
                    torch.where(t1 <= t2, 1, torch.where(p1s + swap <= p1, 2, 3)),
                ).to(torch.int8)
                p2s, p1s, p1 = p1s, torch.cat([neg, cur[:-1]]), cur
            dh = dirs.cpu().numpy()
            t = steps - 1
            while q >= 1 and t >= 0 and t - q + dl0 + 1 > 0:
                mv = int(dh[t, q - w0])
                moves.append(mv)
                q -= mv <= 2
                t -= 1 + (mv <= 1)
            i, j = i0 + q, t - q + dl0 + 1
        words = pack_moves(np.asarray(moves, np.uint32))
        moves_out[moves_off : moves_off + len(words)] = words
        counts[p] = len(moves)
    return (
        torch.from_numpy(moves_out).to(dev),
        torch.from_numpy(counts).to(dev),
    )


def pair_moves(words: np.ndarray, counts: np.ndarray, plan: WalkPlan, p: int) -> np.ndarray:
    """Pair p's backward move stream from a walk's fetched output."""
    off = int(plan.pairs[p, W_MOVES_OFF])
    cnt = int(counts[p])
    return decode_moves(words[None, off : off + -(-cnt // 16)], counts[p : p + 1])


def walk_segments(m: int, n: int, moves: np.ndarray, rb: int, snap_k: int) -> np.ndarray:
    """(steps, entry lane) of each segment a pair's walk recomputes, in order.

    Replays the backward move stream from (m, n): the walk recomputes one
    segment for each run of cells with the same band and snapshot segment
    (both only fall along the path), ``steps`` diagonals deep with its entry
    cell on lane q of the band.
    """
    mv = np.asarray(moves, np.int64)
    i = m - np.concatenate([[0], np.cumsum(mv <= 2)[:-1]])
    j = n - np.concatenate([[0], np.cumsum(mv != 2)[:-1]])
    b = (i - 1) // rb
    q = i - b * rb
    dl = q + j
    seg = (dl - 1) // snap_k
    first = np.ones(len(mv), bool)
    first[1:] = (b[1:] != b[:-1]) | (seg[1:] != seg[:-1])
    return np.stack([dl[first] - seg[first] * snap_k, q[first]], axis=1)


def decode_moves(words: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Host decode of packed walk output -> int8 move stream.

    Copied from ``msa_tpu/ops/pallas_walk.py:775`` (that module imports
    jax). ``words``: (G, words_per_slot) int32, slot g's moves 16 to a word
    (move c rides bits 2*(c % 16) of word c // 16); ``counts``: (G,) moves
    per slot. Slots concatenate in order.
    """
    G = words.shape[0]
    shifts = 2 * np.arange(16, dtype=np.uint32)
    m2 = (
        (words.astype(np.uint32)[:, :, None] >> shifts) & 3
    ).astype(np.int8).reshape(G, -1)
    mask = np.arange(m2.shape[1])[None, :] < counts[:, None]
    return m2[mask]
