"""Exact traceback walk: the CUDA kernel, its plain version, and the decode.

Port of ``msa_tpu/ops/pallas_walk.py::_walk_call``. From (m, n) each pair's
walk goes back segment by segment: it recomputes the snap_k diagonals of the
current segment in a window of W = min(snap_k + 128, rb + 1) lanes, seeded by
the fill's snapshot (``band_fill``), and follows the moves until it leaves
the segment or the band. It stops at the first cell with i == 0 or j == 0.

Move codes are 0 match, 1 substitution, 2 up, 3 left, with the tie-break
match -> diagonal -> up -> left; move c of a pair rides bits 2*(c % 16) of
word c // 16 of the pair's slice of ``moves`` (at params column
P_MOVES_OFF), and ``counts[p]`` says how many moves the pair has.

``walk`` launches ``csrc/walk.cu`` for CUDA tensors and runs ``walk_ref``
for CPU tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from msa_tpu_torch.config import CELLS_PER_THREAD, MAX_RB
from msa_tpu_torch.ops.band_fill import (
    NEG_FILL,
    X_SENTINEL,
    Y_SENTINEL,
    FillState,
    Plan,
)


def window(plan: Plan) -> int:
    """Lanes the walk recomputes per segment."""
    return min(plan.snap_k + 128, plan.rb + 1)


def segment(i: int, j: int, rb: int, snap_k: int, lanes: int, win: int):
    """(band, i0, q, dl0, w0, steps) of the segment holding cell (i, j)."""
    b = (i - 1) // rb
    i0 = b * rb
    q = i - i0
    dl = q + j
    dl0 = (dl - 1) // snap_k * snap_k
    w0 = 0 if q - snap_k <= 0 else (q - snap_k) // 128 * 128
    w0 = min(w0, lanes - win)
    return b, i0, q, dl0, w0, dl - dl0


def walk(
    table: torch.Tensor, plan: Plan, fill: FillState, pxy: int, pgap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trace every pair of ``plan``; returns (moves words, counts)."""
    if table.device.type == "cpu":
        return walk_ref(table, plan, fill, pxy, pgap)
    if table.device.type != "cuda":
        raise ValueError(f"walk runs on cuda or cpu, not {table.device}")
    if window(plan) > MAX_RB + 1:
        raise ValueError(f"the walk kernel takes at most {MAX_RB + 1} window lanes")
    from msa_tpu_torch.ops import _build

    lib = _build.load("walk")
    dev = table.device
    table = table.contiguous()
    for t in (fill.rows, fill.snaps):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("fill state must be contiguous int32 on the table's device")
    params = torch.from_numpy(plan.params).to(dev)
    threads = -(-window(plan) // CELLS_PER_THREAD)
    threads = -(-threads // 32) * 32
    dirs = torch.empty(
        plan.num_pairs * plan.snap_k * threads * CELLS_PER_THREAD,
        dtype=torch.uint8, device=dev,
    )
    moves = torch.zeros(max(plan.moves_len, 1), dtype=torch.int32, device=dev)
    counts = torch.zeros(plan.num_pairs, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.walk(
        table.data_ptr(), table.stride(0), params.data_ptr(), plan.num_pairs,
        plan.rb, plan.snap_k, pxy, pgap, fill.rows.data_ptr(),
        fill.snaps.data_ptr(), dirs.data_ptr(), moves.data_ptr(),
        counts.data_ptr(), ctypes.c_void_p(stream),
    )
    _build.check("walk", err)
    walk.launches += 1
    walk.pairs += plan.num_pairs
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
    table: torch.Tensor, plan: Plan, fill: FillState, pxy: int, pgap: int
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

    for p, prm in enumerate(plan.params.tolist()):
        m, n, xg, yg, _, S, snap_off, rows_off, moves_off = prm
        x = table[xg, :m].to(torch.int32)
        y = table[yg, :n].to(torch.int32)
        moves = []
        i, j = m, n
        while i > 0 and j > 0:
            b, i0, q, dl0, w0, steps = segment(i, j, rb, K, lanes, win)
            nrows = min(rb, m - i0)
            base = snap_off + ((b * S + dl0 // K) * 3) * lanes + w0
            p1 = fill.snaps[base : base + win]
            p1s = fill.snaps[base + lanes : base + lanes + win]
            p2s = fill.snaps[base + 2 * lanes : base + 2 * lanes + win]
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
                    row = fill.rows[rows_off + (b - 1) * n :]
                    top[1 : jj + 1] = row[:jj]
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
                    torch.where(t1 <= t2, 1, torch.where(p1s <= p1, 2, 3)),
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
