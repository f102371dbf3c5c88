"""Banded Needleman-Wunsch fill: the CUDA kernel, its plain version, its plan.

Port of ``msa_tpu/ops/pallas_nw.py::_band_sweep_call``. One call fills every
pair of a workload: the gene table (one row of uint8 codes per sequence) is
on the device once, and a parameter table says which two rows each pair
aligns and where its outputs go in three flat int32 buffers:

- ``score[p]``: dp[m][n];
- ``rows``: for each band b < nb - 1, its bottom row dp[(b+1)*rb][j] at
  index j - 1 (j = 1..n; column 0 is analytic), n values a band;
- ``snaps``: for each band b and each s < S, the state (p1, p1s, p2s) of the
  band's rb + 1 lanes entering local diagonal s*snap_k + 1, written for
  s*snap_k < rows_b + n (other slots stay 0). Lane q of p1 holds
  dp[i0+q][s*snap_k - q]; p1s and p2s are the cells one lane up on the last
  and the second-to-last diagonal (csrc/common.cuh).

The JAX kernel pads each state to (R, 128) tiles and fixes the band count at
a compiled cap; here every size is a runtime argument and nothing is padded.

``band_fill`` launches ``csrc/band_fill.cu`` for CUDA tensors and runs
``band_fill_ref`` for CPU tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from msa_tpu_torch.config import MAX_RB

NEG_FILL = 2**30
X_SENTINEL = -1
Y_SENTINEL = -2

# Columns of the parameter table (csrc/common.cuh keeps the same order).
P_M, P_N, P_XG, P_YG, P_NB, P_S, P_SNAP_OFF, P_ROWS_OFF, P_MOVES_OFF = range(9)
NCOL = 9


@dataclasses.dataclass
class Plan:
    """Geometry and buffer offsets of every pair of one fill + walk call."""

    params: np.ndarray  # (P, NCOL) int64
    rb: int
    snap_k: int
    rows_len: int
    snaps_len: int
    moves_len: int

    @property
    def num_pairs(self) -> int:
        return int(self.params.shape[0])

    @property
    def snapshot_bytes(self) -> int:
        return 4 * self.snaps_len


@dataclasses.dataclass
class FillState:
    """The fill's outputs, flat, laid out by a Plan."""

    score: torch.Tensor  # (P,) int32
    rows: torch.Tensor  # (rows_len,) int32
    snaps: torch.Tensor  # (snaps_len,) int32


def plan_pairs(
    lengths: Sequence[int], pairs: Sequence[Tuple[int, int]], rb: int,
    snap_k: int,
) -> Plan:
    """Lay out pairs (x gene, y gene) of sequences with these lengths."""
    if rb < 1:
        raise ValueError(f"rb must be positive, got {rb}")
    if snap_k < 1:
        raise ValueError(f"snap_k must be positive, got {snap_k}")
    params = np.zeros((len(pairs), NCOL), np.int64)
    snap_off = rows_off = moves_off = 0
    for p, (xg, yg) in enumerate(pairs):
        m, n = int(lengths[xg]), int(lengths[yg])
        if m < 1 or n < 1:
            raise ValueError(f"pair {p} has an empty sequence")
        nb = -(-m // rb)
        s = (min(rb, m) + n - 1) // snap_k + 1
        params[p] = [m, n, xg, yg, nb, s, snap_off, rows_off, moves_off]
        snap_off += nb * s * 3 * (rb + 1)
        rows_off += (nb - 1) * n
        moves_off += -(-(m + n) // 16)
    return Plan(params, rb, snap_k, rows_off, snap_off, moves_off)


def gene_table(genes: Sequence[str]) -> np.ndarray:
    """(k, max length) uint8 codes, one row per sequence, zero padded."""
    width = max(1, max(len(g) for g in genes))
    table = np.zeros((len(genes), width), np.uint8)
    for g, seq in enumerate(genes):
        table[g, : len(seq)] = np.frombuffer(seq.encode("latin-1"), np.uint8)
    return table


def band_fill(table: torch.Tensor, plan: Plan, pxy: int, pgap: int) -> FillState:
    """Fill every pair of ``plan``; on the card through the CUDA kernel."""
    if table.dtype != torch.uint8 or table.dim() != 2:
        raise ValueError("gene table must be a 2-D uint8 tensor")
    if table.device.type == "cpu":
        return band_fill_ref(table, plan, pxy, pgap)
    if table.device.type != "cuda":
        raise ValueError(f"band_fill runs on cuda or cpu, not {table.device}")
    if plan.rb > MAX_RB:
        raise ValueError(f"the fill kernel takes rb <= {MAX_RB}, got {plan.rb}")
    from msa_tpu_torch.ops import _build

    lib = _build.load("band_fill")
    table = table.contiguous()
    dev = table.device
    params = torch.from_numpy(plan.params).to(dev)
    out = FillState(
        score=torch.zeros(plan.num_pairs, dtype=torch.int32, device=dev),
        rows=torch.zeros(max(plan.rows_len, 1), dtype=torch.int32, device=dev),
        snaps=torch.zeros(plan.snaps_len, dtype=torch.int32, device=dev),
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.band_fill(
        table.data_ptr(), table.stride(0), params.data_ptr(), plan.num_pairs,
        plan.rb, plan.snap_k, pxy, pgap, out.score.data_ptr(),
        out.rows.data_ptr(), out.snaps.data_ptr(), ctypes.c_void_p(stream),
    )
    _build.check("band_fill", err)
    band_fill.launches += 1
    band_fill.pairs += plan.num_pairs
    return out


band_fill.launches = 0  # kernel launches (plain-version runs not counted)
band_fill.pairs = 0  # pairs those launches filled


def band_fill_ref(table: torch.Tensor, plan: Plan, pxy: int, pgap: int) -> FillState:
    """Plain PyTorch fill: one Python step per diagonal, same outputs."""
    dev = table.device
    rb, K = plan.rb, plan.snap_k
    lanes = rb + 1
    i32 = dict(dtype=torch.int32, device=dev)
    score = torch.zeros(plan.num_pairs, **i32)
    rows = torch.zeros(max(plan.rows_len, 1), **i32)
    snaps = torch.zeros(plan.snaps_len, **i32)
    neg = torch.full((1,), NEG_FILL, **i32)
    for p, prm in enumerate(plan.params.tolist()):
        m, n, xg, yg, nb, S, snap_off, rows_off, _ = prm
        x = table[xg, :m].to(torch.int32)
        y = table[yg, :n].to(torch.int32)
        for b in range(nb):
            i0 = b * rb
            nrows = min(rb, m - i0)
            steps = nrows + n
            xv = torch.full((lanes,), X_SENTINEL, **i32)
            xv[1 : nrows + 1] = x[i0 : i0 + nrows]
            yfeed = torch.full((steps,), Y_SENTINEL, **i32)
            yfeed[:n] = y
            tfeed = torch.full((steps,), NEG_FILL, **i32)
            if b == 0:
                tfeed[:n] = torch.arange(1, n + 1, **i32) * pgap
            else:
                tfeed[:n] = rows[rows_off + (b - 1) * n : rows_off + b * n]
            bottom = torch.zeros(n, **i32)

            p1 = torch.full((lanes,), NEG_FILL, **i32)
            p1[0] = i0 * pgap
            p1s = torch.cat([neg, p1[:-1]])
            p2s = torch.full((lanes,), NEG_FILL, **i32)
            yd = torch.full((lanes,), Y_SENTINEL, **i32)
            snap_b = snap_off + b * S * 3 * lanes

            def snapshot(s):
                base = snap_b + s * 3 * lanes
                snaps[base : base + 3 * lanes] = torch.cat([p1, p1s, p2s])

            snapshot(0)
            for dl in range(1, steps + 1):
                yd = torch.cat([yfeed[dl - 1 : dl], yd[:-1]])
                t1 = p2s + torch.where(xv == yd, 0, pxy).to(torch.int32)
                cur = torch.minimum(t1, torch.minimum(p1, p1s) + pgap)
                cur[0] = tfeed[dl - 1]
                if dl < lanes:
                    cur[dl] = (i0 + dl) * pgap
                if b < nb - 1 and dl > rb:
                    bottom[dl - rb - 1] = cur[rb]
                if b == nb - 1 and dl == steps:
                    score[p] = cur[nrows]
                p2s, p1s, p1 = p1s, torch.cat([neg, cur[:-1]]), cur
                if dl % K == 0 and dl < steps:
                    snapshot(dl // K)
            if b < nb - 1:
                rows[rows_off + b * n : rows_off + (b + 1) * n] = bottom
    return FillState(score, rows, snaps)
