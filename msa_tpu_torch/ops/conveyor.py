"""Conveyor fill: the bands of many pairs staggered through concurrent
sweeps, each pair's bands chained across sweeps.

Port of ``msa_tpu/ops/conveyor.py``. A sweep is one band-wide lane space
(rb + 1 lanes, lane q = row i0 + q of the band that owns it) advanced one
anti-diagonal per global step t. Every band placed on a sweep enters it at a
K-aligned start and rides it with band-local diagonal dl = t - start: a new
band's ramp front climbs one lane per step just behind the previous band's
draining cells, so no lane idles through a ramp. Band b + 1 of a pair reads
band b's bottom row (harvested from lane rb into the ``brow`` table) as its
top row, and one snapshot of the whole lane space every K steps serves the
traceback of every band resident at that step.

Host planner (copied, the JAX module imports jax at the top): ``BandPlan``,
``ConveyorPlan``, ``plan_conveyor`` and ``plan_workload``; the
device-memory budget is ``band_fill.py::device_budget``, which both
pipelines share. The JAX package ran one sweep a TPU core; here the sweeps
are thread blocks, and ``plan_conveyor`` places bands, not pairs: each
band goes to the sweep where it can start earliest, behind its producer
(band b - 1, on any sweep) by the JAX planner's rb + 2K, so a pair's bands
run side by side on several SMs. With one sweep the band starts, brow
slots, orientation and ``pair_ready`` are the JAX ones. Dropped, because
only the TPU needs them:

- the 4-band cap per pair: the Pallas walk's params held 4 bands in cols
  8..15; the port's walk reads a band table of any length, and rb 7168 needs
  up to 14 bands for 100k-character sequences;
- ``CHUNK_PAD`` and the round-up of ``n_chunks`` to 8, which served Mosaic's
  compile reuse and its (8, 128) SMEM blocks: here a sweep's chunks cover
  its steps and no more;
- the lane padding to a (R, 128) tile (v_len): a sweep has rb + 1 lanes;
  ``ymax`` (a brow row's length) is the longest y + 1, and brow has no trash
  row (the kernel harvests only the band that owns lane rb).

Layout of a workload's fill state (``ConveyorState``), all int32:

- ``score[g]``: dp[m][n] of the pair in conveyor slot g;
- ``brow``: slot s (one a band, global over the sweeps), column j at
  ``s * ymax + j``; slot 0 (the analytic row j * pgap) is computed, not
  stored;
- ``snaps``: chunk c of sweep w at ``snap_off + (c - first) * 3 * (rb +
  1)``, from the chunk of its first band (``Workload.snap_base``): the
  state (p1, p1s, p2s) after global step c * K, the state a band with
  start <= c * K enters its local step c * K - start + 1 with; the walk
  reads band segment s at chunk start / K + s of the band's sweep;
- ``carry``: (x, yd, p1, p1s, p2s) of each sweep's lanes after the last
  launch, read by the next (the fill runs in segments), and ``progress``,
  the global steps each sweep has finished, which the kernel's consumers
  wait on.

``conveyor_fill`` launches ``csrc/conveyor_fill.cu`` for CUDA tensors and
runs ``conveyor_fill_ref`` for CPU tensors; any other device raises.
``align_pairs_conveyor`` is the driver: segmented fill, walks released as
pairs finish, threaded host decode, and the device-memory split.
"""

from __future__ import annotations

import ctypes
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from msa_tpu_torch.utils.alignment import moves_to_alignment
from msa_tpu_torch.config import MAX_RB, TorchConfig
from msa_tpu_torch.ops.band_fill import (
    NEG_FILL,
    X_SENTINEL,
    Y_SENTINEL,
    device_budget,
    gene_table,
    to_card,
)
from msa_tpu_torch.ops.walk import make_walk_plan, pair_moves, walk

# Columns of the sweep, band and event tables (csrc/conveyor_fill.cu keeps
# the same order).
S_BAND_LO, S_BAND_HI, S_EV_LO, S_EV_HI, S_FIRST, S_CHUNKS, S_SNAP_OFF = range(7)
SCOL = 7
C_START, C_I0, C_ROWS, C_N, C_XG, C_YG, C_BROW_IN, C_BROW_OUT, C_PSWEEP, C_PSTART = range(10)
CCOL = 10
E_T, E_Q, E_PAIR = range(3)
ECOL = 3
# SMs the default sweep count (conveyors = 0) leaves to the walks, so the
# walk of a segment's finished pairs runs beside the next fill segment
# rather than after it. On an H100 big13 end to end was faster with 100
# sweeps than with all 132, though its fill alone was slower
# (chip_smoke.py's big13_conveyor_sweeps, PERF.md).
WALK_SMS = 32


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass
class BandPlan:
    pair_slot: int  # pair index in conveyor order
    band: int  # band index within the pair
    i0: int  # first row of the band (band * rb)
    n: int  # y length of the pair
    xi: int  # gene index of x
    yi: int  # gene index of y
    start: int  # global step at which local dl = 0 (K-aligned)
    brow_out: int  # brow slot receiving this band's bottom boundary row
    brow_in: int  # brow slot feeding this band's top (0 = analytic)
    is_last: bool  # last band of its pair (emits the score event)
    q_last: int  # rows in the last band (score lane)
    sweep: int = 0  # the sweep the band rides


@dataclasses.dataclass
class ConveyorPlan:
    bands: List[BandPlan]  # in placement order: pair by pair, band by band
    n_chunks: int  # chunks until the last sweep ends
    rb: int
    snap_k: int
    ymax: int  # brow row length: columns 0 .. longest n
    n_slots: int  # brow slots incl. the analytic slot 0
    # Per pair slot: first chunk index at which every snapshot, boundary row
    # and score event the pair's walk reads has been written.
    pair_ready: List[int] = dataclasses.field(default_factory=list)
    # Per sweep: the chunk of its first band's start, and its end.
    sweep_first: List[int] = dataclasses.field(default_factory=list)
    sweep_chunks: List[int] = dataclasses.field(default_factory=list)


def check_geometry(rb: int, snap_k: int) -> None:
    if snap_k < 1 or rb < snap_k or rb % snap_k:
        raise ValueError(f"rb_conveyor {rb} must be a positive multiple of snap_k {snap_k}")
    if rb > MAX_RB:
        raise ValueError(f"rb_conveyor + 1 = {rb + 1} lanes do not fit one block ({MAX_RB + 1})")


def plan_conveyor(
    genes: Sequence[str], pairs: Sequence[Tuple[int, int]], rb: int, snap_k: int,
    sweeps: int = 1,
) -> ConveyorPlan:
    """K-aligned band schedule over ``sweeps`` concurrent sweeps (deterministic).

    Bands are taken in order (pair, band), and each goes to the sweep where
    it can start earliest (ties: the sweep that idles least before it, then
    the lowest), under two rules:

    - after the sweep's previous band, >= max(prev_n + K, rb + K) steps:
      regions stay disjoint (lane q frees at prev dl = q + n, K steps before
      the ramp front reaches it) and at most one band ramps;
    - after its producer (band b - 1 of the pair, on any sweep), >= rb + 2K:
      the bottom row is harvested (rb steps) at least K steps before the
      successor's top lane reads it.

    A pair's last band is deferred by K until its score event's chunk holds
    no other event of its sweep (the JAX chunk table's rule). With one sweep
    the producer is the previous band and the plan is the JAX planner's.
    Sweeps fill in order, so the sweeps that hold bands are the first ones.
    """
    K = snap_k
    bands: List[BandPlan] = []
    free_at = np.zeros(max(1, sweeps), np.int64)  # earliest next start on each sweep
    last: List[Optional[BandPlan]] = [None] * len(free_at)
    ev_chunks: List[set] = [set() for _ in free_at]
    slot = 1  # 0 = analytic row
    max_n = 0
    for pslot, (xi, yi) in enumerate(pairs):
        m, n = len(genes[xi]), len(genes[yi])
        nb = max(1, -(-m // rb))
        q_last = m - (nb - 1) * rb
        max_n = max(max_n, n)
        pred: Optional[BandPlan] = None
        for b in range(nb):
            cand = np.maximum(free_at, pred.start + rb + 2 * K if pred else 0)
            # The earliest start; among those, the sweep that idles least
            # before it (the latest free), then the lowest.
            ties = np.flatnonzero(cand == cand.min())
            w = int(ties[np.argmax(free_at[ties])])
            start = int(cand[w])
            if b == nb - 1:
                if (start + q_last + n) // K in ev_chunks[w]:
                    best = None
                    for w in np.lexsort((np.arange(len(cand)), -free_at, cand)).tolist():
                        if best is not None and cand[w] > best[0]:
                            break
                        start = int(cand[w])
                        while (start + q_last + n) // K in ev_chunks[w]:
                            start += K
                        best = min(best or (start, -int(free_at[w]), w), (start, -int(free_at[w]), w))
                    start, w = best[0], best[2]
                ev_chunks[w].add((start + q_last + n) // K)
            prev = last[w]
            # The lanes of the previous band must all be done before this
            # band's ramp front reaches them (conveyor_fill.cu relies on it).
            assert prev is None or start - prev.start >= prev.n + K
            bp = BandPlan(
                pair_slot=pslot, band=b, i0=b * rb, n=n, xi=xi, yi=yi,
                start=start, brow_out=slot, brow_in=pred.brow_out if pred else 0,
                is_last=(b == nb - 1), q_last=q_last, sweep=w,
            )
            bands.append(bp)
            last[w] = pred = bp
            free_at[w] = start + _round_up(max(n + K, rb + K), K)
            slot += 1
    used = [bp for bp in last if bp is not None]
    first = [-1] * len(used)
    for bp in bands:
        if first[bp.sweep] < 0:
            first[bp.sweep] = bp.start // K
    # A sweep ends when its last band has drained; every earlier band of it
    # has been harvested by then (its start + n + K <= the next start).
    chunks = [-(-(bp.start + rb + bp.n + 2) // K) for bp in used]
    pair_ready = [0] * len(pairs)
    for bp in bands:
        # Last chunk the band touches: its highest-dl snapshot, bottom row
        # and score event all land by (start + rb + n) // K; +2 margin, as
        # in the JAX planner.
        pair_ready[bp.pair_slot] = max(
            pair_ready[bp.pair_slot], min((bp.start + rb + bp.n) // K + 2, chunks[bp.sweep])
        )
    return ConveyorPlan(
        bands=bands, n_chunks=max(chunks), rb=rb, snap_k=K, ymax=max_n + 1,
        n_slots=slot, pair_ready=pair_ready, sweep_first=first, sweep_chunks=chunks,
    )


def _orient(genes: Sequence[str], i: int, j: int, rb: int, snap_k: int):
    """(cost, swap, x gene, y gene) of the cheaper orientation of a pair.

    A band of x-length m, y-length n occupies the sweep for about
    max(n, rb) + K steps, so a pair costs ceil(m / rb) * (max(n, rb) + K)
    steps of rb lanes; the partial last band wastes lanes for its whole
    residency, which the transpose can cut. Transposed pairs walk with the
    swap tie-break, so their alignments, swapped back, are exact.
    """
    cands = []
    for xi, yi, sw in ((i, j, 0), (j, i, 1)):
        mm, nn = len(genes[xi]), len(genes[yi])
        nb = max(1, -(-mm // rb))
        cands.append((nb * (max(nn, rb) + snap_k), sw, xi, yi))
    return min(cands)


def _size_order(genes: Sequence[str], pairs: Sequence[Tuple[int, int]]) -> List[int]:
    return sorted(
        range(len(pairs)),
        key=lambda idx: -(len(genes[pairs[idx][0]]) + len(genes[pairs[idx][1]])),
    )


def plan_workload(
    genes: Sequence[str], pairs: Sequence[Tuple[int, int]], rb: int, snap_k: int,
    sweeps: int = 1,
):
    """The band schedule of a workload: ``(order, ordered, swapped, plan)``.

    ``order[r]`` is the caller index of the r-th pair in size-descending
    conveyor order; ``ordered[r]`` its (x gene, y gene) after orientation;
    ``swapped[r]`` whether it was transposed; ``plan`` the band schedule
    over ``sweeps`` sweeps.
    """
    order = _size_order(genes, pairs)
    oriented = [_orient(genes, *pairs[idx], rb, snap_k) for idx in order]
    ordered = [(xi, yi) for _, _, xi, yi in oriented]
    swapped = [sw for _, sw, _, _ in oriented]
    return order, ordered, swapped, plan_conveyor(genes, ordered, rb, snap_k, sweeps)


@dataclasses.dataclass
class Workload:
    """A workload's band schedule and the tables the fill kernel reads.

    Conveyor slot g is the caller's pair ``order[g]``, oriented as
    ``ordered[g]``. Sweep w's bands are rows ``sweep_table[w, S_BAND_LO]``
    .. ``S_BAND_HI`` of ``band_table`` (by start), its score events rows
    ``S_EV_LO`` .. ``S_EV_HI`` of ``event_table`` (by step, at most one a
    chunk), its snapshot of chunk c at ``snap_off + (c - first) * 3 *
    (rb + 1)``.
    """

    order: List[int]
    ordered: List[Tuple[int, int]]
    swapped: List[int]
    plan: ConveyorPlan
    sweep_table: np.ndarray  # (W, SCOL) int64
    band_table: np.ndarray  # (bands, CCOL) int64
    event_table: np.ndarray  # (pairs, ECOL) int64
    rb: int
    snap_k: int
    ymax: int
    snaps_len: int
    brow_len: int

    @property
    def num_pairs(self) -> int:
        return len(self.order)

    @property
    def num_sweeps(self) -> int:
        return int(self.sweep_table.shape[0])

    @property
    def max_chunks(self) -> int:
        return self.plan.n_chunks

    @property
    def snapshot_bytes(self) -> int:
        return 4 * self.snaps_len

    def pair_ready(self, g: int) -> int:
        return self.plan.pair_ready[g]

    def snap_base(self, bp: BandPlan) -> int:
        """Offset in ``snaps`` of the snapshot taken at band ``bp``'s start."""
        first, snap_off = self.sweep_table[bp.sweep, [S_FIRST, S_SNAP_OFF]].tolist()
        return snap_off + (bp.start // self.snap_k - first) * 3 * (self.rb + 1)


def plan_sweeps(
    genes: Sequence[str], pairs: Sequence[Tuple[int, int]], rb: int, snap_k: int,
    conveyors: int,
) -> Workload:
    """Place the pairs' bands on at most ``conveyors`` sweeps; the tables."""
    check_geometry(rb, snap_k)
    order, ordered, swapped, plan = plan_workload(genes, pairs, rb, snap_k, max(1, conveyors))
    lanes = rb + 1
    sweep_rows, band_rows, event_rows = [], [], []
    snap_off = 0
    producer = {bp.brow_out: bp for bp in plan.bands}
    by_sweep: List[List[BandPlan]] = [[] for _ in plan.sweep_first]
    for bp in plan.bands:
        by_sweep[bp.sweep].append(bp)  # by start
    for w, (first, chunks) in enumerate(zip(plan.sweep_first, plan.sweep_chunks)):
        mine = by_sweep[w]
        events = sorted(
            (bp.start + bp.q_last + bp.n, bp.q_last, bp.pair_slot) for bp in mine if bp.is_last
        )
        sweep_rows.append([
            len(band_rows), len(band_rows) + len(mine), len(event_rows),
            len(event_rows) + len(events), first, chunks, snap_off,
        ])
        for bp in mine:
            pred = producer.get(bp.brow_in)
            band_rows.append([
                bp.start, bp.i0, min(rb, len(genes[bp.xi]) - bp.i0), bp.n, bp.xi, bp.yi,
                bp.brow_in, bp.brow_out, pred.sweep if pred else -1, pred.start if pred else 0,
            ])
        event_rows += events
        snap_off += (chunks - first) * 3 * lanes
    return Workload(
        order=order, ordered=ordered, swapped=swapped, plan=plan,
        sweep_table=np.array(sweep_rows, np.int64).reshape(-1, SCOL),
        band_table=np.array(band_rows, np.int64).reshape(-1, CCOL),
        event_table=np.array(event_rows, np.int64).reshape(-1, ECOL),
        rb=rb, snap_k=snap_k, ymax=plan.ymax, snaps_len=snap_off,
        brow_len=plan.n_slots * plan.ymax,
    )


def conveyor_walk_plan(wl: Workload, genes: Sequence[str], slots: Sequence[int]):
    """The walk's view of the conveyor's output for conveyor slots ``slots``."""
    by_pair: List[List[BandPlan]] = [[] for _ in range(wl.num_pairs)]
    for bp in wl.plan.bands:
        by_pair[bp.pair_slot].append(bp)
    pairs = []
    for g in slots:
        bands = [(wl.snap_base(bp), bp.brow_in * wl.ymax) for bp in by_pair[g]]
        xi, yi = wl.ordered[g]
        pairs.append((len(genes[xi]), len(genes[yi]), xi, yi, wl.swapped[g], bands))
    return make_walk_plan(pairs, wl.rb, wl.snap_k)


@dataclasses.dataclass
class ConveyorState:
    """The conveyor fill's outputs and carry, flat, laid out by a Workload."""

    score: torch.Tensor  # (pairs,) int32, by conveyor slot
    brow: torch.Tensor  # (brow_len,) int32
    snaps: torch.Tensor  # (snaps_len,) int32
    carry: torch.Tensor  # (W * 5 * (rb + 1),) int32
    progress: torch.Tensor  # (W,) int32: global steps each sweep has finished


def conveyor_state(wl: Workload, device: torch.device) -> ConveyorState:
    i32 = dict(dtype=torch.int32, device=device)
    return ConveyorState(
        score=torch.zeros(wl.num_pairs, **i32),
        brow=torch.zeros(max(wl.brow_len, 1), **i32),
        snaps=torch.zeros(wl.snaps_len, **i32),
        carry=torch.zeros(wl.num_sweeps * 5 * (wl.rb + 1), **i32),
        progress=torch.zeros(wl.num_sweeps, **i32),
    )


def resident_sweeps(rb: int, snap_k: int, device: torch.device) -> Optional[int]:
    """Sweeps the fill kernel can hold resident at once on ``device`` (one
    block each); None on the CPU, where the plain version takes any count."""
    if device.type != "cuda":
        return None
    from msa_tpu_torch.ops import _build

    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check("conveyor_fill_resident",
                     _build.load("conveyor_fill").conveyor_fill_resident(rb, snap_k, ctypes.byref(blocks)))
    return blocks.value


def conveyor_fill(
    table: torch.Tensor, wl: Workload, pxy: int, pgap: int, c0: int, c1: int,
    state: ConveyorState,
) -> ConveyorState:
    """Advance every sweep through chunks [c0, c1); updates ``state`` in place.

    Segments must run in order from c0 = 0; on the card through the kernel,
    which raises when the sweeps do not all fit at once.
    """
    if table.dtype != torch.uint8 or table.dim() != 2:
        raise ValueError("gene table must be a 2-D uint8 tensor")
    check_geometry(wl.rb, wl.snap_k)
    if table.device.type == "cpu":
        return conveyor_fill_ref(table, wl, pxy, pgap, c0, c1, state)
    if table.device.type != "cuda":
        raise ValueError(f"conveyor_fill runs on cuda or cpu, not {table.device}")
    from msa_tpu_torch.ops import _build

    dev = table.device
    for t in (state.score, state.brow, state.snaps, state.carry, state.progress):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("conveyor state must be contiguous int32 on the table's device")
    resident = resident_sweeps(wl.rb, wl.snap_k, dev)
    if wl.num_sweeps > resident:
        raise ValueError(
            f"{wl.num_sweeps} conveyor sweeps do not fit the card at once ({resident} "
            f"resident blocks at rb {wl.rb}); the sweeps wait on each other, so all must"
        )
    lib = _build.load("conveyor_fill")
    table = table.contiguous()
    sweeps, bands, events = (
        to_card(t, dev) for t in (wl.sweep_table, wl.band_table, wl.event_table)
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.conveyor_fill(
        table.data_ptr(), table.stride(0), sweeps.data_ptr(), bands.data_ptr(),
        events.data_ptr(), wl.num_sweeps, wl.rb, wl.snap_k, wl.ymax, pxy, pgap,
        c0, c1, state.score.data_ptr(), state.brow.data_ptr(),
        state.snaps.data_ptr(), state.carry.data_ptr(), state.progress.data_ptr(),
        ctypes.c_void_p(stream),
    )
    _build.check("conveyor_fill", err)
    _build.count(conveyor_fill, wl.num_pairs if c0 == 0 else 0)
    return state


conveyor_fill.launches = 0  # kernel launches (plain-version runs not counted)
conveyor_fill.pairs = 0  # pairs of the workloads those launches began


class _RefSweep:
    """One sweep of ``conveyor_fill_ref``: its lanes, cursors and y stream."""

    def __init__(self, table, wl: Workload, w: int, c0: int, c1: int, state: ConveyorState):
        b_lo, b_hi, e_lo, e_hi, first, chunks, snap_off = wl.sweep_table[w].tolist()
        K, lanes = wl.snap_k, wl.rb + 1
        self.t0, self.t1 = max(c0, first) * K, min(c1, chunks) * K
        self.first, self.snap_off = first, snap_off
        self.bands = wl.band_table[b_lo:b_hi].tolist()
        self.events = wl.event_table[e_lo:e_hi].tolist()
        self.carry = state.carry[w * 5 * lanes : (w + 1) * 5 * lanes].view(5, lanes)
        i32 = dict(dtype=torch.int32, device=table.device)
        self.neg = torch.full((1,), NEG_FILL, **i32)
        # Lane q at step t holds the y code Y[t - q - 1]: the stream
        # reversed, rev[T - t + q] with ystream[lanes + g] = Y[g].
        self.T = chunks * K
        ystream = torch.full((self.T + lanes,), Y_SENTINEL, **i32)
        for start, _, _, n, _, yg, *_ in self.bands:
            ystream[lanes + start : lanes + start + n] = table[yg, :n]
        self.rev = ystream.flip(0)
        if self.t0 == first * K:
            self.xv = torch.full((lanes,), X_SENTINEL, **i32)
            self.p1 = torch.full((lanes,), NEG_FILL, **i32)
            self.prev = torch.full((lanes,), NEG_FILL, **i32)
        else:
            self.xv, self.p1 = self.carry[0].clone(), self.carry[2].clone()
            self.prev = torch.cat([self.carry[4][1:], self.neg])
        self.top = self.bot = -1
        self.ev = next((e for e, (t, _, _) in enumerate(self.events) if t >= self.t0),
                       len(self.events))

    def shift(self, v):
        return torch.cat([self.neg, v[:-1]])

    def step(self, table, wl: Workload, pxy: int, pgap: int, t: int, state: ConveyorState):
        rb, K, ymax, lanes = wl.rb, wl.snap_k, wl.ymax, wl.rb + 1
        bands = self.bands
        while self.top + 1 < len(bands) and bands[self.top + 1][C_START] <= t:
            self.top += 1
        while self.bot + 1 < len(bands) and bands[self.bot + 1][C_START] + rb <= t:
            self.bot += 1
        start, i0, rows, n, xg, _, brow_in, *_ = bands[self.top]
        dl = t - start
        if dl <= rb:  # the ramp: lane dl takes its x code
            if 1 <= dl <= rows:
                self.xv[dl : dl + 1] = table[xg, i0 + dl - 1 : i0 + dl]
            else:
                self.xv[dl] = X_SENTINEL
        yd = self.rev[self.T - t : self.T - t + lanes]
        sub = (self.xv != yd).to(torch.int32) * pxy
        p1, prev = self.p1, self.prev
        cur = torch.empty_like(p1)
        cur[1:] = torch.minimum(prev[:-1] + sub[1:], torch.minimum(p1[1:], p1[:-1]) + pgap)
        if dl > n:
            cur[0] = NEG_FILL
        elif brow_in:  # the producer's row, harvested on whichever sweep
            row = brow_in * ymax + dl
            cur[0:1] = state.brow[row : row + 1]
        else:
            cur[0] = dl * pgap
        if dl <= rb:
            cur[dl] = (i0 + dl) * pgap
        if self.bot >= 0:
            b_start, _, _, b_n, _, _, _, brow_out, *_ = bands[self.bot]
            h = t - b_start - rb
            if h <= b_n:
                row = brow_out * ymax + h
                state.brow[row : row + 1] = cur[rb : rb + 1]
        if self.ev < len(self.events) and self.events[self.ev][E_T] == t:
            _, q, g = self.events[self.ev]
            state.score[g : g + 1] = cur[q : q + 1]
            self.ev += 1
        self.prev, self.p1 = p1, cur
        if t % K == 0:
            base = self.snap_off + (t // K - self.first) * 3 * lanes
            state.snaps[base : base + 3 * lanes] = torch.cat(
                [cur, self.shift(cur), self.shift(p1)])

    def store(self):
        lanes = self.carry.shape[1]
        self.carry[0] = self.xv
        self.carry[1] = self.rev[self.T - self.t1 + 1 : self.T - self.t1 + 1 + lanes]
        self.carry[2] = self.p1
        self.carry[3] = self.shift(self.p1)
        self.carry[4] = self.shift(self.prev)


def conveyor_fill_ref(
    table: torch.Tensor, wl: Workload, pxy: int, pgap: int, c0: int, c1: int,
    state: ConveyorState,
) -> ConveyorState:
    """Plain PyTorch fill: one Python step per sweep and global step, same
    outputs as the kernel.

    All sweeps advance in global step order, so a band reads its producer's
    row, harvested on another sweep, when the kernel reads it: after the
    harvest (the planner's stagger). ``progress`` is the kernel's alone.
    """
    live = [_RefSweep(table, wl, w, c0, c1, state) for w in range(wl.num_sweeps)]
    live = [sw for sw in live if sw.t0 < sw.t1]
    if not live:
        return state
    for t in range(min(sw.t0 for sw in live), max(sw.t1 for sw in live)):
        for sw in live:
            if sw.t0 <= t < sw.t1:
                sw.step(table, wl, pxy, pgap, t, state)
    for sw in live:
        sw.store()
    return state


def sweep_count(conveyors: int, resident: Optional[int], free: int = 0) -> int:
    """Concurrent sweeps of a conveyor workload: ``conveyors``, 0 meaning as
    many as are resident less ``free`` (blocks left to the walks), never
    more than ``resident`` (the card's count, ``resident_sweeps``). Without
    a card (None) there is no cap, and 0 means one sweep."""
    if resident is None:
        return max(1, conveyors)
    return max(1, resident - free) if conveyors <= 0 else min(conveyors, resident)


def conveyor_sweeps(config: TorchConfig, device: torch.device) -> int:
    """``sweep_count`` of ``config`` on ``device``: at 0, the sweeps of
    ``WALK_SMS`` SMs are left to the walks."""
    resident = resident_sweeps(config.rb_conveyor, config.snap_k, device)
    free = 0
    if resident is not None:
        per_sm = resident // torch.cuda.get_device_properties(device).multi_processor_count
        free = WALK_SMS * per_sm
    return sweep_count(config.conveyors, resident, free)


def align_pairs_conveyor(
    genes: Sequence[str],
    pairs: Sequence[Tuple[int, int]],
    pxy: int,
    pgap: int,
    *,
    device: torch.device,
    config: TorchConfig,
    on_result: Optional[Callable[[int, Tuple[int, str, str]], None]] = None,
) -> List[Tuple[int, str, str]]:
    """(penalty, align1, align2) for each (x gene, y gene) pair, in order.

    The fill runs as ``config.fill_segments`` launches over global chunk
    ranges; after each, one walk launch traces the pairs whose
    ``pair_ready`` chunk the fill has passed, and the host decodes them on
    ``config.decode_workers`` threads while the next segment fills.
    Workloads whose snapshots exceed ``device_budget`` are split in
    two halves (recursively). ``on_result(idx, triple)`` fires once per pair
    as its decode finishes, from a decode thread, so a journal keeps every
    pair decoded before a failure.
    """
    num = len(pairs)
    if not num:
        return []
    rb, K = config.rb_conveyor, config.snap_k
    wl = plan_sweeps(genes, pairs, rb, K, conveyor_sweeps(config, device))

    budget = device_budget(device, config.hbm_budget)
    if wl.snapshot_bytes > budget:
        if num < 2:
            raise ValueError(
                f"conveyor snapshots need {wl.snapshot_bytes / 2**30:.1f} GiB "
                f"({wl.max_chunks} chunks x 3 x {rb + 1} lanes at snap_k={K}) "
                f"for a single pair, over the {budget / 2**30:.1f} GiB budget"
            )
        # Alternate the size-sorted pairs so both halves hold about half.
        size_order = _size_order(genes, pairs)
        out_split: List[Tuple[int, str, str]] = [None] * num  # type: ignore
        for idxs in (size_order[0::2], size_order[1::2]):
            sub_result = None
            if on_result is not None:
                def sub_result(si, triple, idxs=idxs):
                    on_result(idxs[si], triple)
            sub = align_pairs_conveyor(
                genes, [pairs[i] for i in idxs], pxy, pgap, device=device, config=config,
                on_result=sub_result,
            )
            for si, i in enumerate(idxs):
                out_split[i] = sub[si]
        return out_split

    table = torch.from_numpy(gene_table(genes)).to(device)
    state = conveyor_state(wl, device)
    segs = max(1, config.fill_segments)
    n_seg = -(-wl.max_chunks // segs)
    ready = sorted(range(num), key=wl.pair_ready)
    on_card = device.type == "cuda"
    # On the card the walks run on a stream of their own, each after the
    # fill segment that finished its pairs: a sweep is one block, so the
    # walks take the SMs the sweeps leave free while the next segment fills.
    fill_stream = torch.cuda.current_stream(device) if on_card else None
    walk_stream = torch.cuda.Stream(device) if on_card else None

    def launch_walk(slots):
        wplan = conveyor_walk_plan(wl, genes, slots)
        if not on_card:
            return slots, wplan, (*walk(table, wplan, state.brow, state.snaps, pxy, pgap), state.score), None
        walk_stream.wait_stream(fill_stream)
        with torch.cuda.stream(walk_stream):
            words, counts = walk(table, wplan, state.brow, state.snaps, pxy, pgap)
            fetched = [t.to("cpu", non_blocking=True) for t in (words, counts, state.score)]
            done = torch.cuda.Event()
            done.record()
        return slots, wplan, fetched, done

    def decode(g, words, counts, wplan, p, score):
        xi, yi = wl.ordered[g]
        ax, ay = moves_to_alignment(genes[xi], genes[yi], pair_moves(words, counts, wplan, p))
        if wl.swapped[g]:  # a1 is always the alignment of genes[pairs[idx][0]]
            ax, ay = ay, ax
        triple = (int(score), ax, ay)
        if on_result is not None:
            on_result(wl.order[g], triple)
        return triple

    out: List[Tuple[int, str, str]] = [None] * num  # type: ignore
    futures = []
    with ThreadPoolExecutor(max_workers=max(1, config.decode_workers)) as pool:

        def collect(launched):
            slots, wplan, fetched, done = launched
            if done is not None:
                done.synchronize()  # this walk's output only, not the fill
            words, counts, scores = (t.numpy() for t in fetched)
            for p, g in enumerate(slots):
                futures.append((g, pool.submit(decode, g, words, counts, wplan, p, scores[g])))

        pending = None
        taken = 0
        for c0 in range(0, wl.max_chunks, n_seg):
            c1 = min(c0 + n_seg, wl.max_chunks)
            conveyor_fill(table, wl, pxy, pgap, c0, c1, state)
            # The previous segment's walk runs beside this segment's fill;
            # its pairs go to the decoders before the next walk is launched,
            # so a failing launch loses none of them.
            if pending is not None:
                collect(pending)
                pending = None
            first = taken
            while taken < num and (wl.pair_ready(ready[taken]) <= c1 or c1 == wl.max_chunks):
                taken += 1
            if taken > first:
                pending = launch_walk(ready[first:taken])
        if pending is not None:
            collect(pending)
        for g, fut in futures:
            out[wl.order[g]] = fut.result()
    return out
