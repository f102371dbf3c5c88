"""Conveyor fill: the bands of many pairs staggered through one sweep.

Port of ``msa_tpu/ops/conveyor.py``. A sweep is one band-wide lane space
(rb + 1 lanes, lane q = row i0 + q of the band that owns it) advanced one
anti-diagonal per global step t. Every band of every pair in the sweep
enters it at a K-aligned start and rides it with band-local diagonal
dl = t - start: a new band's ramp front climbs one lane per step just behind
the previous band's draining cells, so no lane idles through a ramp. Band
b + 1 of a pair reads band b's bottom row (harvested from lane rb into the
``brow`` table) as its top row, and one snapshot of the whole lane space
every K steps serves the traceback of every band resident at that step.

Host planner (copied, the JAX module imports jax at the top): ``BandPlan``,
``ConveyorPlan``, ``plan_conveyor``, ``plan_workload`` and
``plan_snapshot_bytes``; the device-memory budget is
``band_fill.py::device_budget``, which both pipelines share. The stagger
rules and the score-event deferral are kept verbatim, so for a workload the
JAX planner accepts, the band starts, brow slots, orientation and
``pair_ready`` are the JAX ones. Dropped, because only the TPU needs them:

- the 4-band cap per pair: the Pallas walk's params held 4 bands in cols
  8..15; the port's walk reads a band table of any length, and rb 7168 needs
  up to 14 bands for 100k-character sequences;
- ``CHUNK_PAD`` and the round-up of ``n_chunks`` to 8, which served Mosaic's
  compile reuse and its (8, 128) SMEM blocks: here ``n_chunks`` covers the
  sweep's steps and no more;
- the lane padding to a (R, 128) tile (v_len): a sweep has rb + 1 lanes;
  ``ymax`` (a brow row's length) is the longest y + 1, and brow has no trash
  row (the kernel harvests only the band that owns lane rb).

Added: ``plan_sweeps`` splits the device pairs over ``conveyors`` concurrent
sweeps, one thread block each (the JAX package ran one sweep per TPU and an
LPT split over devices, ``msa_tpu/models/kway.py:220-287``), by LPT on the
planner's own cost nb * (max(n, rb) + K). With one sweep the plan is JAX's.

Layout of a workload's fill state (``ConveyorState``), all int32, sweep w at
its offsets in the sweep table:

- ``score[g]``: dp[m][n] of the pair in conveyor slot g;
- ``brow``: slot s of sweep w, column j at ``brow_off + s * ymax + j``;
  slot 0 (the analytic row j * pgap) is computed, not stored;
- ``snaps``: chunk c of sweep w at ``snap_off + c * 3 * (rb + 1)``: the
  state (p1, p1s, p2s) after global step c * K, the state a band with
  start <= c * K enters its local step c * K - start + 1 with; the walk
  reads band segment s at chunk start / K + s;
- ``carry``: (x, yd, p1, p1s, p2s) of each sweep's lanes after the last
  launch, read by the next (the fill runs in segments).

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
from msa_tpu_torch.utils.tasks import PairTask
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
from msa_tpu_torch.parallel.schedule import lpt_schedule

# Columns of the sweep, band and event tables (csrc/conveyor_fill.cu keeps
# the same order).
S_BAND_LO, S_BAND_HI, S_EV_LO, S_EV_HI, S_CHUNKS, S_SNAP_OFF, S_BROW_OFF = range(7)
SCOL = 7
C_START, C_I0, C_ROWS, C_N, C_XG, C_YG, C_BROW_IN, C_BROW_OUT = range(8)
CCOL = 8
E_T, E_Q, E_PAIR = range(3)
ECOL = 3


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass
class BandPlan:
    pair_slot: int  # pair index within the sweep (conveyor order)
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


@dataclasses.dataclass
class ConveyorPlan:
    bands: List[BandPlan]
    n_chunks: int
    rb: int
    snap_k: int
    ymax: int  # brow row length: columns 0 .. longest n
    n_slots: int  # brow slots incl. the analytic slot 0
    # Per pair slot: first chunk index at which every snapshot, boundary row
    # and score event the pair's walk reads has been written.
    pair_ready: List[int] = dataclasses.field(default_factory=list)


def check_geometry(rb: int, snap_k: int) -> None:
    if snap_k < 1 or rb < snap_k or rb % snap_k:
        raise ValueError(f"rb_conveyor {rb} must be a positive multiple of snap_k {snap_k}")
    if rb > MAX_RB:
        raise ValueError(f"rb_conveyor + 1 = {rb + 1} lanes do not fit one block ({MAX_RB + 1})")


def plan_conveyor(
    genes: Sequence[str], pairs: Sequence[Tuple[int, int]], rb: int, snap_k: int,
) -> ConveyorPlan:
    """K-aligned band schedule of one sweep (deterministic)."""
    K = snap_k
    bands: List[BandPlan] = []
    prev_n = None  # y length of the previous band in conveyor order
    slot = 1  # 0 = analytic row
    max_n = 0
    ev_chunks = set()  # K-chunks already holding a score event
    for pslot, (xi, yi) in enumerate(pairs):
        m, n = len(genes[xi]), len(genes[yi])
        nb = max(1, -(-m // rb))
        q_last = m - (nb - 1) * rb
        max_n = max(max_n, n)
        pred_row = 0  # analytic for the first band
        for b in range(nb):
            if bands:
                # >= prev_n + K: regions stay disjoint (lane q frees at prev
                # dl = q + n). >= rb + K: at most one band ramping. Same pair:
                # the predecessor's bottom row is harvested (rb steps) at
                # least K steps before the successor's top lane reads it.
                stagger = max(prev_n + K, rb + K)
                if b > 0:
                    stagger = max(stagger, rb + 2 * K)
                start = _round_up(bands[-1].start + stagger, K)
            else:
                start = 0
            if b == nb - 1:
                # One score event per chunk (the JAX chunk table's rule, kept
                # so plans stay identical): defer the last band until the
                # chunk of its event start + q_last + n is free.
                while (start + q_last + n) // K in ev_chunks:
                    start += K
                ev_chunks.add((start + q_last + n) // K)
            # The lanes of the previous band must all be done before this
            # band's ramp front reaches them (conveyor_fill.cu relies on it).
            assert not bands or start - bands[-1].start >= prev_n + K
            bands.append(BandPlan(
                pair_slot=pslot, band=b, i0=b * rb, n=n, xi=xi, yi=yi,
                start=start, brow_out=slot, brow_in=pred_row,
                is_last=(b == nb - 1), q_last=q_last,
            ))
            pred_row = slot
            slot += 1
            prev_n = n
    last = bands[-1]
    total = last.start + rb + last.n + 2
    n_chunks = -(-total // K)
    pair_ready = [0] * len(pairs)
    for bp in bands:
        # Last chunk the band touches: its highest-dl snapshot, bottom row
        # and score event all land by (start + rb + n) // K; +2 margin, as
        # in the JAX planner.
        pair_ready[bp.pair_slot] = max(
            pair_ready[bp.pair_slot], min((bp.start + rb + bp.n) // K + 2, n_chunks)
        )
    return ConveyorPlan(
        bands=bands, n_chunks=n_chunks, rb=rb, snap_k=K, ymax=max_n + 1,
        n_slots=slot, pair_ready=pair_ready,
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
):
    """One sweep's plan: ``(order, ordered, swapped, plan)``.

    ``order[r]`` is the caller index of the r-th pair in size-descending
    conveyor order; ``ordered[r]`` its (x gene, y gene) after orientation;
    ``swapped[r]`` whether it was transposed; ``plan`` the band schedule.
    """
    order = _size_order(genes, pairs)
    oriented = [_orient(genes, *pairs[idx], rb, snap_k) for idx in order]
    ordered = [(xi, yi) for _, _, xi, yi in oriented]
    swapped = [sw for _, sw, _, _ in oriented]
    return order, ordered, swapped, plan_conveyor(genes, ordered, rb, snap_k)


def plan_snapshot_bytes(plan: ConveyorPlan) -> int:
    """Device bytes of one sweep's snapshots."""
    return plan.n_chunks * 3 * (plan.rb + 1) * 4


@dataclasses.dataclass
class Workload:
    """The plans of all sweeps and the tables the fill kernel reads.

    Global conveyor slot g (sweep w's local pair p is g = slot0[w] + p) is
    the caller's pair ``order[g]``, oriented as ``ordered[g]``.
    """

    order: List[int]
    ordered: List[Tuple[int, int]]
    swapped: List[int]
    sweeps: List[ConveyorPlan]
    slot0: List[int]
    sweep_table: np.ndarray  # (W, SCOL) int64
    band_table: np.ndarray  # (bands, CCOL) int64, each sweep's rows by start
    event_table: np.ndarray  # (pairs, ECOL) int64, each sweep's rows by step
    rb: int
    snap_k: int
    ymax: int
    snaps_len: int
    brow_len: int

    @property
    def num_pairs(self) -> int:
        return len(self.order)

    @property
    def max_chunks(self) -> int:
        return max(p.n_chunks for p in self.sweeps)

    @property
    def snapshot_bytes(self) -> int:
        return 4 * self.snaps_len

    def sweep_of(self, g: int) -> Tuple[int, int]:
        """(sweep, pair slot within the sweep) of conveyor slot g."""
        w = int(np.searchsorted(self.slot0, g, side="right")) - 1
        return w, g - self.slot0[w]

    def pair_ready(self, g: int) -> int:
        w, local = self.sweep_of(g)
        return self.sweeps[w].pair_ready[local]


def plan_sweeps(
    genes: Sequence[str], pairs: Sequence[Tuple[int, int]], rb: int, snap_k: int,
    conveyors: int,
) -> Workload:
    """Split the pairs over ``conveyors`` sweeps (LPT) and plan each."""
    check_geometry(rb, snap_k)
    costs = [
        (PairTask(idx, i, j), _orient(genes, i, j, rb, snap_k)[0])
        for idx, (i, j) in enumerate(pairs)
    ]
    shards = [
        sorted(t.task_id for t in shard)
        for shard in lpt_schedule(costs, max(1, min(conveyors, len(pairs))))
        if shard
    ]
    order, ordered, swapped, sweeps, slot0 = [], [], [], [], []
    for idxs in shards:
        sub_order, sub_ordered, sub_swapped, plan = plan_workload(
            genes, [pairs[i] for i in idxs], rb, snap_k
        )
        slot0.append(len(order))
        order += [idxs[r] for r in sub_order]
        ordered += sub_ordered
        swapped += sub_swapped
        sweeps.append(plan)

    lanes = rb + 1
    ymax = max(p.ymax for p in sweeps)
    sweep_rows, band_rows, event_rows = [], [], []
    snap_off = brow_off = 0
    for w, plan in enumerate(sweeps):
        events = sorted(
            (bp.start + bp.q_last + bp.n, bp.q_last, slot0[w] + bp.pair_slot)
            for bp in plan.bands if bp.is_last
        )
        sweep_rows.append([
            len(band_rows), len(band_rows) + len(plan.bands), len(event_rows),
            len(event_rows) + len(events), plan.n_chunks, snap_off, brow_off,
        ])
        for bp in plan.bands:
            band_rows.append([
                bp.start, bp.i0, min(rb, len(genes[bp.xi]) - bp.i0), bp.n,
                bp.xi, bp.yi, bp.brow_in, bp.brow_out,
            ])
        event_rows += events
        snap_off += plan.n_chunks * 3 * lanes
        brow_off += plan.n_slots * ymax
    return Workload(
        order=order, ordered=ordered, swapped=swapped, sweeps=sweeps, slot0=slot0,
        sweep_table=np.array(sweep_rows, np.int64).reshape(-1, SCOL),
        band_table=np.array(band_rows, np.int64).reshape(-1, CCOL),
        event_table=np.array(event_rows, np.int64).reshape(-1, ECOL),
        rb=rb, snap_k=snap_k, ymax=ymax, snaps_len=snap_off, brow_len=brow_off,
    )


def conveyor_walk_plan(wl: Workload, genes: Sequence[str], slots: Sequence[int]):
    """The walk's view of the conveyor's output for conveyor slots ``slots``."""
    lanes = wl.rb + 1
    K = wl.snap_k
    pairs = []
    for g in slots:
        w, local = wl.sweep_of(g)
        snap_off, brow_off = wl.sweep_table[w, [S_SNAP_OFF, S_BROW_OFF]].tolist()
        bands = [
            (snap_off + bp.start // K * 3 * lanes,
             brow_off + bp.brow_in * wl.ymax if bp.brow_in else 0)
            for bp in wl.sweeps[w].bands if bp.pair_slot == local
        ]
        xi, yi = wl.ordered[g]
        pairs.append((len(genes[xi]), len(genes[yi]), xi, yi, wl.swapped[g], bands))
    return make_walk_plan(pairs, wl.rb, K)


@dataclasses.dataclass
class ConveyorState:
    """The conveyor fill's outputs and carry, flat, laid out by a Workload."""

    score: torch.Tensor  # (pairs,) int32, by conveyor slot
    brow: torch.Tensor  # (brow_len,) int32
    snaps: torch.Tensor  # (snaps_len,) int32
    carry: torch.Tensor  # (W * 5 * (rb + 1),) int32


def conveyor_state(wl: Workload, device: torch.device) -> ConveyorState:
    i32 = dict(dtype=torch.int32, device=device)
    return ConveyorState(
        score=torch.zeros(wl.num_pairs, **i32),
        brow=torch.zeros(max(wl.brow_len, 1), **i32),
        snaps=torch.zeros(wl.snaps_len, **i32),
        carry=torch.zeros(len(wl.sweeps) * 5 * (wl.rb + 1), **i32),
    )


def conveyor_fill(
    table: torch.Tensor, wl: Workload, pxy: int, pgap: int, c0: int, c1: int,
    state: ConveyorState,
) -> ConveyorState:
    """Advance every sweep through chunks [c0, c1); updates ``state`` in place.

    Segments must run in order from c0 = 0; on the card through the kernel.
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
    for t in (state.score, state.brow, state.snaps, state.carry):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("conveyor state must be contiguous int32 on the table's device")
    lib = _build.load("conveyor_fill")
    table = table.contiguous()
    sweeps, bands, events = (
        to_card(t, dev) for t in (wl.sweep_table, wl.band_table, wl.event_table)
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.conveyor_fill(
        table.data_ptr(), table.stride(0), sweeps.data_ptr(), bands.data_ptr(),
        events.data_ptr(), len(wl.sweeps), wl.rb, wl.snap_k, wl.ymax, pxy, pgap,
        c0, c1, state.score.data_ptr(), state.brow.data_ptr(),
        state.snaps.data_ptr(), state.carry.data_ptr(), ctypes.c_void_p(stream),
    )
    _build.check("conveyor_fill", err)
    _build.count(conveyor_fill, wl.num_pairs if c0 == 0 else 0)
    return state


conveyor_fill.launches = 0  # kernel launches (plain-version runs not counted)
conveyor_fill.pairs = 0  # pairs of the workloads those launches began


def conveyor_fill_ref(
    table: torch.Tensor, wl: Workload, pxy: int, pgap: int, c0: int, c1: int,
    state: ConveyorState,
) -> ConveyorState:
    """Plain PyTorch fill: one Python step per global step, same outputs.

    The lanes' y codes are a view of one reversed y stream per sweep (lane q
    at step t holds the code that entered lane 0 at step t - q), and p1s, p2s
    are p1 and the previous p1 shifted up one lane.
    """
    dev = table.device
    rb, K, ymax = wl.rb, wl.snap_k, wl.ymax
    lanes = rb + 1
    i32 = dict(dtype=torch.int32, device=dev)
    neg = torch.full((1,), NEG_FILL, **i32)

    def shift(v):
        return torch.cat([neg, v[:-1]])

    for w, (b_lo, b_hi, e_lo, e_hi, n_chunks, snap_off, brow_off) in enumerate(
        wl.sweep_table.tolist()
    ):
        t0, t1 = c0 * K, min(c1, n_chunks) * K
        if t0 >= t1:
            continue
        bands = wl.band_table[b_lo:b_hi].tolist()
        events = wl.event_table[e_lo:e_hi].tolist()
        carry = state.carry[w * 5 * lanes : (w + 1) * 5 * lanes].view(5, lanes)
        T = n_chunks * K
        ystream = torch.full((T + lanes,), Y_SENTINEL, **i32)
        for start, _, _, n, _, yg, _, _ in bands:
            ystream[lanes + start : lanes + start + n] = table[yg, :n]
        rev = ystream.flip(0)  # lane q at step t: rev[T - t + q]
        if t0 == 0:
            xv = torch.full((lanes,), X_SENTINEL, **i32)
            p1 = torch.full((lanes,), NEG_FILL, **i32)
            prev = torch.full((lanes,), NEG_FILL, **i32)
        else:
            xv, p1 = carry[0].clone(), carry[2].clone()
            prev = torch.cat([carry[4][1:], neg])
        top = bot = -1
        ev = next((e for e, (t, _, _) in enumerate(events) if t >= t0), len(events))
        for t in range(t0, t1):
            while top + 1 < len(bands) and bands[top + 1][C_START] <= t:
                top += 1
            while bot + 1 < len(bands) and bands[bot + 1][C_START] + rb <= t:
                bot += 1
            start, i0, rows, n, xg, _, brow_in, _ = bands[top]
            dl = t - start
            if dl <= rb:  # the ramp: lane dl takes its x code
                if 1 <= dl <= rows:
                    xv[dl : dl + 1] = table[xg, i0 + dl - 1 : i0 + dl]
                else:
                    xv[dl] = X_SENTINEL
            yd = rev[T - t : T - t + lanes]
            sub = (xv != yd).to(torch.int32) * pxy
            cur = torch.empty(lanes, **i32)
            cur[1:] = torch.minimum(
                prev[:-1] + sub[1:], torch.minimum(p1[1:], p1[:-1]) + pgap
            )
            if dl > n:
                cur[0] = NEG_FILL
            elif brow_in:
                row = brow_off + brow_in * ymax + dl
                cur[0:1] = state.brow[row : row + 1]
            else:
                cur[0] = dl * pgap
            if dl <= rb:
                cur[dl] = (i0 + dl) * pgap
            if bot >= 0:
                b_start, _, _, b_n, _, _, _, brow_out = bands[bot]
                h = t - b_start - rb
                if h <= b_n:
                    row = brow_off + brow_out * ymax + h
                    state.brow[row : row + 1] = cur[rb : rb + 1]
            if ev < len(events) and events[ev][E_T] == t:
                _, q, g = events[ev]
                state.score[g : g + 1] = cur[q : q + 1]
                ev += 1
            prev, p1 = p1, cur
            if t % K == 0:
                base = snap_off + t // K * 3 * lanes
                state.snaps[base : base + 3 * lanes] = torch.cat([p1, shift(p1), shift(prev)])
        carry[0] = xv
        carry[1] = rev[T - t1 + 1 : T - t1 + 1 + lanes]
        carry[2] = p1
        carry[3] = shift(p1)
        carry[4] = shift(prev)
    return state


def sweep_count(conveyors: int, num_pairs: int, device: torch.device) -> int:
    """Concurrent sweeps: ``conveyors``, or min(pairs, SM count) when 0.

    On the CPU (plain versions, one sweep after another) 0 means one sweep.
    """
    if conveyors <= 0:
        conveyors = (
            torch.cuda.get_device_properties(device).multi_processor_count
            if device.type == "cuda" else 1
        )
    return max(1, min(conveyors, num_pairs))


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
    wl = plan_sweeps(genes, pairs, rb, K, sweep_count(config.conveyors, num, device))

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
