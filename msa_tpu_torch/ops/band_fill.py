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

A plan made with ``snaps=False`` has no snapshots (``snaps_len`` = 0): the
score-only mode of ``emit_snaps=False``, which ``nw_score`` runs (port of
``msa_tpu/ops/pallas_nw.py::nw_score_pallas``).

The kernel runs every (pair, band) as a work item on a persistent grid, band
b following band b - 1 through ``rows`` (``csrc/band_fill.cu``). The plan's
item table gives the ticket order: each row is (pair, band, progress slot),
the slot being the band's index among all the bands of the call, and every
band comes after its producer, band b - 1 of the same pair. The longest
remaining pipelined chain goes first: (nb - 1 - b) * (rb + chunk) steps of
lag behind the band, plus the last band's rows + n steps.

``band_fill`` launches ``csrc/band_fill.cu`` for CUDA tensors and runs
``band_fill_ref`` for CPU tensors; any other device raises.

A lone pair can be cut into stripes of whole bands (``plan_stripes``), one
launch each, band ``lo`` of a stripe reading the bottom row that the
previous stripe's last band relays into its buffers (``ops/nw_striped.py``).
Stripe 0 holds the pair's whole layout; every other stripe holds only the
window of rows and snapshots that its bands touch.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from msa_tpu_torch.config import MAX_RB

NEG_FILL = 2**30
X_SENTINEL = -1
Y_SENTINEL = -2

# Columns of the parameter table (csrc/common.cuh keeps the same order).
P_M, P_N, P_XG, P_YG, P_NB, P_S, P_SNAP_OFF, P_ROWS_OFF = range(8)
NCOL = 8
# Longest chunk of steps between two waits of a band for its producer
# (csrc/band_fill.cu, CHUNK_MAX).
CHUNK_MAX = 1024


def chunk_steps(snap_k: int, snaps: bool) -> int:
    """Steps of the kernel's chunk: the largest divisor of snap_k up to
    CHUNK_MAX, so that every snapshot falls on a chunk boundary; CHUNK_MAX
    when there are no snapshots."""
    if not snaps:
        return CHUNK_MAX
    return max(d for d in range(1, min(snap_k, CHUNK_MAX) + 1) if snap_k % d == 0)


@dataclasses.dataclass
class Plan:
    """Geometry and buffer offsets of every pair of one fill call."""

    params: np.ndarray  # (P, NCOL) int64
    rb: int
    snap_k: int
    rows_len: int
    snaps_len: int
    items: np.ndarray  # (total bands, 3) int32, in ticket order
    chunk: int  # steps between two waits for the producer band

    @property
    def num_pairs(self) -> int:
        return int(self.params.shape[0])

    @property
    def num_items(self) -> int:
        """Work items of the kernel: every band of every pair."""
        return int(self.items.shape[0])

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
    snap_k: int, snaps: bool = True,
) -> Plan:
    """Lay out pairs (x gene, y gene) of sequences with these lengths.

    ``snaps=False``: no snapshot slots (S = 0), for a score-only fill.
    """
    if rb < 1:
        raise ValueError(f"rb must be positive, got {rb}")
    if snap_k < 1:
        raise ValueError(f"snap_k must be positive, got {snap_k}")
    chunk = chunk_steps(snap_k, snaps)
    params = np.zeros((len(pairs), NCOL), np.int64)
    items = []
    snap_off = rows_off = slot = 0
    for p, (xg, yg) in enumerate(pairs):
        m, n = int(lengths[xg]), int(lengths[yg])
        if m < 1 or n < 1:
            raise ValueError(f"pair {p} has an empty sequence")
        nb = -(-m // rb)
        s = (min(rb, m) + n - 1) // snap_k + 1 if snaps else 0
        params[p] = [m, n, xg, yg, nb, s, snap_off, rows_off]
        last = m - (nb - 1) * rb + n
        items += [(-((nb - 1 - b) * (rb + chunk) + last), p, b, slot + b) for b in range(nb)]
        snap_off += nb * s * 3 * (rb + 1)
        rows_off += (nb - 1) * n
        slot += nb
    table = np.array([it[1:] for it in sorted(items)], np.int32).reshape(-1, 3)
    return Plan(params, rb, snap_k, rows_off, snap_off, table, chunk)


# Lowest band height ``band_height`` narrows to. A lone 90,000 x 85,000
# pair's score fill on an H100 took 38.1-38.8 ms at rb 2047 and 38.3-38.8 ms
# at 1023 (PERF.md), while every band more costs the walk a segment start.
BAND_FLOOR = 2047


def band_height(lengths: Sequence[int], pairs: Sequence[Tuple[int, int]], rb: int,
                sms: int) -> int:
    """Band height for one fill of ``pairs``: the tallest rung of rb,
    (rb + 1) // 2 - 1, ... whose bands (sum of ceil(m / rung)) number at
    least ``sms``, so that the persistent grid covers the card's SMs; else
    min(rb, BAND_FLOOR), never lower. A fill has one block a band and a
    pair's bands run one after another, so a few tall bands leave most SMs
    idle while narrower ones start down the chain sooner."""
    floor = min(rb, BAND_FLOOR)
    rung = rb
    while rung > floor:
        if sum(-(-int(lengths[xg]) // rung) for xg, _ in pairs) >= sms:
            return rung
        rung = (rung + 1) // 2 - 1
    return floor


@dataclasses.dataclass
class Stripe:
    """Bands ``lo`` .. ``hi`` - 1 of a lone pair, filled by one launch, and
    the window of the pair's layout that the stripe's buffers hold: entries
    ``rows_base`` .. + ``rows_len`` of the rows, ``snaps_base`` .. +
    ``snaps_len`` of the snapshots."""

    lo: int
    hi: int
    items: np.ndarray  # (hi - lo, 3) int32 rows of the plan's items, in ticket order
    relay: int  # the band whose bottom row goes to the next stripe (hi - 1), or -1
    rows_base: int
    rows_len: int
    snaps_base: int
    snaps_len: int

    @property
    def num_items(self) -> int:
        return self.hi - self.lo


def plan_stripes(plan: Plan, stripes: int) -> List[Stripe]:
    """Cut a one-pair plan's nb bands into ``stripes`` contiguous runs.

    The first nb % stripes runs take one band more than the others; where
    stripes > nb the last ones are empty. Each run but the last non-empty
    one relays its last band's bottom row to the next run.

    Stripe 0's window is the whole pair (the gathered state is written into
    it). Stripe c > 0 holds its bands' snapshots and the bottom rows of bands
    lo - 1 (relayed in) to hi - 1; the last of those, its own relay band's,
    is where the plain version stages the row it relays, while the kernel
    stores it straight into the next stripe's window.
    """
    if plan.num_pairs != 1:
        raise ValueError(f"stripes cut one pair, not {plan.num_pairs}")
    if stripes < 1:
        raise ValueError(f"stripes must be positive, got {stripes}")
    _, n, _, _, nb, S, snap_off, rows_off = (int(v) for v in plan.params[0])
    per_band = S * 3 * (plan.rb + 1)
    out, lo = [], 0
    for c in range(stripes):
        hi = lo + nb // stripes + (c < nb % stripes)
        items = plan.items[(plan.items[:, 1] >= lo) & (plan.items[:, 1] < hi)]
        if c == 0:
            window = (0, plan.rows_len, 0, plan.snaps_len)
        else:
            window = (rows_off + (lo - 1) * n, (min(hi, nb - 1) - lo + 1) * n,
                      snap_off + lo * per_band, (hi - lo) * per_band)
        out.append(Stripe(lo, hi, items, hi - 1 if lo < hi < nb else -1, *window))
        lo = hi
    return out


def gene_table(genes: Sequence[str]) -> np.ndarray:
    """(k, max length) uint8 codes, one row per sequence, zero padded."""
    width = max(1, max(len(g) for g in genes))
    table = np.zeros((len(genes), width), np.uint8)
    for g, seq in enumerate(genes):
        table[g, : len(seq)] = np.frombuffer(seq.encode("latin-1"), np.uint8)
    return table


def to_card(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host table on the card, copied without waiting for the stream."""
    return torch.from_numpy(array).pin_memory().to(device, non_blocking=True)


def device_budget(device: torch.device, hbm_budget: int = 0) -> int:
    """Device bytes the buffers of this process's fill and walk may take.

    Both device pipelines split their work under it (``ops/batch.py`` in
    waves, ``ops/conveyor.py`` in halves). ``hbm_budget`` when set: it is
    already one process's. On a card, 75 % of the card's total memory over
    the processes that ``parallel/mesh.py`` binds to it, less what this
    process's tensors hold, and never more than 75 % of what the process
    can still allocate (the free memory plus what PyTorch's allocator holds
    unused), read anew at each call. So what one card's processes hold and
    may take adds up to at most 75 % of it, whatever order they read in;
    the free memory already leaves out what the others hold, so it is not
    divided again. The JAX package kept 25 % headroom for feeds and walk
    buffers; else 12 GiB, its figure for a device that reports nothing.
    """
    from msa_tpu_torch.parallel.mesh import processes_on

    if hbm_budget:
        return hbm_budget
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        held = torch.cuda.memory_allocated(device)
        free += torch.cuda.memory_reserved(device) - held
        return max(0, int(min(0.75 * total / processes_on(device) - held, 0.75 * free)))
    return 12 << 30


def empty_state(plan: Plan, device: torch.device, stripe: Optional[Stripe] = None) -> FillState:
    """Zeroed outputs of a fill laid out by ``plan``, or of ``stripe``'s
    window of that layout."""
    rows_len, snaps_len = (plan.rows_len, plan.snaps_len) if stripe is None else (
        stripe.rows_len, stripe.snaps_len)
    i32 = dict(dtype=torch.int32, device=device)
    return FillState(
        score=torch.zeros(plan.num_pairs, **i32),
        rows=torch.zeros(max(rows_len, 1), **i32),
        snaps=torch.zeros(snaps_len, **i32),
    )


@dataclasses.dataclass
class Launch:
    """The device buffers of one fill launch, all allocated before it runs:
    the tables, the outputs (entry i of the plan's rows at ``out.rows[i -
    rows_base]``, likewise the snapshots), the bands' published column counts
    (one slot a band of the plan) and the ticket counter (both zero)."""

    params: torch.Tensor
    items: torch.Tensor
    out: FillState
    progress: torch.Tensor
    tickets: torch.Tensor
    rows_base: int = 0
    snaps_base: int = 0


def launch_buffers(plan: Plan, device: torch.device, stripe: Optional[Stripe] = None) -> Launch:
    """Buffers of a launch over every item of the plan, or over ``stripe``'s
    items with outputs for its window only."""
    items = plan.items if stripe is None else stripe.items
    i32 = dict(dtype=torch.int32, device=device)
    return Launch(
        params=to_card(plan.params, device), items=to_card(items, device),
        out=empty_state(plan, device, stripe),
        progress=torch.zeros(plan.num_items, **i32), tickets=torch.zeros(1, **i32),
        rows_base=stripe.rows_base if stripe else 0, snaps_base=stripe.snaps_base if stripe else 0,
    )


def _origin(tensor: torch.Tensor, base: int) -> int:
    """The address that entry 0 of the plan's layout would have, for a
    tensor that holds its entries from ``base`` on: the kernel indexes the
    whole layout and touches only the tensor's window of it."""
    return tensor.data_ptr() - tensor.element_size() * base


def band_fill(table: torch.Tensor, plan: Plan, pxy: int, pgap: int) -> FillState:
    """Fill every pair of ``plan``; on the card through the CUDA kernel."""
    if table.dtype != torch.uint8 or table.dim() != 2:
        raise ValueError("gene table must be a 2-D uint8 tensor")
    if table.device.type == "cpu":
        return band_fill_ref(table, plan, pxy, pgap)
    check_card(table, plan)
    buffers = launch_buffers(plan, table.device)
    launch(table, plan, pxy, pgap, buffers)
    return buffers.out


def check_card(table: torch.Tensor, plan: Plan) -> None:
    """Raise unless the kernel takes this table and plan."""
    if table.device.type != "cuda":
        raise ValueError(f"band_fill runs on cuda or cpu, not {table.device}")
    if plan.rb > MAX_RB:
        raise ValueError(f"the fill kernel takes rb <= {MAX_RB}, got {plan.rb}")


def launch(table: torch.Tensor, plan: Plan, pxy: int, pgap: int, buffers: Launch,
           relay_out: int = -1, relay_in: int = -1, relay_to: Optional[Launch] = None,
           pairs: Optional[int] = None) -> None:
    """Launch the fill kernel over ``buffers.items`` on the current stream.

    It allocates nothing. The relay (``ops/nw_striped.py``): band
    ``relay_out`` writes its bottom row and count into ``relay_to``'s rows
    window and progress (another card's, or another launch's on this card); band
    ``relay_in`` waits for its top row at system scope. ``pairs``: the pairs
    the launch finishes (default: the plan's), for the counters.
    """
    from msa_tpu_torch.ops import _build

    lib = _build.load("band_fill")
    table = table.contiguous()
    out = buffers.out
    blocks = ctypes.c_int(0)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.band_fill(
        table.data_ptr(), table.stride(0), buffers.params.data_ptr(), buffers.items.data_ptr(),
        int(buffers.items.shape[0]), plan.rb, plan.snap_k, plan.chunk, pxy, pgap,
        out.score.data_ptr(), _origin(out.rows, buffers.rows_base),
        _origin(out.snaps, buffers.snaps_base) if plan.snaps_len else None,
        buffers.progress.data_ptr(), buffers.tickets.data_ptr(), relay_out, relay_in,
        _origin(relay_to.out.rows, relay_to.rows_base) if relay_to else None,
        relay_to.progress.data_ptr() if relay_to else None,
        ctypes.byref(blocks), ctypes.c_void_p(stream),
    )
    _build.check("band_fill", err)
    _build.count(band_fill, plan.num_pairs if pairs is None else pairs)
    band_fill.blocks = blocks.value


def resident_blocks(plan: Plan, device: torch.device) -> int:
    """Blocks of the relay's instance of the fill kernel that one card holds
    at once at ``plan``'s band height, chunk and snapshot mode (the
    occupancy API; the query also loads the instance on the card)."""
    from msa_tpu_torch.ops import _build

    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check("band_fill_resident", _build.load("band_fill").band_fill_resident(
            plan.rb, plan.chunk, int(plan.snaps_len > 0), 1, ctypes.byref(blocks)))
    return blocks.value


band_fill.launches = 0  # kernel launches (plain-version runs not counted)
band_fill.pairs = 0  # pairs those launches filled
band_fill.blocks = 0  # the last launch's persistent grid


def band_fill_ref(table: torch.Tensor, plan: Plan, pxy: int, pgap: int,
                  stripe: Optional[Stripe] = None,
                  out: Optional[FillState] = None) -> FillState:
    """Plain PyTorch fill: one Python step per diagonal, same outputs.

    Band b of every pair that has one runs in one batch, a row per pair, and
    the bands run in order: band b + 1 reads band b's bottom rows. Steps past
    a pair's own end change none of its outputs. ``stripe``: only its bands,
    band lo reading its top row from ``out``'s rows, and ``out`` laid out as
    the stripe's window (``ops/nw_striped.py``); ``out``: the outputs to
    write into.
    """
    dev = table.device
    rb, K = plan.rb, plan.snap_k
    lanes = rb + 1
    i32 = dict(dtype=torch.int32, device=dev)
    out = empty_state(plan, dev, stripe) if out is None else out
    score, rows, snaps = out.score, out.rows, out.snaps
    lane = torch.arange(lanes, **i32)
    width = table.shape[1]

    def on(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if stripe is None:
        lo, hi, rows_base, snaps_base = 0, int(plan.params[:, P_NB].max(initial=0)), 0, 0
    else:
        lo, hi, rows_base, snaps_base = stripe.lo, stripe.hi, stripe.rows_base, stripe.snaps_base
    for b in range(lo, hi):
        act = np.flatnonzero(plan.params[:, P_NB] > b)
        m, n, xg, yg, nb, S, snap_off, rows_off = plan.params[act].T
        snap_off, rows_off = snap_off - snaps_base, rows_off - rows_base
        i0 = b * rb
        nrows = np.minimum(rb, m - i0)
        steps = nrows + n
        T = int(steps.max())
        nrows_d, n_d = on(nrows)[:, None], on(n)[:, None]
        xv = table[on(xg)[:, None], (i0 + lane - 1).clamp(0, width - 1)[None, :]].to(torch.int32)
        xv = torch.where((lane >= 1) & (lane <= nrows_d), xv, X_SENTINEL)
        d = torch.arange(T, **i32)[None, :]
        yfeed = table[on(yg)[:, None], d.clamp(max=width - 1)].to(torch.int32)
        yfeed = torch.where(d < n_d, yfeed, Y_SENTINEL)
        if b == 0:
            tops = (d + 1) * pgap
        else:
            src = on(rows_off + (b - 1) * n)[:, None] + d.clamp(max=int(n.max()) - 1)
            tops = rows[src.clamp(max=rows.numel() - 1)]
        tfeed = torch.where(d < n_d, tops, NEG_FILL)
        bottom = torch.zeros((len(act), max(T - rb, 1)), **i32)
        last = nb - 1 == b

        neg = torch.full((len(act), 1), NEG_FILL, **i32)
        p1 = torch.full((len(act), lanes), NEG_FILL, **i32)
        p1[:, 0] = i0 * pgap
        p1s = torch.cat([neg, p1[:, :-1]], 1)
        p2s = torch.full((len(act), lanes), NEG_FILL, **i32)
        yd = torch.full((len(act), lanes), Y_SENTINEL, **i32)

        def snapshot(s):
            state = torch.cat([p1, p1s, p2s], 1)
            for a in np.flatnonzero(s * K < steps) if plan.snaps_len else ():
                base = int(snap_off[a] + (b * S[a] + s) * 3 * lanes)
                snaps[base : base + 3 * lanes] = state[a]

        snapshot(0)
        for dl in range(1, T + 1):
            yd = torch.cat([yfeed[:, dl - 1 : dl], yd[:, :-1]], 1)
            t1 = p2s + torch.where(xv == yd, 0, pxy).to(torch.int32)
            cur = torch.minimum(t1, torch.minimum(p1, p1s) + pgap)
            cur[:, 0] = tfeed[:, dl - 1]
            if dl < lanes:
                cur[:, dl] = (i0 + dl) * pgap
            if dl > rb:
                bottom[:, dl - rb - 1] = cur[:, rb]
            done = np.flatnonzero(last & (steps == dl))
            if done.size:
                score[on(act[done])] = cur[on(done), on(nrows[done])]
            p2s, p1s, p1 = p1s, torch.cat([neg, cur[:, :-1]], 1), cur
            if dl % K == 0:
                snapshot(dl // K)
        for a in np.flatnonzero(nb - 1 > b):
            off = int(rows_off[a] + b * n[a])
            rows[off : off + int(n[a])] = bottom[a, : int(n[a])]
    return out


def nw_score(
    genes: Sequence[str], pairs: Sequence[Tuple[int, int]], pxy: int, pgap: int,
    *, device: torch.device, rb: int = MAX_RB,
) -> np.ndarray:
    """(P,) int32 scores of the pairs (x gene, y gene): one fill launch, no snapshots.

    Port of ``msa_tpu/ops/pallas_nw.py::nw_score_pallas`` for many pairs at
    once; the result is fetched, so the call returns when the fill is done.
    """
    # snap_k is unused without snapshots.
    plan = plan_pairs([len(g) for g in genes], pairs, rb, snap_k=1, snaps=False)
    table = torch.from_numpy(gene_table(genes)).to(device)
    return band_fill(table, plan, pxy, pgap).score.cpu().numpy()
