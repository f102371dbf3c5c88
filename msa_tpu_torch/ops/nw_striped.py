"""One lone pair's banded fill striped over several devices.

Port of ``msa_tpu/ops/nw_striped.py``. The JAX module cuts the pair into D
stripes of round_up(m / D, K) rows, one band a TPU chip, streams each
stripe's bottom row to the next chip with one ``ppermute`` per K columns,
and re-derives each (stripe, chunk) segment's directions on the host in a
Python loop for the traceback. Both served one TPU TensorCore, and neither
is carried over:

- A stripe is a run of whole bands of the banded fill's own rb
  (``ops/band_fill.py::plan_stripes``), filled by one ``band_fill`` launch
  on its device, with its own ticket counter, on its own stream, in a host
  thread of its own (``parallel/mesh.py::device_scope``).
- Stripe 0, on ``devices[0]``, holds the pair's whole layout of
  ``plan_pairs``; every later stripe holds only its window of it: its bands'
  snapshots and the bottom rows from the one relayed in to its own last
  (``plan_stripes``). The kernel indexes the whole layout (progress slots
  too) and is handed each window at its offset, so a stripe's first band
  finds its producer's row and count where one launch would.
- The relay: the last band of stripe c harvests its bottom row into stripe
  c + 1's ``rows`` window and publishes its count into stripe c + 1's
  ``progress`` by stores into the other card's memory (peer access through
  UVA, enabled through the kernel library), released and acquired at system
  scope (``csrc/band_fill.cu``).
- Then each later stripe's window is gathered into stripe 0's state, which
  is by construction what one launch over the same plan writes, and the
  walk (``csrc/walk.cu``, unchanged) traces it on ``devices[0]`` through
  ``ops/walk.py::banded_walk_plan``. So ``devices[0]`` holds the whole
  pair, as the walk needs, and every other device about 1/D of it.

No fallback: distinct cards without peer access raise, and so do stripes
sharing a card whose grids cannot all be resident at once
(``parallel/mesh.py::check_stripes``), before any launch. With one device
the fill is one ordinary ``band_fill`` launch. On CPU devices the plain
version runs (``striped_fill_ref``); any other device raises.

On a Hopper card this buys no speed: the banded fill already runs a pair's
bands on separate SMs, band b + 1 trailing band b, and striping moves bands
to other cards without shortening that chain. So no k-way route chooses it
(the JAX package's opt-in ``single_pair_striped`` has no counterpart in
``TorchConfig``); it is called directly.

Stripes on one card, where a relay is a store into another launch's
buffers, are checked by ``chip_smoke.py`` and the card tests. On distinct
cards the relay is a peer store over the cards' link, released and acquired
at system scope; ``chip_smoke.py --cards`` is that check (run on four
H100s of one host: exact over 2 and 4 cards).
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import torch

from msa_tpu_torch.ops.band_fill import (
    P_N,
    P_NB,
    P_ROWS_OFF,
    FillState,
    Plan,
    Stripe,
    band_fill,
    band_fill_ref,
    check_card,
    empty_state,
    gene_table,
    launch,
    launch_buffers,
    plan_pairs,
    plan_stripes,
    resident_blocks,
)
from msa_tpu_torch.ops.walk import banded_walk_plan, pair_moves, walk
from msa_tpu_torch.utils.alignment import moves_to_alignment


def _indexed(dev: torch.device) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _gather(states: Dict[int, FillState], stripes: List[Stripe], plan: Plan) -> FillState:
    """Each later non-empty stripe's own entries into stripe 0's state (the
    whole pair's layout): its snapshots, and the rows of bands lo - 1
    (relayed in) .. hi - 2; the score from the stripe that holds the last
    band."""
    n = int(plan.params[0, P_N])
    live = [c for c, s in enumerate(stripes) if s.num_items]
    out = states[0]
    for c in live[1:]:
        s, st = stripes[c], states[c]
        out.snaps[s.snaps_base : s.snaps_base + s.snaps_len].copy_(st.snaps)
        own = s.num_items * n
        out.rows[s.rows_base : s.rows_base + own].copy_(st.rows[:own])
    out.score.copy_(states[live[-1]].score)
    return out


def striped_fill_ref(tables: Sequence[torch.Tensor], plan: Plan,
                     devices: Sequence[torch.device], pxy: int, pgap: int) -> FillState:
    """Plain version: the stripes one after another through ``band_fill_ref``,
    each on its own window, the relay a copy of the bottom row into the next
    stripe's rows; then the gather."""
    stripes = plan_stripes(plan, len(devices))
    n = int(plan.params[0, P_N])
    live = [c for c, s in enumerate(stripes) if s.num_items]
    states = {c: empty_state(plan, devices[c], stripes[c]) for c in live}
    for c in live:
        s = stripes[c]
        band_fill_ref(tables[c], plan, pxy, pgap, stripe=s, out=states[c])
        if s.relay >= 0:
            start = int(plan.params[0, P_ROWS_OFF]) + s.relay * n
            src = states[c].rows[start - s.rows_base :][:n]
            dst = start - stripes[c + 1].rows_base
            states[c + 1].rows[dst : dst + n] = src.to(devices[c + 1])
    return _gather(states, stripes, plan)


def striped_fill(tables: Sequence[torch.Tensor], plan: Plan, devices: Sequence[torch.device],
                 pxy: int, pgap: int) -> FillState:
    """Fill a one-pair ``plan`` in stripes over ``devices`` (``tables[c]``:
    the gene table on ``devices[c]``); the gathered state on ``devices[0]``.

    On cards: one kernel launch a non-empty stripe, launched in stripe order
    (a producer before its consumer, so a launch that fails leaves no
    consumer waiting), each from its own host thread on its own stream.
    """
    from msa_tpu_torch.parallel.mesh import check_stripes, device_scope

    if len(tables) != len(devices) or not devices:
        raise ValueError(f"{len(tables)} tables for {len(devices)} devices")
    devices = [_indexed(d) for d in devices]
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return striped_fill_ref(tables, plan, devices, pxy, pgap)
    if kinds != {"cuda"}:
        raise ValueError(f"a striped fill runs on cuda devices or on the cpu, not on {devices}")
    for table, dev in zip(tables, devices):
        if table.dtype != torch.uint8 or table.dim() != 2 or table.device != dev:
            raise ValueError(f"gene table must be a 2-D uint8 tensor on {dev}")
        check_card(table, plan)
    if len(devices) == 1:
        return band_fill(tables[0], plan, pxy, pgap)

    from msa_tpu_torch.ops import _build

    stripes = plan_stripes(plan, len(devices))
    live = [c for c, s in enumerate(stripes) if s.num_items]
    resident = {d: resident_blocks(plan, d) for d in set(devices[c] for c in live)}
    grids = [min(s.num_items, resident[d]) if s.num_items else 0
             for s, d in zip(stripes, devices)]
    check_stripes(devices, grids, resident.__getitem__)
    lib = _build.load("band_fill")
    for c in live[:-1]:
        src, dst = devices[c], devices[c + 1]
        if src != dst:
            _build.check("band_fill_peer", lib.band_fill_peer(src.index, dst.index))
    # Every buffer exists, zeroed, before any stripe runs: a consumer's rows
    # and progress are its producer's relay target, and no allocation (which
    # may wait for the card) happens while a stripe spins.
    buffers = {}
    for c in live:
        with torch.cuda.device(devices[c]):
            buffers[c] = launch_buffers(plan, devices[c], stripes[c])
    for dev in resident:
        torch.cuda.synchronize(dev)

    nb = int(plan.params[0, P_NB])
    launched = {c: threading.Event() for c in live}
    failed = threading.Event()

    def run(c):
        s = stripes[c]
        try:
            if c > 0:
                launched[c - 1].wait()
            if failed.is_set():
                return
            with device_scope(devices[c]):
                launch(tables[c], plan, pxy, pgap, buffers[c], relay_out=s.relay,
                       relay_in=s.lo if s.lo else -1,
                       relay_to=buffers[c + 1] if s.relay >= 0 else None,
                       pairs=int(s.hi == nb))
                _build.count(striped_fill, int(s.hi == nb))
                launched[c].set()
                torch.cuda.current_stream().synchronize()
        except BaseException:
            failed.set()
            raise
        finally:
            launched[c].set()  # the next stripe launches, or sees the failure

    with ThreadPoolExecutor(max_workers=len(live)) as pool:
        for fut in [pool.submit(run, c) for c in live]:
            fut.result()
    with torch.cuda.device(devices[0]):
        return _gather({c: b.out for c, b in buffers.items()}, stripes, plan)


striped_fill.launches = 0  # stripe launches of the fill kernel (plain-version runs not counted)
striped_fill.pairs = 0  # pairs those launches finished


def nw_align_band_striped(
    x: str, y: str, pxy: int, pgap: int, devices: Sequence[torch.device], *,
    rb: int, snap_k: int,
) -> Tuple[int, str, str]:
    """(penalty, align1, align2) of one pair, its fill striped over ``devices``.

    The tie-break is match -> diag -> up -> left, as the host oracle's; the
    walk runs on ``devices[0]`` over the gathered fill.
    """
    plan = plan_pairs([len(x), len(y)], [(0, 1)], rb, snap_k)
    devices = [_indexed(d) for d in devices]
    codes = torch.from_numpy(gene_table([x, y]))
    tables = {d: codes.to(d) for d in dict.fromkeys(devices)}
    fill = striped_fill([tables[d] for d in devices], plan, devices, pxy, pgap)
    wplan = banded_walk_plan(plan)
    dev = devices[0]
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        words, counts = walk(tables[dev], wplan, fill.rows, fill.snaps, pxy, pgap)
        words, counts, score = words.cpu().numpy(), counts.cpu().numpy(), int(fill.score[0])
    nw_align_band_striped.calls += 1
    a1, a2 = moves_to_alignment(x, y, pair_moves(words, counts, wplan, 0))
    return score, a1, a2


nw_align_band_striped.calls = 0  # pairs aligned through the striped route
