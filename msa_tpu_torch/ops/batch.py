"""The banded device pipeline for a list of pairs, in memory-bounded waves.

Port of ``msa_tpu/ops/batch.py::align_pairs_batched``. The gene table goes
to the device once as uint8 codes. The pairs, largest (m + n) first so that
the longest walks start earliest, are cut into waves whose device bytes
(``pair_bytes``: snapshots, boundary rows, score, move words and count) fit
half of ``device_budget``, read anew before each wave: two waves are in
flight at once. However large the budget, a wave takes at most about half
the pairs' bytes (``HALVES``), so that the first half's walk and host decode
run beside the second half's fill. On a card the call's band height is
``band_height``'s: the given rb, narrowed (to 2047 at the lowest) while the
call's bands would leave some of the card's SMs without a block (a lone
100,000-row pair fills in 13 bands at 8191, on 13 of an H100's 132 SMs); on
the CPU it is the given rb. The count is the call's own pairs: each shard of
a job split over devices or processes is a call, and chooses alone. Each
wave is one fill launch (every band of every pair a work item of the
persistent grid) on the current stream and one walk launch on a second
stream, so wave w walks while wave w + 1 fills.
A wave's scores, move words and counts come back by non-blocking copies
after an event, and ``decode_workers`` host threads turn each pair's moves
into its alignment strings (``decode_moves`` -> ``moves_to_alignment``). A
wave's pairs go to the decoders before the next walk is launched, so a
failing launch loses none of them (the JAX package journaled per group of 8
pairs the same way).

Everything the JAX version did to serve one compiled TPU program (static
caps, band-count buckets, P_GROUP pairs on the sublanes, feed buffers laid
out for aligned DMA) has no counterpart here: the kernels take every size
at run time.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from msa_tpu_torch.config import TorchConfig
from msa_tpu_torch.utils.alignment import moves_to_alignment
from msa_tpu_torch.ops.band_fill import (
    P_M,
    P_N,
    P_NB,
    P_S,
    Plan,
    band_fill,
    band_height,
    device_budget,
    gene_table,
    plan_pairs,
)
from msa_tpu_torch.ops.walk import banded_walk_plan, pair_moves, walk
from msa_tpu_torch.utils.timing import Span, span


# However large the budget, a wave takes at most 1 / HALVES of the device
# pairs' bytes plus the largest pair's. big13 on an H100
# ("NVIDIA H100 80GB HBM3, 700.00 W"; chip_smoke.py's big13_waves, PERF.md)
# took 0.325-0.352 s end to end in two waves, 0.383-0.432 s in one and
# 0.380-0.396 s in five over three calls (a fourth overlapped: two 0.345,
# 0.408 s; one 0.403, 0.415 s): in one wave the host decodes all 78 pairs
# after the device is done, in five each fill drains the card's grid alone.
HALVES = 2


def pair_bytes(plan: Plan) -> np.ndarray:
    """(P,) device bytes of each pair of ``plan``, all int32: its snapshots,
    boundary rows, score, move words and move count."""
    m, n, nb, s = (plan.params[:, c] for c in (P_M, P_N, P_NB, P_S))
    return 4 * (nb * s * 3 * (plan.rb + 1) + (nb - 1) * n + 1 + -(-(m + n) // 16) + 1)


def align_pairs_batched(
    genes: Sequence[str],
    pairs: Sequence[Tuple[int, int]],
    pxy: int,
    pgap: int,
    *,
    device: torch.device,
    rb: int,
    snap_k: int,
    on_result: Optional[Callable[[int, Tuple[int, str, str]], None]] = None,
    config: Optional[TorchConfig] = None,
    job: Optional[Span] = None,
) -> List[Tuple[int, str, str]]:
    """(penalty, align1, align2) for each (x gene, y gene) pair, in order.

    ``rb`` is the tallest band height: on a card every wave is sized,
    planned and walked at ``band_height(lengths, pairs, rb, SMs)``.
    ``config`` gives the device budget (``hbm_budget``) and the decode
    threads (``decode_workers``). ``on_result(idx, triple)`` fires once per
    pair, with the caller's index, from a decode thread as the pair's
    decode finishes. A pair whose bytes exceed half the budget raises
    ``ValueError`` before any launch. ``job`` is the traced job's span the
    pipeline's spans go under (``utils/timing.py``), None when untraced.
    """
    num = len(pairs)
    if not num:
        return []

    def over(r: int, budget: int) -> ValueError:
        xg, yg = pairs[order[r]]
        return ValueError(
            f"pair ({xg}, {yg}) of {lengths[xg]} x {lengths[yg]} needs {sizes[r] / 2**30:.2f} GiB"
            f" on the device (rb={rb}, snap_k={snap_k}), over half the"
            f" {budget / 2**30:.2f} GiB budget (two waves are in flight)"
        )

    with span(job, "batch.size"):
        config = config or TorchConfig()
        lengths = [len(g) for g in genes]
        if device.type == "cuda":
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            rb = band_height(lengths, pairs, rb, sms)
        order = sorted(range(num),
                       key=lambda idx: -(lengths[pairs[idx][0]] + lengths[pairs[idx][1]]))
        sizes = pair_bytes(plan_pairs(lengths, [pairs[idx] for idx in order], rb, snap_k)).tolist()
        budget = device_budget(device, config.hbm_budget)
        biggest = max(range(num), key=sizes.__getitem__)
        if sizes[biggest] > budget // 2:
            raise over(biggest, budget)
        share = -(-sum(sizes) // HALVES) + sizes[biggest]

    with span(job, "batch.gene_table"):
        table = torch.from_numpy(gene_table(genes)).to(device)
        on_card = device.type == "cuda"
        fill_stream = torch.cuda.current_stream(device) if on_card else None
        walk_stream = torch.cuda.Stream(device) if on_card else None
        pool = ThreadPoolExecutor(max_workers=max(1, config.decode_workers))

    def launch_walk(wave, wplan, fill):
        """The wave's walk (on the second stream on a card) and its fetch."""
        if not on_card:
            words, counts = walk(table, wplan, fill.rows, fill.snaps, pxy, pgap)
            return wave, wplan, (words, counts, fill.score), None, fill
        walk_stream.wait_stream(fill_stream)
        with torch.cuda.stream(walk_stream):
            words, counts = walk(table, wplan, fill.rows, fill.snaps, pxy, pgap)
            fetched = [t.to("cpu", non_blocking=True) for t in (words, counts, fill.score)]
            done = torch.cuda.Event()
            done.record()
        # The wave's device buffers stay referenced (by ``fill``) until its
        # walk is collected, so the allocator cannot hand them out before.
        return wave, wplan, fetched, done, fill

    def decode(idx, words, counts, wplan, p, score):
        # On a decode thread: the profiler does not record here, so the
        # span hangs from the job's span, handed in.
        with span(job, "batch.decode") as sp:
            xg, yg = pairs[idx]
            a1, a2 = moves_to_alignment(genes[xg], genes[yg], pair_moves(words, counts, wplan, p))
            triple = (int(score), a1, a2)
            if on_result is not None:
                on_result(idx, triple)
            if sp is not None:
                sp.attrs["chars"] = len(a1) + len(a2)
                sp.count("decode_chars", len(a1) + len(a2))
        return triple

    out: List[Tuple[int, str, str]] = [None] * num  # type: ignore
    futures = []
    with pool:

        def collect(launched):
            wave, wplan, fetched, done, _ = launched
            with span(job, "batch.fetch_wait"):
                if done is not None:
                    done.synchronize()  # this wave's walk and fetch only
            with span(job, "batch.submit"):
                words, counts, scores = (t.numpy() for t in fetched)
                for p, r in enumerate(wave):
                    idx = order[r]
                    futures.append(
                        (idx, pool.submit(decode, idx, words, counts, wplan, p, scores[p])))

        def next_wave(start):
            """(end, plan) of the wave from ``start``: as many pairs as fit
            the budget read now; no plan when none fits."""
            with span(job, "batch.plan"):
                cap = min(device_budget(device, config.hbm_budget) // 2, share)
                end, total = start, 0
                while end < num and total + sizes[end] <= cap:
                    total += sizes[end]
                    end += 1
                if end == start:
                    return end, None
                return end, plan_pairs(lengths, [pairs[order[r]] for r in range(start, end)],
                                       rb, snap_k)

        pending = None
        start = 0
        while start < num:
            end, plan = next_wave(start)
            if end == start and pending is not None:
                # The next pair does not fit beside the wave in flight:
                # finish that wave and read the budget again.
                collect(pending)
                pending = None
                end, plan = next_wave(start)
            if end == start:
                raise over(start, device_budget(device, config.hbm_budget))
            wave = list(range(start, end))
            with span(job, "batch.fill_enqueue") as sp:
                fill = band_fill(table, plan, pxy, pgap)
                if sp is not None:
                    cells = int((plan.params[:, P_M] * plan.params[:, P_N]).sum())
                    sp.attrs.update(pairs=len(wave), cells=cells, bytes=sum(sizes[start:end]),
                                    rb=plan.rb, bands=plan.num_items)
            # The previous wave walks beside this fill; its pairs go to the
            # decoders before the next walk is launched.
            if pending is not None:
                collect(pending)
            with span(job, "batch.walk_enqueue"):
                pending = launch_walk(wave, banded_walk_plan(plan), fill)
            start = end
        if pending is not None:
            collect(pending)
        with span(job, "batch.drain"):
            for idx, fut in futures:
                out[idx] = fut.result()
            pool.shutdown()
            # The last wave's buffers go back to the allocator here, not on return.
            pending = fill = table = None
    return out
