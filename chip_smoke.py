"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits nonzero:

1. setup: CUDA, nvcc, the card's name and power limit; build the three
   kernels from ``msa_tpu_torch/csrc`` (one nvcc per source, in parallel),
   with ptxas's registers and spills for each;
2. the fill kernel against ``band_fill_ref`` on the card, on three pairs of
   2,000-5,000 characters at rb = 1023 (several bands, several snapshots a
   band) and on one pair at the main path's geometry: score, bottom rows
   and every snapshot entry that is a DP cell must be equal as int32; then
   the pipelined fill with snapshots on and off, every entry equal: 20 bands
   of one pair (20,000 x 17,000 at rb 1023), more items than resident
   blocks (300 pairs of 600-3,000 characters at rb 255), skew (70,000 x 6
   and 6 x 70,000);
3. the walk kernel against ``walk_ref`` on the same fill output: move words
   and counts equal, alignments equal to the native host oracle;
4. big13 end to end through ``msa_tpu_torch.cli`` with ``--backend cuda``
   and ``fill_mode=banded``: the full golden chain hash and all 78
   penalties, both kernels launched, all 78 pairs on the device, twice; each
   kernel alone on big13; the walk's moves, segments and bound on big13
   (``big13_walk``, from the run's own output) and ``walk_ablation.py``'s
   variants (lane retirement on and off, the recompute twice) in turns; the
   band-height sweep (rb 1023, 2047, 4095, 8191: fill and walk by events,
   scores golden); big13 in one wave, two (the default) and four or more
   under a forced budget, in turns (``big13_waves``: fill, walk, rest, peak
   memory); the
   host stages of the ``auto`` run (``big13_host_stages``); then mseq1,
   which stays on the host, and the other bundled datasets (permuted big13,
   and the two xulin sets against their recorded host-oracle goldens in
   data/host_goldens.jsonl, skewed pairs included);
5. the conveyor fill kernel against ``conveyor_fill_ref`` on the card, in
   four segments: (a) one sweep of many tenants at rb = 1024 (short and
   long pairs, both orientations of a skewed pair, so some are transposed),
   (b) one sweep at the main path's rb = 7168 with three pairs of
   15,000-20,000 characters: scores, brow on its DP cells and snapshots on
   theirs equal as int32; then the walk on the conveyor layout against
   ``walk_ref``, alignments swapped back equal to the host oracle;
6. big13 through the CLI with ``fill_mode=conveyor``, twice (one sweep a
   pair), then with 26 sweeps (three pairs each): golden hash and penalties,
   the conveyor fill and the walk launched, 78 conveyor pairs; each kernel
   alone on big13, the walk's moves and segments on the conveyor layout;
   the banded and conveyor times side by side; then the
   permuted big13 and the xulin sets under ``fill_mode=conveyor``; the
   fill-mode A/B (banded, conveyor, conveyor, banded, banded, conveyor);
   big13 under ``fill_mode=auto``, golden, through the fill it chooses;
   each kernel's big13 time beside its bound, share of bound and its
   launches under ``auto`` (the conveyor's run's launches apart);
7. ``score_only_vs_plain``: the fill kernel with snapshots off on the
   phase-2 inputs, scores and rows equal to ``band_fill_ref`` with snapshots
   off and scores equal to the full fill's;
8. ``sharded_scores``: ``parallel/engine.py::sharded_pair_scores`` on big13,
   the 78 scores equal to the golden penalties;
9. ``calibrate``: the cost model measured on the card under a temporary
   cache, then read back from the cache;
10. ``two_shards_one_card``: big13 through the CLI with the process's
   devices set to [cuda:0, cuda:0], so the k-way engine splits the device
   pairs into two shards run by two host threads, under each fill mode: the
   golden output;
11. ``distributed``: two ``msa_tpu_torch.cli --distributed --backend cuda``
   processes on big13 (gloo on 127.0.0.1, both on this card): process 0
   prints the golden output, process 1 nothing, and their journals cover
   the 78 tasks disjointly;
12. ``batched_profile``: ``--batched --profile-dir`` on xulin_test against
   its recorded golden, the trace naming the fill and walk kernels;
13. ``torch_backend``: ``--backend torch`` (the plain-torch sweep) on the
   card on mseq1;
14. the striped fill of a lone pair (``ops/nw_striped.py``):
   ``striped_fill_vs_plain`` (right after phase 2's 20-band case) holds the
   main geometry at rb 1023 striped over [cuda:0] x 2 and x 4 against
   ``band_fill_ref`` and one ``band_fill`` launch, every entry equal;
   ``spec_cap`` runs the 100,352 x 100,000 pair of ``scripts/spec_cap.py``
   (made in-process, ``msa_tpu_torch/goldens/spec_cap.py``) in both
   orientations through ``align_pairs_batched`` and striped over [cuda:0] x
   2 and x 4, each gated on the JSON oracle (penalty and ``pair_hash``), with
   fill, walk and end-to-end ms, peak device memory and share of bound;
   ``spec_cap_cli`` runs it as a k = 2 input through the CLI (one fill
   launch, one walk): golden; the conformance sets are the six datasets of
   ``scripts/conformance.py::golden_table``;
15. the pod-scale workloads of ``gen_workload`` against their goldens
   (``msa_tpu_torch/goldens/pod64.json``, ``pod256.json``: chain hash and
   every penalty, and some pairs' strings against ``nw_align_native``):
   ``pod64`` (2,016 pairs) under ``auto``, ``banded`` in four waves or
   more, ``conveyor``, and ``conveyor`` split in halves twice over, then
   the fill-mode A/B through ``scripts/ab_compare.py``; ``pod256`` (32,640
   pairs, over the card's memory) through the CLI in a fresh process, then
   in-process under ``auto`` (waves that ``device_budget`` gives, three or
   more) and ``conveyor``; each run's waves or halves, fill and walk
   launches, device span, idle share, peak memory and host stages; then
   ``conformance_first_call``: ``scripts/conformance.py``, each dataset in
   a fresh process, the first call apart from three warm runs;
16. one JSON line of the kernels' launches (the ``auto`` run's for the
   kernels it runs; the conveyor fill's from its own path's run, beside
   ``auto_launches``), errors, times and bounds, then the last line
   ``{"ok": true, "device": {...}}``.

It needs the repository around it and a CUDA device, and exits nonzero
without either.

    python3 chip_smoke.py --cards

runs only a lone pair's striped fill across distinct cards (two or more;
on one card a relay is a store into another launch's buffers, here a peer
store over the cards' link, released and acquired at system scope):

1. setup: every card's name and power limit, peer access between
   neighbours, the fill and walk kernels built;
2. ``cards_fill``: the main geometry (20,000 x 17,000) at rb 1023 (20
   bands) striped over cuda:0 .. D - 1, D = 2 and every card, against one
   ``band_fill`` launch on cuda:0: score, rows and every snapshot entry
   equal;
3. ``cards_spec_cap``: the spec-cap pair in both orientations through one
   launch on cuda:0 (``align_pairs_batched``), and through
   ``nw_align_band_striped`` over [cuda:0] x D (one card) and over cuda:0 ..
   D - 1 (D cards), in turns; each golden against the JSON oracle, with the
   fill (``striped_fill`` or ``band_fill`` alone) and the whole route timed
   on the host with every card synchronised (a CUDA event cannot time a
   span that starts on one card and ends on another), and each card's peak
   memory.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

# Golden outputs of the reference (BASELINE.md; the same values gate bench.py).
from msa_tpu_torch.scripts.conformance import BIG13_HASH, BIG13_PENALTIES, PUBLISHED

MSEQ1_HASH_PREFIX = PUBLISHED["data/mseq1.dat"]["chain_hash"]


T0 = time.perf_counter()


def phase(name, **fields):
    """One phase's line; ``t``: seconds since the script started."""
    print(json.dumps({"phase": name, "t": round(time.perf_counter() - T0, 1), **fields}), flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card, by CUDA events, after a warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def random_genes(rng, lengths):
    return ["".join(rng.choice(list("ACGT"), n)) for n in lengths]


# The card's peaks (NVIDIA H100 SXM at 700 W): HBM bytes a second, and int32
# operations a second on the CUDA cores: 132 SMs x 64 INT32 lanes x 1.98 GHz,
# half the float32 lanes behind the data sheet's 67 TFLOP/s (an FMA counted
# as two).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations a DP cell needs: compare, select, min, add, min.
OPS_PER_CELL = 5


def bound(cells, nbytes):
    """(bound_ms, bound_by): the larger of the operations' and the bytes' time."""
    ops_ms = cells * OPS_PER_CELL / INT32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def seq_bytes(genes, pairs):
    return sum(len(genes[i]) + len(genes[j]) for i, j in pairs)


def fill_bound(genes, pairs, out_ints):
    """The fill: every DP cell once; each pair's codes read, outputs written once."""
    cells = sum(len(genes[i]) * len(genes[j]) for i, j in pairs)
    return bound(cells, seq_bytes(genes, pairs) + 4 * out_ints)


def walk_work(words, counts, wplan):
    """What one walk launch did, per pair, from its output: moves, segments,
    barrier steps, the cells of each segment's cone (the cells the walk can
    reach: lanes q - u .. q, u steps back from the entry step, none below
    lane 0) and the snapshot lanes the cones start from."""
    import numpy as np

    from msa_tpu_torch.ops import walk as wk

    words, counts = words.cpu().numpy(), counts.cpu().numpy()
    work = []
    for p in range(wplan.num_pairs):
        m, n = (int(v) for v in wplan.pairs[p, [wk.W_M, wk.W_N]])
        moves = wk.pair_moves(words, counts, wplan, p)
        steps, q = wk.walk_segments(m, n, moves, wplan.rb, wplan.snap_k).T
        cone = np.where(q >= steps - 1, steps * (steps + 1) // 2,
                        (q + 1) * (q + 2) // 2 + (steps - 1 - q) * (q + 1))
        work.append({"m": m, "n": n, "moves": len(moves), "segments": len(steps),
                     "steps": int(steps.sum()), "cone_cells": int(cone.sum()),
                     "lanes_loaded": int((np.minimum(steps - 1, q) + 1).sum())})
    return work


def walk_bound(work):
    """The walk: each segment's cone once (5 operations a cell); each pair's
    codes, the snapshot lanes its cones start from (3 planes) and its 2-bit
    moves moved once."""
    cells = sum(w["cone_cells"] for w in work)
    nbytes = sum(w["m"] + w["n"] + 12 * w["lanes_loaded"] + w["moves"] / 4 for w in work)
    return bound(cells, nbytes)


def walk_phase(layout, ms, work, smi, **fields):
    """One walk launch on big13: its time beside its moves and segments."""
    longest = max(work, key=lambda w: w["steps"])
    bound_ms, bound_by = walk_bound(work)
    phase("big13_walk", layout=layout, ms=ms, pairs=len(work),
          moves=sum(w["moves"] for w in work), segments=sum(w["segments"] for w in work),
          cone_cells=sum(w["cone_cells"] for w in work),
          longest_pair={k: longest[k] for k in ("m", "n", "moves", "segments", "steps")},
          ms_per_move_of_longest_pair=ms / longest["moves"],
          ms_per_step_of_longest_pair=ms / longest["steps"],
          bound_ms=bound_ms, bound_by=bound_by, card=smi, **fields)


def band_fill_bound(genes, pairs, plan):
    return fill_bound(genes, pairs, plan.num_pairs + plan.rows_len + plan.snaps_len)


def check_case(name, genes, pairs, rb, snap_k, pxy=3, pgap=2):
    """Fill and walk kernels against their plain versions on one workload."""
    import numpy as np
    import torch

    from msa_tpu_torch.native import nw_align_native
    from msa_tpu_torch.utils.alignment import moves_to_alignment
    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.ops import walk as wk
    from msa_tpu_torch.state import valid_snapshot_cells

    plan = bf.plan_pairs([len(g) for g in genes], pairs, rb, snap_k)
    table = torch.from_numpy(bf.gene_table(genes)).cuda()

    fill = bf.band_fill(table, plan, pxy, pgap)
    ref, fill_plain_ms = host_ms(lambda: bf.band_fill_ref(table, plan, pxy, pgap))
    fill_ms = cuda_ms(lambda: bf.band_fill(table, plan, pxy, pgap), reps=3)
    valid = torch.from_numpy(
        np.concatenate([valid_snapshot_cells(plan, p).reshape(-1)
                        for p in range(plan.num_pairs)])
    ).cuda()
    fill_err = max(
        (fill.score - ref.score).abs().max().item(),
        (fill.rows - ref.rows).abs().max().item(),
        (fill.snaps - ref.snaps)[valid].abs().max().item(),
    )
    if fill_err != 0:
        raise AssertionError(f"{name}: fill kernel differs from band_fill_ref by {fill_err}")
    phase("fill_vs_plain", case=name, pairs=plan.num_pairs, rb=rb, snap_k=snap_k,
          bands=[int(b) for b in plan.params[:, 4]],
          snapshots_per_band=[int(s) for s in plan.params[:, 5]],
          max_abs_err=fill_err, all_entries_equal=torch.equal(fill.snaps, ref.snaps),
          ms=fill_ms, plain_ms=fill_plain_ms)

    wplan = wk.banded_walk_plan(plan)
    args = (table, wplan, fill.rows, fill.snaps, pxy, pgap)
    words, counts = wk.walk(*args)
    (rwords, rcounts), walk_plain_ms = host_ms(lambda: wk.walk_ref(*args))
    walk_ms = cuda_ms(lambda: wk.walk(*args), reps=3)
    walk_err = max((words - rwords).abs().max().item(), (counts - rcounts).abs().max().item())
    if walk_err != 0:
        raise AssertionError(f"{name}: walk kernel differs from walk_ref by {walk_err}")
    work = walk_work(words, counts, wplan)
    words, counts, scores = words.cpu().numpy(), counts.cpu().numpy(), fill.score.cpu().numpy()
    for p, (i, j) in enumerate(pairs):
        moves = wk.pair_moves(words, counts, wplan, p)
        got = (int(scores[p]), *moves_to_alignment(genes[i], genes[j], moves))
        if got != nw_align_native(genes[i], genes[j], pxy, pgap):
            raise AssertionError(f"{name}: pair {p} alignment differs from the host oracle")
    phase("walk_vs_plain", case=name, moves=[int(c) for c in counts],
          max_abs_err=walk_err, alignments="equal to nw_align_native",
          ms=walk_ms, plain_ms=walk_plain_ms)
    return {"fill": (fill_err, fill_ms, fill_plain_ms, band_fill_bound(genes, pairs, plan)),
            "walk": (walk_err, walk_ms, walk_plain_ms, walk_bound(work))}


def check_fill(name, genes, pairs, rb, snap_k, pxy=3, pgap=2):
    """The fill kernel against ``band_fill_ref``, snapshots on and off: score,
    rows and every snapshot entry equal as int32. The plain version runs once,
    with snapshots: without them it computes the same score and rows."""
    import torch

    from msa_tpu_torch.ops import band_fill as bf

    table = torch.from_numpy(bf.gene_table(genes)).cuda()
    lengths = [len(g) for g in genes]
    ref, plain_ms = host_ms(lambda: bf.band_fill_ref(
        table, bf.plan_pairs(lengths, pairs, rb, snap_k), pxy, pgap))
    for snaps in (True, False):
        plan = bf.plan_pairs(lengths, pairs, rb, snap_k, snaps=snaps)
        got = bf.band_fill(table, plan, pxy, pgap)
        if snaps:
            first = got
        blocks = bf.band_fill.blocks
        ms = cuda_ms(lambda: bf.band_fill(table, plan, pxy, pgap), reps=3)
        outs = [(got.score, ref.score), (got.rows, ref.rows)] + [(got.snaps, ref.snaps)] * snaps
        err = max((a - b).abs().max().item() for a, b in outs)
        if err != 0:
            raise AssertionError(f"{name}: fill kernel (snapshots {snaps}) differs from band_fill_ref by {err}")
        phase("fill_vs_plain", case=name, snapshots=snaps, pairs=plan.num_pairs, rb=rb,
              snap_k=snap_k, items=plan.num_items, blocks=blocks,
              more_items_than_blocks=plan.num_items > blocks, max_abs_err=err,
              all_entries_equal=True, ms=ms, plain_ms=plain_ms,
              bound_ms=band_fill_bound(genes, pairs, plan)[0])
    return ref, first


def check_striped(name, genes, rb, snap_k, ref, one, smi, pxy=3, pgap=2):
    """One pair's fill striped over [cuda:0] x 2 and x 4 (``ops/nw_striped.py``:
    each stripe a launch, its last band relaying into the next launch's
    buffers) against ``band_fill_ref`` (``ref``) and one ``band_fill`` launch
    (``one``): score, rows and every snapshot entry equal. Host-timed, like
    one launch beside it (allocation, launch and the wait for the card)."""
    import torch

    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.ops import nw_striped as ns

    plan = bf.plan_pairs([len(g) for g in genes], [(0, 1)], rb, snap_k)
    table = torch.from_numpy(bf.gene_table(genes)).cuda()
    one_ms = cuda_ms(lambda: bf.band_fill(table, plan, pxy, pgap), reps=3)
    one_host_ms = min(host_ms(lambda: bf.band_fill(table, plan, pxy, pgap))[1] for _ in range(3))
    for count in (2, 4):
        devices = [torch.device("cuda", 0)] * count
        launches = ns.striped_fill.launches
        got = ns.striped_fill([table] * count, plan, devices, pxy, pgap)
        if ns.striped_fill.launches != launches + count:
            raise AssertionError(f"{name}: {count} stripes made {ns.striped_fill.launches - launches} launches")
        err = max((a - b).abs().max().item() for want in (ref, one) for a, b in (
            (got.score, want.score), (got.rows, want.rows), (got.snaps, want.snaps)))
        if err != 0:
            raise AssertionError(f"{name}: {count} stripes differ from one launch or the plain fill by {err}")
        ms = min(host_ms(lambda: ns.striped_fill([table] * count, plan, devices, pxy, pgap))[1]
                 for _ in range(3))
        phase("striped_fill_vs_plain", case=name, stripes=count, rb=rb, snap_k=snap_k,
              bands=plan.num_items,
              stripe_bands=[[s.lo, s.hi] for s in bf.plan_stripes(plan, count)],
              max_abs_err=err, equal_to="band_fill_ref and one band_fill launch, every entry",
              striped_host_ms=ms, one_launch_host_ms=one_host_ms, one_launch_ms=one_ms, card=smi)


def spec_cap(cfg, smi):
    """The spec-cap pair (100,352 x 100,000, ``scripts/spec_cap.py``'s seed)
    in both orientations under three routes: the default banded pipeline,
    and striped over [cuda:0] x 2 and x 4; each gated on the JSON oracle.
    Returns the stripe launches of the striped runs."""
    import torch

    from msa_tpu_torch.goldens import spec_cap as sc
    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.ops import batch
    from msa_tpu_torch.ops import nw_striped as ns
    from msa_tpu_torch.ops import walk as wk
    from msa_tpu_torch.utils.hashing import pair_hash

    gold = sc.load()
    x, y = sc.make_pair()
    card = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    kernels = {"band_fill": bf.band_fill, "walk": wk.walk, "striped_fill": ns.striped_fill}
    striped_launches = 0

    for key, (a, b) in (("xy", (x, y)), ("yx", (y, x))):
        want = gold[key]
        plan = bf.plan_pairs([len(a), len(b)], [(0, 1)], cfg.rb, cfg.snap_k)
        bound_ms, bound_by = band_fill_bound([a, b], [(0, 1)], plan)
        # The walk's bound, from its own output on this pair (uncounted launches).
        table = torch.from_numpy(bf.gene_table([a, b])).cuda()
        fill = bf.band_fill(table, plan, 3, 2)
        wplan = wk.banded_walk_plan(plan)
        walk_bound_ms, walk_bound_by = walk_bound(walk_work(
            *wk.walk(table, wplan, fill.rows, fill.snaps, 3, 2), wplan))
        del table, fill
        for route in ("default", "striped_2", "striped_4", "default", "striped_2", "striped_4"):
            for fn in kernels.values():
                fn.launches = fn.pairs = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if route == "default":
                with launch_events(batch, ["band_fill", "walk"]) as spans:
                    got = batch.align_pairs_batched([a, b], [(0, 1)], 3, 2, device=card, rb=cfg.rb,
                                                    snap_k=cfg.snap_k, config=cfg)[0]
                torch.cuda.synchronize()
                fill = spans["band_fill"][0][0].elapsed_time(spans["band_fill"][0][1])
                route_fill = fill
            else:
                # Events around each stripe's launch, on its thread's stream:
                # the fill is the span from the first stripe's start to the
                # last one's end; the route's fill adds the buffers, the
                # checks and the gather (events around striped_fill, which
                # waits for its stripes).
                count = int(route.split("_")[1])
                with launch_events(ns, ["launch", "striped_fill", "walk"]) as spans:
                    got = ns.nw_align_band_striped(a, b, 3, 2, [card] * count, rb=cfg.rb,
                                                   snap_k=cfg.snap_k)
                torch.cuda.synchronize()
                first = spans["launch"][0][0]
                fill = max(first.elapsed_time(end) for _, end in spans["launch"])
                route_fill = spans["striped_fill"][0][0].elapsed_time(spans["striped_fill"][0][1])
            e2e = (time.perf_counter() - t0) * 1e3
            walk_ms = spans["walk"][0][0].elapsed_time(spans["walk"][0][1])
            launches = {name: fn.launches for name, fn in kernels.items()}
            if (got[0], pair_hash(got[1], got[2]), len(got[1])) != (
                    want["penalty"], want["pair_hash"], want["align_len"]):
                raise AssertionError(f"spec cap {key} {route}: not the oracle's alignment")
            stripes = 1 if route == "default" else count
            if launches["band_fill"] != stripes or launches["walk"] != 1 or \
                    launches["striped_fill"] != (0 if route == "default" else stripes):
                raise AssertionError(f"spec cap {key} {route}: launches {launches}")
            phase("spec_cap", orientation=key, m=len(a), n=len(b), route=route,
                  penalty=got[0], pair_hash=want["pair_hash"][:16], golden=True,
                  fill_ms=fill, route_fill_ms=route_fill, walk_ms=walk_ms, e2e_ms=e2e,
                  peak_device_bytes=torch.cuda.max_memory_allocated(),
                  items=plan.num_items, sms=sms, bound_ms=bound_ms, bound_by=bound_by,
                  share_of_bound=bound_ms / fill, walk_bound_ms=walk_bound_ms,
                  walk_bound_by=walk_bound_by, walk_share_of_bound=walk_bound_ms / walk_ms,
                  launches=launches, card=smi)
            striped_launches += launches["striped_fill"]
    return striped_launches


def spec_cap_cli(smi):
    """The spec-cap pair as a k = 2 input through the CLI, ``--backend cuda``:
    the pair on the device through one fill and one walk, the output golden."""
    from msa_tpu_torch.goldens import spec_cap as sc
    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.ops import walk as wk
    from msa_tpu_torch.utils.hashing import chain_hashes

    x, y = sc.make_pair()
    gold = sc.load()["yx"]  # task 0 aligns gene 1 (y) against gene 0 (x)
    kernels = {"band_fill": bf.band_fill, "walk": wk.walk}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spec_cap.txt")
        with open(path, "w") as f:
            f.write(f"3\n2\n2\n{x}\n{y}\n")
        for fn in kernels.values():
            fn.launches = fn.pairs = 0
        with port_env(fill_mode="banded"):
            lines, seconds = run_cli(["--backend", "cuda", "--input", path])
    launches = {name: fn.launches for name, fn in kernels.items()}
    if lines[1] != chain_hashes([gold["pair_hash"]]) or lines[2].split() != [str(gold["penalty"])]:
        raise AssertionError(f"spec cap through the CLI is not golden: {lines[:3]}")
    if launches != {"band_fill": 1, "walk": 1}:
        raise AssertionError(f"spec cap through the CLI: launches {launches}")
    phase("spec_cap_cli", hash_prefix=lines[1][:16], penalties=lines[2].split(), golden=True,
          launches=launches, seconds=seconds, card=smi)


def check_conveyor_case(name, genes, pairs, rb, snap_k, segments, conveyors=1,
                        split_ramp=False, pxy=3, pgap=2):
    """The conveyor fill and the walk on its layout against their plain versions.

    ``conveyors``: sweeps the bands are placed on (a pair's bands chain
    across them). ``split_ramp``: fail unless a segment boundary lands
    inside a band's ramp.
    """
    import torch

    from msa_tpu_torch.native import nw_align_native
    from msa_tpu_torch.utils.alignment import moves_to_alignment
    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.ops import conveyor as cv
    from msa_tpu_torch.ops import walk as wk
    from msa_tpu_torch.state import valid_brow_cells, valid_conveyor_cells

    wl = cv.plan_sweeps(genes, pairs, rb, snap_k, conveyors)
    plan = wl.plan
    # Bands whose producer lies on another sweep: their top rows cross SMs.
    cross = sum(1 for bp in plan.bands if bp.brow_in and plan.bands[bp.brow_in - 1].sweep != bp.sweep)
    if conveyors > 1 and (wl.num_sweeps != conveyors or not cross):
        raise AssertionError(f"{name}: {wl.num_sweeps} sweeps, {cross} cross-sweep bands")
    table = torch.from_numpy(bf.gene_table(genes)).cuda()
    n_seg = -(-wl.max_chunks // segments)
    ranges = [(c0, min(c0 + n_seg, wl.max_chunks)) for c0 in range(0, wl.max_chunks, n_seg)]
    # A segment boundary inside a ramp (a band's first two chunks at rb = K).
    ramp_split = any(bp.start // snap_k < c0 <= (bp.start + rb) // snap_k
                     for bp in plan.bands for c0, _ in ranges[1:])
    if split_ramp and not ramp_split:
        raise AssertionError(f"{name}: no segment boundary inside a ramp")

    def fill(run):
        state = cv.conveyor_state(wl, table.device)
        for c0, c1 in ranges:
            run(table, wl, pxy, pgap, c0, c1, state)
        return state

    got = fill(cv.conveyor_fill)
    ref, fill_plain_ms = host_ms(lambda: fill(cv.conveyor_fill_ref))
    fill_ms = cuda_ms(lambda: fill(cv.conveyor_fill), reps=3)
    snaps_ok = torch.from_numpy(valid_conveyor_cells(wl)).cuda()
    brow_ok = torch.from_numpy(valid_brow_cells(wl)).cuda()
    fill_err = max(
        (got.score - ref.score).abs().max().item(),
        (got.brow - ref.brow)[brow_ok].abs().max().item(),
        (got.snaps - ref.snaps)[snaps_ok].abs().max().item(),
    )
    if fill_err != 0:
        raise AssertionError(f"{name}: conveyor fill differs from conveyor_fill_ref by {fill_err}")
    phase("conveyor_fill_vs_plain", case=name, pairs=wl.num_pairs, transposed=sum(wl.swapped),
          rb=rb, snap_k=snap_k, bands=len(plan.bands), sweeps=wl.num_sweeps,
          cross_sweep_bands=cross, chunks=plan.n_chunks, segments=len(ranges),
          segment_boundary_in_a_ramp=ramp_split, max_abs_err=fill_err,
          all_entries_equal=all(torch.equal(a, b) for a, b in (
              (got.snaps, ref.snaps), (got.brow, ref.brow), (got.carry, ref.carry))),
          progress=got.progress.tolist() == [c * snap_k for c in plan.sweep_chunks],
          ms=fill_ms, plain_ms=fill_plain_ms)

    wplan = cv.conveyor_walk_plan(wl, genes, range(wl.num_pairs))
    args = (table, wplan, got.brow, got.snaps, pxy, pgap)
    words, counts = wk.walk(*args)
    (rwords, rcounts), walk_plain_ms = host_ms(lambda: wk.walk_ref(*args))
    walk_ms = cuda_ms(lambda: wk.walk(*args), reps=3)
    walk_err = max((words - rwords).abs().max().item(), (counts - rcounts).abs().max().item())
    if walk_err != 0:
        raise AssertionError(f"{name}: walk on the conveyor layout differs from walk_ref by {walk_err}")
    words, counts, scores = words.cpu().numpy(), counts.cpu().numpy(), got.score.cpu().numpy()
    for g in range(wl.num_pairs):
        xi, yi = wl.ordered[g]
        ax, ay = moves_to_alignment(genes[xi], genes[yi], wk.pair_moves(words, counts, wplan, g))
        if wl.swapped[g]:
            ax, ay = ay, ax
        i, j = pairs[wl.order[g]]
        if (int(scores[g]), ax, ay) != nw_align_native(genes[i], genes[j], pxy, pgap):
            raise AssertionError(f"{name}: pair ({i}, {j}) alignment differs from the host oracle")
    phase("conveyor_walk_vs_plain", case=name, sweeps=wl.num_sweeps, moves=[int(c) for c in counts],
          max_abs_err=walk_err, alignments="swapped back, equal to nw_align_native",
          ms=walk_ms, plain_ms=walk_plain_ms)
    out_ints = got.score.numel() + got.brow.numel() + got.snaps.numel()
    return fill_err, fill_ms, fill_plain_ms, fill_bound(genes, pairs, out_ints)


@contextlib.contextmanager
def set_env(values):
    """Environment variables for the block."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def port_env(**values):
    """MSA_TPU_TORCH_* settings for the CLI runs inside the block."""
    return set_env({f"MSA_TPU_TORCH_{k.upper()}": str(v) for k, v in values.items()})


def run_cli(args):
    from msa_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(args)
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {args} returned {rc}")
    return buf.getvalue().split("\n"), seconds


def run_big13(counted):
    """big13 through the CLI on the card, gated on the golden output.

    Every counter in ``counted`` is set to 0 just before the run and read
    just after; returns (seconds, launches, pairs) by kernel name.
    """
    for fn in counted.values():
        fn.launches = 0
        fn.pairs = 0
    lines, seconds = run_cli(["--backend", "cuda", "--input", "data/mseq-big13-example.txt"])
    launches = {name: fn.launches for name, fn in counted.items()}
    device_pairs = {name: fn.pairs for name, fn in counted.items()}
    if lines[1] != BIG13_HASH:
        raise AssertionError(f"big13 hash {lines[1]} is not the golden hash")
    if lines[2].split() != [str(p) for p in BIG13_PENALTIES]:
        raise AssertionError("big13 penalties differ from the golden penalties")
    if min(launches.values()) < 1 or set(device_pairs.values()) != {78}:
        raise AssertionError(f"big13 did not run on the kernels: {launches} {device_pairs}")
    return seconds, launches, device_pairs


def conformance(mode, counted):
    """The six bundled datasets through the CLI under one fill mode, each
    against its golden (``scripts/conformance.py::golden_table``)."""
    from msa_tpu_torch.scripts.conformance import golden_table, matches

    for dataset, gold in golden_table().items():
        counted.pairs = 0
        with port_env(fill_mode=mode):
            lines, seconds = run_cli(["--backend", "cuda", "--input", dataset])
        if not matches(gold, lines[1], [int(v) for v in lines[2].split()]):
            raise AssertionError(f"{dataset}: hash {lines[1]} or penalties are not the golden's")
        phase("conformance", fill_mode=mode, dataset=dataset, hash_prefix=lines[1][:16],
              device_pairs=counted.pairs, seconds=seconds)


def conformance_first_call(smi):
    """``scripts/conformance.py`` on the card: each bundled dataset in a fresh
    process, its first call (CUDA context, kernel load, first run) and three
    warm runs recorded apart, every run gated on the golden."""
    from msa_tpu_torch.scripts import conformance as cf

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "conformance.json")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cf.main(["--platform", "cuda", "--out", out])
        with open(out) as f:
            records = json.load(f)
    for rec in records:
        phase("conformance_first_call", **rec, card=smi)
    if rc != 0 or len(records) != 6:
        raise AssertionError(f"scripts/conformance.py: rc {rc}, {len(records)} datasets")


def check_score_only(name, genes, pairs, rb, snap_k, pxy=3, pgap=2):
    """The fill kernel with snapshots off against its plain version and the full fill."""
    import torch

    from msa_tpu_torch.ops import band_fill as bf

    lengths = [len(g) for g in genes]
    off = bf.plan_pairs(lengths, pairs, rb, snap_k, snaps=False)
    full = bf.plan_pairs(lengths, pairs, rb, snap_k)
    table = torch.from_numpy(bf.gene_table(genes)).cuda()
    got = bf.band_fill(table, off, pxy, pgap)
    ref, plain_ms = host_ms(lambda: bf.band_fill_ref(table, off, pxy, pgap))
    with_snaps = bf.band_fill(table, full, pxy, pgap)
    ms = cuda_ms(lambda: bf.band_fill(table, off, pxy, pgap), reps=3)
    full_ms = cuda_ms(lambda: bf.band_fill(table, full, pxy, pgap), reps=3)
    err = max((got.score - ref.score).abs().max().item(), (got.rows - ref.rows).abs().max().item())
    if err != 0 or got.snaps.numel() != 0:
        raise AssertionError(f"{name}: snapshots-off fill differs from band_fill_ref by {err}")
    if not torch.equal(got.score, with_snaps.score):
        raise AssertionError(f"{name}: snapshots-off scores differ from the full fill's")
    phase("score_only_vs_plain", case=name, pairs=off.num_pairs, rb=rb,
          scores=got.score.tolist(), max_abs_err=err, ms=ms, full_mode_ms=full_ms,
          plain_ms=plain_ms)
    return err, ms, plain_ms


def sharded_scores(problem, cells, smi):
    """Every big13 pair's score, snapshots off, against the golden penalties."""
    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.parallel import engine, mesh

    bf.band_fill.launches = bf.band_fill.pairs = 0
    scores, ms = host_ms(lambda: engine.sharded_pair_scores(problem.genes, problem.pxy, problem.pgap))
    launches, pairs = bf.band_fill.launches, bf.band_fill.pairs
    if scores.tolist() != BIG13_PENALTIES:
        raise AssertionError("big13 sharded scores differ from the golden penalties")
    if launches < 1 or pairs != 78:
        raise AssertionError(f"sharded scores did not run on the kernel: {launches} {pairs}")
    phase("sharded_scores", pairs=len(scores), ms=ms, gcups=cells / ms / 1e6,
          band_fill_launches=launches, device_pairs=pairs,
          devices=[str(d) for d in mesh.local_devices(TorchConfig.from_env())], card=smi)


def calibration(smi):
    """The cost model measured on the card, then read back from its cache."""
    from msa_tpu_torch.parallel import costmodel

    with tempfile.TemporaryDirectory() as cache, set_env({"XDG_CACHE_HOME": cache}):
        t0 = time.perf_counter()
        model = costmodel.calibrate(use_cache=False)
        seconds = time.perf_counter() - t0
        if model is None:
            raise AssertionError("calibrate returned None on the card")
        t0 = time.perf_counter()
        cached = costmodel.calibrate()
        cached_seconds = time.perf_counter() - t0
    if cached != model:
        raise AssertionError(f"cached calibration {cached} differs from {model}")
    phase("calibrate", gcups=model.gcups, fixed_us=model.fixed_us, seconds=seconds,
          cached_seconds=cached_seconds, kernel_version=costmodel.kernel_version(), card=smi)


def two_shards_one_card(counted, smi):
    """big13 with the device pairs split over [cuda:0, cuda:0]: two threads, two shards.

    ``counted``: the kernels of each fill mode, by mode.
    """
    import torch

    from msa_tpu_torch.ops import batch
    from msa_tpu_torch.ops import conveyor as cv
    from msa_tpu_torch.parallel import mesh

    real_devices = mesh.local_devices
    real = {batch: batch.align_pairs_batched, cv: cv.align_pairs_conveyor}
    for mode, kernels in counted.items():
        shards = []
        spies = {}
        for module, fn in real.items():
            def spy(genes, pairs, *a, _fn=fn, **kw):
                shards.append(len(pairs))
                return _fn(genes, pairs, *a, **kw)
            spies[module] = spy
        mesh.local_devices = lambda config: [torch.device("cuda", 0)] * 2
        batch.align_pairs_batched, cv.align_pairs_conveyor = spies[batch], spies[cv]
        try:
            with port_env(fill_mode=mode):
                seconds, launches, device_pairs = run_big13(kernels)
        finally:
            mesh.local_devices = real_devices
            batch.align_pairs_batched, cv.align_pairs_conveyor = real[batch], real[cv]
        if len(shards) != 2 or sum(shards) != 78 or min(launches.values()) < 2:
            raise AssertionError(f"big13 was not split into two shards: {shards} {launches}")
        phase("two_shards_one_card", fill_mode=mode, hash=BIG13_HASH, shard_pairs=shards,
              seconds=seconds, launches=launches, device_pairs=device_pairs, card=smi)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def distributed(smi):
    """big13 through two ``--distributed`` CLI processes on this one card."""
    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.models.kway import choose_fill_mode

    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, MSA_TPU_TORCH_LOG="INFO", XDG_CACHE_HOME=tmp)
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "msa_tpu_torch.cli", "--distributed", "--backend", "cuda",
                 "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                 "--process-id", str(pid), "--input", "data/mseq-big13-example.txt",
                 "--checkpoint", os.path.join(tmp, "j-{proc}.jsonl")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for pid in range(2)
        ]
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        seconds = time.perf_counter() - t0
        for p, (_, err) in zip(procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"distributed process failed:\n{err[-3000:]}")
        lines = outs[0][0].split("\n")
        if lines[1] != BIG13_HASH or lines[2].split() != [str(p) for p in BIG13_PENALTIES]:
            raise AssertionError(f"process 0 printed no golden output: {outs[0][0][:300]}")
        if outs[1][0] != "":
            raise AssertionError(f"process 1 printed: {outs[1][0][:300]}")
        owner = {}
        for pid in range(2):
            with open(os.path.join(tmp, f"j-{pid}.jsonl")) as f:
                for rec in map(json.loads, f):
                    if rec["task_id"] in owner:
                        raise AssertionError(f"task {rec['task_id']} journaled twice")
                    owner[rec["task_id"]] = pid
        if sorted(owner) != list(range(78)):
            raise AssertionError(f"the journals cover {len(owner)} of 78 tasks")
    shards = []
    for _, err in outs:
        line = next(ln for ln in err.splitlines() if "msa_tpu_torch.engine: shard " in ln)
        shards.append(json.loads(line.split("shard ", 1)[1]))
    fill = {"banded": "band_fill", "conveyor": "conveyor_fill"}[choose_fill_mode(TorchConfig())]
    for sh in shards:
        if sh["launches"][fill] < 1 or sh["launches"]["walk"] < 1:
            raise AssertionError(f"process {sh['process']} did not run on the kernels: {sh}")
    phase("distributed", processes=2, hash=BIG13_HASH, seconds=seconds,
          pairs=[sh["pairs"] for sh in shards], policy=shards[0]["policy"],
          launches=[sh["launches"] for sh in shards], time_us=int(lines[0].split()[1]),
          journaled=len(owner), card=smi)


def batched_profile(counted, smi):
    """--batched --profile-dir on xulin_test: golden, and a trace of the kernels."""
    with open("data/host_goldens.jsonl") as f:
        gold = next(g for g in map(json.loads, f) if g["dataset"] == "data/xulin_test.txt")
    for fn in counted.values():
        fn.launches = fn.pairs = 0
    with tempfile.TemporaryDirectory() as prof:
        lines, seconds = run_cli(["--batched", "--backend", "cuda", "--profile-dir", prof,
                                  "--input", gold["dataset"]])
        traces = [os.path.join(prof, f) for f in os.listdir(prof)]
        if len(traces) != 1:
            raise AssertionError(f"--profile-dir wrote {traces}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
    if lines[1] != gold["chain_hash"] or lines[2].split() != [str(p) for p in gold["penalties"]]:
        raise AssertionError(f"xulin_test hash {lines[1]} is not the golden hash")
    kernel_us = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            kernel_us[ev["name"]] = kernel_us.get(ev["name"], 0.0) + float(ev.get("dur", 0))
    fills = [k for k in kernel_us if "fill_kernel" in k]
    walks = [k for k in kernel_us if "walk_kernel" in k]
    if not fills or not walks:
        raise AssertionError(f"the trace names no fill or walk kernel: {sorted(kernel_us)[:20]}")
    phase("batched_profile", dataset=gold["dataset"], hash_prefix=lines[1][:16], seconds=seconds,
          launches={name: fn.launches for name, fn in counted.items()},
          trace_kernel_us={k: kernel_us[k] for k in fills + walks}, card=smi)


def torch_backend(smi):
    """--backend torch on the card: every mseq1 pair through the plain-torch sweep."""
    from msa_tpu_torch.ops import nw_torch

    seen = set()
    real = nw_torch.diag_sweep

    def spy(xpad, *a, **kw):
        seen.add(str(xpad.device))
        return real(xpad, *a, **kw)

    nw_torch.diag_sweep = spy
    try:
        lines, seconds = run_cli(["--backend", "torch", "--input", "data/mseq1.dat"])
    finally:
        nw_torch.diag_sweep = real
    if not lines[1].startswith(MSEQ1_HASH_PREFIX):
        raise AssertionError(f"mseq1 hash {lines[1]} is not the golden hash")
    if seen != {"cuda:0"}:
        raise AssertionError(f"the torch backend's sweeps ran on {seen}")
    phase("torch_backend", dataset="data/mseq1.dat", hash_prefix=lines[1][:16], sweep_devices=sorted(seen),
          seconds=seconds, card=smi)


def rb_sweep(table, genes, pairs, problem, cfg, smi):
    """The banded fill and its walk on big13 at each band height, by events."""
    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.ops import walk as wk

    times = {}
    for rb in (1023, 2047, 4095, 8191):
        plan = bf.plan_pairs([len(g) for g in genes], pairs, rb, cfg.snap_k)
        holder = {}

        def fill_once():
            holder["fill"] = bf.band_fill(table, plan, problem.pxy, problem.pgap)

        fill_ms = cuda_ms(fill_once, reps=1)
        if holder["fill"].score.tolist() != BIG13_PENALTIES:
            raise AssertionError(f"big13 scores at rb {rb} differ from the golden penalties")
        wplan = wk.banded_walk_plan(plan)
        walk_ms = cuda_ms(lambda: wk.walk(table, wplan, holder["fill"].rows, holder["fill"].snaps,
                                          problem.pxy, problem.pgap), reps=1)
        del holder["fill"]
        times[rb] = fill_ms + walk_ms
        phase("big13_rb_sweep", rb=rb, fill_ms=fill_ms, walk_ms=walk_ms, items=plan.num_items,
              blocks=bf.band_fill.blocks, snapshot_bytes=plan.snapshot_bytes, card=smi)
    phase("big13_rb_choice", fastest_rb=min(times, key=times.get), config_rb=cfg.rb,
          fill_plus_walk_ms=times, card=smi)


def fill_mode_ab(banded, conveyor, smi):
    """big13 end to end, banded and conveyor alternating, three runs each."""
    seconds = {"banded": [], "conveyor": []}
    for mode in ("banded", "conveyor", "conveyor", "banded", "banded", "conveyor"):
        with port_env(fill_mode=mode):
            s, _, _ = run_big13(banded if mode == "banded" else conveyor)
        seconds[mode].append(s)
    phase("big13_fill_mode_ab", seconds=seconds,
          faster=min(seconds, key=lambda k: sorted(seconds[k])[1]), card=smi)


def conveyor_sweep_choice(genes, pairs, conveyor, resident, default, smi, conveyor_kernels,
                          fill_fields):
    """big13 under fill_mode=conveyor with every resident sweep (one an SM
    at rb_conveyor 7168) and with 16 and 32 SMs left to the walks of the
    segments before (the default): the fill and the walk alone, then end to
    end in turns, three runs each."""
    import statistics

    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.ops import conveyor as cv

    cfg = TorchConfig()
    counts = [resident, resident - 16, resident - 32]
    for count in counts:
        wl = cv.plan_sweeps(genes, pairs, cfg.rb_conveyor, cfg.snap_k, count)
        fill_ms, walk_ms, _ = conveyor_kernels(wl)
        phase("big13_conveyor_sweeps", conveyors=count, **fill_fields(wl, fill_ms), walk_ms=walk_ms,
              card=smi)
    seconds = {count: [] for count in counts}
    for count in counts + counts[::-1] + counts:
        with port_env(fill_mode="conveyor", conveyors=count):
            s, _, _ = run_big13(conveyor)
        seconds[count].append(s)
    phase("big13_conveyor_sweeps_e2e", seconds=seconds, default=default,
          median={c: statistics.median(s) for c, s in seconds.items()},
          faster=min(counts, key=lambda c: statistics.median(seconds[c])), card=smi)


def one_band_problem():
    """The workload of ``gen_workload --k 48 --min-len 6000 --max-len 7168
    --dist uniform --seed 0``, made in-process: 48 sequences, so 1,128 pairs
    of one band each at either band height."""
    from msa_tpu_torch.scripts.gen_workload import make_problem

    return make_problem(k=48, min_len=6000, max_len=7168, dist="uniform", seed=0)


def one_band_ab(banded, conveyor, smi):
    """The fill-mode A/B on a workload of one-band pairs, where the
    conveyor's ramps should pay: banded and conveyor alternating, three runs
    each, through ``align_kway``; both modes give the same chain hash and
    penalties, and 4 pairs the native oracle's alignment. Records the fill
    kernels' device time (CUDA events around each launch), the wall time and
    the peak device memory."""
    import statistics

    import torch

    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.models.kway import align_kway
    from msa_tpu_torch.native import nw_align_native
    from msa_tpu_torch.ops import batch
    from msa_tpu_torch.ops import conveyor as cv
    from msa_tpu_torch.utils.tasks import pair_task_list

    problem = one_band_problem()
    genes = problem.genes
    tasks = pair_task_list(len(genes))
    cells = sum(len(genes[t.i]) * len(genes[t.j]) for t in tasks)
    modes = {"banded": (banded, batch, "band_fill"), "conveyor": (conveyor, cv, "conveyor_fill")}
    runs = {mode: [] for mode in modes}
    outputs = {}
    for mode in ("banded", "conveyor", "conveyor", "banded", "banded", "conveyor"):
        kernels, module, fill = modes[mode]
        for fn in kernels.values():
            fn.launches = fn.pairs = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with port_env(fill_mode=mode), launch_events(module, [fill]) as spans:
            t0 = time.perf_counter()
            res = align_kway(problem, backend="cuda", keep_alignments=True,
                             config=TorchConfig.from_env())
            seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in kernels.items()}
        if min(launches.values()) < 1 or kernels[fill].pairs != len(tasks):
            raise AssertionError(f"one-band {mode}: not all pairs on the kernels: {launches}")
        outputs.setdefault(mode, (res.chain_hash, res.penalties))
        if (res.chain_hash, res.penalties) != outputs[mode]:
            raise AssertionError(f"one-band {mode}: the runs differ")
        for t in (tasks[0], tasks[377], tasks[751], tasks[-1]):
            r = res.pair_results[t.task_id]
            want = nw_align_native(genes[t.i], genes[t.j], problem.pxy, problem.pgap)
            if (r.penalty, r.align1, r.align2) != want:
                raise AssertionError(f"one-band {mode}: task {t.task_id} differs from the native oracle")
        run = {"seconds": seconds, "gcups": cells / seconds / 1e9,
               "fill_ms": sum(a.elapsed_time(b) for a, b in spans[fill]),
               "fill_launches": launches[fill], "peak_device_bytes": torch.cuda.max_memory_allocated()}
        runs[mode].append(run)
        phase("one_band_ab", fill_mode=mode, pairs=len(tasks), cells=cells,
              hash_prefix=res.chain_hash[:16], oracle_pairs=4, **run, card=smi)
    if outputs["banded"] != outputs["conveyor"]:
        raise AssertionError("one-band: banded and conveyor give different outputs")
    median = {mode: {k: statistics.median(r[k] for r in rs) for k in ("seconds", "fill_ms")}
              for mode, rs in runs.items()}
    phase("one_band_ab_summary", hash=outputs["banded"][0], median=median,
          faster_e2e=min(median, key=lambda m: median[m]["seconds"]),
          faster_fill=min(median, key=lambda m: median[m]["fill_ms"]), card=smi)


@contextlib.contextmanager
def launch_events(module, names):
    """Record a CUDA event before and after each call of ``module.<name>``,
    on the stream current at the call; yields {name: [(start, end), ...]}."""
    import torch

    spans = {name: [] for name in names}
    real = {name: getattr(module, name) for name in names}

    def timed(name):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[name](*a, **kw)
            end.record()
            spans[name].append((start, end))
            return out
        # A wrapper defined in ``module`` counts its launches under its
        # module name, which is this function while the block runs.
        call.launches = call.pairs = 0
        return call

    for name in names:
        setattr(module, name, timed(name))
    try:
        yield spans
    finally:
        for name in names:
            spy = getattr(module, name)
            setattr(module, name, real[name])
            if hasattr(real[name], "launches"):
                real[name].launches += spy.launches
                real[name].pairs += spy.pairs


def big13_waves(genes, pairs, banded, cfg, smi):
    """big13 under fill_mode=banded in one wave, in two (the default: a wave
    takes at most half the pairs' bytes, ``batch.HALVES``) and under a
    budget forced to four or more, in turns (1, 4+, 2, 2, 4+, 1): golden
    each time, with the fill's and the walk's device time (CUDA events
    around each launch), the device's span from the first fill to the last
    walk, the rest of the wall time, and the peak device memory."""
    import torch

    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.ops import batch

    sizes = batch.pair_bytes(bf.plan_pairs([len(g) for g in genes], pairs, cfg.rb, cfg.snap_k))
    total, biggest = int(sizes.sum()), int(sizes.max())
    # (HALVES, budget (0: the card's), waves): a wave takes at most half the
    # budget, and the greedy cut in size order fills each wave but the last
    # past its cap less the biggest pair.
    settings = {"one": (1, 0, 1), "two": (batch.HALVES, 0, 2),
                "four_plus": (batch.HALVES, 2 * max(biggest, -(-total // 4)), 4)}
    runs = {name: [] for name in settings}
    default_halves = batch.HALVES
    for name in ("one", "four_plus", "two", "two", "four_plus", "one"):
        halves, budget, waves = settings[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        batch.HALVES = halves
        try:
            with port_env(fill_mode="banded", hbm_budget=budget), \
                    launch_events(batch, ["band_fill", "walk"]) as spans:
                seconds, launches, _ = run_big13(banded)
        finally:
            batch.HALVES = default_halves
        torch.cuda.synchronize()
        got = len(spans["band_fill"])
        if got != len(spans["walk"]) or not (got == waves if waves < 4 else got >= waves):
            raise AssertionError(f"big13 {name}: {launches} launches, expected {waves} waves")
        first, last = spans["band_fill"][0][0], spans["walk"][-1][1]
        fill_ms = sum(a.elapsed_time(b) for a, b in spans["band_fill"])
        walk_ms = sum(a.elapsed_time(b) for a, b in spans["walk"])
        run = {"seconds": seconds, "waves": got, "fill_ms": fill_ms, "walk_ms": walk_ms,
               "device_span_ms": first.elapsed_time(last),
               "rest_ms": seconds * 1e3 - fill_ms - walk_ms,
               "peak_device_bytes": torch.cuda.max_memory_allocated()}
        runs[name].append(run)
        phase("big13_waves", run=name, halves=halves, budget=budget, hash=BIG13_HASH, **run,
              card=smi)
    phase("big13_waves_summary", seconds={k: [r["seconds"] for r in v] for k, v in runs.items()},
          faster=min(runs, key=lambda k: min(r["seconds"] for r in runs[k])),
          wave_bytes_total=total, biggest_pair_bytes=biggest, card=smi)


@contextlib.contextmanager
def stage_timers(stages):
    """Host time of each stage, summed over the threads that ran it, while
    the block runs. ``stages``: {name: (module, attribute)}; yields
    {"totals": {name: [seconds, calls]}, "decode_span": [first start, last
    end]} (the span of the "decode_moves" and "moves_to_alignment" stages)."""
    import threading

    lock = threading.Lock()
    rec = {"totals": {name: [0.0, 0] for name in stages}, "decode_span": [None, None]}
    span = rec["decode_span"]
    real = {name: getattr(mod, attr) for name, (mod, attr) in stages.items()}

    def timed(name):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            t1 = time.perf_counter()
            with lock:
                rec["totals"][name][0] += t1 - t0
                rec["totals"][name][1] += 1
                if name in ("decode_moves", "moves_to_alignment"):
                    span[0] = min(span[0] or t0, t0)
                    span[1] = max(span[1] or t1, t1)
            return out
        return call

    for name, (mod, attr) in stages.items():
        setattr(mod, attr, timed(name))
    try:
        yield rec
    finally:
        for name, (mod, attr) in stages.items():
            setattr(mod, attr, real[name])


def host_stages(smi):
    """Where big13's wall time goes under fill_mode=auto: host time of each
    stage (summed over the threads that ran it), the kernels' device time
    by events, and when the device finished, from the run's start."""
    import torch

    from msa_tpu_torch.models import kway
    from msa_tpu_torch.ops import batch
    from msa_tpu_torch.utils import msaio

    stages = {
        "parse": (msaio, "parse_file"), "plan": (batch, "plan_pairs"),
        "walk_plan": (batch, "banded_walk_plan"), "gene_table": (batch, "gene_table"),
        "fill_enqueue": (batch, "band_fill"), "walk_enqueue": (batch, "walk"),
        "decode_moves": (batch, "pair_moves"), "moves_to_alignment": (batch, "moves_to_alignment"),
        "pair_hash": (kway, "pair_hash"), "chain": (kway, "chain_hashes"),
    }
    with stage_timers(stages) as rec:
        torch.cuda.synchronize()
        mark = torch.cuda.Event(enable_timing=True)
        mark.record()
        with port_env(fill_mode="auto"), launch_events(batch, ["band_fill", "walk"]) as spans:
            t0 = time.perf_counter()
            lines, seconds = run_cli(["--backend", "cuda", "--input", "data/mseq-big13-example.txt"])
        torch.cuda.synchronize()
    if lines[1] != BIG13_HASH or lines[2].split() != [str(p) for p in BIG13_PENALTIES]:
        raise AssertionError("big13 under the stage timers is not golden")
    totals, decode_span = rec["totals"], rec["decode_span"]
    phase("big13_host_stages", fill_mode="auto", hash=BIG13_HASH, seconds=seconds,
          stages_ms={k: v[0] * 1e3 for k, v in totals.items()},
          calls={k: v[1] for k, v in totals.items()},
          decode_wall_ms=(decode_span[1] - decode_span[0]) * 1e3,
          decode_ends_after_start_ms=(decode_span[1] - t0) * 1e3,
          fill_device_ms=[a.elapsed_time(b) for a, b in spans["band_fill"]],
          walk_device_ms=[a.elapsed_time(b) for a, b in spans["walk"]],
          device_done_after_start_ms=mark.elapsed_time(spans["walk"][-1][1]),
          card=smi)


@contextlib.contextmanager
def arg_spy(module, name, record):
    """Append ``record(*args, **kwargs)`` of each call of ``module.<name>``
    in the block to the list it yields."""
    seen = []
    real = getattr(module, name)

    def call(*a, **kw):
        seen.append(record(*a, **kw))
        return real(*a, **kw)

    setattr(module, name, call)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def pod_oracle(problem, tasks, count, seed):
    """{task index: the native host kernel's (penalty, align1, align2)} of
    ``count`` tasks: the largest pair, the smallest, and the rest drawn by
    ``seed``; computed on threads (the host kernel releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from msa_tpu_torch.native import nw_align_native

    genes = problem.genes
    cost = [len(genes[t.i]) * len(genes[t.j]) for t in tasks]
    ends = [max(range(len(tasks)), key=cost.__getitem__), min(range(len(tasks)), key=cost.__getitem__)]
    rest = np.setdiff1d(np.arange(len(tasks)), ends)
    picked = ends + sorted(np.random.default_rng(seed).choice(rest, count - 2, replace=False).tolist())
    with ThreadPoolExecutor(len(picked)) as pool:
        want = pool.map(lambda t: nw_align_native(genes[tasks[t].i], genes[tasks[t].j],
                                                  problem.pxy, problem.pgap), picked)
        return dict(zip(picked, want))


def pod_check(name, golden, chain_hash, penalties):
    """Fail unless the output is the golden's: chain hash and every penalty."""
    if chain_hash == golden["chain_hash"] and list(penalties) == golden["penalties"]:
        return
    differ = [t for t, (a, b) in enumerate(zip(penalties, golden["penalties"])) if a != b]
    raise AssertionError(
        f"{name}: not golden: hash {chain_hash[:16]} (golden {golden['chain_hash'][:16]}),"
        f" {len(penalties)} penalties, first task ids whose penalty differs: {differ[:20]}")


def pod_run(name, problem, golden, mode, oracle, smi, hbm_budget=0, min_parts=1):
    """One pod workload through ``align_kway`` on the card under ``mode``,
    gated on the golden's hash and penalties and on ``oracle``'s alignments.
    Prints the waves (banded: one fill launch each, its pairs and bytes) or
    the halves (conveyor: one ``conveyor_state`` each), each fill and walk
    launch's device ms (CUDA events) and the walk's blocks, the device span
    from the first fill to the last walk, its idle share (1 - the kernels'
    summed event time over the wall), peak device memory beside the card's
    total, the host decode and ``pair_hash``."""
    import gc

    import torch

    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.models import kway
    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.ops import batch
    from msa_tpu_torch.ops import conveyor as cv
    from msa_tpu_torch.ops import walk as wk

    banded = mode != "conveyor"
    module, fill = (batch, "band_fill") if banded else (cv, "conveyor_fill")
    kernels = {fill: getattr(bf if banded else cv, fill), "walk": wk.walk}
    genes = problem.genes
    num = golden["pairs"]
    dev = torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    cfg = TorchConfig.from_env(fill_mode=mode, hbm_budget=hbm_budget)
    budget = bf.device_budget(dev, cfg.hbm_budget)
    if banded:
        parts_spy = arg_spy(batch, "band_fill", lambda table, plan, *a: {
            "pairs": plan.num_pairs, "bytes": int(batch.pair_bytes(plan).sum()),
            "items": plan.num_items})
    else:
        parts_spy = arg_spy(cv, "conveyor_state", lambda wl, device: {
            "pairs": wl.num_pairs, "snapshot_bytes": wl.snapshot_bytes, "sweeps": wl.num_sweeps})
    stages = {"decode_moves": (module, "pair_moves"),
              "moves_to_alignment": (module, "moves_to_alignment"),
              "pair_hash": (kway, "pair_hash"), "chain": (kway, "chain_hashes")}
    for fn in kernels.values():
        fn.launches = fn.pairs = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with stage_timers(stages) as rec, parts_spy as parts, \
            arg_spy(module, "walk", lambda table, wplan, *a: wplan.num_pairs) as walk_blocks, \
            launch_events(module, [fill, "walk"]) as spans:
        t0 = time.perf_counter()
        res = kway.align_kway(problem, backend="cuda", keep_alignments=True, config=cfg)
        seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    if min(launches.values()) < 1 or kernels[fill].pairs != num:
        raise AssertionError(f"{name} {mode}: not every pair on the kernels: {launches}")
    pod_check(f"{name} {mode}", golden, res.chain_hash, res.penalties)
    for t, want in oracle.items():
        r = res.pair_results[t]
        if (r.penalty, r.align1, r.align2) != want:
            raise AssertionError(f"{name} {mode}: task {t} differs from nw_align_native")
    if len(parts) < min_parts:
        raise AssertionError(f"{name} {mode}: {len(parts)} parts, expected {min_parts} or more")
    del res
    fill_ms = [a.elapsed_time(b) for a, b in spans[fill]]
    walk_ms = [a.elapsed_time(b) for a, b in spans["walk"]]
    busy = sum(fill_ms) + sum(walk_ms)
    totals, span = rec["totals"], rec["decode_span"]
    fields = {
        "fill_mode": mode, "pairs": num, "cells": golden["cells"], "seconds": seconds,
        "gcups": golden["cells"] / seconds / 1e9, "hash_prefix": golden["chain_hash"][:16],
        "golden": True, "oracle_pairs": sorted(oracle), "free_at_start_bytes": free,
        "device_budget_bytes": budget, "hbm_budget": hbm_budget,
        ("waves" if banded else "halves"): parts, "fill_ms": fill_ms, "walk_ms": walk_ms,
        "walk_blocks": walk_blocks,
        "device_span_ms": spans[fill][0][0].elapsed_time(spans["walk"][-1][1]),
        "busy_ms": busy, "idle_share": max(0.0, 1 - busy / (seconds * 1e3)),
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev), "card_total_bytes": total,
        "decode_ms": (totals["decode_moves"][0] + totals["moves_to_alignment"][0]) * 1e3,
        "decode_wall_ms": (span[1] - span[0]) * 1e3,
        "pair_hash_ms": totals["pair_hash"][0] * 1e3, "chain_ms": totals["chain"][0] * 1e3,
        "launches": launches}
    phase(name, **fields, card=smi)


def pod64(smi):
    """``gen_workload --k 64`` (2,016 pairs) against ``goldens/pod64.json``
    under ``auto`` (two waves), ``banded`` with a budget forced to four
    waves or more, ``conveyor``, and ``conveyor`` with a budget forced
    under a third of its snapshots (its split in halves, twice over); then
    the fill-mode A/B through ``scripts/ab_compare.py``, three runs each,
    alternating."""
    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.goldens import pod
    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.ops import batch
    from msa_tpu_torch.ops import conveyor as cv
    from msa_tpu_torch.scripts import ab_compare
    from msa_tpu_torch.utils.tasks import pair_task_list

    golden = pod.load(64)
    problem = pod.problem_of(golden)
    tasks = pair_task_list(problem.k)
    oracle = pod_oracle(problem, tasks, 4, seed=64)
    cfg = TorchConfig()
    sizes = batch.pair_bytes(bf.plan_pairs([len(g) for g in problem.genes],
                                           [(t.i, t.j) for t in tasks], cfg.rb, cfg.snap_k))
    four = 2 * max(int(sizes.max()), -(-int(sizes.sum()) // 4))
    pod_run("pod64", problem, golden, "auto", oracle, smi, min_parts=2)
    pod_run("pod64", problem, golden, "banded", oracle, smi, hbm_budget=four, min_parts=4)
    pod_run("pod64", problem, golden, "conveyor", oracle, smi)
    import torch

    wl = cv.plan_sweeps(problem.genes, [(t.i, t.j) for t in tasks], cfg.rb_conveyor, cfg.snap_k,
                        cv.conveyor_sweeps(cfg, torch.device("cuda", 0)))
    pod_run("pod64", problem, golden, "conveyor", oracle, smi, hbm_budget=wl.snapshot_bytes // 3,
            min_parts=4)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ab_compare.main(["--gen", "k=64", "--reps", "3",
                              "--config", "banded:fill_mode=banded",
                              "--config", "conveyor:fill_mode=conveyor"])
    summary = json.loads(buf.getvalue().strip().splitlines()[-1]) if rc == 0 else {}
    if rc != 0 or not summary["golden"]:
        raise AssertionError(f"pod64 A/B: rc {rc}, not gated on the golden: {buf.getvalue()[-500:]}")
    phase("pod64_fill_mode_ab", **summary, card=smi)


def pod256(smi):
    """``gen_workload --k 256`` (32,640 pairs, over the card's memory)
    against ``goldens/pod256.json``: through the CLI in a fresh process,
    then in this process under ``auto`` (waves that ``device_budget``
    gives: three or more) and ``conveyor`` (halves); 8 pairs against the
    native host kernel."""
    import gc

    import torch

    from msa_tpu_torch.goldens import pod
    from msa_tpu_torch.scripts.gen_workload import write_problem
    from msa_tpu_torch.utils.tasks import pair_task_list

    golden = pod.load(256)
    problem = pod.problem_of(golden)
    oracle = pod_oracle(problem, pair_task_list(problem.k), 8, seed=256)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pod256.dat")
        with open(path, "w") as f:
            write_problem(problem, f)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "msa_tpu_torch.cli", "--input", path],
                              capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"pod256 through the CLI failed:\n{proc.stderr[-3000:]}")
    lines = proc.stdout.split("\n")
    pod_check("pod256 cli", golden, lines[1], [int(v) for v in lines[2].split()])
    phase("pod256_cli", time_line=lines[0], wall_seconds=wall, hash_prefix=lines[1][:16],
          penalties=len(lines[2].split()), golden=True, card=smi)
    pod_run("pod256", problem, golden, "auto", oracle, smi, min_parts=3)
    pod_run("pod256", problem, golden, "conveyor", oracle, smi)


def sync_all():
    import torch

    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def wall_ms(fn):
    """(fn(), milliseconds on the host clock, every card synchronised)."""
    sync_all()
    t0 = time.perf_counter()
    out = fn()
    sync_all()
    return out, (time.perf_counter() - t0) * 1e3


def cards_main() -> int:
    """``--cards``: a lone pair's striped fill across distinct cards (see the
    module docstring)."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke --cards: needs two CUDA devices or more", file=sys.stderr)
        return 1
    import numpy as np

    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.goldens import spec_cap as sc
    from msa_tpu_torch.ops import _build, batch
    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.ops import nw_striped as ns
    from msa_tpu_torch.utils.hashing import pair_hash

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    count = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(count)]
    widths = sorted({2, count})
    peers = {f"{a}->{a + 1}": torch.cuda.can_device_access_peer(a, a + 1) for a in range(count - 1)}
    for name in ("band_fill", "walk"):
        _build.load(name)
    phase("setup", cards=smi, count=count, peer_access=peers)

    # 2. the 20-band pair across cards against one launch
    cfg = TorchConfig()
    rng = np.random.default_rng(2024)
    random_genes(rng, [2600, 3400, 4100])
    main_geom = random_genes(rng, [20000, 17000])  # main()'s main geometry, same seed
    plan = bf.plan_pairs([20000, 17000], [(0, 1)], 1023, cfg.snap_k)
    codes = torch.from_numpy(bf.gene_table(main_geom))
    tables = [codes.to(d) for d in cards]
    one, one_ms = wall_ms(lambda: bf.band_fill(tables[0], plan, 3, 2))
    for d in widths:
        got, ms = wall_ms(lambda: ns.striped_fill(tables[:d], plan, cards[:d], 3, 2))
        err = max((a - b).abs().max().item() for a, b in (
            (got.score, one.score), (got.rows, one.rows), (got.snaps, one.snaps)))
        if err != 0 or got.snaps.device != cards[0]:
            raise AssertionError(f"20 bands over {d} cards differ from one launch by {err}")
        phase("cards_fill", case="twenty_bands", cards=d, max_abs_err=err,
              stripe_bands=[[s.lo, s.hi] for s in bf.plan_stripes(plan, d)],
              striped_host_ms=ms, one_launch_host_ms=one_ms, card=smi[0])
    del one, got

    # 3. the spec-cap pair: one launch, stripes on one card, stripes on D cards
    gold = sc.load()
    x, y = sc.make_pair()
    routes = ["one_launch"] + [f"{where}_{d}" for d in widths for where in ("one_card", "cards")]
    for key, (a, b) in (("xy", (x, y)), ("yx", (y, x))):
        want = gold[key]
        plan = bf.plan_pairs([len(a), len(b)], [(0, 1)], cfg.rb, cfg.snap_k)
        bound_ms, bound_by = band_fill_bound([a, b], [(0, 1)], plan)
        pair_tables = {d: torch.from_numpy(bf.gene_table([a, b])).to(d) for d in cards}
        for route in routes + routes[::-1]:
            if route == "one_launch":
                devices = [cards[0]]
            else:
                where, d = route.rsplit("_", 1)
                devices = [cards[0]] * int(d) if where == "one_card" else cards[: int(d)]
            for dev in cards:
                torch.cuda.reset_peak_memory_stats(dev)
            if route == "one_launch":
                # [1]: the fill's output is freed before the route runs.
                fill_ms = wall_ms(lambda: bf.band_fill(pair_tables[cards[0]], plan, 3, 2))[1]
                got, e2e = wall_ms(lambda: batch.align_pairs_batched(
                    [a, b], [(0, 1)], 3, 2, device=cards[0], rb=cfg.rb, snap_k=cfg.snap_k,
                    config=cfg)[0])
            else:
                fill_ms = wall_ms(lambda: ns.striped_fill(
                    [pair_tables[d] for d in devices], plan, devices, 3, 2))[1]
                got, e2e = wall_ms(lambda: ns.nw_align_band_striped(
                    a, b, 3, 2, devices, rb=cfg.rb, snap_k=cfg.snap_k))
            if (got[0], pair_hash(got[1], got[2]), len(got[1])) != (
                    want["penalty"], want["pair_hash"], want["align_len"]):
                raise AssertionError(f"spec cap {key} {route}: not the oracle's alignment")
            phase("cards_spec_cap", orientation=key, route=route, devices=[str(d) for d in devices],
                  penalty=got[0], pair_hash=want["pair_hash"][:16], golden=True,
                  fill_host_ms=fill_ms, e2e_host_ms=e2e, bound_ms=bound_ms, bound_by=bound_by,
                  peak_device_bytes=[torch.cuda.max_memory_allocated(d) for d in cards],
                  card=smi[0])
    print(json.dumps({"ok": True, "cards": count, "card": smi[0]}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from msa_tpu_torch.utils.msaio import parse_file
    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.models.kway import choose_fill_mode
    from msa_tpu_torch.ops import _build
    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.ops import conveyor as cv
    from msa_tpu_torch.ops import walk as wk

    import walk_ablation

    # 1. setup
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    phase("setup", torch=torch.__version__, cuda=torch.version.cuda,
          nvcc=_build.nvcc_path(), card=smi, build_seconds=build_s,
          ptxas=[line.strip() for log in logs.values() for line in log.splitlines()
                 if "registers" in line or "spill" in line])
    for name in _build.SIGNATURES:
        _build.load(name)

    # 2-3. kernels against their plain versions
    rng = np.random.default_rng(2024)
    small = random_genes(rng, [2600, 3400, 4100])
    check_case("small", small, [(1, 0), (2, 0), (2, 1)], rb=1023, snap_k=1024)
    main_geom = random_genes(rng, [20000, 17000])
    cfg = TorchConfig()
    timed = check_case("main_geometry", main_geom, [(0, 1)], rb=cfg.rb, snap_k=cfg.snap_k)
    # The pipelined fill: 20 bands a pair; more items than resident blocks;
    # skewed pairs (one band of 70,000 steps; nine bands of 6 columns).
    ref20, one20 = check_fill("twenty_bands", main_geom, [(0, 1)], rb=1023, snap_k=cfg.snap_k)
    # The same pair in stripes over one card, against both.
    check_striped("twenty_bands", main_geom, 1023, cfg.snap_k, ref20, one20, smi)
    del ref20, one20
    many = random_genes(rng, [int(v) for v in rng.integers(600, 3001, 25)])
    check_fill("many_items", many, [(i, j) for i in range(1, 25) for j in range(i)],
               rb=255, snap_k=cfg.snap_k)
    check_fill("skew", random_genes(rng, [70000, 6]), [(0, 1), (1, 0)], rb=cfg.rb,
               snap_k=cfg.snap_k)

    # 4. big13 end to end on the card, banded fill
    problem = parse_file("data/mseq-big13-example.txt")
    genes = problem.genes
    pairs = [(i, j) for i in range(1, len(genes)) for j in range(i)]
    cells = sum(len(genes[i]) * len(genes[j]) for i, j in pairs)
    banded = {"band_fill": bf.band_fill, "walk": wk.walk}
    torch.cuda.reset_peak_memory_stats()
    runs = []
    with port_env(fill_mode="banded"):
        for _ in range(2):
            seconds, launches, device_pairs = run_big13(banded)
            runs.append(seconds)
    plan = bf.plan_pairs([len(g) for g in genes], pairs, cfg.rb, cfg.snap_k)
    phase("big13_e2e", fill_mode="banded", hash=BIG13_HASH, penalties=len(BIG13_PENALTIES),
          seconds=runs, gcups=[cells / t / 1e9 for t in runs], cells=cells, launches=launches,
          device_pairs=device_pairs, snapshot_bytes=plan.snapshot_bytes,
          peak_device_bytes=torch.cuda.max_memory_allocated(), card=smi)

    # Where the end-to-end time goes: each kernel alone on big13, by events.
    table = torch.from_numpy(bf.gene_table(genes)).cuda()
    holder = {}

    def fill_once():
        holder["fill"] = bf.band_fill(table, plan, problem.pxy, problem.pgap)

    wplan = wk.banded_walk_plan(plan)
    fill_ms = cuda_ms(fill_once, reps=1)
    walk_args = (table, wplan, holder["fill"].rows, holder["fill"].snaps, problem.pxy, problem.pgap)
    walk_ms = cuda_ms(lambda: wk.walk(*walk_args), reps=3)
    banded_work = walk_work(*wk.walk(*walk_args), wplan)
    phase("big13_kernels", fill_mode="banded", fill_ms=fill_ms, walk_ms=walk_ms,
          fill_gcups=cells / fill_ms / 1e6, items=plan.num_items, blocks=bf.band_fill.blocks,
          rest_of_e2e_ms=min(runs) * 1e3 - fill_ms - walk_ms, card=smi)
    # The walk on big13, banded layout, and what its design pays.
    walk_phase("banded", walk_ms, banded_work, smi, rb=cfg.rb, snap_k=cfg.snap_k)
    walk_ablation.ablate(*walk_args, smi, phase)
    del walk_args, holder["fill"]
    rb_sweep(table, genes, pairs, problem, cfg, smi)
    # The banded pipeline in waves, and where the main path's time goes.
    big13_waves(genes, pairs, banded, cfg, smi)
    host_stages(smi)

    lines, seconds = run_cli(["--backend", "cuda", "--input", "data/mseq1.dat"])
    if not lines[1].startswith(MSEQ1_HASH_PREFIX):
        raise AssertionError(f"mseq1 hash {lines[1]} is not the golden hash")
    phase("mseq1_host", hash_prefix=lines[1][:16], seconds=seconds)
    conformance("banded", bf.band_fill)

    # 5. the conveyor fill and the walk on its layout against their plain versions
    skew = random_genes(rng, [2600, 16, 2100, 40, 900])
    skew_pairs = [(i, j) for i in range(1, 5) for j in range(i)] + [(1, 0), (0, 1)]
    check_conveyor_case("multi_tenant", skew, skew_pairs, rb=1024, snap_k=cfg.snap_k,
                        segments=cfg.fill_segments, split_ramp=True)
    conv_geom = random_genes(rng, [20000, 15000, 17500])
    check_conveyor_case("main_geometry", conv_geom, [(1, 0), (2, 0), (2, 1)], rb=cfg.rb_conveyor,
                        snap_k=cfg.snap_k, segments=cfg.fill_segments)
    # Bands chained across sweeps: the main geometry on 3 sweeps, and one
    # pair of 12 bands (12,100 x 1,500 as oriented) on 4.
    conveyor_timed = check_conveyor_case(
        "main_geometry_3_sweeps", conv_geom, [(1, 0), (2, 0), (2, 1)], rb=cfg.rb_conveyor,
        snap_k=cfg.snap_k, segments=cfg.fill_segments, conveyors=3)
    check_conveyor_case("cross_sweep_12_bands", random_genes(rng, [12100, 4500]), [(0, 1)],
                        rb=1024, snap_k=256, segments=cfg.fill_segments, conveyors=4)

    # 6. big13 end to end on the card, conveyor fill, at the default sweep
    # count (every resident sweep but 32 SMs' worth) and at 26
    conveyor = {"conveyor_fill": cv.conveyor_fill, "walk": wk.walk}
    torch.cuda.reset_peak_memory_stats()
    conv_runs = []
    with port_env(fill_mode="conveyor"):
        for _ in range(2):
            seconds, conv_launches, conv_pairs = run_big13(conveyor)
            conv_runs.append(seconds)
    dev = torch.device("cuda")
    resident = cv.resident_sweeps(cfg.rb_conveyor, cfg.snap_k, dev)
    wl = cv.plan_sweeps(genes, pairs, cfg.rb_conveyor, cfg.snap_k, cv.conveyor_sweeps(cfg, dev))
    phase("big13_e2e", fill_mode="conveyor", hash=BIG13_HASH, penalties=len(BIG13_PENALTIES),
          seconds=conv_runs, gcups=[cells / t / 1e9 for t in conv_runs], cells=cells,
          launches=conv_launches, device_pairs=conv_pairs, sweeps=wl.num_sweeps,
          resident_sweeps=resident, snapshot_bytes=wl.snapshot_bytes,
          peak_device_bytes=torch.cuda.max_memory_allocated(), card=smi)
    with port_env(fill_mode="conveyor", conveyors=26):
        seconds26, launches26, pairs26 = run_big13(conveyor)
    wl26 = cv.plan_sweeps(genes, pairs, cfg.rb_conveyor, cfg.snap_k, 26)
    phase("big13_e2e", fill_mode="conveyor", conveyors=26, hash=BIG13_HASH,
          seconds=[seconds26], gcups=[cells / seconds26 / 1e9], launches=launches26,
          device_pairs=pairs26,
          bands_per_sweep=np.bincount([bp.sweep for bp in wl26.plan.bands]).tolist(),
          snapshot_bytes=wl26.snapshot_bytes, card=smi)

    def conveyor_kernels(wl):
        """Fill (all segments) and one walk of all pairs, each alone, by
        events; and what the walk did."""
        n_seg = -(-wl.max_chunks // cfg.fill_segments)

        def fill_once():
            holder["state"] = cv.conveyor_state(wl, dev)
            for c0 in range(0, wl.max_chunks, n_seg):
                cv.conveyor_fill(table, wl, problem.pxy, problem.pgap, c0,
                                 min(c0 + n_seg, wl.max_chunks), holder["state"])

        fill_ms = cuda_ms(fill_once, reps=1)
        if holder["state"].score.tolist() != [BIG13_PENALTIES[i] for i in wl.order]:
            raise AssertionError("big13 conveyor scores differ from the golden penalties")
        cplan = cv.conveyor_walk_plan(wl, genes, range(wl.num_pairs))
        args = (table, cplan, holder["state"].brow, holder["state"].snaps, problem.pxy, problem.pgap)
        walk_ms = cuda_ms(lambda: wk.walk(*args), reps=3)
        work = walk_work(*wk.walk(*args), cplan)
        del args, holder["state"]
        return fill_ms, walk_ms, work

    conv_bound = fill_bound(genes, pairs, wl.snaps_len + wl.brow_len + len(pairs))

    def fill_fields(wl, fill_ms, prefix=""):
        """The fill's time beside its bound, and its steps: the global steps
        of the launch (every sweep's chunks) and their cost."""
        steps = wl.max_chunks * cfg.snap_k
        busiest = max(c - f for f, c in zip(wl.plan.sweep_first, wl.plan.sweep_chunks))
        return {prefix + "fill_ms": fill_ms, prefix + "share_of_bound": conv_bound[0] / fill_ms,
                prefix + "sweeps": wl.num_sweeps, prefix + "fill_steps": steps,
                prefix + "busiest_sweep_steps": busiest * cfg.snap_k,
                prefix + "us_per_step": fill_ms * 1e3 / steps}

    conv_fill_ms, conv_walk_ms, conv_work = conveyor_kernels(wl)
    fill26_ms, walk26_ms, _ = conveyor_kernels(wl26)
    walk_phase("conveyor", conv_walk_ms, conv_work, smi, sweeps=wl.num_sweeps,
               rb=cfg.rb_conveyor, snap_k=cfg.snap_k)
    phase("big13_kernels", fill_mode="conveyor", **fill_fields(wl, conv_fill_ms),
          walk_ms=conv_walk_ms, fill_gcups=cells / conv_fill_ms / 1e6,
          bound_ms=conv_bound[0], before_ms=1599.5,
          rest_of_e2e_ms=min(conv_runs) * 1e3 - conv_fill_ms - conv_walk_ms,
          **fill_fields(wl26, fill26_ms, "sweeps26_"), sweeps26_walk_ms=walk26_ms, card=smi)
    phase("big13_fill_modes", banded_seconds=runs, conveyor_seconds=conv_runs,
          conveyor26_seconds=[seconds26], banded_fill_ms=fill_ms, conveyor_fill_ms=conv_fill_ms,
          conveyor26_fill_ms=fill26_ms, card=smi)
    conveyor_sweep_choice(genes, pairs, conveyor, resident, wl.num_sweeps, smi, conveyor_kernels,
                          fill_fields)
    conformance("conveyor", cv.conveyor_fill)
    fill_mode_ab(banded, conveyor, smi)
    one_band_ab(banded, conveyor, smi)
    with port_env(fill_mode="auto"):
        all_kernels = {"band_fill": bf.band_fill, "conveyor_fill": cv.conveyor_fill, "walk": wk.walk}
        for fn in all_kernels.values():
            fn.launches = fn.pairs = 0
        lines, seconds = run_cli(["--backend", "cuda", "--input", "data/mseq-big13-example.txt"])
        auto_launches = {name: fn.launches for name, fn in all_kernels.items()}
    if lines[1] != BIG13_HASH or lines[2].split() != [str(p) for p in BIG13_PENALTIES]:
        raise AssertionError("big13 under fill_mode=auto is not golden")
    chosen = choose_fill_mode(TorchConfig(fill_mode="auto"))
    fill_kernel = {"banded": "band_fill", "conveyor": "conveyor_fill"}[chosen]
    if auto_launches[fill_kernel] < 1 or auto_launches["walk"] < 1:
        raise AssertionError(f"fill_mode=auto did not run the {chosen} fill: {auto_launches}")
    phase("big13_e2e", fill_mode="auto", chosen=chosen, hash=BIG13_HASH, seconds=[seconds],
          launches=auto_launches, card=smi)

    # Each kernel on big13 beside its bound (the larger of its int32
    # operations at the card's peak and its bytes at HBM rate), with its
    # launches on the main path (fill_mode=auto); the conveyor's own run
    # gives the launches of its fill and walk, under keys of their own.
    big13_bounds = {
        "band_fill": (fill_ms, band_fill_bound(genes, pairs, plan), auto_launches["band_fill"]),
        "walk": (walk_ms, walk_bound(banded_work), auto_launches["walk"]),
        "conveyor_fill": (conv_fill_ms, fill_bound(genes, pairs, wl.snaps_len + wl.brow_len + len(pairs)),
                          auto_launches["conveyor_fill"]),
    }
    kernel_bounds = {
        name: {"ms": ms, "bound_ms": b[0], "bound_by": b[1], "share_of_bound": b[0] / ms,
               "auto_launches": n}
        for name, (ms, b, n) in big13_bounds.items()}
    kernel_bounds["conveyor_fill"]["conveyor_launches"] = conv_launches["conveyor_fill"]
    conv_walk_bound = walk_bound(conv_work)
    phase("big13_kernel_bounds", card=smi, kernels=kernel_bounds, conveyor_walk={
        "ms": conv_walk_ms, "bound_ms": conv_walk_bound[0], "bound_by": conv_walk_bound[1],
        "share_of_bound": conv_walk_bound[0] / conv_walk_ms,
        "conveyor_launches": conv_launches["walk"]})

    # 7-13. this slice: score-only fill, sharded scores, calibration, the
    # device split, two processes, the profiler, the torch backend
    check_score_only("small", small, [(1, 0), (2, 0), (2, 1)], rb=1023, snap_k=1024)
    check_score_only("main_geometry", main_geom, [(0, 1)], rb=cfg.rb, snap_k=cfg.snap_k)
    sharded_scores(problem, cells, smi)
    calibration(smi)
    two_shards_one_card({"banded": banded, "conveyor": conveyor}, smi)
    distributed(smi)
    batched_profile(all_kernels, smi)
    torch_backend(smi)

    # 14. the lone giant pair: the default route and the striped fill
    striped_launches = spec_cap(cfg, smi)
    spec_cap_cli(smi)

    # 15. the pod-scale workloads and the first call
    pod64(smi)
    pod256(smi)
    conformance_first_call(smi)

    # 16. summary
    sources = {
        "band_fill": ("msa_tpu_torch/csrc/band_fill.cu", "msa_tpu/ops/pallas_nw.py:79"),
        "walk": ("msa_tpu_torch/csrc/walk.cu", "msa_tpu/ops/pallas_walk.py:80"),
        "conveyor_fill": ("msa_tpu_torch/csrc/conveyor_fill.cu", "msa_tpu/ops/conveyor.py:322"),
    }
    # Launches of the main path (fill_mode=auto) for the kernels it runs;
    # the conveyor fill, off that path, from the run of its own path
    # (fill_mode=conveyor), with the main path's 0 beside it.
    measured = {"band_fill": (timed["fill"], auto_launches["band_fill"],
                              {"striped_launches": striped_launches,
                               "striped_launches_from": "spec_cap"}),
                "walk": (timed["walk"], auto_launches["walk"],
                         {"conveyor_launches": conv_launches["walk"]}),
                "conveyor_fill": (conveyor_timed, conv_launches["conveyor_fill"],
                                  {"launches_from": "fill_mode=conveyor",
                                   "auto_launches": auto_launches["conveyor_fill"]})}
    kernels = []
    # ms, plain_ms and the bound on the same inputs (the main geometry
    # cases); no single PyTorch call computes a fill or a traceback.
    for name, ((err, ms, plain_ms, (bound_ms, bound_by)), count, extra) in measured.items():
        kernels.append({"name": name, "route": "cuda", "source": sources[name][0],
                        "replaces": sources[name][1], "launches": count,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                        **extra})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--cards"]:
        raise SystemExit(cards_main())
    if sys.argv[1:]:
        raise SystemExit(f"usage: {sys.argv[0]} [--cards]")
    raise SystemExit(main())
