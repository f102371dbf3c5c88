"""The CUDA kernels against their plain versions, on a card.

Marked ``cuda``; each test skips without a CUDA device. They import nothing of
the JAX package. On the machine with the card (which has no jax, so the
suite's conftest cannot load) run::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from msa_tpu_torch.ops.reference import nw_align_numpy
from msa_tpu_torch.config import TorchConfig
from msa_tpu_torch.ops import band_fill as bf
from msa_tpu_torch.ops import conveyor as cv
from msa_tpu_torch.ops import batch
from msa_tpu_torch.ops import walk as wk
from msa_tpu_torch.ops.batch import align_pairs_batched

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _genes(seed, lengths):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGT"), n)) for n in lengths]


@pytest.mark.parametrize("rb,snap_k", [(127, 128), (1023, 1024), (300, 64)])
def test_kernels_equal_plain_versions(card, rb, snap_k):
    genes = _genes(rb, [700, 520, 910])
    pairs = [(1, 0), (2, 0), (2, 1), (0, 2)]
    plan = bf.plan_pairs([len(g) for g in genes], pairs, rb, snap_k)
    table = torch.from_numpy(bf.gene_table(genes)).to(card)
    fill = bf.band_fill(table, plan, 3, 2)
    ref = bf.band_fill_ref(table, plan, 3, 2)
    assert torch.equal(fill.score, ref.score)
    assert torch.equal(fill.rows, ref.rows)
    assert torch.equal(fill.snaps, ref.snaps)
    wplan = wk.banded_walk_plan(plan)
    words, counts = wk.walk(table, wplan, fill.rows, fill.snaps, 3, 2)
    rwords, rcounts = wk.walk_ref(table, wplan, fill.rows, fill.snaps, 3, 2)
    assert torch.equal(words, rwords) and torch.equal(counts, rcounts)


@pytest.mark.parametrize("snaps", [True, False])
def test_pipelined_fill_equals_plain_version(card, snaps):
    """Many bands a pair, pairs of every shape: every entry equal."""
    genes = _genes(31, [1900, 60, 1300, 7, 2500])
    pairs = [(i, j) for i in range(5) for j in range(5) if i != j]
    plan = bf.plan_pairs([len(g) for g in genes], pairs, 63, 96, snaps=snaps)
    table = torch.from_numpy(bf.gene_table(genes)).to(card)
    fill = bf.band_fill(table, plan, 3, 2)
    ref = bf.band_fill_ref(table, plan, 3, 2)
    assert plan.num_items > len(pairs) and bf.band_fill.blocks >= 1
    assert torch.equal(fill.score, ref.score) and torch.equal(fill.rows, ref.rows)
    assert torch.equal(fill.snaps, ref.snaps)


def test_pipeline_on_card_matches_oracle(card):
    genes = _genes(9, [1500, 1300, 900])
    pairs = [(1, 0), (2, 0), (2, 1)]
    got = align_pairs_batched(genes, pairs, 3, 2, device=card, rb=511, snap_k=256)
    for (i, j), res in zip(pairs, got):
        assert res == nw_align_numpy(genes[i], genes[j], 3, 2)


@pytest.mark.parametrize("layout,rb,snap_k", [
    ("banded", 1023, 1024), ("banded", 100, 64), ("conveyor", 1024, 1024), ("conveyor", 128, 64)])
def test_walk_equals_plain_version(card, layout, rb, snap_k):
    """The shared-memory walk against ``walk_ref`` on both fill layouts;
    the last two pairs are skewed (3,000 x 7 and 7 x 2,600)."""
    genes = _genes(rb + snap_k, [2600, 2100, 900, 3000, 7])
    pairs = [(0, 1), (2, 0), (3, 1), (3, 4), (4, 0)]
    table = torch.from_numpy(bf.gene_table(genes)).to(card)
    if layout == "banded":
        plan = bf.plan_pairs([len(g) for g in genes], pairs, rb, snap_k)
        fill = bf.band_fill(table, plan, 3, 2)
        wplan, rows, snaps = wk.banded_walk_plan(plan), fill.rows, fill.snaps
    else:
        wl = cv.plan_sweeps(genes, pairs, rb, snap_k, conveyors=2)
        state = cv.conveyor_fill(table, wl, 3, 2, 0, wl.max_chunks, cv.conveyor_state(wl, card))
        wplan = cv.conveyor_walk_plan(wl, genes, range(wl.num_pairs))
        rows, snaps = state.brow, state.snaps
    words, counts = wk.walk(table, wplan, rows, snaps, 3, 2)
    rwords, rcounts = wk.walk_ref(table, wplan, rows, snaps, 3, 2)
    assert torch.equal(words, rwords) and torch.equal(counts, rcounts)


def test_pipeline_in_waves_matches_oracle(card, monkeypatch):
    genes = _genes(13, [1500, 1300, 900, 2000, 1100])
    pairs = [(i, j) for i in range(5) for j in range(i)]
    sizes = batch.pair_bytes(bf.plan_pairs([len(g) for g in genes], pairs, 511, 256))
    cfg = TorchConfig(hbm_budget=2 * max(int(sizes.max()), int(sizes.sum()) // 4))
    seen = []
    real = batch.band_fill

    def spy(table, plan, pxy, pgap):
        seen.append(plan.num_pairs)
        return real(table, plan, pxy, pgap)

    monkeypatch.setattr(batch, "band_fill", spy)
    got = batch.align_pairs_batched(genes, pairs, 3, 2, device=card, rb=511, snap_k=256,
                                    config=cfg)
    assert len(seen) >= 3 and sum(seen) == len(pairs)
    for (i, j), res in zip(pairs, got):
        assert res == nw_align_numpy(genes[i], genes[j], 3, 2)


def test_fill_rejects_too_wide_band(card):
    plan = bf.plan_pairs([10, 10], [(0, 1)], 8192, 64)
    table = torch.zeros((2, 10), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="rb <="):
        bf.band_fill(table, plan, 3, 2)


@pytest.mark.parametrize("rb,snap_k,conveyors,segments", [
    (1024, 1024, 1, 4), (256, 128, 3, 5), (256, 64, 7, 3)])
def test_conveyor_kernel_equals_plain_version(card, rb, snap_k, conveyors, segments):
    genes = _genes(rb + conveyors, [2600, 16, 2100, 40, 900])
    pairs = [(i, j) for i in range(1, 5) for j in range(i)] + [(1, 0), (0, 1)]
    wl = cv.plan_sweeps(genes, pairs, rb, snap_k, conveyors)
    table = torch.from_numpy(bf.gene_table(genes)).to(card)
    got, ref = cv.conveyor_state(wl, card), cv.conveyor_state(wl, card)
    n_seg = -(-wl.max_chunks // segments)
    for c0 in range(0, wl.max_chunks, n_seg):
        c1 = min(c0 + n_seg, wl.max_chunks)
        cv.conveyor_fill(table, wl, 3, 2, c0, c1, got)
        cv.conveyor_fill_ref(table, wl, 3, 2, c0, c1, ref)
    for a, b in zip((got.score, got.brow, got.snaps, got.carry),
                    (ref.score, ref.brow, ref.snaps, ref.carry)):
        assert torch.equal(a, b)
    # Every sweep has finished its last chunk.
    assert got.progress.tolist() == [c * snap_k for c in wl.plan.sweep_chunks]
    wplan = cv.conveyor_walk_plan(wl, genes, range(wl.num_pairs))
    words, counts = wk.walk(table, wplan, got.brow, got.snaps, 3, 2)
    rwords, rcounts = wk.walk_ref(table, wplan, got.brow, got.snaps, 3, 2)
    assert torch.equal(words, rwords) and torch.equal(counts, rcounts)


def test_conveyor_pipeline_on_card_matches_oracle(card):
    genes = _genes(10, [1500, 1300, 900, 2000])
    pairs = [(1, 0), (2, 0), (2, 1), (3, 0), (3, 2)]
    cfg = TorchConfig(rb_conveyor=512, snap_k=256, conveyors=2)
    got = cv.align_pairs_conveyor(genes, pairs, 3, 2, device=card, config=cfg)
    for (i, j), res in zip(pairs, got):
        assert res == nw_align_numpy(genes[i], genes[j], 3, 2)


def test_conveyor_raises_when_sweeps_do_not_fit(card):
    """More sweeps than the card holds at once would wait on each other
    forever: the wrapper raises before the launch."""
    resident = cv.resident_sweeps(256, 64, card)
    assert resident >= torch.cuda.get_device_properties(card).multi_processor_count
    genes = _genes(5, [200] * (resident + 2))
    pairs = [(i, i + 1) for i in range(resident + 1)]
    wl = cv.plan_sweeps(genes, pairs, 256, 64, resident + 1)
    assert wl.num_sweeps == resident + 1
    table = torch.from_numpy(bf.gene_table(genes)).to(card)
    with pytest.raises(ValueError, match="do not fit"):
        cv.conveyor_fill(table, wl, 3, 2, 0, wl.max_chunks, cv.conveyor_state(wl, card))
    assert cv.sweep_count(0, resident) == resident


def test_conveyor_default_leaves_sms_to_the_walks(card):
    cfg = TorchConfig(rb_conveyor=7168, snap_k=1024)
    resident = cv.resident_sweeps(7168, 1024, card)
    per_sm = resident // torch.cuda.get_device_properties(card).multi_processor_count
    assert per_sm >= 1
    assert cv.conveyor_sweeps(cfg, card) == resident - cv.WALK_SMS * per_sm
    assert cv.conveyor_sweeps(TorchConfig(conveyors=10_000), card) == resident


def test_conveyor_rejects_too_wide_band(card):
    with pytest.raises(ValueError, match="one block"):
        cv.plan_sweeps(["A" * 10, "C" * 10], [(0, 1)], 8192, 1024, 1)


@pytest.mark.parametrize("rb", [127, 1023])
def test_score_only_fill_equals_plain_version(card, rb):
    genes = _genes(rb + 1, [700, 520, 910])
    pairs = [(1, 0), (2, 0), (2, 1), (0, 2)]
    lengths = [len(g) for g in genes]
    off = bf.plan_pairs(lengths, pairs, rb, 128, snaps=False)
    table = torch.from_numpy(bf.gene_table(genes)).to(card)
    got = bf.band_fill(table, off, 3, 2)
    ref = bf.band_fill_ref(table, off, 3, 2)
    full = bf.band_fill(table, bf.plan_pairs(lengths, pairs, rb, 128), 3, 2)
    assert got.snaps.numel() == 0
    assert torch.equal(got.score, ref.score) and torch.equal(got.rows, ref.rows)
    assert torch.equal(got.score, full.score)
    assert bf.nw_score(genes, pairs, 3, 2, device=card, rb=rb).tolist() == ref.score.tolist()


def test_two_shards_on_one_card_match_oracle(card, monkeypatch):
    from msa_tpu_torch.utils.msaio import Problem
    from msa_tpu_torch.models.kway import align_kway
    from msa_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "local_devices", lambda config: [card, card])
    genes = tuple(_genes(12, [1500, 1300, 900, 2000, 1100]))
    problem = Problem(pxy=3, pgap=2, genes=genes)
    for mode in ("banded", "conveyor"):
        cfg = TorchConfig(rb=511, snap_k=256, rb_conveyor=512, host_threshold=0, fill_mode=mode)
        got = align_kway(problem, config=cfg)
        want = align_kway(problem, backend="numpy")
        assert (got.chain_hash, got.penalties) == (want.chain_hash, want.penalties)


@pytest.mark.parametrize("order,key,bands", [((0, 1), "yx", 49), ((1, 0), "xy", 50)])
def test_spec_cap_job_fills_at_the_narrowed_band_height(card, order, key, bands):
    """The 100,352 x 100,000 pair as a k = 2 job: 13 bands at rb 8191 would
    fill 13 of the card's SMs, so the banded pipeline launches at 2047 (the
    job aligns gene 1 against gene 0: 49 bands of 100,000 rows, or 50 of
    100,352), and the answer is the oracle's in both orientations."""
    from torch.profiler import ProfilerActivity, profile

    from msa_tpu_torch.goldens import spec_cap as sc
    from msa_tpu_torch.models.kway import align_kway
    from msa_tpu_torch.utils import timing
    from msa_tpu_torch.utils.hashing import chain_hashes
    from msa_tpu_torch.utils.msaio import Problem

    pair = sc.make_pair()
    problem = Problem(pxy=sc.PXY, pgap=sc.PGAP, genes=tuple(pair[g] for g in order))
    gold = sc.load()[key]
    timing.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = align_kway(problem, backend="cuda", keep_alignments=True,
                         config=TorchConfig(local_devices=1))
    (job,) = timing.recorded_jobs()
    fills = job.named("batch.fill_enqueue")
    assert [(s.attrs["rb"], s.attrs["bands"]) for s in fills] == [(2047, bands)]
    assert got.penalties == [gold["penalty"]] == [124_321]
    assert got.pair_results[0].problem_hash == gold["pair_hash"]
    assert got.chain_hash == chain_hashes([gold["pair_hash"]])


@pytest.mark.parametrize("stripes", [2, 3, 5])
def test_striped_fill_equals_one_launch(card, stripes):
    """Stripes of one pair on one card, each band's relay into the next
    launch's buffers: the gathered state equals one launch and the plain
    version entry for entry, and the alignment the oracle's."""
    from msa_tpu_torch.ops import nw_striped as ns

    x, y = _genes(stripes, [2100, 1700])
    plan = bf.plan_pairs([2100, 1700], [(0, 1)], 127, 128)
    table = torch.from_numpy(bf.gene_table([x, y])).to(card)
    launches = ns.striped_fill.launches
    got = ns.striped_fill([table] * stripes, plan, [card] * stripes, 3, 2)
    assert ns.striped_fill.launches == launches + stripes
    for want in (bf.band_fill(table, plan, 3, 2), bf.band_fill_ref(table, plan, 3, 2)):
        for a, b in ((got.score, want.score), (got.rows, want.rows), (got.snaps, want.snaps)):
            assert torch.equal(a, b)
    assert ns.nw_align_band_striped(x, y, 3, 2, [card] * stripes, rb=127, snap_k=128) == \
        nw_align_numpy(x, y, 3, 2)


@pytest.mark.parametrize("cards", [2, 4])
def test_striped_fill_across_cards(card, cards):
    """Stripes on distinct cards, each relay a peer store into the next card:
    the gathered state on card 0 equals one launch entry for entry, and the
    alignment the oracle's."""
    from msa_tpu_torch.ops import nw_striped as ns

    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")
    devices = [torch.device("cuda", i) for i in range(cards)]
    x, y = _genes(cards, [2900, 2300])
    plan = bf.plan_pairs([2900, 2300], [(0, 1)], 127, 128)
    codes = torch.from_numpy(bf.gene_table([x, y]))
    got = ns.striped_fill([codes.to(d) for d in devices], plan, devices, 3, 2)
    want = bf.band_fill(codes.to(devices[0]), plan, 3, 2)
    for a, b in ((got.score, want.score), (got.rows, want.rows), (got.snaps, want.snaps)):
        assert a.device == devices[0] and torch.equal(a, b)
    assert ns.nw_align_band_striped(x, y, 3, 2, devices, rb=127, snap_k=128) == \
        nw_align_numpy(x, y, 3, 2)


def test_striped_fill_raises_when_stripes_do_not_fit(card):
    from msa_tpu_torch.ops import nw_striped as ns

    stripes = 4
    resident = bf.resident_blocks(bf.plan_pairs([31, 100], [(0, 1)], 31, 32), card)
    m = 31 * (resident + stripes)  # more bands than the card holds blocks of
    plan = bf.plan_pairs([m, 100], [(0, 1)], 31, 32)
    table = torch.zeros((2, m), dtype=torch.uint8, device=card)
    launches = bf.band_fill.launches
    with pytest.raises(RuntimeError, match="resident"):
        ns.striped_fill([table] * stripes, plan, [card] * stripes, 3, 2)
    assert bf.band_fill.launches == launches
