"""The banded pipeline in memory-bounded waves, and the walk's shared-memory cone.

On the CPU (the kernels' plain versions), at tolerance 0: a budget forced to
three or more waves gives the triples of one wave, and both equal the JAX
package's ``align_pairs_batched`` (interpret mode, its small-geometry test
settings) and the numpy oracle; no wave plans more device bytes than half
the budget; ``on_result`` fires once per pair with the caller's index; a
pair over the budget raises. Also the band height a call runs at
(``band_height``), the walk kernel's shared-memory size, the segment replay
that measures a walk, and the shared device budget.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from msa_tpu.ops.reference import nw_align_numpy
from msa_tpu_torch.config import TorchConfig
from msa_tpu_torch.ops import band_fill as bf
from msa_tpu_torch.ops import batch
from msa_tpu_torch.ops import walk as wk
from msa_tpu_torch.utils.msaio import parse_file
from msa_tpu_torch.utils.tasks import pair_task_list

CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parent.parent


def _genes(seed, lengths):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGT"), n)) for n in lengths]


def _workload():
    """Five genes of 120-500 and their ten pairs, as the JAX package's
    ``test_batched_group_walk_interpret``; the pairs not in size order."""
    rng = np.random.default_rng(42)
    genes = ["".join(rng.choice(list("ACGT"), rng.integers(120, 500))) for _ in range(5)]
    pairs = [(i, j) for i in range(1, 5) for j in range(i)]
    return genes, pairs[::2] + pairs[1::2]


@pytest.fixture(scope="module")
def jax_triples():
    """The JAX package's batched pipeline on the workload (interpret mode)."""
    import msa_tpu.ops.batch as jax_batch

    genes, pairs = _workload()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_batch, "RB_ALIGN", 128)
        mp.setattr(jax_batch, "X_CAP", 512)
        mp.setattr(jax_batch, "Y_CAP", 512)
        return jax_batch.align_pairs_batched(genes, pairs, 3, 2, interpret=True)


@pytest.fixture
def waves_seen(monkeypatch):
    """The plan of every fill launch of the banded pipeline."""
    seen = []
    real = batch.band_fill

    def spy(table, plan, pxy, pgap):
        seen.append(plan)
        return real(table, plan, pxy, pgap)

    monkeypatch.setattr(batch, "band_fill", spy)
    return seen


def _forced_budget(genes, pairs, rb, snap_k, waves):
    """A budget whose half holds about 1 / ``waves`` of the workload."""
    sizes = batch.pair_bytes(bf.plan_pairs([len(g) for g in genes], pairs, rb, snap_k))
    return 2 * max(int(sizes.max()), int(sizes.sum()) // waves)


@pytest.mark.parametrize("rb,snap_k", [(128, 1024), (100, 64)])
def test_waves_equal_one_wave_and_jax(monkeypatch, jax_triples, waves_seen, rb, snap_k):
    genes, pairs = _workload()
    two = batch.align_pairs_batched(genes, pairs, 3, 2, device=CPU, rb=rb, snap_k=snap_k)
    assert len(waves_seen) == 2  # the default: about half the bytes a wave
    half = int(batch.pair_bytes(waves_seen[0]).sum())
    assert 2 * half >= sum(int(batch.pair_bytes(plan).sum()) for plan in waves_seen)
    waves_seen.clear()
    monkeypatch.setattr(batch, "HALVES", 1)
    one = batch.align_pairs_batched(genes, pairs, 3, 2, device=CPU, rb=rb, snap_k=snap_k)
    assert len(waves_seen) == 1
    waves_seen.clear()
    budget = _forced_budget(genes, pairs, rb, snap_k, 4)
    many = batch.align_pairs_batched(genes, pairs, 3, 2, device=CPU, rb=rb, snap_k=snap_k,
                                     config=TorchConfig(hbm_budget=budget, decode_workers=3))
    assert len(waves_seen) >= 3
    assert all(int(batch.pair_bytes(plan).sum()) <= budget // 2 for plan in waves_seen)
    assert sum(plan.num_pairs for plan in waves_seen) == len(pairs)
    # Largest (m + n) first, so the longest walks start earliest.
    spans = [int(s) for plan in waves_seen for s in plan.params[:, bf.P_M] + plan.params[:, bf.P_N]]
    assert spans == sorted(spans, reverse=True)
    assert many == two == one == jax_triples
    assert one == [nw_align_numpy(genes[i], genes[j], 3, 2) for i, j in pairs]


def test_on_result_fires_once_per_pair_with_the_callers_index(waves_seen):
    genes, pairs = _workload()
    fired = []
    cfg = TorchConfig(hbm_budget=_forced_budget(genes, pairs, 64, 32, 5), decode_workers=4)
    got = batch.align_pairs_batched(genes, pairs, 3, 2, device=CPU, rb=64, snap_k=32,
                                    on_result=lambda idx, triple: fired.append((idx, triple)),
                                    config=cfg)
    assert len(waves_seen) >= 3
    assert sorted(fired) == list(enumerate(got))


def test_budget_is_read_before_each_wave(monkeypatch, waves_seen):
    """A budget that shrinks between waves gives smaller waves."""
    genes, pairs = _workload()
    sizes = batch.pair_bytes(bf.plan_pairs([len(g) for g in genes], pairs, 64, 32))
    reads = []

    def shrinking(device, hbm_budget=0):
        reads.append(device)
        return 2 * max(int(sizes.max()), int(sizes.sum()) // len(reads))

    monkeypatch.setattr(batch, "device_budget", shrinking)
    got = batch.align_pairs_batched(genes, pairs, 3, 2, device=CPU, rb=64, snap_k=32)
    assert len(reads) >= len(waves_seen) + 1 >= 3  # the first check, then one a wave
    assert got == [nw_align_numpy(genes[i], genes[j], 3, 2) for i, j in pairs]


def test_single_pair_over_the_budget_raises(waves_seen):
    genes = _genes(3, [900, 700])
    with pytest.raises(ValueError, match="over half the"):
        batch.align_pairs_batched(genes, [(0, 1)], 3, 2, device=CPU, rb=64, snap_k=32,
                                  config=TorchConfig(hbm_budget=1000))
    assert waves_seen == []  # raised before any launch


def test_pair_bytes_are_the_plans_buffers():
    genes = _genes(5, [300, 170, 45])
    pairs = [(0, 1), (1, 2), (2, 0)]
    plan = bf.plan_pairs([len(g) for g in genes], pairs, 64, 32)
    words = wk.banded_walk_plan(plan).moves_len
    assert int(batch.pair_bytes(plan).sum()) == 4 * (
        plan.snaps_len + plan.rows_len + plan.num_pairs + words + plan.num_pairs)


# -- the band height a call runs at ------------------------------------------

SPEC_CAP = (100_352, 100_000)


def _all_pairs(lengths):
    lengths = list(lengths)
    return lengths, [(t.i, t.j) for t in pair_task_list(len(lengths))]


def _big13():
    genes = parse_file(str(REPO / "data" / "mseq-big13-example.txt")).genes
    return _all_pairs(len(g) for g in genes)


def _big13_shard(shard, shards):
    """One shard of big13's pairs as ``models/kway.py::_run_batched`` splits
    them over ``shards`` devices (LPT by m * n); each shard is a call of its own."""
    from msa_tpu_torch.parallel.schedule import lpt_schedule

    lengths, _ = _big13()
    tasks = pair_task_list(len(lengths))
    split = lpt_schedule([(t, lengths[t.i] * lengths[t.j]) for t in tasks], shards)
    return lengths, [(t.i, t.j) for t in split[shard]]


def _pod64():
    from msa_tpu_torch.scripts.gen_workload import make_problem

    return _all_pairs(len(g) for g in make_problem(k=64).genes)


BAND_CASES = {
    # name: (lengths and pairs, given rb, chosen rb, bands at the chosen rb)
    "spec_cap_xy": (lambda: (list(SPEC_CAP), [(0, 1)]), 8191, 2047, 50),
    "spec_cap_yx": (lambda: (list(SPEC_CAP), [(1, 0)]), 8191, 2047, 49),
    "spec_cap_k3": (lambda: _all_pairs(SPEC_CAP + (100_000,)), 8191, 2047, 3 * 49),
    "big13": (_big13, 8191, 8191, 497),
    # Split over two devices each shard still covers the SMs; over four,
    # each shard's 119-130 bands do not, so it narrows to 4095.
    "big13_shard_0_of_2": (lambda: _big13_shard(0, 2), 8191, 8191, 245),
    "big13_shard_0_of_4": (lambda: _big13_shard(0, 4), 8191, 4095, 229),
    "big13_shard_1_of_4": (lambda: _big13_shard(1, 4), 8191, 4095, 245),
    "big13_shard_2_of_4": (lambda: _big13_shard(2, 4), 8191, 4095, 232),
    "big13_shard_3_of_4": (lambda: _big13_shard(3, 4), 8191, 4095, 250),
    "pod64": (_pod64, 8191, 8191, 3055),
    "30_items_at_4095": (lambda: ([10 * 4095] * 3, [(0, 1), (1, 2), (2, 0)]), 8191, 2047, 3 * 21),
    "140_items_at_4095": (lambda: ([8000] * 71, [(g, g + 1) for g in range(70)]), 8191, 4095, 140),
    "off_the_ladder": (lambda: (list(SPEC_CAP), [(0, 1)]), 5000, 2047, 50),
    "rb_255_kept": (lambda: (list(SPEC_CAP), [(0, 1)]), 255, 255, 394),
    "rb_64_kept": (lambda: (list(SPEC_CAP), [(0, 1)]), 64, 64, 1568),
}


@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_band_height_covers_the_sms_down_to_the_floor(case):
    """At an H100's 132 SMs: a call whose bands leave SMs idle at the given
    rb narrows down the ladder rb, (rb + 1) // 2 - 1, ... until they cover
    them, and stops at 2047; big13 and the pods keep 8191, and so does each
    of big13's shards over two devices, while each over four narrows to
    4095; an rb under 2048 comes back as given. The plan at the chosen
    height has the bands."""
    make, given, want, bands = BAND_CASES[case]
    lengths, pairs = make()
    got = bf.band_height(lengths, pairs, given, 132)
    assert got == want
    plan = bf.plan_pairs(lengths, pairs, got, 1024)
    assert plan.num_items == bands
    assert got == min(given, bf.BAND_FLOOR) or plan.num_items >= 132


def test_device_budget(monkeypatch):
    assert bf.device_budget(CPU, 12345) == 12345
    assert bf.device_budget(CPU) == 12 << 30
    gib = 1 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (40 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 6 * gib)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 2 * gib)
    # What the allocator holds unused counts as free.
    assert bf.device_budget(torch.device("cuda", 0)) == int(44 * gib * 0.75)


# -- the walk's shared-memory cone -------------------------------------------


def test_cone_rows_hold_each_rows_granules():
    offset = 0
    for u in range(2100):
        assert wk.cone_row(u) == offset
        offset += u // wk.WALK_CELLS + 2


def test_walk_shared_memory_fits_at_the_default_snap_k():
    need = wk.walk_shared_bytes(TorchConfig().snap_k)
    assert need == 132_608  # 524,800 cells of 2 bits, in 8-bit granules
    assert need <= wk.BLOCK_SHARED_MAX - wk.WALK_STATIC_SHARED
    wk.check_walk_geometry(TorchConfig().rb, TorchConfig().snap_k)


@pytest.mark.parametrize("snap_k", [1536, 2048])
def test_walk_rejects_a_snap_k_whose_cone_does_not_fit(snap_k):
    genes = _genes(1, [40, 30])
    plan = bf.plan_pairs([40, 30], [(0, 1)], 64, snap_k)
    table = torch.from_numpy(bf.gene_table(genes))
    fill = bf.band_fill(table, plan, 3, 2)
    with pytest.raises(ValueError, match="shared memory"):
        wk.walk(table, wk.banded_walk_plan(plan), fill.rows, fill.snaps, 3, 2)


def test_walk_segments_replays_the_walks_segments(monkeypatch):
    """``walk_segments`` finds the segments ``walk_ref`` recomputes."""
    genes = _genes(11, [700, 520])
    rb, snap_k = 150, 64
    plan = bf.plan_pairs([700, 520], [(0, 1)], rb, snap_k)
    table = torch.from_numpy(bf.gene_table(genes))
    fill = bf.band_fill(table, plan, 3, 2)
    seen = []
    real = wk.segment

    def spy(i, j, *a):
        out = real(i, j, *a)
        seen.append((out[5], out[2]))  # (steps, q)
        return out

    monkeypatch.setattr(wk, "segment", spy)
    wplan = wk.banded_walk_plan(plan)
    words, counts = wk.walk_ref(table, wplan, fill.rows, fill.snaps, 3, 2)
    moves = wk.pair_moves(words.numpy(), counts.numpy(), wplan, 0)
    got = wk.walk_segments(700, 520, moves, rb, snap_k)
    assert [tuple(r) for r in got.tolist()] == seen
    assert len(seen) > 10
