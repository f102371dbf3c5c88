"""The port's conveyor (plain versions, CPU) against the JAX conveyor.

Inputs come from a numpy seed. The JAX side runs as
``tests/test_pallas_kernels.py`` runs it: ``interpret=True``, ``unroll=1``,
``CHUNK_PAD`` = 1, rb = 1024; its fill output goes through
``msa_tpu_torch.state.conveyor_state_from_jax``. Every comparison is of
int32 values or strings, with tolerance 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import msa_tpu.ops.conveyor as jconv
from msa_tpu.models.kway import align_kway as jax_align_kway
from msa_tpu.ops.reference import nw_align_numpy
from msa_tpu.utils.alignment import moves_to_alignment
from msa_tpu.utils.msaio import Problem
from msa_tpu_torch.config import TorchConfig
from msa_tpu_torch.models import kway
from msa_tpu_torch.ops import conveyor as conv
from msa_tpu_torch.ops.band_fill import gene_table
from msa_tpu_torch.ops.walk import pair_moves, walk_ref
from msa_tpu_torch.state import (
    conveyor_state_from_jax,
    valid_brow_cells,
    valid_conveyor_cells,
)

ALPHA = list("ACGT")
CPU = torch.device("cpu")
RB = 1024
K = jconv.K


def _rand_seq(rng, n):
    return "".join(rng.choice(ALPHA, n))


def _skew_workload():
    """test_pallas_kernels.py:150-174: transposes, both orientations of a pair."""
    rng = np.random.default_rng(31)
    genes = [_rand_seq(rng, n) for n in (2600, 16, 2100, 40, 900)]
    pairs = [(i, j) for i in range(1, 5) for j in range(i)] + [(1, 0), (0, 1)]
    return genes, pairs


def _fill(genes, wl, segments):
    table = torch.from_numpy(gene_table(genes))
    state = conv.conveyor_state(wl, CPU)
    n_seg = -(-wl.max_chunks // segments)
    for c0 in range(0, wl.max_chunks, n_seg):
        conv.conveyor_fill(table, wl, 3, 2, c0, min(c0 + n_seg, wl.max_chunks), state)
    return state


def _alignments(genes, pairs, wl, words, counts, scores, wplan):
    out = {}
    for g in range(wl.num_pairs):
        xi, yi = wl.ordered[g]
        ax, ay = moves_to_alignment(genes[xi], genes[yi], pair_moves(words, counts, wplan, g))
        if wl.swapped[g]:
            ax, ay = ay, ax
        out[wl.order[g]] = (int(scores[g]), ax, ay)
    return [out[idx] for idx in range(len(pairs))]


@pytest.fixture(scope="module")
def jax_skew_fill():
    """The JAX conveyor fill of the skew workload (the file's one JAX run)."""
    genes, pairs = _skew_workload()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconv, "CHUNK_PAD", 1)
        order, ordered, swapped, plan = jconv.plan_workload(genes, pairs, rb=RB)
        tables = jconv.build_chunk_tables(plan)
        y_cap = plan.ymax
        xp = -(-(4 * RB + plan.v_len + 128 + 1 + y_cap) // 128) * 128
        table = np.full((len(genes), xp), jconv.X_SENTINEL, np.int8)
        for g, seq in enumerate(genes):
            table[g, 1 : 1 + len(seq)] = np.frombuffer(seq.encode("latin-1"), np.uint8)
            table[g, 1 + len(seq) :] = jconv.Y_SENTINEL
        specs = np.array([[bp.start, bp.xi, bp.yi, bp.i0] for bp in plan.bands], np.int32)
        params = np.array([3, 2, 0, 0, 0, 0, 0, 0], np.int32)
        scores, snaps, brow = jconv._conveyor_fill_device(
            jconv.jnp.asarray(table), jconv.jnp.asarray(specs),
            jconv.jnp.asarray(np.ascontiguousarray(tables[:, :16])),
            jconv.jnp.asarray(params), xp=xp, n_chunks=plan.n_chunks, rb=RB,
            v_len=plan.v_len, ymax=plan.ymax, n_slots=plan.n_slots,
            n_pairs=len(pairs), interpret=True, unroll=1,
        )
    wl = conv.plan_sweeps(genes, pairs, RB, K, conveyors=1)
    state = conveyor_state_from_jax(
        scores, snaps, brow, plan=wl.plan, rb=RB, v_len=plan.v_len
    )
    return genes, pairs, wl, state


def _same_plan(port, jax_plan):
    """The port's one-sweep plan is the JAX plan, band for band."""
    assert len(port.bands) == len(jax_plan.bands)
    for a, b in zip(port.bands, jax_plan.bands):
        assert a.sweep == 0
        assert {k: v for k, v in dataclasses.asdict(a).items() if k != "sweep"} == dataclasses.asdict(b)
    assert port.n_chunks <= jax_plan.n_chunks
    assert port.pair_ready == [min(r, port.n_chunks) for r in jax_plan.pair_ready]


def _check_chained(genes, wl):
    """The invariants of a plan over several sweeps; whether some pair's
    bands lie on more than one sweep."""
    rb, K = wl.rb, wl.snap_k
    bands = wl.plan.bands
    by_slot = {bp.brow_out: bp for bp in bands}
    assert len(by_slot) == len(bands) and 0 not in by_slot  # each slot written once
    for w in range(wl.num_sweeps):
        mine = [bp for bp in bands if bp.sweep == w]
        assert mine and [bp.start for bp in mine] == sorted(bp.start for bp in mine)
        for prev, bp in zip(mine, mine[1:]):
            assert bp.start % K == 0
            assert bp.start - prev.start >= max(prev.n + K, rb + K)
        chunks = [(bp.start + bp.q_last + bp.n) // K for bp in mine if bp.is_last]
        assert len(chunks) == len(set(chunks))  # one score event a chunk a sweep
        lo, hi, elo, ehi = wl.sweep_table[w, [conv.S_BAND_LO, conv.S_BAND_HI, conv.S_EV_LO, conv.S_EV_HI]]
        assert [r[conv.C_START] for r in wl.band_table[lo:hi]] == [bp.start for bp in mine]
        assert ehi - elo == len(chunks)
    spread = False
    for bp in bands:
        if bp.brow_in:
            pred = by_slot[bp.brow_in]
            assert (pred.pair_slot, pred.band) == (bp.pair_slot, bp.band - 1)
            # Column j is harvested at pred.start + rb + j and read at
            # bp.start + j: at least 2K steps later, on any sweep.
            assert bp.start >= pred.start + rb + 2 * K
            spread |= pred.sweep != bp.sweep
        else:
            assert bp.band == 0
    return spread


def test_planner_matches_jax():
    """The 30 random workloads of test_pallas_kernels.py:257-283."""
    rng = np.random.default_rng(3)
    spread = 0
    for trial in range(30):
        k = int(rng.integers(2, 9))
        lens = [int(rng.integers(1, 4000)) for _ in range(k)]
        genes = ["A" * L for L in lens]
        pairs = [(i, j) for i in range(1, k) for j in range(i)]
        order = sorted(range(len(pairs)), key=lambda idx: -(lens[pairs[idx][0]] + lens[pairs[idx][1]]))
        ordered = [pairs[idx] for idx in order]
        _same_plan(conv.plan_conveyor(genes, ordered, RB, K), jconv.plan_conveyor(genes, ordered, rb=RB))
        got = conv.plan_workload(genes, pairs, RB, K)
        want = jconv.plan_workload(genes, pairs, rb=RB)
        assert got[:3] == want[:3], trial
        _same_plan(got[3], want[3])
        # One sweep is the JAX plan; several place the bands of the same
        # pairs, in the same order and slots, under the stagger rules.
        wl = conv.plan_sweeps(genes, pairs, RB, K, conveyors=1)
        assert (wl.order, wl.ordered, wl.swapped) == tuple(want[:3])
        wl = conv.plan_sweeps(genes, pairs, RB, K, conveyors=3)
        assert (wl.order, wl.ordered, wl.swapped) == tuple(want[:3])
        assert 1 <= wl.num_sweeps <= 3
        spread += _check_chained(genes, wl)
    assert spread  # some pair's bands ride more than one sweep


@pytest.mark.parametrize("segments", [1, 4])
def test_fill_matches_jax(jax_skew_fill, segments):
    genes, pairs, wl, want = jax_skew_fill
    got = _fill(genes, wl, segments)
    assert sum(wl.swapped) > 0
    assert torch.equal(got.score, want.score)
    brow_ok = torch.from_numpy(valid_brow_cells(wl))
    assert brow_ok.any()
    assert torch.equal(got.brow[brow_ok], want.brow[brow_ok])
    snaps_ok = torch.from_numpy(valid_conveyor_cells(wl))
    assert snaps_ok.any()
    assert torch.equal(got.snaps[snaps_ok], want.snaps[snaps_ok])


def test_fill_segments_equal_one_run():
    """Four segments (boundaries inside ramps) give every entry of one run."""
    genes, pairs = _skew_workload()
    wl = conv.plan_sweeps(genes, pairs, RB, K, conveyors=1)
    n_seg = -(-wl.max_chunks // 4)
    assert any(
        bp.start // K < c0 <= (bp.start + RB) // K
        for bp in wl.plan.bands for c0 in range(n_seg, wl.max_chunks, n_seg)
    )
    one, four = _fill(genes, wl, 1), _fill(genes, wl, 4)
    for a, b in zip((one.score, one.brow, one.snaps, one.carry),
                    (four.score, four.brow, four.snaps, four.carry)):
        assert torch.equal(a, b)


def _chain_workload():
    """Pairs of several bands at rb 256 / K 64, both orientations, short and
    long; their bands chain across sweeps."""
    rng = np.random.default_rng(19)
    genes = [_rand_seq(rng, n) for n in (1100, 700, 30, 520, 900)]
    pairs = [(i, j) for i in range(1, 5) for j in range(i)] + [(0, 1)]
    return genes, pairs


def _walks(genes, pairs, wl, state):
    wplan = conv.conveyor_walk_plan(wl, genes, range(wl.num_pairs))
    words, counts = walk_ref(torch.from_numpy(gene_table(genes)), wplan, state.brow, state.snaps, 3, 2)
    return words, counts, _alignments(genes, pairs, wl, words.numpy(), counts.numpy(),
                                      state.score.numpy(), wplan)


@pytest.fixture(scope="module")
def one_sweep_chain():
    genes, pairs = _chain_workload()
    wl = conv.plan_sweeps(genes, pairs, 256, 64, conveyors=1)
    state = _fill(genes, wl, 1)
    return genes, pairs, wl, state, _walks(genes, pairs, wl, state)


@pytest.mark.parametrize("sweeps,segments", [(1, 3), (2, 1), (2, 3), (5, 1), (5, 3)])
def test_chained_sweeps_equal_one_sweep(one_sweep_chain, sweeps, segments):
    """Bands chained over several sweeps (a producer's row read from another
    sweep) give the one-sweep scores, brow cells, walks and alignments."""
    genes, pairs, one, want, (words, counts, aligned) = one_sweep_chain
    wl = conv.plan_sweeps(genes, pairs, 256, 64, conveyors=sweeps)
    assert wl.num_sweeps == sweeps
    assert sweeps == 1 or any(
        bp.brow_in and wl.plan.bands[bp.brow_in - 1].sweep != bp.sweep for bp in wl.plan.bands)
    got = _fill(genes, wl, segments)
    assert torch.equal(got.score, want.score)
    brow_ok = torch.from_numpy(valid_brow_cells(wl))
    assert torch.equal(brow_ok, torch.from_numpy(valid_brow_cells(one)))
    assert torch.equal(got.brow[brow_ok], want.brow[brow_ok])
    got_words, got_counts, got_aligned = _walks(genes, pairs, wl, got)
    assert torch.equal(got_words, words) and torch.equal(got_counts, counts)
    assert got_aligned == aligned
    for (i, j), res in zip(pairs, got_aligned):
        assert res == nw_align_numpy(genes[i], genes[j], 3, 2), (i, j)


@pytest.mark.parametrize("conveyors,resident,free,want", [
    (0, 132, 0, 132), (26, 132, 0, 26), (500, 132, 0, 132), (1, 132, 0, 1), (0, None, 0, 1),
    (5, None, 0, 5), (0, 132, 32, 100), (26, 132, 32, 26), (500, 132, 32, 132),
    (0, 20, 32, 1), (0, None, 32, 1)])
def test_sweep_count_caps_at_resident(conveyors, resident, free, want):
    """0 takes every resident sweep but the ``free`` ones left to the walks;
    no count passes the card's resident blocks; without a card (plain
    version) nothing caps and 0 is one."""
    assert conv.sweep_count(conveyors, resident, free) == want


def test_conveyor_sweeps_on_cpu():
    """Without a card the configured count is taken as it is (0: one sweep)."""
    cpu = torch.device("cpu")
    assert conv.conveyor_sweeps(TorchConfig(conveyors=0), cpu) == 1
    assert conv.conveyor_sweeps(TorchConfig(conveyors=7), cpu) == 7


def test_walk_on_jax_fill(jax_skew_fill):
    """The JAX conveyor's output feeds the port's walk; transposed pairs too."""
    genes, pairs, wl, state = jax_skew_fill
    wplan = conv.conveyor_walk_plan(wl, genes, range(wl.num_pairs))
    words, counts = walk_ref(
        torch.from_numpy(gene_table(genes)), wplan, state.brow, state.snaps, 3, 2
    )
    got = _alignments(genes, pairs, wl, words.numpy(), counts.numpy(), state.score.numpy(), wplan)
    for (i, j), res in zip(pairs, got):
        assert res == nw_align_numpy(genes[i], genes[j], 3, 2), (i, j)


@pytest.mark.parametrize("conveyors", [1, 3, 5])
def test_align_pairs_conveyor(conveyors):
    """The workload of test_pallas_kernels.py:123-147."""
    rng = np.random.default_rng(11)
    genes = [_rand_seq(rng, n) for n in (1400, 2100, 900, 2600, 1300)]
    pairs = [(i, j) for i in range(1, 5) for j in range(i)]
    cfg = TorchConfig(rb_conveyor=RB, snap_k=K, conveyors=conveyors, device="cpu")
    seen = []
    got = conv.align_pairs_conveyor(
        genes, pairs, 3, 2, device=CPU, config=cfg,
        on_result=lambda idx, triple: seen.append((idx, triple)),
    )
    for (i, j), res in zip(pairs, got):
        assert res == nw_align_numpy(genes[i], genes[j], 3, 2), (i, j)
    # Once per pair, as each decode finishes: in any order.
    assert sorted(seen) == list(enumerate(got))


def test_hbm_autosplit(monkeypatch):
    """Over-budget snapshots split the workload into sub-sweeps, still exact."""
    rng = np.random.default_rng(7)
    genes = [_rand_seq(rng, n) for n in (650, 550, 450, 350)]
    pairs = [(i, j) for i in range(1, 4) for j in range(i)]
    full = conv.plan_sweeps(genes, pairs, 256, 128, conveyors=1).snapshot_bytes
    cfg = TorchConfig(rb_conveyor=256, snap_k=128, conveyors=1, hbm_budget=int(full * 0.8))
    calls = {"n": 0}
    real_plan = conv.plan_conveyor

    def counting_plan(*a, **kw):
        calls["n"] += 1
        return real_plan(*a, **kw)

    monkeypatch.setattr(conv, "plan_conveyor", counting_plan)
    got = conv.align_pairs_conveyor(genes, pairs, 3, 2, device=CPU, config=cfg)
    assert calls["n"] >= 3, "workload did not split"
    for (i, j), res in zip(pairs, got):
        assert res == nw_align_numpy(genes[i], genes[j], 3, 2), (i, j)


def test_single_pair_over_budget_raises():
    cfg = TorchConfig(rb_conveyor=1024, snap_k=1024, hbm_budget=1)
    with pytest.raises(ValueError, match="single pair"):
        conv.align_pairs_conveyor(["A" * 2048, "C" * 2048], [(0, 1)], 3, 2, device=CPU, config=cfg)


@pytest.mark.parametrize(
    "rb,snap_k,match", [(1000, 128, "multiple"), (8192, 1024, "one block"), (64, 128, "multiple")]
)
def test_fill_rejects_bad_geometry(rb, snap_k, match):
    with pytest.raises(ValueError, match=match):
        conv.plan_sweeps(["ACGT" * 10, "GT" * 9], [(0, 1)], rb, snap_k, 1)


def test_fill_rejects_other_devices():
    wl = conv.plan_sweeps(["ACGT" * 10, "GT" * 9], [(0, 1)], 128, 128, 1)
    table = torch.zeros((2, 40), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv.conveyor_fill(table, wl, 3, 2, 0, 1, conv.conveyor_state(wl, CPU))


def _problem(seed=42):
    rng = np.random.default_rng(seed)
    genes = tuple(
        "".join(rng.choice(ALPHA, int(rng.integers(120, 500)))) for _ in range(5)
    )
    return Problem(pxy=3, pgap=2, genes=genes)


@pytest.mark.parametrize("conveyors", [1, 0, 4])
def test_kway_conveyor_matches_jax_package(monkeypatch, conveyors):
    seen = []
    real = conv.conveyor_fill

    def spy(table, wl, *args):
        seen.append(wl.num_pairs)
        return real(table, wl, *args)

    monkeypatch.setattr(conv, "conveyor_fill", spy)
    problem = _problem()
    cfg = TorchConfig(rb_conveyor=256, snap_k=128, host_threshold=1, device="cpu",
                      fill_mode="conveyor", conveyors=conveyors)
    got = kway.align_kway(problem, config=cfg)
    want = jax_align_kway(problem, backend="numpy")
    assert seen and set(seen) == {10}  # every segment covered all 10 pairs
    assert (got.chain_hash, got.penalties) == (want.chain_hash, want.penalties)


def test_choose_fill_mode():
    for mode in ("banded", "conveyor"):
        assert kway.choose_fill_mode(TorchConfig(fill_mode=mode)) == mode
    # "auto" follows the card's A/B: the pipelined banded fill.
    assert kway.choose_fill_mode(TorchConfig(fill_mode="auto")) == "banded"
    with pytest.raises(ValueError, match="fill_mode"):
        kway.choose_fill_mode(TorchConfig(fill_mode="striped"))


def test_config_conveyor_knobs_from_env(monkeypatch):
    monkeypatch.setenv("MSA_TPU_TORCH_FILL_MODE", "conveyor")
    monkeypatch.setenv("MSA_TPU_TORCH_CONVEYORS", "26")
    cfg = TorchConfig.from_env()
    assert (cfg.fill_mode, cfg.conveyors, cfg.rb_conveyor) == ("conveyor", 26, 7168)
    assert cfg.rb_conveyor % cfg.snap_k == 0
