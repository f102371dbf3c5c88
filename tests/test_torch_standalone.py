"""The port stands alone: its copies of the JAX package's host code, its host
kernel, the fill's item table, and no silent CPU route.

Each copied module is held against ``msa_tpu``'s on seeded inputs (equal
results, tolerance 0); the port's C++ host kernel against ``msa_tpu.native``
and the numpy oracle.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import msa_tpu.native as jax_native
from msa_tpu.ops import reference as jax_reference
from msa_tpu.utils import alignment as jax_alignment
from msa_tpu.utils import checkpoint as jax_checkpoint
from msa_tpu.utils import hashing as jax_hashing
from msa_tpu.utils import msaio as jax_msaio
from msa_tpu.utils import tasks as jax_tasks
from msa_tpu.utils import timing as jax_timing
from msa_tpu_torch import native
from msa_tpu_torch.config import TorchConfig
from msa_tpu_torch.models import pairwise
from msa_tpu_torch.ops import band_fill as bf
from msa_tpu_torch.ops import reference
from msa_tpu_torch.utils import alignment, checkpoint, hashing, msaio, tasks, timing

ALPHA = list("ACGT")


def _seqs(seed, lengths):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(ALPHA, n)) for n in lengths]


def _hash(mods, rng):
    a1, a2 = _seqs(int(rng.integers(1 << 30)), [57, 64])
    return mods.pair_hash(a1, a2), mods.hash_alignment_pair(a1, a2), mods.sha512_hex(a1.encode())


def _chain(mods, rng):
    hashes = [jax_hashing.sha512_hex(s) for s in _seqs(int(rng.integers(1 << 30)), [5] * 7)]
    return mods.chain_hashes(hashes), mods.chain_update("", hashes[0])


def _parse_format(mods, rng):
    genes = _seqs(int(rng.integers(1 << 30)), [int(n) for n in rng.integers(1, 40, 6)])
    text = f"3 2 {len(genes)}\n" + "\n".join(genes) + "\n"
    problem = mods.parse_input(text)
    pens = [int(p) for p in rng.integers(0, 999, 15)]
    out = mods.format_output(1234, "ab" * 64, pens)
    return (problem.pxy, problem.pgap, problem.genes, problem.k, problem.num_pairs, out,
            mods.format_result_lines("ab" * 64, pens), mods.parse_input(text.encode()).genes)


def _moves(mods, rng):
    # Short walks take the scalar builder, long ones (>= 4096 moves) numpy's.
    out = []
    for m, n in [(40, 33), (2600, 2300), (5, 300)]:
        x, y = _seqs(int(rng.integers(1 << 30)), [m, n])
        dp = jax_reference.nw_dp_matrix(x, y, 3, 2)
        moves = jax_reference.walk_dirs(jax_reference.nw_dirs(dp, x, y, 3, 2), m, n)
        out.append(mods.moves_to_alignment(x, y, moves))
    return out


def _task_ids(mods, rng):
    k = int(rng.integers(2, 30))
    return mods.pair_task_list(k), mods.num_pairs(k), mods.task_id(k - 1, k // 3)


def _journal(mods, rng, tmp_path):
    genes = _seqs(int(rng.integers(1 << 30)), [30, 20, 10])
    key = mods.problem_key(3, 2, genes)
    path = tmp_path / f"{mods.__name__}.jsonl"
    with mods.PairJournal(str(path), key) as journal:
        for tid in range(3):
            journal.record(tid, int(rng.integers(100)), hashing.sha512_hex(str(tid)))
    with open(path, "a") as f:
        f.write('{"torn": ')  # a crash mid-write
    return key, mods.PairJournal(str(path), key).load(), mods.PairJournal(str(path), "other").load()


def _timing(mods, rng):
    timer = mods.StageTimer()
    for name in ("a", "b", "a"):
        with timer.stage(name):
            pass
    return mods.gcups(int(rng.integers(1 << 40)), 1.5), mods.gcups(7, 0), sorted(timer.counts.items())


def _oracle(mods, rng):
    x, y = _seqs(int(rng.integers(1 << 30)), [180, 2500])
    return (mods.nw_score_numpy(x, y, 3, 2), mods.nw_align_numpy(x, y, 3, 2),
            mods.nw_align_numpy_blocked(x, y, 5, 1, block=64), mods.nw_dp_matrix(x[:50], y[:40], 3, 2).tolist())


CASES = {
    "hash": (_hash, hashing, jax_hashing),
    "chain": (_chain, hashing, jax_hashing),
    "parse_format": (_parse_format, msaio, jax_msaio),
    "moves_to_alignment": (_moves, alignment, jax_alignment),
    "task_ids": (_task_ids, tasks, jax_tasks),
    "journal": (_journal, checkpoint, jax_checkpoint),
    "timing": (_timing, timing, jax_timing),
    "reference": (_oracle, reference, jax_reference),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copied_util_equals_jax_package(case, tmp_path):
    fn, port_mod, jax_mod = CASES[case]
    extra = (tmp_path,) if case == "journal" else ()
    got = fn(port_mod, np.random.default_rng(len(case)), *extra)
    want = fn(jax_mod, np.random.default_rng(len(case)), *extra)
    assert got == want


@pytest.mark.parametrize("m,n", [(1, 1), (37, 120), (300, 290), (2000, 6), (6, 2000), (700, 1900)])
def test_native_equals_jax_native_and_oracle(m, n):
    x, y = _seqs(m * 7919 + n, [m, n])
    got = native.nw_align_native(x, y, 3, 2)
    assert got == jax_native.nw_align_native(x, y, 3, 2) == reference.nw_align_numpy(x, y, 3, 2)
    want = jax_native.nw_score_native(x, y, 4, 3)
    assert native.nw_score_native(x, y, 4, 3) == reference.nw_score_numpy(x, y, 4, 3) == want
    assert native.native_available()


def test_native_builds_into_the_port(tmp_path, monkeypatch):
    """The host library is built by g++ from the port's source; a failed build raises."""
    assert native.lib_path().startswith(native.BUILD)
    assert native.build() == native.lib_path()
    monkeypatch.setattr(native, "BUILD", str(tmp_path))
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing.cpp"))
    with pytest.raises((RuntimeError, OSError)):
        native.build()


@settings(max_examples=60, deadline=None)
@given(
    lengths=st.lists(st.integers(1, 400), min_size=2, max_size=6),
    rb=st.integers(1, 130),
    snap_k=st.integers(1, 1500),
    snaps=st.booleans(),
    data=st.data(),
)
def test_item_table_order(lengths, rb, snap_k, snaps, data):
    """Every band once, producer before consumer, one slot per band."""
    k = len(lengths)
    pairs = data.draw(st.lists(st.tuples(st.integers(0, k - 1), st.integers(0, k - 1)),
                               min_size=1, max_size=8))
    plan = bf.plan_pairs(lengths, pairs, rb, snap_k, snaps=snaps)
    nb = plan.params[:, bf.P_NB]
    assert plan.num_items == int(nb.sum())
    items = plan.items
    assert items.dtype == np.int32 and items.shape == (int(nb.sum()), 3)
    seen = {(int(p), int(b)): t for t, (p, b, _) in enumerate(items)}
    assert len(seen) == plan.num_items
    assert set(seen) == {(p, b) for p in range(plan.num_pairs) for b in range(int(nb[p]))}
    first_slot = np.concatenate([[0], np.cumsum(nb)[:-1]])
    for t, (p, b, slot) in enumerate(items.tolist()):
        assert slot == first_slot[p] + b
        if b:
            assert seen[(p, b - 1)] < t
    assert 1 <= plan.chunk <= bf.CHUNK_MAX
    assert not snaps or snap_k % plan.chunk == 0


def test_item_table_starts_the_longest_chain():
    plan = bf.plan_pairs([3000, 200, 2500], [(1, 0), (0, 2), (2, 1)], 500, 256)
    assert plan.items[0].tolist() == [1, 0, 1]  # 3000 x 2500: the longest chain, slot 1
    assert plan.chunk == 256
    assert bf.plan_pairs([10, 10], [(0, 1)], 4, 1, snaps=False).chunk == bf.CHUNK_MAX
    assert bf.chunk_steps(3000, True) == 1000


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_pipeline_device_raises_without_card(monkeypatch, backend):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu") as err:
        pairwise.pipeline_device(backend, TorchConfig())
    assert "MSA_TPU_TORCH_DEVICE=cpu" in str(err.value) and "numpy" in str(err.value)
    assert pairwise.pipeline_device(backend, TorchConfig(device="cpu")) == torch.device("cpu")
    assert pairwise.pipeline_device("native", TorchConfig()) is None


def test_cli_without_card_asks_for_the_cpu(monkeypatch, data_dir, capsys):
    from msa_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        main(["--input", str(data_dir / "mseq.dat")])
    assert capsys.readouterr().out == ""
    assert main(["--backend", "native", "--input", str(data_dir / "mseq.dat")]) == 0
    assert capsys.readouterr().out.split("\n")[2] == "5 4 9 "
