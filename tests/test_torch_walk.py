"""The port's traceback walk (plain version, CPU) against the JAX Pallas walk.

Alignments must be byte-exact against ``nw_align_pallas`` in interpret mode
and against the numpy oracle. The cross-fed case hands the JAX fill's output,
mapped by ``fill_state_from_jax``, to the port's walk.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from msa_tpu.ops.pallas_nw import SNAP_K, _band_sweep
from msa_tpu.ops.pallas_walk import nw_align_pallas
from msa_tpu.ops.reference import nw_align_numpy
from msa_tpu.utils.alignment import moves_to_alignment
from msa_tpu_torch.ops.band_fill import gene_table, plan_pairs
from msa_tpu_torch.ops.batch import align_pairs_batched
from msa_tpu_torch.ops.walk import (
    W_SWAP,
    banded_walk_plan,
    decode_moves,
    pack_moves,
    pair_moves,
    walk_ref,
)
from msa_tpu_torch.state import fill_state_from_jax

ALPHA = list("ACGT")
CPU = torch.device("cpu")


def _rand_seq(rng, n):
    return "".join(rng.choice(ALPHA, n))


def _port_align(x, y, pxy, pgap, rb, snap_k):
    return align_pairs_batched(
        [x, y], [(0, 1)], pxy, pgap, device=CPU, rb=rb, snap_k=snap_k
    )[0]


def _jax_align(x, y, pxy, pgap):
    return nw_align_pallas(
        x, y, pxy, pgap, interpret=True, rb_align=128, x_cap=1, y_cap_req=1
    )


@pytest.mark.parametrize(
    "m,n,pxy,pgap",
    [
        (300, 280, 3, 2),  # cases of test_pallas_kernels.py:64-94
        (500, 600, 3, 2),
        (200, 700, 5, 1),
        (500, 150, 4, 3),
    ],
)
def test_walk_matches_jax(m, n, pxy, pgap):
    rng = np.random.default_rng(m + 17 * n)
    x, y = _rand_seq(rng, m), _rand_seq(rng, n)
    want = _jax_align(x, y, pxy, pgap)
    assert want == nw_align_numpy(x, y, pxy, pgap)
    # The JAX geometry (rb 128, one segment per band), then windows that
    # start above lane 0 (rb > snap_k + 128) and many segments per band.
    assert _port_align(x, y, pxy, pgap, 128, SNAP_K) == want
    assert _port_align(x, y, pxy, pgap, 333, 64) == want


@pytest.mark.parametrize(
    "m,n,rb,snap_k,want_w0_zero",
    [
        # The walk enters segments within ``steps`` of the band top, so the
        # window starts at lane 0 (w0 = 0) while the entry is above it.
        (420, 380, 200, 64, True),
        # snap_k > rb: the window is the whole band, w0 = 0 throughout.
        (300, 340, 48, 128, True),
    ],
)
def test_walk_cone_window(monkeypatch, m, n, rb, snap_k, want_w0_zero):
    """The window that follows the cone, in the geometries where it is
    clamped, against the Pallas walk and the numpy oracle."""
    from msa_tpu_torch.ops import walk as wk

    seen = []
    real = wk.segment

    def spy(i, j, *a):
        out = real(i, j, *a)
        seen.append(out)
        return out

    monkeypatch.setattr(wk, "segment", spy)
    rng = np.random.default_rng(m * n + rb)
    x, y = _rand_seq(rng, m), _rand_seq(rng, n)
    want = _jax_align(x, y, 3, 2)
    assert want == nw_align_numpy(x, y, 3, 2)
    assert _port_align(x, y, 3, 2, rb, snap_k) == want
    # (band, i0, q, dl0, w0, steps): entries at lane q >= 1 whose window
    # starts at 0 below the cone's edge q - steps + 1.
    clamped = [s for s in seen if s[4] == 0 and 1 <= s[2] and s[2] - s[5] + 1 < 0]
    assert bool(clamped) == want_w0_zero
    assert any(s[4] > 0 for s in seen) == (snap_k <= rb)


def test_walk_repetitive_matches_jax():
    """Repetitive sequences maximize tie-breaking pressure in the walk."""
    x = "ACAC" * 80 + "GG" + "ACAC" * 20
    y = "ACAC" * 95 + "TT"
    want = _jax_align(x, y, 3, 2)
    assert want == nw_align_numpy(x, y, 3, 2)
    assert _port_align(x, y, 3, 2, 128, SNAP_K) == want
    assert _port_align(x, y, 3, 2, 300, 40) == want


@pytest.mark.parametrize("m,n,pxy,pgap", [(500, 600, 3, 2), (300, 2500, 4, 1)])
def test_walk_on_jax_fill(m, n, pxy, pgap):
    """The JAX fill's output, mapped into the port's layout, feeds the walk."""
    rng = np.random.default_rng(3 * m + n)
    x, y = _rand_seq(rng, m), _rand_seq(rng, n)
    score, rows, snaps = _band_sweep(
        x, y, pxy, pgap, rb=128, emit_rows=True, emit_snaps=True,
        interpret=True, unroll=1,
    )
    snaps = np.asarray(snaps)
    fill = fill_state_from_jax(
        score, rows, snaps, m=m, n=n, rb=128,
        v_len=snaps.shape[2] * snaps.shape[3], snap_k=SNAP_K,
    )
    plan = plan_pairs([m, n], [(0, 1)], 128, SNAP_K)
    words, counts = walk_ref(
        torch.from_numpy(gene_table([x, y])), banded_walk_plan(plan), fill.rows,
        fill.snaps, pxy, pgap,
    )
    moves = decode_moves(words.numpy()[None, :], counts.numpy())
    want = nw_align_numpy(x, y, pxy, pgap)
    assert (int(fill.score[0]), *moves_to_alignment(x, y, moves)) == want


def test_pack_moves_inverts_decode():
    rng = np.random.default_rng(1)
    for count in (0, 1, 15, 16, 17, 100):
        moves = rng.integers(0, 4, count).astype(np.uint32)
        words = pack_moves(moves)
        assert len(words) == -(-count // 16)
        got = decode_moves(words[None, :], np.array([count]))
        assert got.tolist() == moves.tolist()


def test_walk_skewed_pairs():
    """Tall-thin and short-wide pairs: one-column bands and one-row bands."""
    rng = np.random.default_rng(8)
    genes = [_rand_seq(rng, n) for n in (700, 3, 1, 650)]
    pairs = [(0, 1), (1, 0), (0, 2), (2, 3), (3, 0)]
    got = align_pairs_batched(genes, pairs, 3, 2, device=CPU, rb=100, snap_k=64)
    for (i, j), res in zip(pairs, got):
        assert res == nw_align_numpy(genes[i], genes[j], 3, 2), (i, j)


@pytest.mark.parametrize("rb,snap_k", [(100, 64), (1024, 1024), (48, 128)])
def test_walk_swap_transposed_pairs(rb, snap_k):
    """Pairs filled transposed and walked with swap = 1 give, swapped back,
    the original orientation's alignment (the up/left tie-break flips)."""
    from msa_tpu_torch.ops.band_fill import band_fill

    rng = np.random.default_rng(rb + snap_k)
    genes = [_rand_seq(rng, n) for n in (420, 90, 260, 15)]
    pairs = [(1, 0), (2, 0), (3, 2), (0, 3)]
    transposed = [(j, i) for i, j in pairs]
    plan = plan_pairs([len(g) for g in genes], transposed, rb, snap_k)
    wplan = banded_walk_plan(plan)
    wplan.pairs[:, W_SWAP] = 1
    table = torch.from_numpy(gene_table(genes))
    fill = band_fill(table, plan, 3, 2)
    words, counts = walk_ref(table, wplan, fill.rows, fill.snaps, 3, 2)
    for p, (i, j) in enumerate(pairs):
        moves = pair_moves(words.numpy(), counts.numpy(), wplan, p)
        aj, ai = moves_to_alignment(genes[j], genes[i], moves)
        want = nw_align_numpy(genes[i], genes[j], 3, 2)
        assert (int(fill.score[p]), ai, aj) == want, (i, j)
