"""The port's banded fill (plain version, CPU) against the JAX Pallas fill.

Inputs come from a numpy seed. The JAX side runs ``_band_sweep_call`` in
interpret mode, as ``tests/test_pallas_kernels.py`` runs it; its output goes
through ``msa_tpu_torch.state.fill_state_from_jax``. Score, bottom rows and
every snapshot entry that is a DP cell must be equal as int32 (tolerance 0).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from msa_tpu.ops.pallas_nw import SNAP_K, _band_sweep
from msa_tpu.ops.reference import nw_score_numpy
from msa_tpu_torch.ops.band_fill import band_fill, gene_table, plan_pairs
from msa_tpu_torch.state import (
    fill_state_from_jax,
    pair_rows,
    pair_snaps,
    valid_snapshot_cells,
)

ALPHA = list("ACGT")


def _rand_seq(rng, n):
    return "".join(rng.choice(ALPHA, n))


def _port_fill(genes, pairs, pxy, pgap, rb, snap_k):
    plan = plan_pairs([len(g) for g in genes], pairs, rb, snap_k)
    table = torch.from_numpy(gene_table(genes))
    return plan, band_fill(table, plan, pxy, pgap)


@pytest.mark.parametrize(
    "m,n,pxy,pgap,rb",
    [
        (130, 290, 3, 2, 8192),  # cases of test_pallas_kernels.py:32-56
        (300, 140, 5, 1, 8192),
        (257, 257, 2, 3, 8192),
        (400, 230, 3, 2, 128),  # multi-band
        (300, 2500, 3, 2, 128),  # align geometry: 3 bands, 3 snapshots each
    ],
)
def test_fill_matches_jax(m, n, pxy, pgap, rb):
    rng = np.random.default_rng(m * 1000 + n)
    x, y = _rand_seq(rng, m), _rand_seq(rng, n)
    score, rows, snaps = _band_sweep(
        x, y, pxy, pgap, rb=rb, emit_rows=True, emit_snaps=True,
        interpret=True, unroll=1,
    )
    snaps = np.asarray(snaps)
    v_len = snaps.shape[2] * snaps.shape[3]
    want = fill_state_from_jax(
        score, rows, snaps, m=m, n=n, rb=rb, v_len=v_len, snap_k=SNAP_K
    )
    plan, got = _port_fill([x, y], [(0, 1)], pxy, pgap, rb, SNAP_K)

    assert int(got.score[0]) == int(want.score[0]) == nw_score_numpy(x, y, pxy, pgap)
    assert torch.equal(pair_rows(got, plan, 0), pair_rows(want, plan, 0))
    valid = torch.from_numpy(valid_snapshot_cells(plan, 0))
    assert valid.any()
    assert torch.equal(pair_snaps(got, plan, 0)[valid], pair_snaps(want, plan, 0)[valid])


def test_fill_many_pairs_match_single_pairs():
    """One call over several pairs lays each pair out as it would alone."""
    rng = np.random.default_rng(5)
    genes = [_rand_seq(rng, n) for n in (210, 95, 340)]
    pairs = [(1, 0), (2, 0), (2, 1), (0, 2)]
    plan, fill = _port_fill(genes, pairs, 3, 2, rb=100, snap_k=64)
    for p, (i, j) in enumerate(pairs):
        one_plan, one = _port_fill([genes[i], genes[j]], [(0, 1)], 3, 2, 100, 64)
        assert int(fill.score[p]) == int(one.score[0]) == nw_score_numpy(
            genes[i], genes[j], 3, 2
        )
        assert torch.equal(pair_rows(fill, plan, p), pair_rows(one, one_plan, 0))
        assert torch.equal(pair_snaps(fill, plan, p), pair_snaps(one, one_plan, 0))


@pytest.mark.parametrize("rb,snap_k", [(1, 5), (37, 50), (64, 1024)])
def test_fill_score_odd_geometry(rb, snap_k):
    """rb and snap_k are runtime sizes with no alignment rule."""
    rng = np.random.default_rng(rb)
    x, y = _rand_seq(rng, 90), _rand_seq(rng, 70)
    _, fill = _port_fill([x, y], [(0, 1)], 4, 3, rb, snap_k)
    assert int(fill.score[0]) == nw_score_numpy(x, y, 4, 3)


def test_fill_rejects_other_devices():
    table = torch.zeros((2, 4), dtype=torch.uint8, device="meta")
    plan = plan_pairs([4, 4], [(0, 1)], 8, 8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        band_fill(table, plan, 3, 2)
