"""The CUDA kernels against their plain versions, on a card.

Marked ``cuda``; each test skips without a CUDA device. On the machine with
the card (which has no jax, so the suite's conftest cannot load) run::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from msa_tpu.ops.reference import nw_align_numpy
from msa_tpu_torch.ops import band_fill as bf
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
    words, counts = wk.walk(table, plan, fill, 3, 2)
    rwords, rcounts = wk.walk_ref(table, plan, fill, 3, 2)
    assert torch.equal(words, rwords) and torch.equal(counts, rcounts)


def test_pipeline_on_card_matches_oracle(card):
    genes = _genes(9, [1500, 1300, 900])
    pairs = [(1, 0), (2, 0), (2, 1)]
    got = align_pairs_batched(genes, pairs, 3, 2, device=card, rb=511, snap_k=256)
    for (i, j), res in zip(pairs, got):
        assert res == nw_align_numpy(genes[i], genes[j], 3, 2)


def test_fill_rejects_too_wide_band(card):
    plan = bf.plan_pairs([10, 10], [(0, 1)], 8192, 64)
    table = torch.zeros((2, 10), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="rb <="):
        bf.band_fill(table, plan, 3, 2)
