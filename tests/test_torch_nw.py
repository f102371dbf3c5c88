"""The port's anti-diagonal sweep (``ops/nw_torch.py``) against ``msa_tpu.ops.nw_jax``.

Inputs come from numpy seeds and the cases of ``tests/test_nw_jax.py``. The
sweeps compare on the JAX package's own padded buffers (``_prep_pair``), so
scores and the dirs of every cell of the m x n rectangle must be equal as
integers; alignments must be the same strings. Tolerance 0 throughout.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.ops import nw_jax
from msa_tpu.ops.reference import nw_align_numpy, nw_score_numpy
from msa_tpu_torch.ops import nw_torch
from tests.test_nw_jax import CASES
from tests.test_torch_slice import MSEQ1_HASH, MSEQ1_PENALTIES, MSEQ_HASH

ALPHA = list("ACGT")
# (m, n): square, skewed both ways, and one side of a single character. All
# stay under 256, so the JAX sweep compiles once per padded shape.
SHAPES = [(120, 97), (30, 230), (230, 30), (1, 75), (200, 200)]


def _pair(seed, m, n):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(ALPHA, m)), "".join(rng.choice(ALPHA, n))


@pytest.mark.parametrize("x,y,pxy,pgap", CASES)
def test_cases_match_jax(x, y, pxy, pgap):
    assert nw_torch.nw_score_torch(x, y, pxy, pgap) == nw_jax.nw_score_jax(x, y, pxy, pgap)
    assert nw_torch.nw_align_torch(x, y, pxy, pgap) == nw_jax.nw_align_jax(x, y, pxy, pgap)


@pytest.mark.parametrize("m,n", SHAPES)
def test_sweep_scores_and_dirs_match_jax(m, n):
    x, y = _pair(m * 1000 + n, m, n)
    pxy, pgap = 3, 2
    xpad, ybuf, _, _, _, _ = nw_jax._prep_pair(x, y)
    for swap in (0, 1):
        want_score, want_dirs, _ = nw_jax.diag_sweep(
            jnp.asarray(xpad), jnp.asarray(ybuf), jnp.int32(m), jnp.int32(n), pxy, pgap,
            swap=jnp.int32(swap), emit_dirs=True,
        )
        got_score, got_dirs, _ = nw_torch.diag_sweep(
            torch.from_numpy(xpad), torch.from_numpy(ybuf), m, n, pxy, pgap,
            swap=swap, emit_dirs=True,
        )
        assert int(got_score.item()) == int(want_score) == nw_score_numpy(x, y, pxy, pgap)
        i = np.arange(1, m + 1)[:, None]
        j = np.arange(1, n + 1)[None, :]
        want = np.asarray(want_dirs)[i + j - 1, i]
        got = got_dirs.numpy()[i + j - 1, i]
        assert want.shape == (m, n)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,n", SHAPES)
def test_unpadded_prep_matches_padded(m, n):
    """The port's buffers (no bucket padding) give the JAX-padded score."""
    x, y = _pair(m + 7 * n, m, n)
    xpad, ybuf, mm, nn, Mp, Np = nw_torch._prep_pair(x, y)
    assert (mm, nn, Mp, Np) == (m, n, m, n)
    score, dirs, _ = nw_torch.diag_sweep(torch.from_numpy(xpad), torch.from_numpy(ybuf), m, n, 4, 3)
    assert dirs is None
    assert int(score.item()) == nw_jax.nw_score_jax(x, y, 4, 3)


@pytest.mark.parametrize("m,n", SHAPES)
def test_align_matches_jax(m, n):
    x, y = _pair(m * 31 + n, m, n)
    got = nw_torch.nw_align_torch(x, y, 3, 2)
    assert got == nw_jax.nw_align_jax(x, y, 3, 2) == nw_align_numpy(x, y, 3, 2)


def test_cli_torch_backend_goldens(data_dir, capsys):
    from msa_tpu_torch.cli import main

    for name, hash_, pens in [
        ("mseq.dat", MSEQ_HASH, [5, 4, 9]),
        ("mseq1.dat", MSEQ1_HASH, MSEQ1_PENALTIES),
    ]:
        assert main(["--backend", "torch", "--platform", "cpu", "--input", str(data_dir / name)]) == 0
        lines = capsys.readouterr().out.split("\n")
        assert lines[1] == hash_
        assert lines[2] == "".join(f"{p} " for p in pens)


def test_torch_backend_takes_no_pipeline():
    """Every pair of the torch backend goes through the sweep, none to fill + walk."""
    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.models.pairwise import PairwiseAligner

    aligner = PairwiseAligner(3, 2, backend="torch", config=TorchConfig(host_threshold=0, device="cpu"))
    assert aligner.device == torch.device("cpu")
    x, y = _pair(5, 40, 60)
    assert not aligner.on_device(x, y)
    assert aligner.align(x, y) == nw_align_numpy(x, y, 3, 2)
