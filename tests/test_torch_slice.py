"""The port's slice end to end on the CPU: k-way engine, CLI, import rules.

On the CPU the device pipeline runs the kernels' plain versions (the
tensors lie on the CPU). Results must equal the JAX package's numpy backend
in chain hash and penalties, and the CLI must reproduce the goldens.
"""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from msa_tpu.models.kway import align_kway as jax_align_kway
from msa_tpu.utils.msaio import Problem
from msa_tpu_torch.config import TorchConfig
from msa_tpu_torch.models import pairwise
from msa_tpu_torch.models.kway import align_kway
from msa_tpu_torch.ops import batch

REPO = pathlib.Path(__file__).resolve().parent.parent
MSEQ_HASH = (
    "602d0f604e8fb908195d53e681094f7d063c4168a33a18f32b4ca3d29f27073a"
    "486dca2ab98aab9eb47f5c407b5c59b8e6c0fa8ef4d07d131b8d6a66a37a065f"
)
MSEQ1_HASH = (
    "4d676f40ea4c1e6b79f546d8c87214c5c7c18e3e55ed0844edfdc73b82bbc9f2"
    "1b0f4a2eab30b0ddb6b499b623e23e5dd598ef7a5c7175ecfc0235ac0858c20a"
)
MSEQ1_PENALTIES = [
    5, 4, 9, 12, 14, 11, 11, 10, 11, 10, 20, 22, 16, 8, 15, 36, 38, 32,
    24, 28, 22, 31, 30, 27, 22, 20, 22, 20, 20, 22, 16, 8, 15, 0, 22, 22,
]


def _problem(seed=42):
    rng = np.random.default_rng(seed)
    genes = tuple(
        "".join(rng.choice(list("ACGT"), int(rng.integers(120, 500))))
        for _ in range(5)
    )
    return Problem(pxy=3, pgap=2, genes=genes)


@pytest.fixture
def device_pairs(monkeypatch):
    """Counts the pairs of each fill launch of the banded device pipeline."""
    seen = []
    real = batch.band_fill

    def spy(table, plan, pxy, pgap):
        seen.append(plan.num_pairs)
        return real(table, plan, pxy, pgap)

    monkeypatch.setattr(batch, "band_fill", spy)
    return seen


@pytest.mark.parametrize("rb,snap_k", [(128, 1024), (200, 96)])
def test_kway_matches_jax_package(device_pairs, rb, snap_k):
    problem = _problem()
    cfg = TorchConfig(rb=rb, snap_k=snap_k, host_threshold=1, device="cpu", fill_mode="banded")
    got = align_kway(problem, config=cfg)
    want = jax_align_kway(problem, backend="numpy")
    assert sum(device_pairs) == 10  # all 10 pairs took fill + walk
    assert got.penalties == want.penalties
    assert got.chain_hash == want.chain_hash


def test_kway_threshold_splits_host_and_device(device_pairs):
    problem = _problem(7)
    lens = [len(g) for g in problem.genes]
    cells = sorted(lens[i] * lens[j] for i in range(5) for j in range(i))
    cfg = TorchConfig(rb=150, snap_k=128, host_threshold=cells[5], device="cpu",
                      fill_mode="banded")
    got = align_kway(problem, config=cfg)
    assert sum(device_pairs) == 5
    want = jax_align_kway(problem, backend="numpy")
    assert (got.chain_hash, got.penalties) == (want.chain_hash, want.penalties)


def test_kway_checkpoint_resume(tmp_path, device_pairs):
    problem = _problem(3)
    cfg = TorchConfig(rb=128, snap_k=256, host_threshold=1, device="cpu", fill_mode="banded")
    path = str(tmp_path / "journal.jsonl")
    first = align_kway(problem, config=cfg, checkpoint=path)
    again = align_kway(problem, config=cfg, checkpoint=path)
    assert sum(device_pairs) == 10  # the resumed run had nothing left to do
    assert (again.chain_hash, again.penalties) == (first.chain_hash, first.penalties)


@pytest.mark.parametrize("backend", ["numpy", "native", "auto"])
def test_cli_goldens(data_dir, capsys, backend):
    from msa_tpu_torch.cli import main

    for name, hash_, pens in [
        ("mseq.dat", MSEQ_HASH, [5, 4, 9]),
        ("mseq1.dat", MSEQ1_HASH, MSEQ1_PENALTIES),
    ]:
        assert main(["--backend", backend, "--platform", "cpu", "--input", str(data_dir / name)]) == 0
        lines = capsys.readouterr().out.split("\n")
        assert lines[0].startswith("Time: ") and lines[0].endswith(" us")
        assert lines[1] == hash_
        assert lines[2] == "".join(f"{p} " for p in pens)


def test_cli_module_stdin_contract(data_dir):
    with open(data_dir / "mseq.dat", "rb") as f:
        out = subprocess.run(
            [sys.executable, "-m", "msa_tpu_torch.cli", "--platform", "cpu"], stdin=f, cwd=REPO,
            capture_output=True, check=True, timeout=120,
        ).stdout.decode()
    lines = out.split("\n")
    assert lines[1] == MSEQ_HASH and lines[2] == "5 4 9 " and out.endswith("\n")


def test_pairwise_aligner_routes_by_threshold(device_pairs):
    from msa_tpu.ops.reference import nw_align_numpy

    x, y = _problem(11).genes[:2]
    cfg = TorchConfig(rb=64, snap_k=64, host_threshold=len(x) * len(y), device="cpu")
    aligner = pairwise.PairwiseAligner(3, 2, backend="auto", config=cfg)
    assert aligner.align(x, y) == nw_align_numpy(x, y, 3, 2)  # device pipeline
    assert aligner.align(x, y[:-1]) == nw_align_numpy(x, y[:-1], 3, 2)  # host
    assert device_pairs == [1]


def test_cuda_backend_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pairwise.pipeline_device("cuda", TorchConfig())
    with pytest.raises(RuntimeError, match="--platform cpu"):
        pairwise.pipeline_device("auto", TorchConfig())
    with pytest.raises(ValueError, match="unknown backend"):
        pairwise.pipeline_device("pallas", TorchConfig())


def test_config_from_env(monkeypatch):
    monkeypatch.setenv("MSA_TPU_TORCH_RB", "4095")
    monkeypatch.setenv("MSA_TPU_TORCH_DEVICE", "cpu")
    cfg = TorchConfig.from_env()
    assert (cfg.rb, cfg.device, cfg.snap_k) == (4095, "cpu", 1024)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "msa_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "fill_ablation.py", REPO / "walk_ablation.py"]
    assert len(files) > 8
    assert {REPO / "msa_tpu_torch" / "scripts" / f"{name}.py" for name in (
        "conformance", "schedule_compare", "scaling_curve", "sweep", "plot_bench", "bench")} | {
            REPO / "msa_tpu_torch" / "goldens" / "pod.py"} <= set(files)
    for path in files:
        for name in _imports(path):
            # The port keeps its own copies of the host code it shares with
            # the JAX package: it imports nothing of it.
            assert name.split(".")[0] not in ("jax", "msa_tpu"), f"{path} imports {name}"


def test_port_modules_leave_jax_unimported():
    """Importing every module of the port, the engine's included, loads no jax
    and nothing of the JAX package."""
    files = sorted((REPO / "msa_tpu_torch").rglob("*.py"))
    rel = {str(p.relative_to(REPO)) for p in files}
    assert {"msa_tpu_torch/parallel/engine.py", "msa_tpu_torch/parallel/costmodel.py",
            "msa_tpu_torch/parallel/mesh.py", "msa_tpu_torch/ops/nw_torch.py",
            "msa_tpu_torch/utils/timing.py", "msa_tpu_torch/utils/logging.py",
            "msa_tpu_torch/ops/nw_striped.py", "msa_tpu_torch/goldens/spec_cap.py",
            "msa_tpu_torch/goldens/pod.py", "msa_tpu_torch/scripts/gen_workload.py",
            "msa_tpu_torch/scripts/ab_compare.py", "msa_tpu_torch/scripts/conformance.py",
            "msa_tpu_torch/scripts/schedule_compare.py", "msa_tpu_torch/scripts/scaling_curve.py",
            "msa_tpu_torch/scripts/sweep.py", "msa_tpu_torch/scripts/plot_bench.py",
            "msa_tpu_torch/scripts/bench.py"} <= rel
    modules = [
        ".".join(p.relative_to(REPO).with_suffix("").parts[:-1] if p.name == "__init__.py"
                 else p.relative_to(REPO).with_suffix("").parts)
        for p in files
    ]
    code = "import sys\n" + "".join(f"import {m}\n" for m in modules) + (
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if m.startswith('jax'))\n"
        "assert 'msa_tpu' not in sys.modules,"
        " sorted(m for m in sys.modules if m.split('.')[0] == 'msa_tpu')\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
