"""The port's benchmark (``msa_tpu_torch/scripts/bench.py``) on the CPU.

``run`` on mseq1 through the kernels' plain versions, gated on the JAX
package's full hash and penalties (tolerance 0); the gate fails closed on a
wrong hash, a wrong penalty and a rep that departs (exit code 1, value 0.0,
an error, no traceback, no timed rep after a failed warm-up); the port's
big13 constants are the root ``bench.py``'s; ``main``'s arguments.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest

from msa_tpu.models.kway import align_kway as jax_align_kway
from msa_tpu.utils.msaio import parse_file as jax_parse_file
from msa_tpu_torch.config import TorchConfig
from msa_tpu_torch.models import kway
from msa_tpu_torch.scripts import bench
from msa_tpu_torch.utils.msaio import parse_file

REPO = Path(__file__).resolve().parents[1]
MSEQ1 = str(REPO / "data" / "mseq1.dat")
# Every pair through the device pipeline's plain versions.
CPU = TorchConfig(device="cpu", host_threshold=0, rb=255, snap_k=128)


@pytest.fixture(scope="module")
def golden():
    res = jax_align_kway(jax_parse_file(MSEQ1), backend="numpy")
    return res.chain_hash, res.penalties


@pytest.fixture
def spy(monkeypatch):
    """Counts ``align_kway`` calls; ``spy.depart_at`` makes that call's hash differ."""
    real = kway.align_kway

    class Spy:
        calls = 0
        depart_at = None

    def counted(*args, **kwargs):
        Spy.calls += 1
        res = real(*args, **kwargs)
        if Spy.calls == Spy.depart_at:
            res.chain_hash = "0" * 128
        return res

    monkeypatch.setattr(kway, "align_kway", counted)
    return Spy


def test_run_is_golden_and_reports_the_best_rep(golden, spy):
    problem = parse_file(MSEQ1)
    rc, rec = bench.run(problem, *golden, CPU, "auto", reps=3, warmups=1)
    assert rc == 0 and spy.calls == 4
    cells = bench.workload_cells(problem.genes)
    assert len(rec["reps"]) == len(rec["seconds"]) == 3
    assert rec["value"] == round(cells / min(rec["seconds"]) / 1e9, 2)
    assert rec["reps"] == [round(cells / t / 1e9, 2) for t in rec["seconds"]]
    assert rec["vs_baseline"] == round(cells / min(rec["seconds"]) / 1e9 / bench.BASELINE_GCUPS, 2)
    assert (rec["metric"], rec["unit"]) == ("big13_e2e_gcups", "GCUPS") and "error" not in rec


@pytest.mark.parametrize("fault", ["hash", "penalty"])
def test_a_wrong_golden_stops_at_the_warm_up(fault, golden, spy):
    chain_hash, penalties = golden
    if fault == "hash":
        chain_hash = chain_hash[:-1] + ("0" if chain_hash[-1] != "0" else "1")
    else:
        penalties = [penalties[0] + 1, *penalties[1:]]
    rc, rec = bench.run(parse_file(MSEQ1), chain_hash, penalties, CPU, "auto", reps=3, warmups=2)
    assert rc == 1 and spy.calls == 1
    assert rec["value"] == 0.0 and rec["vs_baseline"] == 0.0 and "warm-up 0" in rec["error"]
    assert "reps" not in rec


def test_a_departing_rep_fails_closed(golden, spy, monkeypatch, capsys):
    spy.depart_at = 2 + 3  # two warm-ups, then the third timed rep
    problem = parse_file(MSEQ1)
    monkeypatch.setattr("msa_tpu_torch.utils.msaio.parse_file", lambda path: problem)
    monkeypatch.setattr(bench, "BIG13_HASH", golden[0])
    monkeypatch.setattr(bench, "BIG13_PENALTIES", golden[1])
    monkeypatch.setenv("MSA_TPU_TORCH_HOST_THRESHOLD", "0")
    monkeypatch.setenv("MSA_TPU_TORCH_RB", "255")
    monkeypatch.setenv("MSA_TPU_TORCH_SNAP_K", "128")
    assert bench.main(["--platform", "cpu"]) == 1
    out, err = capsys.readouterr()
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["value"] == 0.0 and rec["error"].startswith("rep 2:") and rec["card"] is None
    assert "reps" not in rec and "Traceback" not in out + err
    assert spy.calls == 5


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_big13_constants_are_the_root_benchs():
    root = _root_bench()
    assert bench.BIG13_HASH == root.GOLDEN_HASH
    assert bench.BIG13_PENALTIES == root.GOLDEN_PENALTIES and len(bench.BIG13_PENALTIES) == 78
    assert bench.BASELINE_GCUPS == root.BASELINE_GCUPS
    genes = parse_file(str(REPO / bench.BIG13)).genes
    assert bench.workload_cells(genes) == root.workload_cells(genes)
    assert round(bench.workload_cells(genes) / 1e11, 3) == 2.785
    assert (bench.REPS, bench.WARMUPS) == (5, 2)


def test_main_runs_big13_as_the_root_bench_does(monkeypatch, capsys):
    seen = {}

    def fake_run(problem, golden_hash, golden_penalties, config, backend, **kw):
        seen.update(k=problem.k, hash=golden_hash, penalties=golden_penalties,
                    device=config.device, backend=backend, kw=kw)
        return 0, {"metric": bench.METRIC, "value": 1.0}

    monkeypatch.setattr(bench, "run", fake_run)
    assert bench.main(["--platform", "cpu"]) == 0
    assert seen == {"k": 13, "hash": bench.BIG13_HASH, "penalties": bench.BIG13_PENALTIES,
                    "device": "cpu", "backend": "auto", "kw": {}}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "metric": "big13_e2e_gcups", "value": 1.0, "card": None}
    with pytest.raises(SystemExit):
        bench.main(["--platform", "tpu"])


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="needs a host without a card")
def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(bench, "run", lambda *a, **kw: pytest.fail("run without a card"))
    with pytest.raises(RuntimeError, match="none is available"):
        bench.main([])
