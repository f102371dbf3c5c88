"""A cell end to end at a cut size, through the kernels' plain versions on the
CPU (``run.py --platform cpu``), and faults planted under it.

Each fault breaks the timed path where it produces an answer, and the run
must come out not correct: a pair's strings altered in the decode, a pair's
penalty altered at the fill, the chain hash altered at the fold, a pair left
out of a job, a job that raises.
"""

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

spec_ = importlib.util.spec_from_file_location("bench_run", os.path.join(BENCH, "run.py"))
run = importlib.util.module_from_spec(spec_)
spec_.loader.exec_module(run)


CUT = "cut-closed1"


def cut_benchmark(tmp_path, lengths=(160, 140, 120), check_pairs=3):
    """A BENCHMARK.json whose one cell, ``cut-closed1``, runs a cut k-way job
    of the cells' traffic and metrics."""
    with open(os.path.join(BENCH, "configs", "speccap.json")) as f:
        config = json.load(f)
    config.update(name="cut", k=len(lengths), lengths=list(lengths), check_pairs=check_pairs)
    (tmp_path / "cut.json").write_text(json.dumps(config))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [dict(bench["configs"][0], name="cut", file="cut.json")]
    bench["workloads"] = [dict(bench["workloads"][0], name=CUT, config="cut")]
    for m in bench["per_layer"]:
        m["workloads"] = [CUT]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return str(path)


def run_cell(bench, capsys, trace=0, seconds=1.0, seed=2**33 + 1):
    rc = run.main(["--workload", CUT, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace), "--platform", "cpu", "--benchmark", bench])
    out, err = capsys.readouterr()
    return rc, (json.loads(out.strip().splitlines()[-1]) if out.strip() else None), err


def test_a_cut_cell_is_correct_end_to_end(tmp_path, capsys):
    rc, res, err = run_cell(cut_benchmark(tmp_path), capsys)
    assert rc == 0 and res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"gcups", "job_p90_ms", "setup_s"}
    assert list(res)[-1] == "compared"
    assert all(v == {"value": 0, "limit": 0} for v in res["compared"].values())
    assert res["checked"]["jobs_checked"] >= 1 and res["checked"]["pairs_checked"] == 3
    tail = err.strip().splitlines()[-len(res["compared"]):]
    assert tail == [f"compared {k} 0 limit 0" for k in res["compared"]]
    assert res["device"]["platform"] == "cpu"


def test_a_traced_cut_cell_reports_its_per_layer_metrics(tmp_path, capsys):
    rc, res, _ = run_cell(cut_benchmark(tmp_path), capsys, trace=1)
    assert rc == 0 and res["correct"] is True
    assert {"service.job_p50_ms", "kway.pre_device_ms", "batch.waves", "batch.decode_wall_ms",
            "host.pair_hash_ms"} <= set(res["metrics"])
    assert "gcups" not in res["metrics"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def flip(text):
    return ("C" if text[0] != "C" else "A") + text[1:]


def kway():
    from msa_tpu_torch.models import kway as module

    return module


def batch():
    from msa_tpu_torch.ops import batch as module

    return module


def _plus_one(fill):
    fill.score += 1
    return fill


def _raise_on_third(real):
    calls = []

    def call(self, *a, **kw):
        calls.append(1)
        if len(calls) == 3:  # after the two warm-up jobs
            raise RuntimeError("planted fault")
        return real(self, *a, **kw)

    return call


# fault: (where, attribute, wrapper of the real function, the number it fails)
FAULTS = {
    "strings altered in the decode": (batch, "moves_to_alignment",
                                      lambda real: lambda *a: tuple(map(flip, real(*a))),
                                      "alignments_wrong"),
    # (160 + 140 + 120 cut: the smallest pair, 140 x 120, is the last a
    # size-ordered batch fills; the sample checks it on every seed)
    "the smallest pair's strings altered": (batch, "moves_to_alignment",
                                            lambda real: lambda x, y, m: tuple(
                                                map(flip, real(x, y, m)))
                                            if len(x) + len(y) == 260 else real(x, y, m),
                                            "alignments_wrong"),
    "penalty altered at the fill": (batch, "band_fill",
                                    lambda real: lambda *a: _plus_one(real(*a)),
                                    "penalties_wrong"),
    "chain hash altered at the fold": (kway, "chain_hashes",
                                       lambda real: lambda hs: flip(real(hs)), "folds_wrong"),
    "a pair left out": (lambda: kway().KWayAligner, "align_tasks",
                        lambda real: lambda self, *a: real(self, *a)[:-1], "folds_wrong"),
    "a job that raises": (lambda: kway().KWayAligner, "align_all", _raise_on_third,
                          "jobs_failed"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_makes_the_run_not_correct(fault, tmp_path, capsys, monkeypatch):
    where, attr, make, number = FAULTS[fault]
    target = where()
    monkeypatch.setattr(target, attr, make(getattr(target, attr)))
    rc, res, _ = run_cell(cut_benchmark(tmp_path), capsys)
    assert rc == 0 and res["correct"] is False
    assert res["compared"][number]["value"] > res["compared"][number]["limit"]


def tree_digest(path):
    out = {}
    for base, _, files in os.walk(path):
        for name in files:
            full = os.path.join(base, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = hashlib.sha256(f.read()).hexdigest()
    return out


def copy_benchmark(dst):
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "_scratch", "_unpack", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)


def test_a_new_cell_takes_only_new_files(tmp_path):
    copy_benchmark(tmp_path)
    before = tree_digest(tmp_path / "benchmark")
    bench_dir = tmp_path / "benchmark"
    with open(bench_dir / "configs" / "speccap.json") as f:
        config = json.load(f)
    config.update(name="small", k=3, lengths=[120, 100, 90], check_pairs=2)
    (bench_dir / "configs" / "small.json").write_text(json.dumps(config))
    (bench_dir / "traffic" / "closed1short.json").write_text(json.dumps(
        {"name": "closed1short", "callers": 1, "pool": 2, "warmup_jobs": 1, "keep_every": 2}))
    (bench_dir / "metrics" / "service.jobs.py").write_text(
        "def read(run):\n    return len(run.jobs)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "small", "source": "https://example.org/small",
                             "file": "benchmark/configs/small.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "small-short", "config": "small",
                               "traffic": "closed1short", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "service.jobs", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "entry", "moves": "gcups",
                               "workloads": ["small-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = tree_digest(bench_dir)
    assert all(after[k] == v for k, v in before.items())
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "small-short", "--seed", "5",
         "--seconds", "0.5", "--trace", "1", "--platform", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["metrics"]["service.jobs"]["value"] == res["attempted"]


def test_without_the_program_a_run_fails_and_prints_no_result(tmp_path):
    copy_benchmark(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "speccap-closed1", "--seed", "1",
         "--seconds", "1", "--platform", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "msa_tpu_torch" in proc.stderr


def test_without_a_card_a_run_exits_2_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", "speccap-closed1",
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout.strip() == ""
