"""The port's job recorder (``msa_tpu_torch/utils/timing.py``) on the CPU.

A job is traced exactly when a ``torch.profiler`` records on its calling
thread: then it records one ``kway.job`` and a span for every stage of the
k-way engine and the banded pipeline (the kernels' plain versions here), on
the calling thread and on the decode threads, all under the job's id;
untraced it records nothing. The CLI's ``--profile-dir`` trace holds the
spans inside their job's ``msa.job`` range, and a traced benchmark run reads
the four metrics that the spans feed, without mixing two runs' jobs.
"""

from __future__ import annotations

import glob
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import msa_tpu_torch
from msa_tpu_torch.config import TorchConfig
from msa_tpu_torch.models.kway import KWayAligner
from msa_tpu_torch.ops import _build
from msa_tpu_torch.utils import timing

REPO = pathlib.Path(__file__).resolve().parent.parent

# Every stage of a job with device pairs, one span or more each.
STAGES = {
    "kway.job", "kway.setup", "batch.size", "batch.gene_table", "batch.plan",
    "batch.fill_enqueue", "batch.walk_enqueue", "batch.fetch_wait", "batch.submit",
    "batch.decode", "batch.drain", "kway.pair_hash", "kway.host_pairs", "kway.chain",
}
CALLING_THREAD = STAGES - {"batch.decode"}
METRICS = ("kway.host_only_ms", "kway.unspanned_ms", "batch.fetch_wait_ms",
           "host.decode_ns_per_char")


def _problem(lengths=(230, 200, 170, 150), seed=3):
    rng = np.random.default_rng(seed)
    genes = ["".join(rng.choice(list("ACGT"), n)) for n in lengths]
    return msa_tpu_torch.parse_input("3\n2\n%d\n%s\n" % (len(genes), "\n".join(genes)))


def _config(**kw):
    return TorchConfig(device="cpu", host_threshold=0, rb=31, snap_k=16, decode_workers=2,
                       local_devices=1, **kw)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _by_kway(problem, config):
    return msa_tpu_torch.align_kway(problem, keep_alignments=True, config=config)


def _by_align_all(problem, config):
    engine = KWayAligner(problem.pxy, problem.pgap, backend="auto", config=config)
    return engine.align_all(problem.genes, keep_alignments=True)


ENTRIES = {"align_kway": _by_kway, "KWayAligner.align_all": _by_align_all}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_an_untraced_job_records_nothing(entry):
    problem, config = _problem(), _config()
    timing.RECORDER.clear()
    ENTRIES[entry](problem, config)
    assert timing.recorded_jobs() == [] and timing.RECORDER.stored == 0
    # An earlier profiled session's jobs stay readable after an untraced job
    # and give way to the next profiled session's.
    _profiled(lambda: ENTRIES[entry](problem, config))
    first = timing.recorded_jobs()
    ENTRIES[entry](problem, config)
    assert timing.recorded_jobs() == first and len(first) == 1
    _profiled(lambda: ENTRIES[entry](problem, config))
    second = timing.recorded_jobs()
    assert len(second) == 1 and second[0].id != first[0].id


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_a_traced_job_records_every_stage_nested_under_its_id(entry):
    problem, config = _problem(), _config()
    timing.RECORDER.clear()  # back-to-back profiled sessions read as one
    result = _profiled(lambda: ENTRIES[entry](problem, config))
    assert result.chain_hash == ENTRIES[entry](problem, config).chain_hash
    (job,) = timing.recorded_jobs()
    root = job.root
    names = {s.name for s in job.spans}
    assert names == STAGES
    assert len(job.named("batch.fill_enqueue")) >= 2
    assert job.spans[-1] is root and root.parent == 0 and job.dropped == 0
    assert root.attrs == {"k": 4, "pairs": 6, "cells": sum(
        len(a) * len(b) for i, a in enumerate(problem.genes) for b in problem.genes[i + 1:])}
    ids = {s.id for s in job.spans}
    for s in job.spans:
        assert s.job is job and root.start <= s.start <= s.end <= root.end
        assert s is root or s.parent in ids
    # The calling thread's stages follow one another; the decodes run on
    # the decode threads, one span a pair.
    own = sorted((s for s in job.spans if s is not root), key=lambda s: s.start)
    assert {s.name for s in own if s.tid == root.tid} == CALLING_THREAD - {"kway.job"}
    calling = [s for s in own if s.tid == root.tid]
    assert all(a.end <= b.start for a, b in zip(calling, calling[1:]))
    decodes = job.named("batch.decode")
    assert len(decodes) == 6 and all(s.tid != root.tid for s in decodes)
    chars = sum(len(r.align1) + len(r.align2) for r in result.pair_results)
    assert sum(s.attrs["chars"] for s in decodes) == job.counters["decode_chars"] == chars
    fills = job.named("batch.fill_enqueue")
    assert sum(s.attrs["cells"] for s in fills) == root.attrs["cells"]
    assert sum(s.attrs["pairs"] for s in fills) == 6



def test_a_fill_span_carries_its_band_height_and_bands():
    """On the CPU the pipeline keeps the rb it is given; each fill's span
    holds it and its plan's items, every band of the wave's pairs."""
    problem, config = _problem(), _config()
    timing.RECORDER.clear()
    _profiled(lambda: _by_kway(problem, config))
    (job,) = timing.recorded_jobs()
    fills = job.named("batch.fill_enqueue")
    lengths = [len(g) for g in problem.genes]
    assert len(fills) >= 2 and {s.attrs["rb"] for s in fills} == {config.rb}
    assert sum(s.attrs["bands"] for s in fills) == sum(
        -(-lengths[i] // config.rb) for i in range(1, 4) for _ in range(i))


def test_a_full_store_drops_and_counts_later_spans(monkeypatch):
    monkeypatch.setattr(timing.RECORDER, "limit", 5)
    timing.RECORDER.clear()
    _profiled(lambda: _by_kway(_problem(), _config()))
    (job,) = timing.recorded_jobs()
    assert len(job.spans) == 5 and job.dropped > 0 and timing.RECORDER.dropped == job.dropped
    assert job.root not in job.spans  # the root closes last


@pytest.mark.parametrize("fn_name,counter", [("band_fill", "fill"), ("walk", "walk")])
def test_kernel_launches_count_for_the_running_job(fn_name, counter):
    def fn():
        pass

    fn.__name__, fn.launches, fn.pairs = fn_name, 0, 0
    timing.RECORDER.clear()
    _build.count(fn, 3)  # no job runs: only the function's own counters
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.job() as root:
            _build.count(fn, 3)
            _build.count(fn, 4)
    (job,) = timing.recorded_jobs()
    assert (fn.launches, fn.pairs) == (3, 10)
    want = {f"{counter}_launches": 2}
    if counter == "fill":
        want["pairs"] = 7
    assert job.counters == want and root.job is job


def test_stage_timer_spans_under_a_traced_job():
    timing.RECORDER.clear()
    plain = timing.StageTimer()
    with plain.stage("a") as sp:
        assert sp is None
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.job() as root:
            timer = timing.StageTimer(root)
            for name in ("schedule", "align_shard", "schedule"):
                with timer.stage(name) as sp:
                    with timing.span(sp, "kway.setup"):
                        pass
    (job,) = timing.recorded_jobs()
    assert timer.counts == {"schedule": 2, "align_shard": 1} and plain.counts == {"a": 1}
    stages = [s for s in job.spans if s.parent == root.id]
    assert [s.name for s in stages] == ["schedule", "align_shard", "schedule"]
    assert [s.parent for s in job.named("kway.setup")] == [s.id for s in stages]


def test_spans_go_on_the_trace_clock_through_the_job_range():
    timing.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.job() as root:
            with timing.span(root, "kway.setup"):
                pass
    (job,) = timing.recorded_jobs()
    end_us = 5_000.0
    ranges = [{"ph": "X", "cat": "user_annotation", "name": timing.JOB_RANGE, "tid": job.tid,
               "ts": end_us - root.ns / 1e3 - 7.0, "dur": root.ns / 1e3 + 7.0}]
    events = timing.chrome_events(ranges)
    assert {e["name"] for e in events} == {"kway.job", "kway.setup"}
    for e in events:
        s = next(s for s in job.spans if s.id == e["args"]["span"])
        assert e["cat"] == "msa" and e["args"]["job"] == job.id and e["tid"] == s.tid
        assert e["ts"] == pytest.approx(end_us - (root.end - s.start) / 1e3, abs=1e-3)
    # A thread whose ranges do not match its jobs in number is left out.
    assert timing.chrome_events(ranges * 2) == []


def test_cli_profile_dir_writes_the_spans_inside_their_job_range(tmp_path, monkeypatch, capsys):
    from msa_tpu_torch.cli import main

    for var, value in (("HOST_THRESHOLD", "0"), ("RB", "31"), ("SNAP_K", "16")):
        monkeypatch.setenv("MSA_TPU_TORCH_" + var, value)
    data = REPO / "data" / "mseq.dat"
    assert main(["--platform", "cpu", "--input", str(data), "--profile-dir", str(tmp_path)]) == 0
    assert capsys.readouterr().out.split("\n")[1].startswith("602d0f604e8fb908")
    (path,) = glob.glob(str(tmp_path / "trace-*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (job_range,) = [e for e in events if e.get("name") == timing.JOB_RANGE]
    spans = [e for e in events if e.get("cat") == "msa"]
    assert STAGES <= {e["name"] for e in spans}
    assert len({e["args"]["job"] for e in spans}) == 1
    start, end = job_range["ts"], job_range["ts"] + job_range["dur"]
    for e in spans:
        assert start - 1e3 <= e["ts"] <= e["ts"] + e["dur"] <= end + 1e3


def test_the_engine_stages_land_in_each_process_trace(tmp_path):
    from tests.test_torch_engine import _assert_golden, _launch

    outs = _launch(backend="auto", extra_args=["--profile-dir", str(tmp_path)], extra_env={
        "MSA_TPU_TORCH_HOST_THRESHOLD": "0", "MSA_TPU_TORCH_RB": "16",
        "MSA_TPU_TORCH_SNAP_K": "8"})
    _assert_golden(outs)
    paths = glob.glob(str(tmp_path / "trace-*.json"))
    assert len(paths) == 2
    for path in paths:
        with open(path) as f:
            spans = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "msa"]
        names = {e["name"] for e in spans}
        assert {"kway.job", "schedule", "align_shard", "allgather_merge", "hash_chain"} <= names
        assert STAGES - {"kway.chain"} <= names  # the engine folds the chain itself
        (shard,) = [e for e in spans if e["name"] == "align_shard"]
        assert {e["args"]["parent"] for e in spans if e["name"] == "batch.size"} == {
            shard["args"]["span"]}


RUNS = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("bench_run", sys.argv[1])
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
from msa_tpu_torch.utils import timing
for seed in (2**33 + 1, 5):
    rc = run.main(["--workload", "cut-closed1", "--seed", str(seed), "--seconds", "0.5",
                   "--trace", "1", "--platform", "cpu", "--benchmark", sys.argv[2]])
    print("IDS", rc, json.dumps([j.id for j in timing.recorded_jobs()]), flush=True)
"""


def test_a_traced_benchmark_run_reads_the_metrics_of_its_own_jobs(tmp_path):
    with open(REPO / "benchmark" / "configs" / "speccap.json") as f:
        config = json.load(f)
    config.update(name="cut", k=3, lengths=[160, 140, 120], check_pairs=3)
    (tmp_path / "cut.json").write_text(json.dumps(config))
    with open(REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"] = [dict(bench["configs"][0], name="cut", file="cut.json")]
    bench["workloads"] = [dict(bench["workloads"][0], name="cut-closed1", config="cut")]
    for m in bench["per_layer"]:
        m["workloads"] = ["cut-closed1"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    proc = subprocess.run(
        [sys.executable, "-c", RUNS, str(REPO / "benchmark" / "run.py"),
         str(tmp_path / "BENCHMARK.json")],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    results = [json.loads(line) for line in lines if line.startswith("{")]
    ids = [json.loads(line.split(" ", 2)[2]) for line in lines if line.startswith("IDS 0 ")]
    assert len(results) == 2 and len(ids) == 2
    for res, run_ids in zip(results, ids):
        assert res["correct"] is True and len(run_ids) == res["attempted"]
        for name in METRICS:
            assert res["metrics"][name]["value"] > 0, name
    assert not set(ids[0]) & set(ids[1])
