"""The trace's arithmetic and the metric files, on made-up runs."""

import importlib.util
import os

import pytest

from msabench import peaks, spec, trace, window

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def made_up_trace(jobs):
    return [
        ev(trace.WINDOW, "user_annotation", 1000.0, 1000.0),
        ev(trace.JOB, "user_annotation", 1000.0, 600.0),
        ev(trace.JOB, "user_annotation", 1600.0, 400.0),
        # fill and walk overlap on two streams: 1100-1400 busy, not 400 us
        ev("void band_fill_kernel<true, false>(unsigned char const*)", "kernel", 1100.0, 200.0),
        ev("void walk_kernel<4, true>(unsigned char const*)", "kernel", 1200.0, 200.0),
        ev("Memcpy DtoH", "gpu_memcpy", 1700.0, 100.0),
        ev("before the window", "kernel", 0.0, 50.0),
    ]


def made_up_jobs():
    a = window.Job(problem=0, start=10.0, seconds=0.0006, result=object())
    a.spans = [("fill", 10.00005, 10.00006, (1000, 20)), ("pair_hash", 10.0004, 10.0006, None)]
    b = window.Job(problem=1, start=10.0006, seconds=0.0004, result=object())
    b.spans = [("decode.strings", 10.0009, 10.0010, None)]
    return [a, b]


def test_busy_is_the_union_and_idle_goes_to_the_host_stage():
    jobs = made_up_jobs()
    tr = trace.summarize(made_up_trace(jobs), jobs)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(400e-6)  # 1100-1400 and 1700-1800
    assert tr.kernel_s["void band_fill_kernel<true, false>"] == pytest.approx(200e-6)
    # idle: 1000-1100 job a (1050-1060 its fill's enqueue), 1400-1600 its
    # pair_hash, 1600-1700 and 1800-1900 job b, 1900-2000 its decode
    assert tr.idle_by["fill"] == pytest.approx(10e-6)
    assert tr.idle_by["pair_hash"] == pytest.approx(200e-6)
    assert tr.idle_by["decode.strings"] == pytest.approx(100e-6)
    assert tr.idle_by["job"] == pytest.approx(290e-6)
    assert sum(tr.idle_by.values()) == pytest.approx(tr.window_s - tr.busy_s)


def read(name, run):
    return spec.reader(name)(run)


def test_metric_files_on_a_made_up_run():
    jobs = made_up_jobs()
    tr = trace.summarize(made_up_trace(jobs), jobs)
    run = window.Run(setup_s=3.0, window_s=1e-3, jobs=jobs, cells=2000, peak_bytes=2**30,
                     card="NVIDIA H100 80GB HBM3", trace=tr)
    assert read("gcups", run) == pytest.approx(2000 / 1e-3 / 1e9)
    assert read("job_p90_ms", run) == pytest.approx(0.6)
    assert read("service.job_p50_ms", run) == pytest.approx(0.4)
    assert read("kway.pre_device_ms", run) == pytest.approx(0.05)
    assert read("batch.waves", run) == 1
    assert read("batch.decode_wall_ms", run) == pytest.approx(0.1)
    assert read("host.pair_hash_ms", run) == pytest.approx(0.2)
    assert read("walk.device_ms", run) == pytest.approx(0.1)  # 200 us over 2 jobs
    assert read("device.idle_share", run) == pytest.approx(0.6)
    assert read("device.peak_gib", run) == 1.0
    rate = 132 * 64 * 1.98e9
    assert read("band_fill_roofline", run) == pytest.approx(1000 * 1 / rate / 200e-6 * 100)
    assert read("job_mfu", run) == pytest.approx(2000 * 1 / 1e-3 / rate * 100)


def test_metrics_that_find_nothing_return_none():
    run = window.Run(setup_s=1.0, window_s=1.0, jobs=[], cells=0, peak_bytes=0, card="cpu")
    for name in ("gcups", "job_p90_ms", "kway.pre_device_ms", "batch.waves", "walk.device_ms",
                 "band_fill_roofline", "device.idle_share", "device.peak_gib", "job_mfu"):
        assert read(name, run) is None, name


def test_the_kernels_count_cannot_beat_the_bound():
    # csrc/common.cuh::band_step spends 5 int32 instructions a cell; at the
    # card's full int32 rate it would read 1 / 5 of the roofline, and a
    # kernel on packed 16-bit DPX forms (one a cell) all of it.
    rate = peaks.int32_ops_per_s("NVIDIA H100 80GB HBM3")
    cells = 10**10
    best_time = cells * 5 / rate
    assert peaks.fill_bound_s(cells, 0, "NVIDIA H100 80GB HBM3") / best_time == pytest.approx(0.2)
    assert peaks.INT32_OPS_PER_CELL <= 1
