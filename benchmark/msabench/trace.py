"""What the card did in a traced window, from a ``torch.profiler`` trace.

The profiler records the card's kernels, copies and sets (CUPTI) and two
kinds of host range, the window and each job (``window.py``), on one clock.
The jobs' ranges place the host spans of ``spans.py``, taken by
``time.perf_counter`` in every thread, on that clock (the median offset
between a job's range and its own start). From the exported trace:

- ``busy_s``: the union of the card's activity intervals inside the window
  (not their sum: the fill of one wave and the walk of another overlap);
- ``kernel_s``: device seconds of each kernel, by name up to its argument
  list;
- ``idle_by``: the card's idle seconds by what the host was doing, each idle
  moment given to the first of ``PRIORITY`` whose range was open then, on
  any thread, else to ``between jobs``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
JOB = "job"
PRIORITY = ("pair_hash", "chain", "decode.strings", "decode.moves", "walk", "fill", "plan", JOB)
OUTSIDE = "between jobs"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    idle_by: Dict[str, float]


@contextlib.contextmanager
def profiled():
    """A ``torch.profiler.profile`` of the host and, where there is one, the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


def read(prof, jobs) -> Trace:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, jobs)


def summarize(events: List[Dict], jobs) -> Trace:
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in spans if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError(f"the trace holds no {WINDOW!r} range")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])

    def clip(e) -> Tuple[float, float]:
        t0 = float(e["ts"])
        return max(t0, w0), min(t0 + float(e["dur"]), w1)

    device = [(clip(e), e["name"]) for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    device = [(iv, name) for iv, name in device if iv[1] > iv[0]]
    kernel_s: Dict[str, float] = {}
    for (t0, t1), name in device:
        short = name.split("(")[0]
        kernel_s[short] = kernel_s.get(short, 0.0) + (t1 - t0) * 1e-6
    busy = union([iv for iv, _ in device])
    ranges = sorted(float(e["ts"]) for e in spans
                    if e.get("name") == JOB and e.get("cat") == "user_annotation")
    labels = []
    if ranges and len(ranges) == len(jobs):
        offsets = sorted(ts - job.start * 1e6 for ts, job in zip(ranges, jobs))
        off = offsets[len(offsets) // 2]
        for job in jobs:
            host = [(JOB, job.start, job.start + job.seconds)] + [s[:3] for s in job.spans]
            labels += [(clip({"ts": t0 * 1e6 + off, "dur": (t1 - t0) * 1e6}), stage)
                       for stage, t0, t1 in host if stage in PRIORITY]
    idle = gaps(busy, w0, w1)
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                 kernel_s=kernel_s, idle_by=attribute(idle, labels))


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: List[Tuple[float, float]], w0: float, w1: float) -> List[Tuple[float, float]]:
    out, t = [], w0
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if w1 > t:
        out.append((t, w1))
    return out


def attribute(idle: List[Tuple[float, float]],
              labels: List[Tuple[Tuple[float, float], str]]) -> Dict[str, float]:
    """Idle seconds by the highest-priority host range open at each moment."""
    points = []
    for (a, b), name in labels:
        if b > a:
            points += [(a, 1, name), (b, -1, name)]
    for a, b in idle:
        points += [(a, 1, None), (b, -1, None)]
    points.sort(key=lambda p: (p[0], -p[1]))
    open_count = {name: 0 for name in PRIORITY}
    in_gap, last = 0, None
    out: Dict[str, float] = {}
    for t, step, name in points:
        if last is not None and in_gap and t > last:
            label = next((n for n in PRIORITY if open_count[n]), OUTSIDE)
            out[label] = out.get(label, 0.0) + (t - last) * 1e-6
        if name is None:
            in_gap += step
        else:
            open_count[name] += step
        last = t
    return out
