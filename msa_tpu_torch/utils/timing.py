"""Timing and tracing of the port.

``timestamp_us``, ``StageTimer`` and ``gcups`` are copies of those of
``msa_tpu/utils/timing.py``; ``profile`` ports its ``profile`` to
``torch.profiler``.

The job recorder is the port's own. A job (``align_kway``,
``KWayAligner.align_all``) is traced exactly when a ``torch.profiler``
records on the thread that calls it: the root checks once (``job``) and
hands its span down; every stage opens a child with ``span(parent, name)``,
on whichever thread runs it (the decode threads are handed the job's span:
the profiler does not record on them). A span holds its name, start and end
(``time.perf_counter_ns``), thread, job id, parent and a few integer
attributes; a job holds counters (kernel launches and pairs from
``ops/_build.py::count``, ``decode_chars``). Untraced, a site costs one
``is None`` check and the root one flag check. While tracing, each job opens
one profiler range (``record_function``), ``msa.job``, on its thread;
``profile`` places the job's spans on the trace's clock through it and adds
them to the exported Chrome trace (``cat`` "msa"). ``recorded_jobs`` reads
the jobs of the last profiled session.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch


def timestamp_us() -> int:
    """Microsecond wall clock (the reference's GetTimeStamp)."""
    return time.time_ns() // 1000


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    Given a traced job's span, each stage is also a span of that name under
    it (``stage`` yields it, else None).
    """

    def __init__(self, job: Optional["Span"] = None) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.job = job

    @contextlib.contextmanager
    def stage(self, name: str):
        with span(self.job, name) as sp:
            t0 = time.perf_counter()
            try:
                yield sp
            finally:
                dt = time.perf_counter() - t0
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name}: {self.totals[name]*1e3:.1f} ms"
                f" ({self.counts[name]}x)"
            )
        return "\n".join(lines)


def gcups(cells: int, seconds: float) -> float:
    """Giga cell updates per second."""
    if seconds <= 0:
        return float("inf")
    return cells / seconds / 1e9


JOB_RANGE = "msa.job"  # the one profiler range a traced job opens
RANGE_CATEGORIES = ("user_annotation", "cpu_op")  # its category in an exported trace
SPAN_LIMIT = 1 << 18  # spans the recorder stores; later ones are dropped and counted

_profiling = torch._C._autograd._profiler_enabled
_ids = itertools.count(1)
# The job's range: torch's fast binding of ``record_function`` where it has
# one, which opens and closes in microseconds where ``record_function``
# takes tens to hundreds, so the range's ends stay that close to the root's
# stamps.
_JobRange = getattr(torch._C._profiler, "_RecordFunctionFast", None) or \
    torch.profiler.record_function


class Job:
    """One traced job: its id, calling thread, root span, finished spans
    (the root last) and counters; ``dropped`` spans found the store full."""

    __slots__ = ("id", "tid", "root", "spans", "counters", "dropped")

    def __init__(self) -> None:
        self.id = next(_ids)
        self.tid = _tid()
        self.root = _RootSpan(self)
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.dropped = 0

    def named(self, name: str) -> List["Span"]:
        return [s for s in self.spans if s.name == name]


class Span:
    """A timed stage of a job; ``with`` stamps it and stores it on exit."""

    __slots__ = ("job", "name", "id", "parent", "tid", "start", "end", "attrs")

    def __init__(self, job: Job, name: str, parent: int):
        self.job = job
        self.name = name
        self.id = next(_ids)
        self.parent = parent
        self.attrs: Dict[str, int] = {}
        self.tid = 0
        self.start = self.end = 0

    def __enter__(self) -> "Span":
        self.tid = _tid()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter_ns()
        RECORDER.keep(self)

    @property
    def ns(self) -> int:
        return self.end - self.start

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the job's counter ``name``."""
        RECORDER.add(self.job, name, n)


class _RootSpan(Span):
    """``kway.job``: opens the job's profiler range around its own stamps
    and makes the job the running one on its thread (``running``)."""

    __slots__ = ("_prev", "_range")

    def __init__(self, job: Job):
        super().__init__(job, "kway.job", 0)

    def __enter__(self) -> "Span":
        self._range = _JobRange(JOB_RANGE)
        self._range.__enter__()
        self._prev, _THREAD.job = _THREAD.job, self
        return super().__enter__()

    def __exit__(self, *exc) -> None:
        super().__exit__()
        _THREAD.job = self._prev
        self._range.__exit__(None, None, None)
        self._range = None


class _Recorder:
    """The bounded in-memory store of the last profiled session's jobs."""

    def __init__(self, limit: int) -> None:
        self.limit = limit
        self.lock = threading.Lock()
        self.jobs: List[Job] = []
        self.stored = 0
        self.dropped = 0
        self.stale = False  # an untraced job ran since the last traced one

    def clear(self) -> None:
        with self.lock:
            self.jobs, self.stored, self.dropped, self.stale = [], 0, 0, False

    def open(self) -> _RootSpan:
        if self.stale:
            self.clear()
        job = Job()
        with self.lock:
            self.jobs.append(job)
        return job.root

    def keep(self, span: Span) -> None:
        with self.lock:
            if self.stored >= self.limit:
                self.dropped += 1
                span.job.dropped += 1
                return
            self.stored += 1
            span.job.spans.append(span)

    def add(self, job: Job, name: str, n: int) -> None:
        with self.lock:
            job.counters[name] = job.counters.get(name, 0) + n


RECORDER = _Recorder(SPAN_LIMIT)


class _Thread(threading.local):
    job: Optional[Span] = None  # the span the thread's kernel launches count under
    tid: int = 0  # the thread's native id, read once: it takes a system call


_THREAD = _Thread()


def _tid() -> int:
    tid = _THREAD.tid
    if not tid:
        tid = _THREAD.tid = threading.get_native_id()
    return tid


class _Off:
    """The no-op context of an untraced site; ``with`` gives None."""

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()
NEW_JOB = object()  # a default that asks for a job of its own (``KWayAligner.align_all``)


def job():
    """The root span of a new job, ``kway.job``, when a ``torch.profiler``
    records on this thread; else a no-op. Enter it with ``with``: it gives
    the root span or None."""
    if not _profiling():
        RECORDER.stale = True
        return _OFF
    return RECORDER.open()


def span(parent: Optional[Span], name: str):
    """A child span of ``parent`` named ``name``, or a no-op when ``parent``
    is None (the job is not traced). ``with`` gives the span or None."""
    if parent is None:
        return _OFF
    return Span(parent.job, name, parent.id)


@contextlib.contextmanager
def running(parent: Optional[Span]):
    """Count the kernel launches of this thread under ``parent``'s job."""
    if parent is None:
        yield
        return
    prev, _THREAD.job = _THREAD.job, parent
    try:
        yield
    finally:
        _THREAD.job = prev


def count_launch(kind: str, pairs: int) -> None:
    """A kernel launch on this thread, for the running job's counters:
    ``<kind>_launches`` and, for fills, the ``pairs`` they filled."""
    sp = _THREAD.job
    if sp is not None:
        sp.count(kind + "_launches", 1)
        if kind == "fill":
            sp.count("pairs", pairs)


def recorded_jobs() -> List[Job]:
    """The finished jobs of the last profiled session, in start order."""
    with RECORDER.lock:
        return [j for j in RECORDER.jobs if j.root.end]


def chrome_events(events: List[Dict]) -> List[Dict]:
    """The recorded jobs' spans as Chrome trace events on the clock of
    ``events`` (a ``torch.profiler`` export).

    Each job's ``msa.job`` range, matched by thread and order, places its
    spans: the root's end stamp is taken just before the range closes, and
    the range's end lies on the host clock to within tens of microseconds.
    Jobs whose thread holds another number of ranges are left out.
    """
    ranges: Dict[int, List[Dict]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") == JOB_RANGE and e.get("cat") in RANGE_CATEGORIES:
            ranges.setdefault(int(e["tid"]), []).append(e)
    jobs: Dict[int, List[Job]] = {}
    for j in recorded_jobs():
        jobs.setdefault(j.tid, []).append(j)
    pid = os.getpid()
    out = []
    for tid, js in jobs.items():
        rs = sorted(ranges.get(tid, []), key=lambda e: float(e["ts"]))
        if len(rs) != len(js):
            continue
        for j, r in zip(js, rs):
            off = float(r["ts"]) + float(r["dur"]) - j.root.end / 1e3
            for s in j.spans:
                args = {"job": j.id, "span": s.id, "parent": s.parent, **s.attrs}
                if s is j.root:
                    args.update(j.counters)
                out.append({"ph": "X", "cat": "msa", "name": s.name, "pid": pid, "tid": s.tid,
                            "ts": round(s.start / 1e3 + off, 3), "dur": round(s.ns / 1e3, 3),
                            "args": args})
    return out


@contextlib.contextmanager
def profile(profile_dir: Optional[str]):
    """Record a torch.profiler trace (CPU, and CUDA with a card) of the block.

    Writes it as a Chrome trace, ``trace-<pid>.json`` in ``profile_dir``,
    with the traced jobs' spans (``chrome_events``); no-op when the
    directory is empty or None.
    """
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    RECORDER.clear()
    with torch_profile(activities=activities) as prof:
        yield
    path = os.path.join(profile_dir, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"] += chrome_events(trace["traceEvents"])
    with open(path, "w") as f:
        json.dump(trace, f)
