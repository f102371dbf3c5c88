"""The measured window: one caller, jobs back to back, and what a run records.

The caller sends the next job when the last has answered, cycling through
the pool, until ``seconds`` have passed; the job running then finishes
inside the window, so the window is the time from the first job's start to
the last job's end and every job in it has answered or failed. A job is timed
by the host clock around the program's call, which returns host strings, so
the card's work for it has ended inside its time.

The caller keeps a job's whole answer (every pair's strings) only where
``keep(n)`` says so, and the last job's, for the check; it lets go of the
others' at once, as a caller that wants the hash and penalties does, so the
process does not grow by every answer the window gets.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
import traceback
from typing import Callable, List, Optional, Sequence

from msabench.trace import JOB, WINDOW, Trace


@dataclasses.dataclass
class Job:
    problem: int
    start: float = 0.0
    seconds: float = 0.0
    result: object = None
    error: Optional[str] = None
    spans: list = dataclasses.field(default_factory=list)  # (stage, start, end, work)


@dataclasses.dataclass
class Run:
    """What a metric file's ``read`` is given."""

    setup_s: float
    window_s: float
    jobs: List[Job]
    cells: int  # DP cells of the jobs that answered
    peak_bytes: int
    card: str
    trace: Optional[Trace] = None

    @property
    def done(self) -> List[Job]:
        return [j for j in self.jobs if j.error is None]


def closed_loop(call: Callable, inputs: Sequence, seconds: float, keep: Callable[[int], bool],
                spans=None) -> (List[Job], float):
    """(jobs, window seconds). With ``spans`` (traced runs) each job and the
    window are ``torch.profiler`` ranges and the spans note the running job."""
    ranges = contextlib.nullcontext
    if spans is not None:
        from torch.profiler import record_function as ranges
    jobs: List[Job] = []
    with ranges(WINDOW) if spans is not None else ranges():
        t0 = time.perf_counter()
        while True:
            job = Job(problem=len(jobs) % len(inputs))
            if spans is not None:
                spans.job = job
            with ranges(JOB) if spans is not None else ranges():
                job.start = time.perf_counter()
                try:
                    result = call(inputs[job.problem])
                except Exception as exc:  # a failed job is counted, and the stream goes on
                    result = None
                    job.error = repr(exc)
                    if not any(j.error for j in jobs):
                        traceback.print_exc(file=sys.stderr)
                end = time.perf_counter()
            job.seconds = end - job.start
            last = end - t0 >= seconds
            if keep(len(jobs)) or last:
                job.result = result
            del result
            jobs.append(job)
            if last:
                return jobs, end - t0
