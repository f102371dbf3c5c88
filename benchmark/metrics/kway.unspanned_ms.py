"""kway.unspanned_ms (ms; layer: k-way engine, ``models/kway.py``; program span; moves job_p90_ms).

The root span's self time: a job's ``kway.job`` time on its calling thread
that no other span of the job covers (``msa_tpu_torch/utils/timing.py``,
read through ``recorded_jobs``), the median over the traced window's jobs.
Near 0 when every host stage of the job has a name. None unless the program
recorded one job for each of the window's jobs, every span kept.
"""

from msabench.stats import median
from msabench.trace import union


def recorded(run):
    try:
        from msa_tpu_torch.utils.timing import recorded_jobs
    except ImportError:  # a program without the recorder
        return None
    # The jobs that started in the window (an earlier profiled session's
    # are older), one for each of the window's.
    since = int(run.jobs[0].start * 1e9) - 1000 if run.jobs else 0
    jobs = [j for j in recorded_jobs() if j.root.start >= since]
    if not jobs or len(jobs) != len(run.jobs) or any(j.dropped for j in jobs):
        return None
    return jobs


def read(run):
    jobs = recorded(run)
    if jobs is None:
        return None
    selfs = []
    for j in jobs:
        r = j.root
        kids = [(max(s.start, r.start), min(s.end, r.end)) for s in j.spans
                if s is not r and s.tid == r.tid and s.end > s.start]
        selfs.append(r.ns - sum(b - a for a, b in union([iv for iv in kids if iv[1] > iv[0]])))
    p = median(selfs)
    return None if p is None else p / 1e6
