"""kway.host_only_ms (ms; layer: k-way engine, ``models/kway.py``; program span; moves job_p90_ms).

The part of a job in which none of its device work is outstanding, from the
program's own spans (``msa_tpu_torch/utils/timing.py``, read through
``recorded_jobs``): the ``kway.job`` root's start to its first
``batch.fill_enqueue`` start, plus its last ``batch.fetch_wait`` end to the
root's end; the median over the traced window's jobs. None unless the
program recorded one job for each of the window's jobs, every span kept.
"""

from msabench.stats import median


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
    parts = []
    for j in jobs:
        fills, waits = j.named("batch.fill_enqueue"), j.named("batch.fetch_wait")
        if fills and waits:
            parts.append(min(s.start for s in fills) - j.root.start
                         + j.root.end - max(s.end for s in waits))
    p = median(parts)
    return None if p is None else p / 1e6
