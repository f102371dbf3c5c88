"""batch.fetch_wait_ms (ms; layer: banded pipeline, ``ops/batch.py``; program span; moves gcups).

How long the host waits for the card a job: the ``batch.fetch_wait`` spans
(each wave's ``done.synchronize()``, its walk and its fetch) summed over the
job's waves, the median over the traced window's jobs
(``msa_tpu_torch/utils/timing.py``, read through ``recorded_jobs``). None
unless the program recorded one job for each of the window's jobs, every
span kept.
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
    p = median([sum(s.ns for s in j.named("batch.fetch_wait")) for j in jobs
                if j.named("batch.fetch_wait")])
    return None if p is None else p / 1e6
