"""service.job_p50_ms (ms; layer: entry, ``align_kway``; host clock; moves job_p90_ms).

The median (nearest rank) of the traced window's job times: the body of the
distribution whose tail ``job_p90_ms`` reads.
"""

from msabench.stats import median


def read(run):
    p = median([j.seconds for j in run.jobs])
    return None if p is None else p * 1e3
