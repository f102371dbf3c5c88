"""job_p90_ms (ms, lower is better; end to end, host clock).

The 90th percentile (nearest rank) of the times of all the window's jobs,
each from the call to its answer.
"""

from msabench.stats import percentile


def read(run):
    p = percentile([j.seconds for j in run.jobs], 90)
    return None if p is None else p * 1e3
