"""batch.waves (count; layer: banded pipeline, ``ops/batch.py``; program counter; moves gcups).

``band_fill`` launches a job, the median over the traced window's jobs: the
waves the pipeline cut the job's pairs into.
"""

from msabench.stats import median


def read(run):
    return median([sum(s[0] == "fill" for s in job.spans) for job in run.done
                   if any(s[0] == "fill" for s in job.spans)])
