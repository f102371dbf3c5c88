"""batch.decode_wall_ms (ms; layer: banded pipeline, ``ops/batch.py``; program span; moves gcups).

The host decode's wall time a job: from the first start to the last end of
its ``pair_moves`` and ``moves_to_alignment`` calls, over all the decode
threads, the median over the traced window's jobs.
"""

from msabench.stats import median


def read(run):
    walls = []
    for job in run.done:
        spans = [(t0, t1) for stage, t0, t1, _ in job.spans if stage.startswith("decode.")]
        if spans:
            walls.append(max(t1 for _, t1 in spans) - min(t0 for t0, _ in spans))
    p = median(walls)
    return None if p is None else p * 1e3
