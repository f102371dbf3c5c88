"""kway.pre_device_ms (ms; layer: k-way engine, ``models/kway.py``; program span; moves gcups).

Host time from a job's call to its first ``ops/batch.py::band_fill`` call,
the median over the traced window's jobs: the engine's own work before the
card gets any (aligner, device, pair split, gene table, first plan).
"""

from msabench.stats import median


def read(run):
    waits = []
    for job in run.done:
        fills = [t0 for stage, t0, _, _ in job.spans if stage == "fill"]
        if fills:
            waits.append(min(fills) - job.start)
    p = median(waits)
    return None if p is None else p * 1e3
