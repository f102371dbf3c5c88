"""host.pair_hash_ms (ms; layer: host code, ``models/kway.py::pair_hash``; program span; moves gcups).

Host seconds a job spends in ``pair_hash`` (the SHA-512 of each pair's
strings, on the main thread after the device pairs are back), summed over
its pairs, the median over the traced window's jobs.
"""

from msabench.stats import median


def read(run):
    p = median([sum(t1 - t0 for stage, t0, t1, _ in job.spans if stage == "pair_hash")
                for job in run.done if any(s[0] == "pair_hash" for s in job.spans)])
    return None if p is None else p * 1e3
