"""host.decode_ns_per_char (ns; layer: host code, ``ops/batch.py``; program span; moves gcups).

The host decode's cost a character: the traced window's total
``batch.decode`` span time on the decode threads (``pair_moves``, then
``moves_to_alignment``, a pair a span), over its total ``decode_chars``
counter (the characters of the aligned strings produced), from
``msa_tpu_torch/utils/timing.py`` through ``recorded_jobs``. None unless the
program recorded one job for each of the window's jobs, every span kept.
"""


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
    ns = sum(s.ns for j in jobs for s in j.named("batch.decode"))
    chars = sum(j.counters.get("decode_chars", 0) for j in jobs)
    return ns / chars if chars else None
