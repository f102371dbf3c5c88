"""job_mfu (%; layer: device; host clock; moves gcups).

The whole window's share of the card's int32 peak: the answered jobs' DP
cells at ``peaks.INT32_OPS_PER_CELL`` instructions each (derived in
``band_fill_roofline.py``), over the window's seconds, over the card's int32
rate. It bounds what any kernel's roofline can claim end to end: a kernel
taken off the path leaves its own roofline silent, and this share still
reads the whole job.
"""

from msabench import peaks


def read(run):
    rate = peaks.int32_ops_per_s(run.card)
    if not rate or not run.done:
        return None
    return run.cells * peaks.INT32_OPS_PER_CELL / run.window_s / rate * 100
