"""device.idle_share (share, 0 to 1; layer: device; device trace; moves gcups).

1 - the union of the card's activity intervals (kernels, copies, sets) over
the traced window's length, from ``torch.profiler`` (``msabench/trace.py``).
"""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
