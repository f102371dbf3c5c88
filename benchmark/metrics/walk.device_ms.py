"""walk.device_ms (ms; layer: kernels, ``csrc/walk.cu``; device trace; moves gcups).

Device time of ``walk_kernel`` in the traced window (``torch.profiler``),
over the jobs that answered. No roofline: the traceback's own work is not
yet counted independently of the program's recompute scheme.
"""


def read(run):
    if run.trace is None or not run.done:
        return None
    s = sum(v for k, v in run.trace.kernel_s.items() if "walk_kernel" in k)
    return s * 1e3 / len(run.done) if s > 0 else None
