"""device.peak_gib (GiB; layer: device; program counter; moves gcups).

``torch.cuda.max_memory_allocated`` over the window, reset at its start, in
GiB: the program's buffers at their largest (two waves in flight).
"""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
