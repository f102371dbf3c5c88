"""band_fill_roofline (%; layer: kernels, ``csrc/band_fill.cu``; device trace; moves gcups).

The least time the card could fill the traced window's DP cells in, over the
device time of ``band_fill_kernel`` in the trace (``torch.profiler``), in %.

The work is what the recurrence needs, whatever implements it: each DP cell
of the pairs the fill launches were given (their plans' m x n), at the
fewest int32 instructions one cell can take, at the card's published int32
rate (``msabench/peaks.py``: 132 SMs x 64 a clock x 1.98 GHz on an H100).

The count, ``peaks.INT32_OPS_PER_CELL`` = 1. A cell's value depends on five
values: its three neighbours (diagonal, up, left) and the two symbols it
compares; the penalties are immediates. An sm_90 integer instruction reads
at most three source registers in each lane, Hopper's fused DPX forms
included (``__viaddmin_s32(a, b, c)`` = min(a + b, c), ``__vimin3_s32``,
IADD3, LOP3), so it folds at most three values into one, and k of them at
most 2k + 1: five need two a lane. The packed DPX forms
(``__viaddmin_s16x2``, ``__vimin3_s16x2``) compute two 16-bit lanes in one
instruction, and with linear gaps neighbouring cells differ by a few
penalties, so scores kept as differences fit 16 bits: two instructions for
two cells, one a cell. The kernel takes five a cell in a 32-bit lane
(``csrc/common.cuh::band_step``: min, add, compare, select, add-min). So
no kernel that keeps a cell in a lane of 16 bits or more can read over
100 %. The one assumption: a bit-parallel kernel (a cell in fewer bits,
several cells a word, as BitPAl's) can take less than one instruction a
cell, and its roofline needs this count derived again. The bytes' time,
each pair's sequences read once at 3.35 TB/s, is four orders of magnitude
below the operations' at these sizes; the larger of the two is taken.
"""

from msabench import peaks


def read(run):
    if run.trace is None:
        return None
    device_s = sum(v for k, v in run.trace.kernel_s.items() if "band_fill_kernel" in k)
    work = [w for job in run.jobs for stage, _, _, w in job.spans if stage == "fill"]
    if device_s <= 0 or not work:
        return None
    bound = sum(peaks.fill_bound_s(cells, seq, run.card) or 0.0 for cells, seq in work)
    return bound / device_s * 100 if bound > 0 else None
