"""Timing and tracing of the port.

``timestamp_us``, ``StageTimer`` and ``gcups`` are copies of those of
``msa_tpu/utils/timing.py``; ``profile`` ports its ``profile`` to
``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


def timestamp_us() -> int:
    """Microsecond wall clock (the reference's GetTimeStamp)."""
    return time.time_ns() // 1000


class StageTimer:
    """Accumulating per-stage wall-clock timer."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name}: {self.totals[name]*1e3:.1f} ms"
                f" ({self.counts[name]}x)"
            )
        return "\n".join(lines)


def gcups(cells: int, seconds: float) -> float:
    """Giga cell updates per second."""
    if seconds <= 0:
        return float("inf")
    return cells / seconds / 1e9


@contextlib.contextmanager
def profile(profile_dir: Optional[str]):
    """Record a torch.profiler trace (CPU, and CUDA with a card) of the block.

    Writes it as a Chrome trace, ``trace-<pid>.json`` in ``profile_dir``;
    no-op when the directory is empty or None.
    """
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, f"trace-{os.getpid()}.json"))
