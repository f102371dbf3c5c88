"""Timing and tracing of the port.

``StageTimer`` and ``gcups`` are the JAX package's own (its timing module
imports jax only inside ``profile``); ``profile`` ports
``msa_tpu/utils/timing.py::profile`` to ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from msa_tpu.utils.timing import StageTimer, gcups  # noqa: F401


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
