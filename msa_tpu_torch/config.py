"""Knobs of the PyTorch/CUDA port.

Only what the banded fill + walk path reads lives here. Every field can be
overridden from the environment with the prefix ``MSA_TPU_TORCH_`` (for
example ``MSA_TPU_TORCH_RB=4095``). Unlike the JAX package, nothing is sized
at compile time: the kernels take every size as a runtime argument, so a
config object is passed to the aligner instead of being read at import.
"""

from __future__ import annotations

import dataclasses
import os

# Cells each thread of the fill and walk kernels owns (csrc/common.cuh, CELLS).
CELLS_PER_THREAD = 8
MAX_THREADS = 1024
# Largest band height the fill kernel takes: rb + 1 lanes, one per row q of
# the band (q = 0 is the carried top row), spread over at most 1024 threads.
MAX_RB = CELLS_PER_THREAD * MAX_THREADS - 1


@dataclasses.dataclass
class TorchConfig:
    # Band height: rows of the DP swept together by one thread block. The
    # default fills a block: rb + 1 = 8192 lanes = 1024 threads x 8 cells.
    rb: int = MAX_RB
    # Snapshot stride of the fill == segment length of the walk (one knob,
    # as in msa_tpu.config.snap_k).
    snap_k: int = 1024
    # Pairs with fewer DP cells than this take the native host kernel
    # (msa_tpu/models/pairwise.py:83); the rest take the device pipeline.
    host_threshold: int = 1 << 18
    # Torch device of the pipeline: "" picks "cuda" when a card is present.
    # "cpu" runs the pipeline through the kernels' plain versions.
    device: str = ""

    @classmethod
    def from_env(cls, **overrides) -> "TorchConfig":
        cfg = cls(**overrides)
        for f in dataclasses.fields(cls):
            env = os.environ.get(f"MSA_TPU_TORCH_{f.name.upper()}")
            if env is not None:
                cur = getattr(cfg, f.name)
                setattr(cfg, f.name, int(env) if isinstance(cur, int) else env)
        return cfg
