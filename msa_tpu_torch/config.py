"""Knobs of the PyTorch/CUDA port.

What the device pipeline (banded or conveyor fill, walk) and the
multi-device engine read lives here. Every field can be overridden from
the environment with the prefix ``MSA_TPU_TORCH_`` (for example
``MSA_TPU_TORCH_RB=4095``). Unlike the JAX package, nothing is sized
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
    # Tallest band height of the banded pipeline: rows of the DP swept
    # together by one thread block. The default fills a block: rb + 1 = 8192
    # lanes = 1024 threads x 8 cells. On an H100 it was the fastest of rb
    # 1023, 2047, 4095 and 8191 for big13's banded fill and walk together
    # (chip_smoke.py's rb sweep, PERF.md). On a card the banded pipeline
    # narrows it for a call whose bands would leave SMs idle, down to 2047
    # at the lowest (ops/band_fill.py::band_height); below 2048 it is kept.
    rb: int = MAX_RB
    # Snapshot stride of the fill == segment length of the walk (one knob,
    # as in msa_tpu.config.snap_k).
    snap_k: int = 1024
    # Pairs with fewer DP cells than this take the native host kernel, one
    # after another once the device pairs are back; the rest take the device
    # pipeline. Measured on an H100 ("NVIDIA H100 80GB HBM3, 700.00 W";
    # scripts/ab_compare.py, 5 alternating reps, PERF.md): 2^16 and 2^18
    # tie within the reps' spread on xulin_adversarial.dat, xulin_test.txt
    # and 1,128 generated pairs of 200-4,000 characters; 2^20 is slower on
    # the first (median 171 against 157 ms) and 2^22 on the first and the
    # last (194 against 157 ms, 1.83 against 1.17 s).
    host_threshold: int = 1 << 18
    # Torch device of the pipeline: "" picks "cuda" when a card is present.
    # "cpu" runs the pipeline through the kernels' plain versions.
    device: str = ""
    # Fill of the device pairs: "conveyor" (ops/conveyor.py: the bands of
    # many pairs staggered through concurrent sweeps, each pair's bands
    # chained across them), "banded" (ops/batch.py: each band of each pair a
    # work item, band after band across SMs) or "auto"
    # (models/kway.py::choose_fill_mode: banded).
    fill_mode: str = "auto"
    # Conveyor band height: a multiple of snap_k (band starts and snapshots
    # stay K-aligned), and rb_conveyor + 1 lanes must fit one block (8,192):
    # a sweep is one thread block with a lane per row of the bands it holds.
    # Not the JAX package's 31744: that is one TensorCore's (R, 128) vector
    # state; 7 * 1024 is the largest multiple of snap_k under 8,192 lanes.
    rb_conveyor: int = 7168
    # Fill launches per conveyor workload (global chunk ranges); after each,
    # one walk launch covers the pairs the fill has finished.
    fill_segments: int = 4
    # Host threads turning walk output into alignment strings, under either
    # fill.
    decode_workers: int = 4
    # Device bytes the pipelines' buffers may take; 0 asks the card (75 % of
    # what it can still allocate, ops/band_fill.py::device_budget). Over it,
    # the conveyor's workload is split in halves; the banded pipeline runs
    # in waves of at most half of it each (ops/batch.py).
    hbm_budget: int = 0
    # Concurrent conveyor sweeps, one thread block each. A sweep holds the
    # bands of many pairs one after another, and a pair's bands lie on
    # several sweeps, each band waiting on its producer's sweep; so every
    # sweep must be resident at once, and a count over what the card holds
    # raises at the launch. 0 means every resident sweep but those of 32
    # SMs, left to the walks (ops/conveyor.py::WALK_SMS).
    conveyors: int = 0
    # Pair schedule of the multi-process engine (parallel/engine.py):
    # "calibrated" (LPT over the cost model that process 0 measures on its
    # card and broadcasts; "lpt" when there is no card), "lpt" (cost m * n)
    # or "block" (contiguous task ids).
    schedule_policy: str = "calibrated"
    # Devices one process splits its device pairs over (models/kway.py,
    # one host thread each); 0 means every card of the process.
    local_devices: int = 0
    # Write a torch.profiler trace of the run into this directory when set.
    profile_dir: str = ""

    @classmethod
    def from_env(cls, **overrides) -> "TorchConfig":
        cfg = cls(**overrides)
        for f in dataclasses.fields(cls):
            env = os.environ.get(f"MSA_TPU_TORCH_{f.name.upper()}")
            if env is not None:
                cur = getattr(cfg, f.name)
                setattr(cfg, f.name, int(env) if isinstance(cur, int) else env)
        return cfg
