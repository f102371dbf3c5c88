"""Cost models for pair scheduling.

Port of ``msa_tpu/parallel/costmodel.py``. The analytic model m * n counts
DP cells exactly; the calibrated one adds what a pair costs beyond its cells
(upload, launch, fetch), measured on the card by timing the score-only fill
(``ops/band_fill.py::nw_score``) at two pair sizes. Measured models persist
in ``$XDG_CACHE_HOME/msa_tpu_torch/calibration.json`` (``~/.cache`` by
default), keyed by the card's name and ``kernel_version()``, the content
digest of the fill kernel's sources: an edited kernel never reuses a stale
entry.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch


def kernel_version() -> str:
    """Digest of ``csrc/band_fill.cu``, its headers and the nvcc flags."""
    from msa_tpu_torch.ops import _build

    return _build._digest("band_fill")


@dataclasses.dataclass
class CalibratedCost:
    """cost_us(m, n) = fixed_us + m * n / gcups / 1e3."""

    gcups: float = 60.0  # fill throughput of the probe
    fixed_us: float = 120_000.0  # per-pair cost beyond the cells

    def cost_us(self, m: int, n: int) -> float:
        return self.fixed_us + m * n / self.gcups / 1e3


def _cache_path() -> str:
    base = os.environ.get("XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "msa_tpu_torch", "calibration.json")


def _cache_key(device_name: str, sample_len: int, small_len: int) -> str:
    return f"{device_name}|{kernel_version()}|{sample_len}|{small_len}"


def load_cached_calibration(
    device_name: str, sample_len: int, small_len: int
) -> Optional[CalibratedCost]:
    try:
        with open(_cache_path()) as f:
            rec = json.load(f).get(_cache_key(device_name, sample_len, small_len))
        if rec:
            return CalibratedCost(gcups=float(rec["gcups"]), fixed_us=float(rec["fixed_us"]))
    except (OSError, ValueError, KeyError):
        pass
    return None


def save_calibration(
    device_name: str, sample_len: int, small_len: int, model: CalibratedCost
) -> None:
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        data[_cache_key(device_name, sample_len, small_len)] = dataclasses.asdict(model)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass  # the cache is best-effort; the model is still returned


def analytic_cost(m: int, n: int) -> int:
    """The reference's exact cell-count model."""
    return m * n


def calibrate(
    sample_len: int = 20000, small_len: int = 2048, reps: int = 2, use_cache: bool = True,
    device: Optional[torch.device] = None,
) -> Optional[CalibratedCost]:
    """Measure the fill's throughput and per-pair fixed cost on the card.

    Two timed pair sizes solve cost(m, n) = fixed_us + cells / rate for both
    terms. A pair's bands run side by side on a few SMs (the 20,000-long
    probe has 3 bands at rb 8191), so the rate is that of one pair's chain
    of bands, not the card's. Returns None without a
    card, or when the two timings stay inverted after a retry with more
    repetitions. ``nw_score`` fetches its result, so each call is timed to
    its end.
    """
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    if use_cache:
        cached = load_cached_calibration(name, sample_len, small_len)
        if cached is not None:
            return cached
    from msa_tpu_torch.config import MAX_RB
    from msa_tpu_torch.ops.band_fill import nw_score

    rng = np.random.default_rng(0)

    def timed(n: int) -> float:
        genes = ["".join(rng.choice(list("ACGT"), n)) for _ in range(2)]
        nw_score(genes, [(0, 1)], 3, 2, device=device, rb=MAX_RB)  # build, load, warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            nw_score(genes, [(0, 1)], 3, 2, device=device, rb=MAX_RB)
            best = min(best, time.perf_counter() - t0)
        return best

    t_small = timed(small_len)
    t_big = timed(sample_len)
    if t_big <= t_small:
        # Noise inverted the samples: retry once with more repetitions; a
        # model still inverted would skew every schedule, so give none.
        if reps < 8:
            return calibrate(sample_len, small_len, reps=reps * 4, use_cache=False, device=device)
        return None
    d_cells = sample_len * sample_len - small_len * small_len
    # Anything outside [1, 1000] GCUPS is a measurement artifact.
    gcups = min(max(d_cells / (t_big - t_small) / 1e9, 1.0), 1000.0)
    fixed_us = max(t_small * 1e6 - small_len * small_len / gcups / 1e3, 0.0)
    model = CalibratedCost(gcups=gcups, fixed_us=fixed_us)
    save_calibration(name, sample_len, small_len, model)
    return model
