"""Pairwise global alignment with the port's backends.

Port of ``msa_tpu/models/pairwise.py``. Backends:

- ``numpy``  the host oracle (``msa_tpu.ops.reference``);
- ``native`` the C++ host kernel (``msa_tpu.native``);
- ``cuda``   the device pipeline (banded fill + walk kernels) on a card;
             raises when there is none;
- ``auto``   the device pipeline on ``config.device`` (or a card, when one
             is present), else the native host kernel.

With ``cuda`` or ``auto``, pairs under ``config.host_threshold`` DP cells
stay on the host, as in the JAX package (pairwise.py:54-63).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from msa_tpu.utils.hashing import pair_hash
from msa_tpu_torch.config import TorchConfig

BACKENDS = ("numpy", "native", "cuda", "auto")


@dataclasses.dataclass
class PairResult:
    task_id: int
    penalty: int
    align1: str
    align2: str
    problem_hash: str


def pipeline_device(backend: str, config: TorchConfig) -> Optional[torch.device]:
    """The torch device big pairs run on, or None for host-only backends."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend in ("numpy", "native"):
        return None
    if backend == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'cuda' needs a CUDA device; none is available")
        dev = torch.device(config.device or "cuda")
        if dev.type != "cuda":
            raise ValueError(f"backend 'cuda' cannot run on device {dev}")
        return dev
    if config.device:
        return torch.device(config.device)
    return torch.device("cuda") if torch.cuda.is_available() else None


def align_host(x: str, y: str, pxy: int, pgap: int, backend: str) -> Tuple[int, str, str]:
    if backend == "numpy":
        from msa_tpu.ops.reference import nw_align_numpy

        return nw_align_numpy(x, y, pxy, pgap)
    from msa_tpu.native import nw_align_native

    return nw_align_native(x, y, pxy, pgap)


class PairwiseAligner:
    """Penalties, backend and config of one run."""

    def __init__(self, pxy: int, pgap: int, backend: str = "auto",
                 config: Optional[TorchConfig] = None):
        self.pxy = pxy
        self.pgap = pgap
        self.backend = backend
        self.config = config or TorchConfig.from_env()
        self.device = pipeline_device(backend, self.config)

    def on_device(self, x: str, y: str) -> bool:
        return self.device is not None and len(x) * len(y) >= self.config.host_threshold

    def align(self, x: str, y: str) -> Tuple[int, str, str]:
        if self.on_device(x, y):
            from msa_tpu_torch.ops.batch import align_pairs_batched

            return align_pairs_batched(
                [x, y], [(0, 1)], self.pxy, self.pgap, device=self.device,
                rb=self.config.rb, snap_k=self.config.snap_k,
            )[0]
        return align_host(x, y, self.pxy, self.pgap, self.backend)

    def do_task(self, task_id: int, x: str, y: str) -> PairResult:
        penalty, a1, a2 = self.align(x, y)
        return PairResult(task_id, penalty, a1, a2, pair_hash(a1, a2))
