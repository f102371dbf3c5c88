"""Pairwise global alignment with the port's backends.

Port of ``msa_tpu/models/pairwise.py``. Backends:

- ``numpy``  the host oracle (``ops/reference.py``);
- ``native`` the C++ host kernel (``native.py``);
- ``torch``  the anti-diagonal sweep in plain torch ops (``ops/nw_torch.py``,
             the counterpart of the JAX package's ``jax`` backend) for every
             pair, on ``config.device`` or else the card;
- ``cuda``   the device pipeline (conveyor or banded fill, walk) on a card;
- ``auto``   the device pipeline on ``config.device`` or else the card.

Without a card, ``torch``, ``cuda`` and ``auto`` raise unless the caller
asks for the CPU (``config.device = "cpu"``: ``--platform cpu`` or
``MSA_TPU_TORCH_DEVICE=cpu``); there the pipeline runs the kernels' plain
versions. With ``cuda`` or ``auto``, pairs under ``config.host_threshold``
DP cells stay on the host, as in the JAX package (pairwise.py:54-63).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from msa_tpu_torch.utils.hashing import pair_hash
from msa_tpu_torch.config import TorchConfig

BACKENDS = ("numpy", "native", "torch", "cuda", "auto")


@dataclasses.dataclass
class PairResult:
    task_id: int
    penalty: int
    align1: str
    align2: str
    problem_hash: str


def pipeline_device(backend: str, config: TorchConfig) -> Optional[torch.device]:
    """The torch device pairs run on, or None for host-only backends.

    For ``torch`` that is the sweep's device; for the others the device
    pipeline's: ``config.device`` when it names one, else the process's
    first card (``parallel/mesh.py::local_devices``). Raises without a card
    unless ``config.device`` names a device.
    """
    from msa_tpu_torch.parallel.mesh import local_devices

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend in ("numpy", "native"):
        return None
    if backend == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'cuda' needs a CUDA device; none is available")
        if config.device and torch.device(config.device).type != "cuda":
            raise ValueError(f"backend 'cuda' cannot run on device {config.device}")
    elif not config.device and not torch.cuda.is_available():
        raise RuntimeError(
            f"backend {backend!r} runs on a CUDA device and none is available; to run on"
            " the CPU, ask for it: --platform cpu, MSA_TPU_TORCH_DEVICE=cpu, or a host"
            " backend (--backend numpy or native)"
        )
    return local_devices(config)[0]


def align_host(x: str, y: str, pxy: int, pgap: int, backend: str) -> Tuple[int, str, str]:
    if backend == "numpy":
        from msa_tpu_torch.ops.reference import nw_align_numpy

        return nw_align_numpy(x, y, pxy, pgap)
    from msa_tpu_torch.native import nw_align_native

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
        """Whether the pair takes the device pipeline (fill + walk)."""
        return (
            self.backend != "torch" and self.device is not None
            and len(x) * len(y) >= self.config.host_threshold
        )

    def align(self, x: str, y: str) -> Tuple[int, str, str]:
        if self.backend == "torch":
            from msa_tpu_torch.ops.nw_torch import nw_align_torch

            return nw_align_torch(x, y, self.pxy, self.pgap, device=self.device)
        if self.on_device(x, y):
            from msa_tpu_torch.ops.batch import align_pairs_batched

            return align_pairs_batched(
                [x, y], [(0, 1)], self.pxy, self.pgap, device=self.device,
                rb=self.config.rb, snap_k=self.config.snap_k, config=self.config,
            )[0]
        return align_host(x, y, self.pxy, self.pgap, self.backend)

    def do_task(self, task_id: int, x: str, y: str) -> PairResult:
        penalty, a1, a2 = self.align(x, y)
        return PairResult(task_id, penalty, a1, a2, pair_hash(a1, a2))
