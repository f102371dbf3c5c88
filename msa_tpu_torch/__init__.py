"""msa_tpu_torch — the PyTorch/CUDA port of msa_tpu for NVIDIA Hopper.

The same k-way MSA by sum of pairwise Needleman-Wunsch alignments, with the
same output contract (SHA-512 chain hash and penalties) as ``msa_tpu``,
whose JAX code stays the reference. Big pairs run through three
hand-written CUDA kernels for sm_90a: the banded fill
(``csrc/band_fill.cu``), the conveyor fill (``csrc/conveyor_fill.cu``) and
the traceback walk (``csrc/walk.cu``); each has a plain PyTorch version
beside it, which runs for tensors on the CPU.

- ``ops``      kernels, their plain versions, the kernel build, the pipelines,
               the anti-diagonal sweep in plain torch (``nw_torch``);
- ``models``   pairwise aligner and k-way engine (fill-mode routing, the
               LPT split of the device pairs over the process's devices);
- ``parallel`` schedules, cost model, devices, the multi-process engine;
- ``utils``    I/O contract, hashing, alignment strings, tasks, journal,
               timing, tracing and logging;
- ``native``   the C++ host kernel (``csrc/host``), built with g++ at first use;
- ``state``    the JAX fills' output in the port's layouts;
- ``cli``      the reference's stdin/stdout contract.

The port imports torch and never jax, and nothing of the JAX package: it
keeps its own copies of the host code it shares with it (``utils``,
``ops/reference.py``, ``native``). Its entry points run on a card unless the
caller asks for the CPU.

The top-level names are those of ``msa_tpu``: ``parse_input``,
``format_output``, ``KWayAligner`` and ``align_kway``. They load at first
use, so ``import msa_tpu_torch`` alone imports no torch (the host-only
modules, ``goldens`` and ``scripts/gen_workload.py``, rely on it).
"""

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "parse_input": "msa_tpu_torch.utils.msaio",
    "format_output": "msa_tpu_torch.utils.msaio",
    "KWayAligner": "msa_tpu_torch.models.kway",
    "align_kway": "msa_tpu_torch.models.kway",
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
