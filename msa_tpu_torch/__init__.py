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
- ``utils``    timing, tracing and logging;
- ``state``    the JAX fills' output in the port's layouts;
- ``cli``      the reference's stdin/stdout contract.

The port imports torch and never jax; of ``msa_tpu`` it uses only the
jax-free modules (``utils``, ``ops/reference.py``, ``native``).
"""

__version__ = "0.1.0"
