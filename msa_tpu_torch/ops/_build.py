"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for sm_90a into
a shared library with a plain C interface, ``build/lib<name>-<digest>.so``,
and loaded with ``ctypes``. The digest covers the source and the headers, so
an edited kernel is rebuilt and an unchanged one is loaded as it is. All the
sources build in parallel (one ``nvcc`` each). A missing ``nvcc``, a failed
build or a failed load raises: there is no fallback.

Every C entry point takes its pointers and the CUDA stream as ``c_void_p`` and
returns ``cudaGetLastError()`` after its launch; ``check`` raises when that
is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

from msa_tpu_torch.utils import timing

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    # band_fill(genes, stride, params, items, num_items, rb, snap_k, chunk,
    #           pxy, pgap, score, rows, snaps, progress, tickets, relay_out,
    #           relay_in, relay_rows, relay_progress, blocks, stream)
    "band_fill": [P, LL, P, P, I, I, I, I, I, I, P, P, P, P, P, I, I, P, P, ctypes.POINTER(I), P],
    # walk(genes, stride, params, bands, num_pairs, rb, snap_k, pxy, pgap,
    #      rows, snaps, moves, counts, stream)
    "walk": [P, LL, P, P, I, I, I, I, I, P, P, P, P, P],
    # conveyor_fill(genes, stride, sweeps, bands, events, num_sweeps, rb,
    #               snap_k, ymax, pxy, pgap, c0, c1, score, brow, snaps,
    #               carry, progress, stream)
    "conveyor_fill": [P, LL, P, P, P, I, I, I, I, I, I, I, I, P, P, P, P, P, P],
}
# Other C functions of a library: conveyor_fill_resident(rb, snap_k, blocks);
# band_fill_resident(rb, chunk, snaps, relay, blocks); band_fill_peer(dev, peer).
HELPERS = {
    "conveyor_fill": {"conveyor_fill_resident": [I, I, ctypes.POINTER(I)]},
    "band_fill": {"band_fill_resident": [I, I, I, I, ctypes.POINTER(I)], "band_fill_peer": [I, I]},
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        if fname == f"{name}.cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(fname.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}-{_digest(name)}.so")


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Compile every kernel not yet built, all at once; returns ptxas logs."""
    names = list(SIGNATURES) if names is None else names
    todo = [n for n in names if not os.path.exists(_lib_path(n))]
    logs: Dict[str, str] = {}
    if not todo:
        return logs
    os.makedirs(BUILD, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        out = _lib_path(name)
        # The pid keeps processes that build at once off each other's
        # output; os.replace then installs one complete library atomically.
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_lib_path(name))
            for fname, argtypes in {name: SIGNATURES[name], **HELPERS.get(name, {})}.items():
                fn = getattr(lib, fname)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


def count(fn, pairs: int) -> None:
    """Count one launch of ``fn``'s kernel over ``pairs`` pairs, and in a
    traced job the job's ``walk_launches`` or ``fill_launches`` and ``pairs``
    (``utils/timing.py::count_launch``).

    Device threads launch at once, so the counters are updated under a lock.
    """
    with _COUNT_LOCK:
        fn.launches += 1
        fn.pairs += pairs
    timing.count_launch("walk" if fn.__name__ == "walk" else "fill", pairs)
