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

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    # band_fill(genes, stride, params, num_pairs, rb, snap_k, pxy, pgap,
    #           score, rows, snaps, stream)
    "band_fill": [P, LL, P, I, I, I, I, I, P, P, P, P],
    # walk(genes, stride, params, num_pairs, rb, snap_k, pxy, pgap,
    #      rows, snaps, dirs, moves, counts, stream)
    "walk": [P, LL, P, I, I, I, I, I, P, P, P, P, P, P],
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


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
        cmd = [nvcc, *NVCC_FLAGS, "-o", out + ".tmp",
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (out, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
        else:
            os.replace(out + ".tmp", out)
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
            fn = getattr(lib, name)
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
