"""The C++ host kernel, loaded with ctypes.

The port's counterpart of ``msa_tpu/native/lib.py``, with the same entry
points (``nw_score_native``, ``nw_align_native``, ``native_available``): the
sequential Needleman-Wunsch oracle of ``csrc/host/msanative.cpp`` for the
pairs that stay on the host. The source is compiled on first use by ``g++
-O3 -std=c++17 -shared -fPIC`` into ``build/libmsanative-<digest>.so`` (the
digest covers the source and the flags, so an edited source is rebuilt). No
``-march=native``: the library must run on whatever CPU loads it. A missing
compiler, a failed build or a failed load raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(PKG, "csrc", "host", "msanative.cpp")
BUILD = os.path.join(PKG, "build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD, f"libmsanative-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the host library unless it is built; returns its path."""
    out = lib_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the host kernel cannot be built")
    os.makedirs(BUILD, exist_ok=True)
    # The pid keeps processes that build at once off each other's output.
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            P, I = ctypes.c_char_p, ctypes.c_int
            lib.nw_score.restype = I
            lib.nw_score.argtypes = [P, I, P, I, I, I]
            lib.nw_align.restype = I
            # x, m, y, n, pxy, pgap, out align1 (m + n + 1), out align2,
            # out aligned length
            lib.nw_align.argtypes = [P, I, P, I, I, I, P, P, ctypes.POINTER(I)]
            _LIB = lib
        return _LIB


def native_available() -> bool:
    """Whether the host library builds and loads here."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def nw_score_native(x: str, y: str, pxy: int, pgap: int) -> int:
    return int(_load().nw_score(x.encode(), len(x), y.encode(), len(y), pxy, pgap))


def nw_align_native(x: str, y: str, pxy: int, pgap: int) -> Tuple[int, str, str]:
    """(penalty, align1, align2) of one pair on the host."""
    lib = _load()
    m, n = len(x), len(y)
    buf1 = ctypes.create_string_buffer(m + n + 1)
    buf2 = ctypes.create_string_buffer(m + n + 1)
    out_len = ctypes.c_int(0)
    penalty = lib.nw_align(x.encode(), m, y.encode(), n, pxy, pgap, buf1, buf2,
                           ctypes.byref(out_len))
    la = out_len.value
    return int(penalty), buf1.raw[:la].decode("latin-1"), buf2.raw[:la].decode("latin-1")
