"""SHA-512 pair hash and chain of the reference program.

``seqalign-mpi-skeleton.cpp:155-159``: each pair's hash is
sha512(sha512(align1) ++ sha512(align2)) in lowercase hex, and the run's hash
folds them in task-id order: H <- sha512(H ++ pair hash), H starting empty.
"""

from __future__ import annotations

import hashlib
from typing import Iterable


def sha512_hex(text: str) -> str:
    return hashlib.sha512(text.encode("latin-1")).hexdigest()


def pair_hash(align1: str, align2: str) -> str:
    return sha512_hex(sha512_hex(align1) + sha512_hex(align2))


def chain(pair_hashes: Iterable[str]) -> str:
    h = ""
    for ph in pair_hashes:
        h = sha512_hex(h + ph)
    return h
