"""SHA-512 hash algebra of the reference.

The reference vendors a header-only SHA-512 (``sha512.hh``) and folds every
pairwise alignment into one order-sensitive chain
(``seqalign-mpi-skeleton.cpp:155-159``)::

    h1 = sha512(align1); h2 = sha512(align2)
    problemhash = sha512(h1 ++ h2)
    H <- sha512(H ++ problemhash)      # folded in task-id order, H starts ""

All hashes are lowercase 128-hex-char strings; standard SHA-512, so Python's
``hashlib`` is bit-compatible (verified against the reference goldens).

The port's own copy of ``msa_tpu/utils/hashing.py``; the port imports nothing of the JAX
package. The tests hold the two copies equal.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Tuple, Union


def sha512_hex(data: Union[str, bytes]) -> str:
    if isinstance(data, str):
        data = data.encode()
    return hashlib.sha512(data).hexdigest()


def pair_hash(align1: str, align2: str) -> str:
    """problemhash = sha512(sha512(a1) ++ sha512(a2))."""
    return sha512_hex(sha512_hex(align1) + sha512_hex(align2))


def chain_hashes(problem_hashes: Iterable[str]) -> str:
    """Fold per-pair hashes in task-id order: H <- sha512(H ++ h)."""
    h = ""
    for ph in problem_hashes:
        h = sha512_hex(h + ph)
    return h


def chain_update(h: str, problem_hash: str) -> str:
    return sha512_hex(h + problem_hash)


def hash_alignment_pair(align1: str, align2: str) -> Tuple[str, str, str]:
    h1 = sha512_hex(align1)
    h2 = sha512_hex(align2)
    return h1, h2, sha512_hex(h1 + h2)
