"""Alignment-string algebra shared by every backend.

Replicates, bit for bit, the reference's traceback completion and gap-trim
rules so that alignments (and therefore SHA-512 hashes) are byte-identical:

- Traceback walks from (m, n) while ``i > 0 and j > 0`` taking moves in the
  tie-break order match -> diagonal -> up -> left
  (``seqalign-mpi-skeleton.cpp:236-262``). Backends produce this walk as a
  sequence of *moves*; this module turns moves into strings.
- Greedy prefix completion: remaining slots are filled right-aligned with the
  unconsumed prefix of each sequence, padded with ``'_'``
  (``seqalign-mpi-skeleton.cpp:263-272``).
- Gap-trim: scan the l = m+n wide result from the right for the last column
  where *both* strings hold ``'_'``; the alignment is everything after it
  (``seqalign-mpi-skeleton.cpp:135-144``).

Move encoding (walk order is from (m, n) backward toward the origin):

    0 = diagonal, characters match
    1 = diagonal, substitution (mismatch)
    2 = up    (consume x[i-1], gap in y)
    3 = left  (consume y[j-1], gap in x)

The port's own copy of ``msa_tpu/utils/alignment.py``; the port imports nothing of the JAX
package. The tests hold the two copies equal.
"""

from __future__ import annotations

from typing import Sequence, Tuple

GAP = "_"

DIAG_MATCH, DIAG_SUB, UP, LEFT = 0, 1, 2, 3

_VECTOR_THRESHOLD = 4096  # above this many moves, use the NumPy builder


def moves_to_alignment(
    x: str, y: str, moves: Sequence[int]
) -> Tuple[str, str]:
    """Build the trimmed alignment strings from a backward move sequence.

    ``moves`` is the traceback walk starting at (m, n); the walk must stop
    exactly when ``i == 0 or j == 0`` (reference loop condition at
    ``seqalign-mpi-skeleton.cpp:236``).
    """
    if len(moves) >= _VECTOR_THRESHOLD:
        return _moves_to_alignment_np(x, y, moves)
    m, n = len(x), len(y)
    i, j = m, n
    sx = []  # suffix of align1, built backward
    sy = []
    for mv in moves:
        if mv == DIAG_MATCH or mv == DIAG_SUB:
            i -= 1
            j -= 1
            sx.append(x[i])
            sy.append(y[j])
        elif mv == UP:
            i -= 1
            sx.append(x[i])
            sy.append(GAP)
        elif mv == LEFT:
            j -= 1
            sx.append(GAP)
            sy.append(y[j])
        else:  # pragma: no cover - defensive
            raise ValueError(f"bad move {mv}")
    if i != 0 and j != 0:
        raise ValueError(
            f"traceback stopped early at i={i}, j={j}; walk must reach a border"
        )
    sx.reverse()
    sy.reverse()
    return finish_alignment(x, y, i, j, "".join(sx), "".join(sy))


def _moves_to_alignment_np(
    x: str, y: str, moves: Sequence[int]
) -> Tuple[str, str]:
    """Vectorized move-to-string construction (big pairs).

    Byte-identical to the scalar path: walks are counted with cumulative
    sums instead of a per-move Python loop.
    """
    import numpy as np

    m, n = len(x), len(y)
    mv = np.asarray(moves, dtype=np.int8)
    if mv.size and ((mv < 0).any() or (mv > 3).any()):
        raise ValueError("bad move value")
    xcons = mv <= UP  # 0,1,2 consume x
    ycons = (mv <= DIAG_SUB) | (mv == LEFT)  # 0,1,3 consume y
    i0 = m - int(xcons.sum())
    j0 = n - int(ycons.sum())
    if i0 != 0 and j0 != 0:
        raise ValueError(
            f"traceback stopped early at i={i0}, j={j0};"
            " walk must reach a border"
        )
    # Forward order (origin -> (m,n)); index of the consumed character.
    fx = xcons[::-1]
    fy = ycons[::-1]
    xcodes = np.frombuffer(x.encode("latin-1"), dtype=np.uint8)
    ycodes = np.frombuffer(y.encode("latin-1"), dtype=np.uint8)
    gap = np.uint8(ord(GAP))
    xi = np.cumsum(fx) - 1 + i0
    yj = np.cumsum(fy) - 1 + j0
    sx = np.where(fx, xcodes[np.clip(xi, 0, max(m - 1, 0))], gap)
    sy = np.where(fy, ycodes[np.clip(yj, 0, max(n - 1, 0))], gap)
    suffix_x = sx.tobytes().decode("latin-1")
    suffix_y = sy.tobytes().decode("latin-1")
    return finish_alignment(x, y, i0, j0, suffix_x, suffix_y)


def finish_alignment(
    x: str, y: str, i0: int, j0: int, suffix_x: str, suffix_y: str
) -> Tuple[str, str]:
    """Apply the reference's prefix completion + gap trim.

    ``suffix_x``/``suffix_y`` are the aligned tails recovered by the walk
    (equal length); ``(i0, j0)`` is where the walk stopped (one of them 0).
    """
    m, n = len(x), len(y)
    l = m + n
    pos = l - len(suffix_x)  # == xpos == ypos after the main loop
    if len(suffix_x) != len(suffix_y):
        raise ValueError("suffix length mismatch")
    # Positions 1..pos (1-based) are filled right-aligned with the remaining
    # prefix then '_' padding (seqalign-mpi-skeleton.cpp:263-272).
    a1 = GAP * (pos - i0) + x[:i0] + suffix_x
    a2 = GAP * (pos - j0) + y[:j0] + suffix_y
    # Gap trim: find last 1-based position a where both are '_'; keep a+1..l.
    # (seqalign-mpi-skeleton.cpp:135-144; id defaults to 1 => keep whole.)
    if l > 4096:
        import numpy as np

        b1 = np.frombuffer(a1.encode("latin-1"), dtype=np.uint8)
        b2 = np.frombuffer(a2.encode("latin-1"), dtype=np.uint8)
        both = np.flatnonzero((b1 == ord(GAP)) & (b2 == ord(GAP)))
        cut = int(both[-1]) + 1 if both.size else 0
    else:
        cut = 0  # 0-based count of chars to drop
        for a in range(l - 1, -1, -1):
            if a1[a] == GAP and a2[a] == GAP:
                cut = a + 1
                break
    return a1[cut:], a2[cut:]
