"""I/O contract of the reference aligner.

Input format (reference driver ``seqalign-mpi-skeleton.cpp:43-47``): three
whitespace-separated integers — mismatch penalty ``pxy``, gap penalty
``pgap``, sequence count ``k`` — followed by ``k`` whitespace-separated
sequence tokens.

Output format (``seqalign-mpi-skeleton.cpp:61-69``)::

    Time: <microseconds> us
    <128-hex SHA-512 chain hash>
    <p0> <p1> ... <pN-1> <newline, note trailing space before it>

The port's own copy of ``msa_tpu/utils/msaio.py``; the port imports nothing of the JAX
package. The tests hold the two copies equal.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Iterable, List, Sequence, TextIO, Union


@dataclasses.dataclass(frozen=True)
class Problem:
    """One k-way MSA problem instance."""

    pxy: int  # mismatch penalty
    pgap: int  # gap penalty
    genes: tuple  # k sequences (str)

    @property
    def k(self) -> int:
        return len(self.genes)

    @property
    def num_pairs(self) -> int:
        k = self.k
        return k * (k - 1) // 2


def parse_input(source: Union[str, bytes, TextIO]) -> Problem:
    """Parse the reference's stdin format from a string, bytes, or stream."""
    if isinstance(source, bytes):
        source = source.decode()
    if isinstance(source, str):
        source = io.StringIO(source)
    tokens = source.read().split()
    if len(tokens) < 3:
        raise ValueError("input must start with three integers: pxy pgap k")
    pxy, pgap, k = int(tokens[0]), int(tokens[1]), int(tokens[2])
    genes = tokens[3 : 3 + k]
    if len(genes) != k:
        raise ValueError(f"expected {k} sequences, found {len(genes)}")
    return Problem(pxy=pxy, pgap=pgap, genes=tuple(genes))


def parse_file(path: str) -> Problem:
    with open(path, "r") as f:
        return parse_input(f)


def format_output(
    elapsed_us: int, chain_hash: str, penalties: Sequence[int]
) -> str:
    """Byte-exact reproduction of the reference's stdout contract.

    The reference prints each penalty followed by a space, then a newline
    (``seqalign-mpi-skeleton.cpp:66-69``), so the penalty line carries a
    trailing space.
    """
    pens = "".join(f"{int(p)} " for p in penalties)
    return f"Time: {int(elapsed_us)} us\n{chain_hash}\n{pens}\n"


def format_result_lines(chain_hash: str, penalties: Iterable[int]) -> List[str]:
    """The two content lines (hash, penalties) used for golden comparisons."""
    pens = "".join(f"{int(p)} " for p in penalties)
    return [chain_hash, pens]
