"""CLI with the reference's exact I/O contract, on the PyTorch/CUDA port.

Usage::

    python -m msa_tpu_torch.cli < data/mseq.dat
    python -m msa_tpu_torch.cli --backend cuda --input data/mseq-big13-example.txt

Reads pxy, pgap, k and k sequences; prints ``Time: <us> us``, the SHA-512
chain hash and the space-separated penalties, byte-identical to
``msa_tpu.cli`` (``msa_tpu/cli.py:20-118``).
"""

from __future__ import annotations

import argparse
import sys
import time

from msa_tpu_torch.models.pairwise import BACKENDS


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="msa_tpu_torch", description=__doc__)
    parser.add_argument(
        "--backend", default="auto", choices=BACKENDS,
        help="pairwise backend (auto: big pairs on the card when there is one)",
    )
    parser.add_argument(
        "--input", default=None, help="read problem from file instead of stdin"
    )
    parser.add_argument(
        "--checkpoint", default=None, metavar="PATH",
        help="journal completed pairs to PATH and resume from it on restart",
    )
    args = parser.parse_args(argv)

    from msa_tpu.utils.msaio import format_output, parse_file, parse_input
    from msa_tpu_torch.models.kway import align_kway

    problem = parse_file(args.input) if args.input else parse_input(sys.stdin)
    start = time.time_ns() // 1000
    result = align_kway(problem, backend=args.backend, checkpoint=args.checkpoint)
    elapsed = time.time_ns() // 1000 - start
    sys.stdout.write(format_output(elapsed, result.chain_hash, result.penalties))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
