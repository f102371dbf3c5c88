"""CLI with the reference's exact I/O contract, on the PyTorch/CUDA port.

Usage::

    python -m msa_tpu_torch.cli < data/mseq.dat
    python -m msa_tpu_torch.cli --backend cuda --input data/mseq-big13-example.txt
    python -m msa_tpu_torch.cli --distributed --coordinator 127.0.0.1:PORT \\
        --num-processes 2 --process-id {0,1} --input data/mseq-big13-example.txt

Reads pxy, pgap, k and k sequences; prints ``Time: <us> us``, the SHA-512
chain hash and the space-separated penalties, byte-identical to
``msa_tpu.cli`` (``msa_tpu/cli.py:20-118``). In a multi-process run every
process computes the same result and only process 0 prints it.
"""

from __future__ import annotations

import argparse
import sys

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
        "--batched", action="store_true",
        help="run through the sharded engine (parallel/engine.py)",
    )
    parser.add_argument(
        "--checkpoint", default=None, metavar="PATH",
        help="journal completed pairs to PATH and resume from it on restart"
        " (a {proc} placeholder expands to the process index)",
    )
    parser.add_argument(
        "--distributed", action="store_true",
        help="join a multi-process run (gloo process group) and take a shard of"
        " the pairs; pass --coordinator/--num-processes/--process-id, or set"
        " MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE",
    )
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument(
        "--platform", default=None, choices=("cpu", "cuda"),
        help="torch device of the run (config.device)",
    )
    parser.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="write a torch.profiler trace of the run to DIR"
        " (default MSA_TPU_TORCH_PROFILE_DIR)",
    )
    args = parser.parse_args(argv)

    from msa_tpu_torch.utils.msaio import format_output, parse_file, parse_input
    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.utils.timing import profile, timestamp_us

    config = TorchConfig.from_env()
    if args.platform:
        config.device = args.platform
    if args.distributed:
        from msa_tpu_torch.parallel.engine import init_distributed

        init_distributed(args.coordinator, args.num_processes, args.process_id)
    try:
        problem = parse_file(args.input) if args.input else parse_input(sys.stdin)
        start = timestamp_us()
        with profile(args.profile_dir or config.profile_dir):
            if args.batched or args.distributed:
                from msa_tpu_torch.parallel.engine import align_kway_sharded

                result = align_kway_sharded(
                    problem, backend=args.backend, checkpoint=args.checkpoint, config=config
                )
            else:
                from msa_tpu_torch.models.kway import align_kway

                result = align_kway(
                    problem, backend=args.backend, checkpoint=args.checkpoint, config=config
                )
        elapsed = timestamp_us() - start
        from msa_tpu_torch.parallel.engine import process_group

        # Process 0 owns stdout, as the reference's rank 0 did.
        if process_group()[0] == 0:
            sys.stdout.write(format_output(elapsed, result.chain_hash, result.penalties))
    finally:
        if args.distributed:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
