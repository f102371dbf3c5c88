"""Logging with the process rank (port of ``msa_tpu/utils/logging.py``).

The level comes from ``MSA_TPU_TORCH_LOG`` (default WARNING); the rank of a
multi-process run from ``torch.distributed``.
"""

from __future__ import annotations

import logging
import os
import sys

import torch.distributed as dist


def get_logger(name: str = "msa_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    handler = logging.StreamHandler(sys.stderr)
    rank = ""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        rank = f"[p{dist.get_rank()}]"
    handler.setFormatter(logging.Formatter(f"%(asctime)s %(levelname).1s {rank} %(name)s: %(message)s"))
    logger.addHandler(handler)
    level = os.environ.get("MSA_TPU_TORCH_LOG", "WARNING").upper()
    logger.setLevel(getattr(logging, level, logging.WARNING))
    return logger
