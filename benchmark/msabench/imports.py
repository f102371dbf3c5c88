"""The check that a run loaded nothing of JAX or of the JAX package.

Modules are compared by their top-level name (the part before the first
dot), whole: ``msa_tpu_torch`` is not ``msa_tpu``.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "msa_tpu")


def found(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: ``sys.modules``)."""
    tops = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))
