"""Order statistics of the metric files."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank q-th percentile (0 < q <= 100): a value that was observed."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


def median(values: Sequence[float]) -> Optional[float]:
    return percentile(values, 50)
