"""The cards' published rates, and the least work a DP cell needs.

Keyed by the name ``torch.cuda.get_device_name()`` gives. H100 SXM: 132 SMs;
64 int32 results a clock on each SM for add, compare, min and max (the CUDA C
Programming Guide's throughput table, compute capability 9.0); 1.98 GHz, the
largest SM clock of its data sheet, at the 700 W limit; 3.35 TB/s of HBM3.
A card set below 700 W runs slower than this under load: its power limit is
printed beside every result.
"""

from __future__ import annotations

from typing import Dict, Optional

CARDS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"sms": 132, "int32_per_sm_clock": 64, "clock_hz": 1.98e9,
                              "hbm_bytes_per_s": 3.35e12},
}

# The fewest integer instructions one DP cell can take, for a cell in a lane
# of 16 bits or more (packed DPX forms): derived in
# ``metrics/band_fill_roofline.py``.
INT32_OPS_PER_CELL = 1


def int32_ops_per_s(card: str) -> Optional[float]:
    c = CARDS.get(card)
    return c and c["sms"] * c["int32_per_sm_clock"] * c["clock_hz"]


def fill_bound_s(cells: int, seq_bytes: int, card: str) -> Optional[float]:
    """Least seconds the card can fill ``cells`` DP cells in: the larger of
    the operations' time and the time to read the sequences once."""
    c = CARDS.get(card)
    if c is None:
        return None
    return max(cells * INT32_OPS_PER_CELL / int32_ops_per_s(card),
               seq_bytes / c["hbm_bytes_per_s"])
