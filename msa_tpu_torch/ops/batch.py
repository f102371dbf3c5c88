"""The device pipeline for a list of pairs: one fill launch, one walk launch.

Port of ``msa_tpu/ops/batch.py::align_pairs_batched``. The gene table goes
to the device once as uint8 codes. One fill launch covers every pair (one
thread block each) and one walk launch traces every pair. The scores, move
words and move counts come back in one fetch each, and the host turns each
pair's moves into its alignment strings: ``decode_moves`` ->
``moves_to_alignment``. Everything the JAX version did to serve one compiled
TPU program (static caps, band-count buckets, P_GROUP pairs on the
sublanes, feed buffers laid out for aligned DMA) has no counterpart here:
the kernels take every size at run time.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from msa_tpu.utils.alignment import moves_to_alignment
from msa_tpu_torch.ops.band_fill import (
    P_MOVES_OFF,
    band_fill,
    gene_table,
    plan_pairs,
)
from msa_tpu_torch.ops.walk import decode_moves, walk


def align_pairs_batched(
    genes: Sequence[str],
    pairs: Sequence[Tuple[int, int]],
    pxy: int,
    pgap: int,
    *,
    device: torch.device,
    rb: int,
    snap_k: int,
    on_result: Optional[Callable[[int, Tuple[int, str, str]], None]] = None,
) -> List[Tuple[int, str, str]]:
    """(penalty, align1, align2) for each (x gene, y gene) pair, in order.

    ``on_result(idx, triple)`` fires as each pair's alignment is decoded.
    """
    if not pairs:
        return []
    plan = plan_pairs([len(g) for g in genes], pairs, rb, snap_k)
    table = torch.from_numpy(gene_table(genes)).to(device)
    fill = band_fill(table, plan, pxy, pgap)
    words_d, counts_d = walk(table, plan, fill, pxy, pgap)
    scores = fill.score.cpu().numpy()
    words = words_d.cpu().numpy()
    counts = counts_d.cpu().numpy()

    out: List[Tuple[int, str, str]] = []
    for idx, (xg, yg) in enumerate(pairs):
        off = int(plan.params[idx, P_MOVES_OFF])
        cnt = int(counts[idx])
        moves = decode_moves(words[None, off : off + -(-cnt // 16)], counts[idx : idx + 1])
        a1, a2 = moves_to_alignment(genes[xg], genes[yg], moves)
        out.append((int(scores[idx]), a1, a2))
        if on_result is not None:
            on_result(idx, out[-1])
    return out
