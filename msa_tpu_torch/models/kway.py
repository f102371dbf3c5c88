"""k-way MSA by sum of pairwise alignments.

Port of ``msa_tpu/models/kway.py``: all k(k-1)/2 pairs in canonical task
order, each pair's hash folded into one SHA-512 chain and its penalty
listed, both by task id, so the output does not depend on where or in which
order the pairs ran. Every pair at or above ``host_threshold`` DP cells takes
the device pipeline (``ops/batch.py``: one fill launch and one walk launch
for all of them); the rest take the host kernel. A pair journal makes a run
resumable.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from msa_tpu.utils.hashing import chain_hashes, pair_hash
from msa_tpu.utils.msaio import Problem
from msa_tpu.utils.tasks import pair_task_list
from msa_tpu_torch.config import TorchConfig
from msa_tpu_torch.models.pairwise import PairResult, PairwiseAligner


@dataclasses.dataclass
class KWayResult:
    chain_hash: str
    penalties: List[int]
    pair_results: Optional[List[PairResult]] = None


class KWayAligner:
    def __init__(self, pxy: int, pgap: int, backend: str = "auto",
                 config: Optional[TorchConfig] = None):
        self.pairwise = PairwiseAligner(pxy, pgap, backend=backend, config=config)

    def align_tasks(
        self, genes: Sequence[str], tasks: Sequence, checkpoint: Optional[str] = None
    ) -> List[PairResult]:
        """Align a task subset; results in the given task order."""
        pw = self.pairwise
        results: dict = {}
        journal = None
        if checkpoint:
            from msa_tpu.utils.checkpoint import PairJournal, problem_key

            journal = PairJournal(checkpoint, problem_key(pw.pxy, pw.pgap, genes))
            done = journal.load()
            for t in tasks:
                if t.task_id in done:
                    penalty, h = done[t.task_id]
                    results[t.task_id] = PairResult(t.task_id, penalty, "", "", h)
        try:
            remaining = [t for t in tasks if t.task_id not in results]
            device_tasks = [t for t in remaining if pw.on_device(genes[t.i], genes[t.j])]
            if device_tasks:
                from msa_tpu_torch.ops.batch import align_pairs_batched

                def on_result(idx, triple):
                    t = device_tasks[idx]
                    penalty, a1, a2 = triple
                    results[t.task_id] = PairResult(
                        t.task_id, penalty, a1, a2, pair_hash(a1, a2)
                    )
                    if journal is not None:
                        journal.record(t.task_id, penalty, results[t.task_id].problem_hash)

                align_pairs_batched(
                    genes, [(t.i, t.j) for t in device_tasks], pw.pxy, pw.pgap,
                    device=pw.device, rb=pw.config.rb, snap_k=pw.config.snap_k,
                    on_result=on_result,
                )
            for t in tasks:
                if t.task_id not in results:
                    results[t.task_id] = pw.do_task(t.task_id, genes[t.i], genes[t.j])
                    if journal is not None:
                        r = results[t.task_id]
                        journal.record(t.task_id, r.penalty, r.problem_hash)
        finally:
            if journal is not None:
                journal.close()
        return [results[t.task_id] for t in tasks]

    def align_all(
        self, genes: Sequence[str], keep_alignments: bool = False,
        checkpoint: Optional[str] = None,
    ) -> KWayResult:
        results = self.align_tasks(genes, pair_task_list(len(genes)), checkpoint)
        return KWayResult(
            chain_hash=chain_hashes(r.problem_hash for r in results),
            penalties=[r.penalty for r in results],
            pair_results=results if keep_alignments else None,
        )


def align_kway(
    problem: Problem,
    backend: str = "auto",
    keep_alignments: bool = False,
    checkpoint: Optional[str] = None,
    config: Optional[TorchConfig] = None,
) -> KWayResult:
    """One-shot driver: Problem -> (chain hash, penalties)."""
    engine = KWayAligner(problem.pxy, problem.pgap, backend=backend, config=config)
    return engine.align_all(
        problem.genes, keep_alignments=keep_alignments, checkpoint=checkpoint
    )
