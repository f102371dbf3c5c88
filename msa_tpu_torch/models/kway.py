"""k-way MSA by sum of pairwise alignments.

Port of ``msa_tpu/models/kway.py``: all k(k-1)/2 pairs in canonical task
order, each pair's hash folded into one SHA-512 chain and its penalty
listed, both by task id, so the output does not depend on where or in which
order the pairs ran. Every pair at or above ``host_threshold`` DP cells takes
the device pipeline (``ops/conveyor.py`` or ``ops/batch.py``), split by LPT
over the process's devices with one host thread each; the rest take the host
kernel. A pair journal makes a run resumable.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence

from msa_tpu_torch.utils import timing
from msa_tpu_torch.utils.hashing import chain_hashes, pair_hash
from msa_tpu_torch.utils.msaio import Problem
from msa_tpu_torch.utils.tasks import pair_task_list
from msa_tpu_torch.config import TorchConfig
from msa_tpu_torch.models.pairwise import PairResult, PairwiseAligner
from msa_tpu_torch.utils.timing import Span, running, span

FILL_MODES = ("auto", "banded", "conveyor")


def choose_fill_mode(config: TorchConfig) -> str:
    """The fill of the device pairs: ``config.fill_mode`` unless "auto".

    "auto" takes the banded fill. The fill-mode A/B of ``chip_smoke.py``
    on an H100 ("NVIDIA H100 80GB HBM3, 700.00 W"; modes alternating,
    three runs each, one call; PERF.md), with the conveyor redesigned for
    Hopper (bands chained across resident sweeps, 100 of them):
    - big13 (78 pairs of up to 14 bands): banded 0.325-0.364 s end to
      end, conveyor 0.440-0.457 s; the fills alone 139.9 ms and 215.1 ms;
    - 1,128 pairs of one band each (6,000-7,168 characters): the
      conveyor's fill is the faster, 61.0-66.6 ms against 67.8-68.0 ms,
      but end to end banded took 1.37-1.73 s and conveyor 1.31-1.56 s,
      an overlap that the host decode of 1,128 pairs sets; in an earlier
      call, with 132 sweeps, banded won all three pairs of runs.
    The conveyor wins no workload end to end beyond the runs' spread, so
    no rule that routes by workload is supported. The JAX package's rule
    (the conveyor from 3 device pairs, msa_tpu/models/kway.py:28-59) fits
    one TPU TensorCore's lane space.
    """
    if config.fill_mode not in FILL_MODES:
        raise ValueError(f"unknown fill_mode {config.fill_mode!r}; expected one of {FILL_MODES}")
    return "banded" if config.fill_mode == "auto" else config.fill_mode


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
        self, genes: Sequence[str], tasks: Sequence, checkpoint: Optional[str] = None,
        job: Optional[Span] = None,
    ) -> List[PairResult]:
        """Align a task subset; results in the given task order. ``job``
        is the traced job's span the stages go under, None when untraced."""
        pw = self.pairwise
        results: dict = {}
        journal = None
        on_result = None
        with span(job, "kway.setup"):
            if checkpoint:
                from msa_tpu_torch.utils.checkpoint import PairJournal, problem_key

                journal = PairJournal(checkpoint, problem_key(pw.pxy, pw.pgap, genes))
                done = journal.load()
                for t in tasks:
                    if t.task_id in done:
                        penalty, h = done[t.task_id]
                        results[t.task_id] = PairResult(t.task_id, penalty, "", "", h)
            if journal is not None:
                # Each pair is journaled as its walk decodes, so a crash keeps
                # every finished pair. Device and decode threads call in at once.
                lock = threading.Lock()

                def on_result(t, triple):
                    penalty, a1, a2 = triple
                    with lock:
                        journal.record(t.task_id, penalty, pair_hash(a1, a2))

            remaining = [t for t in tasks if t.task_id not in results]
            device_tasks = [t for t in remaining if pw.on_device(genes[t.i], genes[t.j])]
        try:
            if device_tasks:
                triples = self._run_batched(genes, device_tasks, on_result, job)
                with span(job, "kway.pair_hash"):
                    for t, (penalty, a1, a2) in zip(device_tasks, triples):
                        results[t.task_id] = PairResult(
                            t.task_id, penalty, a1, a2, pair_hash(a1, a2))
            with span(job, "kway.host_pairs"):
                for t in tasks:
                    if t.task_id not in results:
                        results[t.task_id] = pw.do_task(t.task_id, genes[t.i], genes[t.j])
                        if journal is not None:
                            r = results[t.task_id]
                            journal.record(t.task_id, r.penalty, r.problem_hash)
                return [results[t.task_id] for t in tasks]
        finally:
            if journal is not None:
                journal.close()

    def _run_batched(self, genes: Sequence[str], tasks: Sequence, on_task_result=None,
                     job: Optional[Span] = None):
        """(penalty, align1, align2) of each device task, in ``tasks`` order.

        Port of ``msa_tpu/models/kway.py:220-287``: the device pairs are
        split by LPT (cost m * n, ties by task id) over the process's devices
        (``parallel/mesh.py::local_devices``), each shard at least two pairs,
        and every device runs the whole fill + walk pipeline in a host thread
        of its own, under ``torch.cuda.device`` and a stream of its own.
        ``on_task_result(task, triple)`` fires as each pair decodes, from any
        thread.
        """
        pw = self.pairwise
        with span(job, "kway.setup"):
            from msa_tpu_torch.parallel.mesh import local_devices, map_shards
            from msa_tpu_torch.parallel.schedule import lpt_schedule

            if choose_fill_mode(pw.config) == "conveyor":
                from msa_tpu_torch.ops.conveyor import align_pairs_conveyor
            else:
                align_pairs_conveyor = None
                from msa_tpu_torch.ops.batch import align_pairs_batched
            devs = local_devices(pw.config)  # at most config.local_devices
            n_used = max(1, min(len(devs), len(tasks) // 2))

        def run_on(dev, shard, parent=job):
            cb = None
            if on_task_result is not None:
                def cb(idx, triple):
                    on_task_result(shard[idx], triple)

            pairs = [(t.i, t.j) for t in shard]
            if align_pairs_conveyor is not None:
                return align_pairs_conveyor(
                    genes, pairs, pw.pxy, pw.pgap, device=dev, config=pw.config, on_result=cb,
                )
            with running(parent):
                return align_pairs_batched(
                    genes, pairs, pw.pxy, pw.pgap, device=dev, rb=pw.config.rb,
                    snap_k=pw.config.snap_k, on_result=cb, config=pw.config, job=parent,
                )

        if n_used == 1:
            return run_on(pw.device, tasks)
        with span(job, "kway.shards") as shards:
            split = lpt_schedule([(t, len(genes[t.i]) * len(genes[t.j])) for t in tasks], n_used)
            by_id = map_shards(lambda dev, shard: run_on(dev, shard, shards), devs, split)
            return [by_id[t.task_id] for t in tasks]

    def align_all(
        self, genes: Sequence[str], keep_alignments: bool = False,
        checkpoint: Optional[str] = None, job=timing.NEW_JOB,
    ) -> KWayResult:
        """The k-way result of all pairs of ``genes``: a job of its own
        (``utils/timing.py::job``) unless ``align_kway`` hands in its span."""
        if job is not timing.NEW_JOB:
            return self._align_all(genes, keep_alignments, checkpoint, job)
        with timing.job() as job:
            return self._align_all(genes, keep_alignments, checkpoint, job)

    def _align_all(self, genes, keep_alignments, checkpoint, job) -> KWayResult:
        with span(job, "kway.setup"):
            tasks = pair_task_list(len(genes))
            if job is not None:
                total = sum(len(g) for g in genes)
                cells = (total * total - sum(len(g) ** 2 for g in genes)) // 2
                job.attrs.update(k=len(genes), pairs=len(tasks), cells=cells)
        results = self.align_tasks(genes, tasks, checkpoint, job)
        with span(job, "kway.chain"):
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
    """One-shot entry: Problem -> (chain hash, penalties). The job, aligner
    construction included, is traced while a ``torch.profiler`` records."""
    with timing.job() as job:
        with span(job, "kway.setup"):
            engine = KWayAligner(problem.pxy, problem.pgap, backend=backend, config=config)
        return engine.align_all(
            problem.genes, keep_alignments=keep_alignments, checkpoint=checkpoint, job=job
        )
