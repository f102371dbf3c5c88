"""Multi-process k-way engine and the all-pairs score fill.

Port of ``msa_tpu/parallel/engine.py``. The reference's MPI orchestration
becomes:

- every process parses the same input (no gene broadcast);
- a deterministic schedule (``parallel/schedule.py``) gives each process its
  shard, so no message carries a task;
- each process aligns its shard on its own devices (``models/kway.py``);
- two ``all_gather`` calls merge the penalties and the 128-byte pair hashes
  by task id, and every process folds the same chain.

The merge moves host bytes, as ``multihost_utils.process_allgather`` did,
so the process group is gloo (``torch.distributed``) on one card and on
many: NCCL is not needed.
"""

from __future__ import annotations

import json
import os
import socket
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from msa_tpu_torch.utils.hashing import chain_hashes
from msa_tpu_torch.utils.msaio import Problem
from msa_tpu_torch.config import TorchConfig
from msa_tpu_torch.models.kway import KWayAligner, KWayResult
from msa_tpu_torch.parallel import mesh
from msa_tpu_torch.parallel.schedule import lpt_schedule, pair_costs, schedule_for
from msa_tpu_torch.utils.logging import get_logger
from msa_tpu_torch.utils import timing
from msa_tpu_torch.utils.timing import StageTimer


def sharded_pair_scores(
    genes: Sequence[str], pxy: int, pgap: int,
    devices: Optional[List[torch.device]] = None, config: Optional[TorchConfig] = None,
) -> np.ndarray:
    """(pairs,) int64 minimum penalties of every pair, by task id.

    The pairs are split by LPT (cost m * n) over ``devices`` (default
    ``local_devices(config)``), and each device fills its shard with
    snapshots off in one launch (``ops/band_fill.py::nw_score``), from a
    host thread of its own. The JAX version padded pairs to shape buckets
    and the pair count to the mesh (``engine.py:79-105``) for XLA's static
    shapes; the kernel takes every size at run time, so nothing is padded.
    """
    from msa_tpu_torch.ops.band_fill import nw_score

    config = config or TorchConfig.from_env()
    devices = mesh.local_devices(config) if devices is None else devices
    if not devices:
        raise RuntimeError("no device to fill the pairs on")
    costs = pair_costs(genes)

    def run(dev, shard):
        return nw_score(genes, [(t.i, t.j) for t in shard], pxy, pgap, device=dev, rb=config.rb)

    by_id = mesh.map_shards(run, devices, lpt_schedule(costs, len(devices)))
    return np.array([by_id[t.task_id] for t, _ in costs], np.int64)


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the process group of a multi-process run (gloo), and learn this
    process's place on its host (``mesh.set_host_place``), which decides its
    cards.

    With ``coordinator`` ("HOST:PORT"; process 0 listens there),
    ``num_processes`` and ``process_id``; with none of them, from the
    ``env://`` variables ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and
    ``WORLD_SIZE``. Raises when the group cannot be formed.
    """
    given = [v is not None for v in (coordinator, num_processes, process_id)]
    if not any(given):
        dist.init_process_group("gloo", init_method="env://")
    else:
        if not all(given):
            raise ValueError("coordinator, num_processes and process_id go together")
        host, _, port = coordinator.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"coordinator {coordinator!r} is not HOST:PORT")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
            rank=process_id,
        )
    mesh.set_host_place(*local_place())


def local_place() -> Tuple[int, int]:
    """(local rank, processes on this host) in the process group.

    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` when set (``torchrun`` sets
    them); else every process's host name, gathered once over gloo, so it
    touches no card: the processes on this host, in rank order.
    """
    if "LOCAL_RANK" in os.environ and "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_RANK"]), int(os.environ["LOCAL_WORLD_SIZE"])
    names: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    mine = [r for r, name in enumerate(names) if name == names[dist.get_rank()]]
    return mine.index(dist.get_rank()), len(mine)


def process_group() -> Tuple[int, int]:
    """(this process's index, process count): (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _broadcast_calibration(log, probe: Optional[torch.device]):
    """Process 0's cost model, broadcast so that every process agrees.

    Each process derives the schedule itself, so they must all use the same
    model: process 0 calibrates on ``probe`` (its pipeline's card) and
    sends (ok, gcups, fixed_us) as three float64 values. None when there is
    no card to calibrate on.
    """
    from msa_tpu_torch.parallel.costmodel import CalibratedCost, calibrate

    params = torch.zeros(3, dtype=torch.float64)
    if dist.get_rank() == 0 and probe is not None:
        model = calibrate(device=probe)
        if model is not None:
            params[:] = torch.tensor([1.0, model.gcups, model.fixed_us], dtype=torch.float64)
    dist.broadcast(params, src=0)
    if params[0] < 1.0:
        return None
    model = CalibratedCost(gcups=float(params[1]), fixed_us=float(params[2]))
    log.info("calibrated cost model: %.3f GCUPS, %.0f us fixed", model.gcups, model.fixed_us)
    return model


def _launches() -> dict:
    """Kernel launches of this process so far, by kernel."""
    from msa_tpu_torch.ops.band_fill import band_fill
    from msa_tpu_torch.ops.conveyor import conveyor_fill
    from msa_tpu_torch.ops.walk import walk

    return {fn.__name__: fn.launches for fn in (band_fill, conveyor_fill, walk)}


def align_kway_sharded(
    problem: Problem,
    backend: str = "auto",
    keep_alignments: bool = False,
    checkpoint: Optional[str] = None,
    config: Optional[TorchConfig] = None,
) -> KWayResult:
    """Multi-process k-way engine.

    Every process derives the same schedule, aligns its shard through the
    k-way engine (device pairs split over its devices), then the processes
    exchange penalties and pair hashes by task id and fold the same chain.
    Journals are per process: ``{proc}`` in the checkpoint path becomes the
    process index. One process is ``KWayAligner.align_all``.
    """
    config = config or TorchConfig.from_env()
    genes = problem.genes
    pidx, nproc = process_group()
    log = get_logger("msa_tpu_torch.engine")
    if checkpoint:
        checkpoint = checkpoint.replace("{proc}", str(pidx))
    aligner = KWayAligner(problem.pxy, problem.pgap, backend=backend, config=config)
    if nproc == 1:
        return aligner.align_all(genes, keep_alignments=keep_alignments, checkpoint=checkpoint)

    # One job across the stages: traced while a torch.profiler records.
    with timing.job() as job:
        timer = StageTimer(job)
        pw = aligner.pairwise
        if pw.device is not None and pw.device.type == "cuda":
            # The process's first card is its current one, so that whatever
            # runs on the current card runs on its own.
            torch.cuda.set_device(pw.device)
        with timer.stage("schedule"):
            policy = config.schedule_policy
            cost_model = None
            if policy == "calibrated":
                # The model times the device pipeline's fill, so only a run that
                # has one on a card calibrates.
                probe = pw.device if pw.backend in ("cuda", "auto") else None
                cost_model = _broadcast_calibration(log, probe)
                if cost_model is None:
                    policy = "lpt"  # no calibration: the exact m * n model
            my_tasks = schedule_for(genes, nproc, policy=policy, cost_model=cost_model)[pidx]

        from msa_tpu_torch.ops.band_fill import device_budget

        cards = mesh.local_devices(config) if pw.device is not None else []
        budget = device_budget(pw.device, config.hbm_budget) if pw.device is not None else 0
        with timer.stage("align_shard") as shard:
            my_results = aligner.align_tasks(genes, my_tasks, checkpoint=checkpoint, job=shard)
        local_rank, local_count = mesh.host_place() or (0, 1)
        log.info("shard %s", json.dumps({
            "process": pidx, "processes": nproc, "local_rank": local_rank,
            "local_processes": local_count, "cards": [str(d) for d in cards],
            "processes_on_card": [mesh.processes_on(d) for d in cards],
            "device_budget": budget, "policy": policy, "pairs": len(my_tasks),
            "device_pairs": sum(pw.on_device(genes[t.i], genes[t.j]) for t in my_tasks),
            "total_pairs": problem.num_pairs, "launches": _launches(),
        }))

        total = problem.num_pairs
        penalties = np.full(total, -1, dtype=np.int64)
        hash_bytes = np.zeros((total, 128), dtype=np.uint8)
        for r in my_results:
            penalties[r.task_id] = r.penalty
            hash_bytes[r.task_id] = np.frombuffer(r.problem_hash.encode("ascii"), dtype=np.uint8)

        with timer.stage("allgather_merge"):
            # Max-merge: each task is one process's; the others hold -1 / 0.
            merged = []
            for local in (torch.from_numpy(penalties), torch.from_numpy(hash_bytes)):
                parts = [torch.empty_like(local) for _ in range(nproc)]
                dist.all_gather(parts, local)
                merged.append(torch.stack(parts).amax(dim=0).numpy())
            penalties, hash_bytes = merged

        with timer.stage("hash_chain"):
            chain = chain_hashes(bytes(hash_bytes[tid]).decode("ascii") for tid in range(total))
        log.info("stage times:\n%s", timer.report())
        return KWayResult(
            chain_hash=chain,
            penalties=[int(p) for p in penalties],
            pair_results=my_results if keep_alignments else None,
        )
