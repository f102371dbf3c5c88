"""The process's devices.

Counterpart of ``msa_tpu/parallel/mesh.py::get_mesh`` and
``jax.local_devices()``: the devices one process shards its device pairs
over (``models/kway.py``), its score-only fills (``parallel/engine.py``)
and a lone pair's stripes (``ops/nw_striped.py``), only ever its own.

In a process group the processes of one host split its cards by
``card_rule``: process ``local_rank`` of ``local_count`` takes cards
``local_rank``, ``local_rank + local_count``, ... when there are at least
as many cards as processes, else card ``local_rank % cards``, which it
shares. ``parallel/engine.py::init_distributed`` learns the process's place
on its host (``set_host_place``) before any card is touched.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from msa_tpu_torch.config import TorchConfig

# (local rank, processes on the host) of this process in its process group.
_host_place: Optional[Tuple[int, int]] = None


def set_host_place(local_rank: int, local_count: int) -> None:
    """Record this process's place among the processes of its host."""
    global _host_place
    if not 0 <= local_rank < local_count:
        raise ValueError(f"local rank {local_rank} is not one of {local_count} processes")
    _host_place = (local_rank, local_count)


def host_place() -> Optional[Tuple[int, int]]:
    """(local rank, processes on the host) in a process group, else None."""
    if _host_place is None or not (dist.is_available() and dist.is_initialized()):
        return None
    return _host_place


def card_rule(local_rank: int, local_count: int, cards: int) -> List[int]:
    """The card indices of process ``local_rank`` of the ``local_count``
    processes of a host with ``cards`` cards: every ``local_count``-th card
    from ``local_rank`` when ``local_count <= cards``, else the one card
    ``local_rank % cards``."""
    if cards < 1:
        raise ValueError("a host without cards has no card to give")
    if local_count <= cards:
        return list(range(local_rank, cards, local_count))
    return [local_rank % cards]


def card_sharers(card: int, local_count: int, cards: int) -> int:
    """How many of a host's ``local_count`` processes ``card_rule`` binds to
    ``card``."""
    if local_count <= cards:
        return 1
    return local_count // cards + (card < local_count % cards)


def processes_on(device: torch.device) -> int:
    """The processes of this host that share ``device`` (1 outside a process
    group and off the card). A card that ``config.device`` names is counted
    as ``card_rule`` counts it."""
    place = host_place()
    if place is None or device.type != "cuda":
        return 1
    cards = torch.cuda.device_count()
    index = torch.cuda.current_device() if device.index is None else device.index
    return card_sharers(index, place[1], cards)


def local_devices(config: TorchConfig) -> List[torch.device]:
    """The process's cards, at most ``config.local_devices`` of them (0: all).

    Every card of the host outside a process group, else its cards by
    ``card_rule``. ``[cpu]`` when ``config.device`` is "cpu"; the one device
    ``config.device`` names when it names an indexed card. "cuda" with no
    card gives no device, never the CPU; with ``config.device`` unset and no
    card it raises: the CPU runs only when the caller asks for it.
    """
    if config.device:
        dev = torch.device(config.device)
        if dev.type != "cuda" or dev.index is not None:
            return [dev]
    elif not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; to run on the CPU, ask for it:"
            " --platform cpu or MSA_TPU_TORCH_DEVICE=cpu"
        )
    count = torch.cuda.device_count()
    place = host_place()
    ids = list(range(count)) if place is None or not count else card_rule(*place, count)
    return [torch.device("cuda", i) for i in ids[: config.local_devices or len(ids)]]


@contextlib.contextmanager
def device_scope(dev: torch.device):
    """Make ``dev`` the thread's card and give the thread a stream of its own.

    Nothing to do for the CPU.
    """
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(torch.cuda.Stream(dev)):
        yield


def check_stripes(devices: Sequence[torch.device], grids: Sequence[int],
                  resident: Callable[[torch.device], int],
                  can_access: Callable[[int, int], bool] = None) -> None:
    """Raise, with the reason, unless a lone pair's stripes can run on
    ``devices`` (``ops/nw_striped.py``) at once.

    ``grids[c]``: blocks of stripe c's fill launch (0: an empty stripe);
    ``resident(card)``: blocks of the fill one card holds at once. Stripe
    c's last band stores into stripe c + 1's card, so two distinct cards in
    a row need peer access (``can_access``, default
    ``torch.cuda.can_device_access_peer``). Stripes that share a card spin
    on each other's counts, so their grids must all be resident at once.
    Nothing relays through the host or runs the stripes one after another.
    """
    can_access = can_access or torch.cuda.can_device_access_peer
    for c in range(len(devices) - 1):
        src, dst = devices[c], devices[c + 1]
        if grids[c + 1] and src != dst and not can_access(src.index, dst.index):
            raise RuntimeError(
                f"{src} cannot store into {dst} (no peer access): the striped fill's"
                " relay writes the next stripe's rows on its card and does not go"
                " through the host"
            )
    per_card: Dict[torch.device, int] = {}
    for dev, blocks in zip(devices, grids):
        per_card[dev] = per_card.get(dev, 0) + blocks
    for dev, blocks in per_card.items():
        if blocks > resident(dev):
            raise RuntimeError(
                f"the stripes on {dev} take {blocks} blocks, over the {resident(dev)} the"
                " card holds at once; a stripe spins on the one before it, so all must"
                " be resident (use fewer stripes on one card or a smaller pair)"
            )


def map_shards(fn, devices: Sequence[torch.device], shards: Sequence[Sequence]) -> Dict[int, Any]:
    """Run ``fn(devices[d], shards[d])`` for each non-empty shard of tasks.

    Each shard runs in a host thread of its own under ``device_scope``;
    ``fn`` returns one result per task of its shard. Returns the results by
    task id, whatever order the threads finish in.
    """

    def run(dev, shard):
        with device_scope(dev):
            return fn(dev, shard)

    by_id: Dict[int, Any] = {}
    with ThreadPoolExecutor(max_workers=max(1, len(shards))) as pool:
        futures = [(shard, pool.submit(run, dev, shard)) for dev, shard in zip(devices, shards) if shard]
        for shard, fut in futures:
            by_id.update(zip((t.task_id for t in shard), fut.result()))
    return by_id
