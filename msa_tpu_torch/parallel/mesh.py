"""The process's devices.

Counterpart of ``msa_tpu/parallel/mesh.py::get_mesh`` and
``jax.local_devices()``: the devices one process shards its device pairs
over (``models/kway.py``), its score-only fills (``parallel/engine.py``)
and a lone pair's stripes (``ops/nw_striped.py``), only ever its own.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Sequence

import torch

from msa_tpu_torch.config import TorchConfig


def local_devices(config: TorchConfig) -> List[torch.device]:
    """``cuda:0 .. count - 1``, at most ``config.local_devices`` of them (0: all).

    ``[cpu]`` when ``config.device`` is "cpu"; the one device
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
    return [torch.device("cuda", i) for i in range(min(count, config.local_devices or count))]


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
