"""Host spans around the program's module functions, in traced runs only.

As ``chip_smoke.py::stage_timers`` does, each stage is the program's own
function, replaced for the window by a wrapper that notes its start and end
(``time.perf_counter``) on the job that is running, from whichever thread
calls it (``trace.py`` places them on the trace's clock to tell what the
host was doing while the card was idle). The program is not edited; the
wrappers are taken out when the window closes.
"""

from __future__ import annotations

import contextlib
import importlib
import threading
import time
from typing import Dict, List, Tuple

STAGES: Dict[str, Tuple[str, str]] = {
    "plan": ("msa_tpu_torch.ops.batch", "plan_pairs"),
    "fill": ("msa_tpu_torch.ops.batch", "band_fill"),
    "walk": ("msa_tpu_torch.ops.batch", "walk"),
    "decode.moves": ("msa_tpu_torch.ops.batch", "pair_moves"),
    "decode.strings": ("msa_tpu_torch.ops.batch", "moves_to_alignment"),
    "pair_hash": ("msa_tpu_torch.models.kway", "pair_hash"),
    "chain": ("msa_tpu_torch.models.kway", "chain_hashes"),
}


class Spans:
    """The running job's spans: ``job.spans`` gets (stage, start, end, work),
    ``work`` being (DP cells, sequence bytes) of a fill launch's plan and
    None elsewhere."""

    def __init__(self) -> None:
        self.job = None
        self._lock = threading.Lock()

    def _wrap(self, stage: str, real):
        def call(*args, **kwargs):
            job = self.job
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            t1 = time.perf_counter()
            work = _plan_work(args[1]) if stage == "fill" else None
            with self._lock:
                job.spans.append((stage, t0, t1, work))
            return out

        return call

    @contextlib.contextmanager
    def installed(self):
        real: List[Tuple[object, str, object]] = []
        try:
            for stage, (module_name, attr) in STAGES.items():
                module = importlib.import_module(module_name)
                real.append((module, attr, getattr(module, attr)))
                setattr(module, attr, self._wrap(stage, getattr(module, attr)))
            yield self
        finally:
            for module, attr, fn in reversed(real):
                setattr(module, attr, fn)


def _plan_work(plan) -> Tuple[int, int]:
    from msa_tpu_torch.ops.band_fill import P_M, P_N

    m, n = plan.params[:, P_M], plan.params[:, P_N]
    return int((m * n).sum()), int((m + n).sum())
