"""A cell of ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix or metric is a file
of its own, found by name: a configuration by its ``file`` entry (relative
to ``BENCHMARK.json``), a traffic mix as ``traffic/<name>.json`` and a metric
as ``metrics/<name>.py`` beside this package. A metric file defines
``read(run)``, which returns the metric's value or None when the run has
nothing to read for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _named(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; known: {[e['name'] for e in entries]}")


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(bench_path: str, workload: str) -> Cell:
    with open(bench_path) as f:
        bench = json.load(f)
    wl = _named(bench["workloads"], workload, "workload")
    entry = _named(bench["configs"], wl["config"], "configuration")
    with open(os.path.join(os.path.dirname(os.path.abspath(bench_path)), entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", wl["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(
        name=workload, chips=int(wl["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def reader(name: str) -> Callable[[object], Optional[float]]:
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("msabench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
