"""The generator: shapes, cell counts and seeds of each configuration."""

import json
import os

import numpy as np
import pytest

from msabench import generate, spec
from reference import tasks

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
TRAFFIC = {"warmup_jobs": 1, "pool": 2}


def config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


# The reference's headline shape (data/mseq-big13-example.txt), for a later cell.
BIG13 = {"name": "big13", "k": 13, "lengths": list(range(90_000, 29_999, -5_000))}


@pytest.mark.parametrize("name, k, cells", [
    ("big13", 13, 278_525_000_000),  # 2.785e11, the bundled big13's shape
    ("speccap", 2, 10_035_200_000),  # 1.0035e10
])
def test_shapes_and_cells(name, k, cells):
    c = BIG13 if name == "big13" else config(name)
    sizes = generate.lengths(c)
    assert len(sizes) == k and tasks.cells(sizes) == cells
    assert sizes == {"big13": list(range(90_000, 29_999, -5_000)),
                     "speccap": [100_352, 100_000]}[name]
    assert c.get("cells_per_job", cells) == cells


def test_problems_follow_the_seed_and_keep_the_sizes():
    c = dict(config("speccap"), lengths=[300, 200, 100], k=3)
    warm, pool = generate.problems(c, TRAFFIC, 7)
    again = generate.problems(c, TRAFFIC, 7)
    other = generate.problems(c, TRAFFIC, 8)
    assert (warm, pool) == again
    assert pool != other[1]
    everyone = warm + pool + other[0] + other[1]
    assert all([len(g) for g in p.genes] == [300, 200, 100] for p in everyone)
    assert len({p.genes for p in everyone}) == len(everyone)
    assert all(set("".join(p.genes)) <= set("ACGT") for p in everyone)
    assert pool[0].text().split("\n")[:3] == ["3", "2", "3"]


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3, -1, 2**70])
def test_any_whole_seed(seed):
    c = dict(config("speccap"), lengths=[50, 40])
    assert generate.problems(c, TRAFFIC, seed) == generate.problems(c, TRAFFIC, seed)


def test_drawn_lengths_are_the_same_for_every_run_seed():
    c = {"name": "pod", "k": 8, "min_len": 100, "max_len": 400, "dist": "loguniform",
         "lengths_seed": 0, "alphabet": "ACGT", "pxy": 3, "pgap": 2}
    sizes = generate.lengths(c)
    rng = np.random.default_rng(0)
    assert sizes == np.exp(rng.uniform(np.log(100), np.log(401), size=8)).astype(np.int64).tolist()
    for seed in (1, 2):
        assert [len(g) for g in generate.problems(c, TRAFFIC, seed)[1][0].genes] == sizes


def test_kept_places_one_a_block():
    places = generate.kept_places(5, 16, blocks=100)
    assert places.tolist() == generate.kept_places(5, 16, blocks=100).tolist()
    assert places.min() >= 0 and places.max() < 16


with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    WORKLOADS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_benchmark_cells_resolve(workload):
    cell = spec.cell(os.path.join(ROOT, "BENCHMARK.json"), workload)
    assert cell.chips == 1 and cell.traffic["callers"] == 1
    assert {m["name"] for m in cell.end_to_end} == {"gcups", "job_p90_ms", "setup_s"}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
