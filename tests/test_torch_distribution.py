"""Pair distribution across processes and cards, and the ported harness scripts.

On the CPU, tolerance 0 throughout: the process-to-card rule as a table
(``parallel/mesh.py``); ``device_budget`` divided among a card's processes
so that their shares add up to at most 75 % of the card in any order of
reading; four ``--distributed --platform cpu`` processes on a generated
k = 64 workload, golden against the JAX package's ``align_kway`` (native
backend), journals disjoint, local ranks 0-3; ``schedule_compare`` against
``msa_tpu.parallel.schedule.schedule_for`` and the JAX artifact's keys;
``scaling_curve``'s sections against the JAX package; ``sweep``'s ladder
against the native score, its e2e grid gated; ``plot_bench``'s table.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from msa_tpu.models.kway import align_kway as jax_align_kway
from msa_tpu.native.lib import nw_score_native
from msa_tpu.parallel import schedule as jax_schedule
from msa_tpu.parallel.costmodel import CalibratedCost as JaxCalibratedCost
from msa_tpu.utils.msaio import Problem as JaxProblem
from msa_tpu.utils.msaio import parse_file as jax_parse_file
from msa_tpu_torch.config import TorchConfig
from msa_tpu_torch.models import pairwise
from msa_tpu_torch.ops import band_fill as bf
from msa_tpu_torch.parallel import costmodel, engine, mesh
from msa_tpu_torch.scripts import gen_workload, plot_bench, scaling_curve, schedule_compare, sweep
from tests.test_torch_engine import _free_port
from tests.test_torch_slice import MSEQ1_PENALTIES

REPO = Path(__file__).resolve().parents[1]
GIB = 1 << 30


@pytest.fixture
def host(monkeypatch):
    """A host of ``cards`` cards on which this process is ``local_rank`` of
    ``local_count`` processes of a process group."""

    def place(local_rank, local_count, cards):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(mesh, "_host_place", None)
        mesh.set_host_place(local_rank, local_count)

    return place


# -- the process-to-card rule (F4) -----------------------------------------------

RULE = {
    # (local processes, cards): each local rank's cards
    (1, 4): [[0, 1, 2, 3]],
    (2, 4): [[0, 2], [1, 3]],
    (3, 8): [[0, 3, 6], [1, 4, 7], [2, 5]],
    (4, 4): [[0], [1], [2], [3]],
    (4, 2): [[0], [1], [0], [1]],
    (3, 2): [[0], [1], [0]],
    (4, 1): [[0], [0], [0], [0]],
}


@pytest.mark.parametrize("local_count, cards", sorted(RULE))
def test_card_rule_table(host, local_count, cards):
    want = RULE[(local_count, cards)]
    for rank in range(local_count):
        assert mesh.card_rule(rank, local_count, cards) == want[rank]
        host(rank, local_count, cards)
        assert mesh.local_devices(TorchConfig()) == [torch.device("cuda", c) for c in want[rank]]
        # The pipeline runs on the process's first card, never the bare "cuda".
        assert pairwise.pipeline_device("auto", TorchConfig()) == torch.device("cuda", want[rank][0])
        assert pairwise.pipeline_device("cuda", TorchConfig(device="cuda")) == torch.device(
            "cuda", want[rank][0])
    for card in range(cards):
        bound = sum(card in cards_of for cards_of in want)
        assert mesh.card_sharers(card, local_count, cards) == bound
        assert mesh.processes_on(torch.device("cuda", card)) == bound


def test_named_device_and_cap_win_over_the_rule(host):
    host(1, 2, 4)
    assert mesh.local_devices(TorchConfig(device="cuda:2")) == [torch.device("cuda", 2)]
    assert mesh.local_devices(TorchConfig(device="cpu")) == [torch.device("cpu")]
    assert mesh.local_devices(TorchConfig(local_devices=1)) == [torch.device("cuda", 1)]
    assert mesh.local_devices(TorchConfig(local_devices=5)) == [
        torch.device("cuda", 1), torch.device("cuda", 3)]
    assert pairwise.pipeline_device("cuda", TorchConfig(device="cuda:2")) == torch.device("cuda", 2)


def test_outside_a_process_group_every_card(monkeypatch, host):
    host(1, 2, 4)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    assert mesh.host_place() is None
    assert mesh.local_devices(TorchConfig()) == [torch.device("cuda", i) for i in range(4)]
    assert mesh.processes_on(torch.device("cuda", 0)) == 1


def test_host_place_rejects_a_rank_outside_the_host():
    with pytest.raises(ValueError, match="local rank"):
        mesh.set_host_place(4, 4)


@pytest.mark.parametrize("env", [{}, {"LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "3"}])
def test_init_distributed_learns_the_local_place(monkeypatch, env):
    """One gloo process: its place from the gathered host names, or from the
    torchrun variables when they are set."""
    for key in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(mesh, "_host_place", None)
    engine.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        assert mesh.host_place() == ((2, 3) if env else (0, 1))
    finally:
        dist.destroy_process_group()
    assert mesh.host_place() is None


# -- the device budget among a card's processes (F5) --------------------------------


class Card:
    """One 80 GiB card shared by processes, each holding its tensors and its
    allocator's cache; each process's context takes 0.5 GiB."""

    total = 80 * GIB

    def __init__(self, processes):
        self.allocated = [0] * processes
        self.reserved = [0] * processes
        self.current = 0

    def free(self):
        return self.total - sum(self.reserved) - len(self.reserved) * GIB // 2

    def patch(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (self.free(), self.total))
        monkeypatch.setattr(torch.cuda, "memory_allocated",
                            lambda device=None: self.allocated[self.current])
        monkeypatch.setattr(torch.cuda, "memory_reserved",
                            lambda device=None: self.reserved[self.current])


@pytest.mark.parametrize("order", list(itertools.permutations(range(4)))[::5])
def test_shares_of_one_card_add_up_to_75_percent_in_any_order(monkeypatch, host, order):
    host(0, 4, 1)
    card = Card(4)
    card.patch(monkeypatch)
    for rounds in range(3):
        for p in order:
            card.current = p
            budget = bf.device_budget(torch.device("cuda", 0))
            assert budget <= 0.75 * card.total / 4 - card.allocated[p]
            # The process takes its whole budget, and its cache grows with it.
            card.allocated[p] += budget
            card.reserved[p] = max(card.reserved[p], card.allocated[p])
    assert sum(card.allocated) <= 0.75 * card.total


def test_budget_is_a_quarter_of_the_card_for_four_processes(monkeypatch, host):
    host(3, 4, 1)
    card = Card(4)
    card.patch(monkeypatch)
    card.current = 3
    assert bf.device_budget(torch.device("cuda", 0)) == int(0.75 * card.total / 4)
    card.allocated[3] = card.reserved[3] = 5 * GIB
    assert bf.device_budget(torch.device("cuda", 0)) == int(0.75 * card.total / 4) - 5 * GIB
    # Little free memory caps it at 75 % of what the process can still allocate.
    card.reserved[0] = 70 * GIB
    assert bf.device_budget(torch.device("cuda", 0)) == int(0.75 * card.free())
    # An explicit budget is already one process's.
    assert bf.device_budget(torch.device("cuda", 0), 12345) == 12345


def test_own_cards_keep_the_whole_budget(monkeypatch, host):
    host(1, 4, 4)
    card = Card(1)
    card.patch(monkeypatch)
    assert bf.device_budget(torch.device("cuda", 1)) == int(0.75 * card.free())


# -- four processes on the CPU (F4 end to end) -----------------------------------------


def test_four_processes_on_a_k64_workload(tmp_path):
    """``gen_workload --k 64`` of short sequences through four ``--distributed``
    processes; the pairs over 10,000 cells take the device pipeline's plain
    versions at a small band geometry."""
    problem = gen_workload.make_problem(k=64, min_len=20, max_len=160, seed=0)
    path = tmp_path / "k64.dat"
    with open(path, "w") as f:
        gen_workload.write_problem(problem, f)
    want = jax_align_kway(JaxProblem(problem.pxy, problem.pgap, problem.genes), backend="native")
    port = _free_port()
    env = dict(os.environ, MSA_TPU_TORCH_LOG="INFO", MSA_TPU_TORCH_HOST_THRESHOLD="10000",
               MSA_TPU_TORCH_RB="32", MSA_TPU_TORCH_SNAP_K="16")
    for key in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(key, None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "msa_tpu_torch.cli", "--distributed", "--platform", "cpu",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "4", "--process-id", str(p),
             "--input", str(path), "--checkpoint", str(tmp_path / "j-{proc}.jsonl")],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p in range(4)
    ]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lines = outs[0][0].split("\n")
    assert lines[1] == want.chain_hash
    assert lines[2] == "".join(f"{v} " for v in want.penalties)
    assert all(out == "" for out, _ in outs[1:])
    logs = [json.loads(next(ln for ln in err.splitlines() if "engine: shard " in ln)
                       .split("shard ", 1)[1]) for _, err in outs]
    assert [log["local_rank"] for log in logs] == [0, 1, 2, 3]
    assert {log["local_processes"] for log in logs} == {4}
    assert all(log["cards"] == ["cpu"] for log in logs)
    assert all(log["device_pairs"] >= 1 for log in logs)
    owner = {}
    for p in range(4):
        with open(tmp_path / f"j-{p}.jsonl") as f:
            for rec in map(json.loads, f):
                assert rec["task_id"] not in owner, "task journaled twice"
                owner[rec["task_id"]] = p
    assert sorted(owner) == list(range(problem.num_pairs))
    assert sorted(log["pairs"] for log in logs) == sorted(
        list(owner.values()).count(p) for p in range(4))


# -- schedule_compare ---------------------------------------------------------------

ARTIFACT = REPO / "artifacts" / "schedule_compare_r5.json"


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    return None


@pytest.mark.parametrize("nproc", [3, 5])
def test_schedule_compare_shards_equal_jax(monkeypatch, tmp_path, capsys, nproc):
    model = costmodel.CalibratedCost(gcups=50.0, fixed_us=1500.0)
    monkeypatch.setattr(costmodel, "calibrate", lambda: model)
    seen = []
    real = schedule_compare.run_shards

    def spy(aligner, genes, shards, *a):
        seen.append([[t.task_id for t in s] for s in shards])
        return real(aligner, genes, shards, *a)

    monkeypatch.setattr(schedule_compare, "run_shards", spy)
    out = tmp_path / "compare.json"
    rc = schedule_compare.main(["--dataset", str(REPO / "data" / "mseq1.dat"), "--platform", "cpu",
                                "--nproc", str(nproc), "--reps", "1", "--out", str(out)])
    assert rc == 0
    genes = jax_parse_file(str(REPO / "data" / "mseq1.dat")).genes
    jax_model = JaxCalibratedCost(gcups=model.gcups, fixed_us=model.fixed_us)
    want = [[[t.task_id for t in s] for s in jax_schedule.schedule_for(
        genes, nproc, policy=p, cost_model=jax_model if p == "calibrated" else None)]
        for p in ("lpt", "calibrated")]
    assert seen == want
    record = json.loads(out.read_text())
    assert _keys(record) == _keys(json.loads(ARTIFACT.read_text()))
    assert record["policies"]["lpt"]["shard_pairs"] == [len(s) for s in want[0]]
    printed = capsys.readouterr().out
    assert json.loads(printed.strip().splitlines()[-1])["golden"] is True
    assert "lpt shard 0: " in printed and " predicted " in printed


def test_schedule_compare_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(costmodel, "calibrate", lambda: None)
    assert schedule_compare.main(["--dataset", str(REPO / "data" / "mseq.dat"), "--platform",
                                  "cpu", "--out", str(tmp_path / "x.json")]) == 1
    assert not (tmp_path / "x.json").exists()


# -- scaling_curve ------------------------------------------------------------------


@pytest.mark.parametrize("pod_k", [64, 256])
def test_scaling_balance_equals_the_jax_scripts(pod_k):
    """Section (b), recomputed as ``scripts/scaling_curve.py`` does it."""
    rng = np.random.default_rng(2)
    lens = np.exp(rng.uniform(np.log(1000), np.log(30000), size=pod_k)).astype(int)
    genes = ["A" * int(n) for n in lens]
    costs = {t.task_id: c for t, c in jax_schedule.pair_costs(genes)}
    want = []
    for nd in (2, 4, 8, 16, 32):
        for policy in ("lpt", "block"):
            loads = [sum(costs[t.task_id] for t in s)
                     for s in jax_schedule.schedule_for(genes, nd, policy=policy)]
            want.append((policy, nd, round(max(loads) / (sum(loads) / nd), 4)))
    got = [(r["policy"], r["shards"], r["imbalance"]) for r in scaling_curve.schedule_balance(pod_k)]
    assert got == want


def test_scaling_scores_over_devices_equal_jax():
    from msa_tpu.parallel.engine import sharded_pair_scores as jax_sharded_pair_scores
    from msa_tpu.parallel.mesh import get_mesh

    genes = scaling_curve.random_genes(7, 40, 120)
    records, scores = scaling_curve.sharded_scores(genes, "cpu", 4, reps=1)
    want = np.asarray(jax_sharded_pair_scores(genes, 3, 2, mesh=get_mesh())).tolist()
    assert sorted(scores) == [1, 2, 4]
    assert all(s.tolist() == want for s in scores.values())
    assert [r["devices"] for r in records] == [1, 2, 4]
    assert records[0]["scaling_efficiency"] == 1.0


def test_scaling_e2e_over_local_devices_is_golden():
    records = scaling_curve.e2e_local_devices("cpu", [1, 3])
    assert [r["hash_ok"] for r in records] == [True, True]
    assert [len(r["device_names"]) for r in records] == [1, 3]
    assert {r["pairs"] for r in records} == {len(MSEQ1_PENALTIES)}


# -- sweep and plot_bench -------------------------------------------------------------


def test_sweep_ladder_scores_equal_native(tmp_path):
    out = tmp_path / "sweep.jsonl"
    assert sweep.main(["--m", "700", "--n", "560", "--rbs", "31,127,255", "--reps", "1",
                       "--platform", "cpu", "--out", str(out)]) == 0
    x, y = sweep.pair(700, 560)
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["rb"] for r in records] == [31, 127, 255]
    assert {r["score"] for r in records} == {nw_score_native(x, y, 3, 2)}


def test_sweep_e2e_grid_is_gated(tmp_path, capsys):
    out = tmp_path / "grid.jsonl"
    rc = sweep.main(["--e2e", "--dataset", "data/mseq1.dat", "--platform", "cpu", "--reps", "1",
                     "--fill-modes", "banded,conveyor", "--snap-ks", "8", "--rbs", "16",
                     "--out", str(out)])
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert rc == 0, records
    assert [(r["fill_mode"], r["rb_conveyor"], r["rcs"]) for r in records] == [
        ("banded", 8184, [0]), ("conveyor", 8184, [0])]
    assert all(r["gcups_best"] > 0 for r in records)


def test_plot_bench_prints_the_tables(tmp_path, capsys):
    path = tmp_path / "bench.jsonl"
    records = [
        {"kernel": "e2e", "fill_mode": "banded", "snap_k": 1024, "rb": 8191, "fill_segments": 4,
         "conveyors": 0, "gcups_best": 812.5},
        {"kernel": "band_score", "rb": 1023, "gcups": 101.2},
        {"kernel": "band_score", "rb": 8191, "gcups": 88.0},
    ]
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    assert plot_bench.main(str(path)) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["fill", "snapK", "rb", "segs", "conv", "best", "vs", "cluster"]
    assert lines[1].split()[:6] == ["banded", "1024", "8191", "4", "0", "812.5"]
    assert lines[2].split()[:2] == ["rb", "GCUPS"]
    assert lines[3].split()[:3] == ["1023", "101.2", "487x"]
    assert lines[4].split()[:2] == ["8191", "88.0"]
