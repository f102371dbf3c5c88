"""The port's harness (``msa_tpu_torch/scripts/``) and the pod goldens.

On the CPU at small sizes, tolerance 0 throughout (hashes and int32
penalties): the port's generator writes the JAX package script's bytes; the
port's ``align_kway`` on generated workloads (one in three or more waves)
equals the JAX package's numpy backend; ``goldens/pod.py`` equals it too
and resumes a cut derivation to the same JSON; the committed pod goldens
reproduce their workloads and their cheapest pairs; ``ab_compare`` and
``conformance`` gate on the hash and exit 1 on a mismatch; the planners keep
offsets past 2^31 exact, with no buffer allocated.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from msa_tpu.models.kway import align_kway as jax_align_kway
from msa_tpu.utils.msaio import Problem as JaxProblem
from msa_tpu_torch.config import TorchConfig
from msa_tpu_torch.goldens import pod
from msa_tpu_torch.models.kway import align_kway
from msa_tpu_torch.native import nw_score_native
from msa_tpu_torch.ops import band_fill as bf
from msa_tpu_torch.ops import batch
from msa_tpu_torch.ops import conveyor as cv
from msa_tpu_torch.ops import walk as wk
from msa_tpu_torch.scripts import ab_compare, conformance, gen_workload

REPO = Path(__file__).resolve().parents[1]
DISTS = ("uniform", "loguniform", "skew")
# Small band geometry: the kernels' plain versions step every lane of a band.
RB, SNAP_K = 255, 128


def _gen(k, dist, min_len=300, max_len=1500, seed=0):
    return gen_workload.make_problem(k=k, min_len=min_len, max_len=max_len, dist=dist, seed=seed)


def _jax(problem):
    res = jax_align_kway(JaxProblem(problem.pxy, problem.pgap, problem.genes), backend="numpy")
    return res.chain_hash, res.penalties


@pytest.mark.parametrize("dist", DISTS)
def test_gen_workload_writes_the_scripts_bytes(dist, capsys):
    args = ["--k", "12", "--min-len", "50", "--max-len", "3000", "--dist", dist, "--seed", "5"]
    want = subprocess.run([sys.executable, str(REPO / "scripts" / "gen_workload.py"), *args],
                          capture_output=True, check=True).stdout
    assert gen_workload.main(args) == 0
    assert capsys.readouterr().out.encode() == want
    buf = io.StringIO()
    gen_workload.write_problem(gen_workload.make_problem(12, 50, 3000, dist, 5), buf)
    assert buf.getvalue().encode() == want


@pytest.mark.parametrize("dist,waves", [("uniform", 1), ("loguniform", 3), ("skew", 1)])
def test_align_kway_equals_jax_on_generated_workloads(dist, waves, monkeypatch):
    problem = _gen(10, dist)
    cfg = TorchConfig(device="cpu", rb=RB, snap_k=SNAP_K)
    genes = problem.genes
    device = [(i, j) for i in range(1, 10) for j in range(i)
              if len(genes[i]) * len(genes[j]) >= cfg.host_threshold]
    assert device
    if waves > 1:
        sizes = batch.pair_bytes(bf.plan_pairs([len(g) for g in genes], device, RB, SNAP_K))
        cfg.hbm_budget = 2 * max(int(sizes.max()), int(sizes.sum()) // (waves + 1))
    seen = []
    real = batch.band_fill

    def spy(table, plan, pxy, pgap):
        seen.append(plan.num_pairs)
        return real(table, plan, pxy, pgap)

    monkeypatch.setattr(batch, "band_fill", spy)
    res = align_kway(problem, config=cfg)
    assert (res.chain_hash, res.penalties) == _jax(problem)
    assert sum(seen) == len(device) and len(seen) >= waves


def test_pod_golden_equals_jax_and_resumes(tmp_path):
    generator = {"k": 6, "min_len": 300, "max_len": 1500, "dist": "loguniform", "seed": 0,
                 "pxy": 3, "pgap": 2}
    whole = pod.derive(generator, str(tmp_path / "whole.jsonl"), workers=2, mem_bytes=1 << 30)
    problem = pod.problem_of(whole)
    assert (whole["chain_hash"], whole["penalties"]) == _jax(problem)
    assert whole["pairs"] == 15 and whole["k"] == 6 and whole["oracle"] == pod.ORACLE
    assert whole["cells"] == sum(len(problem.genes[i]) * len(problem.genes[j])
                                 for i in range(1, 6) for j in range(i))
    # A derivation cut after 5 pairs: its journal holds their 5 lines.
    cut = tmp_path / "cut.jsonl"
    cut.write_text("".join((tmp_path / "whole.jsonl").read_text().splitlines(True)[:5]))
    resumed = pod.derive(generator, str(cut), workers=2, mem_bytes=1 << 30)
    assert resumed["pairs_from_journal"] == 5
    volatile = ("seconds", "pairs_from_journal")
    assert {k: v for k, v in resumed.items() if k not in volatile} == \
        {k: v for k, v in whole.items() if k not in volatile}


@pytest.mark.parametrize("k", [64, 256])
def test_committed_pod_golden(k):
    golden = pod.load(k)
    assert golden["generator"] == dict(pod.DEFAULTS, k=k)
    assert golden["oracle"] == pod.ORACLE and golden["seconds"] > 0 and golden["cores"] >= 1
    problem = pod.problem_of(golden)
    genes = problem.genes
    tasks = [(i, j) for i in range(1, problem.k) for j in range(i)]
    assert golden["k"] == problem.k == k
    assert golden["pairs"] == len(tasks) == len(golden["penalties"]) == k * (k - 1) // 2
    assert golden["cells"] == sum(len(genes[i]) * len(genes[j]) for i, j in tasks)
    assert len(golden["chain_hash"]) == 128 and int(golden["chain_hash"], 16) >= 0
    cheapest = sorted(range(len(tasks)), key=lambda t: len(genes[tasks[t][0]]) * len(genes[tasks[t][1]]))
    for t in cheapest[:3]:
        i, j = tasks[t]
        assert nw_score_native(genes[i], genes[j], problem.pxy, problem.pgap) == golden["penalties"][t]


AB_GEN = "k=5,min_len=200,max_len=600"
# Every pair through the device pipeline's plain versions.
AB_CONFIGS = ["--config", "rb255:rb=255,snap_k=128,host_threshold=0",
              "--config", "rb511:rb=511,snap_k=128,host_threshold=0"]


def test_ab_compare_two_configs_one_hash(capsys):
    rc = ab_compare.main(["--gen", AB_GEN, "--platform", "cpu", "--reps", "2", *AB_CONFIGS])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    problem = _gen(5, "loguniform", 200, 600)
    assert summary["hash"] == _jax(problem)[0][:16]
    for name in ("rb255", "rb511"):
        assert len(summary[name]["reps"]) == 2
        assert summary[name]["best"] <= summary[name]["median"]
        assert summary[name]["gcups"] > 0


@pytest.mark.parametrize("fault", ["a_run_differs", "the_golden_differs"])
def test_ab_compare_exits_1_when_a_hash_differs(fault, tmp_path, monkeypatch, capsys):
    from msa_tpu_torch.models import kway

    argv = ["--gen", AB_GEN, "--platform", "cpu", "--reps", "1", *AB_CONFIGS]
    if fault == "a_run_differs":
        real, calls = kway.align_kway, []

        def drifting(*a, **kw):
            calls.append(1)
            res = real(*a, **kw)
            if len(calls) == 3:
                res.chain_hash = "0" * 128
            return res

        monkeypatch.setattr(kway, "align_kway", drifting)
    else:
        path = tmp_path / "pod5.json"
        path.write_text(json.dumps({"generator": ab_compare.parse_gen(AB_GEN),
                                    "chain_hash": "0" * 128, "penalties": None}))
        monkeypatch.setattr(pod, "golden_path", lambda k: str(path))
    assert ab_compare.main(argv) == 1


def test_ab_compare_rejects_an_unknown_field():
    with pytest.raises(ValueError, match="no field 'bogus'"):
        ab_compare.parse_config("a:bogus=1", TorchConfig())
    name, cfg = ab_compare.parse_config("b:rb=511,fill_mode=conveyor", TorchConfig())
    assert (name, cfg.rb, cfg.fill_mode) == ("b", 511, "conveyor")


@pytest.mark.parametrize("golden,rc", [("", 0), ("=deadbeefdeadbeef", 1)])
def test_conformance_on_the_cpu(golden, rc, tmp_path):
    out = tmp_path / "records.json"
    proc = subprocess.run(
        [sys.executable, "-m", "msa_tpu_torch.scripts.conformance", "--platform", "cpu",
         "--dataset", f"data/mseq.dat{golden}", "--dataset", "data/mseq1.dat", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == rc, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"rc": rc, "failures": rc}
    records = json.loads(out.read_text())
    assert [r["dataset"] for r in records] == ["data/mseq.dat", "data/mseq1.dat"]
    assert [r["ok"] for r in records] == [rc == 0, True]
    for r in records:
        assert len(r["warm_s"]) == 3 and r["warm_min_s"] == min(r["warm_s"])
        assert r["first_call_s"] == r["first_run_s"] and r["context_s"] is None


def test_golden_table_covers_the_six_datasets():
    table = conformance.golden_table()
    assert sorted(table) == sorted([*conformance.PUBLISHED, *conformance.CROSS_CHECK])
    assert all(len(g["chain_hash"]) >= 16 for g in table.values())
    big13 = table["data/mseq-big13-example.txt"]
    assert conformance.matches(big13, big13["chain_hash"], big13["penalties"])
    assert not conformance.matches(big13, big13["chain_hash"], big13["penalties"][::-1])
    assert not conformance.matches({"chain_hash": "602d", "penalties": None}, "602d" * 32, [])


def test_planner_offsets_past_2_31_are_exact():
    """pod256's plans (no buffers): every offset column equals the running
    sum of the sizes in Python integers, and runs past 2^31 elements."""
    problem = pod.problem_of({"generator": dict(pod.DEFAULTS)})
    genes = problem.genes
    lengths = [len(g) for g in genes]
    pairs = [(i, j) for i in range(1, problem.k) for j in range(i)]
    plan = bf.plan_pairs(lengths, pairs, 8191, 1024)
    assert plan.params.dtype == np.int64 and plan.snaps_len > 2**34
    snap_off = rows_off = 0
    for p, (m, n, _, _, nb, s, so, ro) in enumerate(plan.params.tolist()):
        assert (so, ro) == (snap_off, rows_off), p
        snap_off += nb * s * 3 * 8192
        rows_off += (nb - 1) * n
    assert (plan.snaps_len, plan.rows_len) == (snap_off, rows_off)
    sizes = batch.pair_bytes(plan)
    assert sizes.dtype == np.int64 and int(sizes.sum()) == sum(
        4 * (nb * s * 3 * 8192 + (nb - 1) * n + 1 + -(-(m + n) // 16) + 1)
        for m, n, _, _, nb, s, _, _ in plan.params.tolist())

    wplan = wk.banded_walk_plan(plan)
    assert wplan.pairs.dtype == np.int64 and wplan.bands.dtype == np.int64
    moves = 0
    for p, row in enumerate(wplan.pairs.tolist()):
        assert row[wk.W_MOVES_OFF] == moves
        moves += -(-(row[wk.W_M] + row[wk.W_N]) // 16)
    assert int(wplan.bands[:, 0].max()) > 2**31
    assert wplan.bands[:, 0].tolist() == [
        so + b * s * 3 * 8192 for _, _, _, _, nb, s, so, _ in plan.params.tolist() for b in range(nb)]

    wl = cv.plan_sweeps(genes, pairs, 7168, 1024, 100)
    assert wl.sweep_table.dtype == np.int64 and wl.snaps_len > 2**33
    end = 0
    for row in wl.sweep_table.tolist():
        assert row[cv.S_SNAP_OFF] == end
        end += (row[cv.S_CHUNKS] - row[cv.S_FIRST]) * 3 * 7169
    assert end == wl.snaps_len and int(wl.sweep_table[:, cv.S_SNAP_OFF].max()) > 2**31
    cplan = cv.conveyor_walk_plan(wl, genes, range(wl.num_pairs))
    assert cplan.bands.dtype == np.int64 and int(cplan.bands[:, 0].max()) > 2**31
    assert sorted(cplan.bands[:, 0].tolist()) == sorted(wl.snap_base(bp) for bp in wl.plan.bands)
