"""The port's schedule, cost model, multi-device split and multi-process engine.

On the CPU, against the JAX package: ``schedule_for`` and
``sharded_pair_scores`` must equal ``msa_tpu.parallel``'s as task-id lists
and int scores; the snapshots-off fill must give the scores of the full fill
and of ``nw_score_pallas`` (interpret mode); the device split and the
two-process CLI (gloo on 127.0.0.1) must reproduce the mseq1 golden. Also
the journal repair (pairs journaled as they decode) and the kernel build's
race between processes. Tolerance 0 throughout.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from msa_tpu.ops.reference import nw_score_numpy
from msa_tpu.parallel import schedule as jax_schedule
from msa_tpu.parallel.costmodel import CalibratedCost as JaxCalibratedCost
from msa_tpu.utils.msaio import Problem, parse_file
from msa_tpu.utils.tasks import pair_task_list
from msa_tpu_torch.config import TorchConfig
from msa_tpu_torch.models import kway
from msa_tpu_torch.ops import band_fill as bf
from msa_tpu_torch.ops import batch
from msa_tpu_torch.ops import conveyor as conv
from msa_tpu_torch.parallel import costmodel, engine, mesh, schedule
from tests.test_torch_slice import MSEQ1_HASH, MSEQ1_PENALTIES

REPO = pathlib.Path(__file__).resolve().parent.parent
ALPHA = list("ACGT")
CPU = torch.device("cpu")


def _genes(seed, lengths):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(ALPHA, n)) for n in lengths]


def _ids(shards):
    return [[t.task_id for t in shard] for shard in shards]


# -- schedule and cost model ---------------------------------------------------


@pytest.mark.parametrize("policy", ["lpt", "calibrated", "block"])
@pytest.mark.parametrize("num_shards", [2, 5])
def test_schedule_for_matches_jax(policy, num_shards):
    rng = np.random.default_rng(num_shards)
    genes = _genes(7, [int(n) for n in rng.integers(5, 3000, 9)]) + ["ACGT"] * 2
    port_model = costmodel.CalibratedCost(gcups=4.2, fixed_us=850.0)
    jax_model = JaxCalibratedCost(gcups=4.2, fixed_us=850.0)
    got = schedule.schedule_for(genes, num_shards, policy=policy, cost_model=port_model)
    want = jax_schedule.schedule_for(genes, num_shards, policy=policy, cost_model=jax_model)
    assert _ids(got) == _ids(want)
    assert sorted(sum(_ids(got), [])) == list(range(len(genes) * (len(genes) - 1) // 2))


def test_calibration_cache_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    name = "NVIDIA H100 80GB HBM3"
    assert costmodel.load_cached_calibration(name, 20000, 2048) is None
    model = costmodel.CalibratedCost(gcups=4.1, fixed_us=1250.0)
    costmodel.save_calibration(name, 20000, 2048, model)
    assert costmodel.load_cached_calibration(name, 20000, 2048) == model
    assert (tmp_path / "msa_tpu_torch" / "calibration.json").exists()
    key = costmodel._cache_key(name, 20000, 2048)
    assert name in key and costmodel.kernel_version() in key
    # Another card, another probe size, or an edited kernel: no entry.
    assert costmodel.load_cached_calibration("NVIDIA H200", 20000, 2048) is None
    assert costmodel.load_cached_calibration(name, 20000, 4096) is None
    monkeypatch.setattr(costmodel, "kernel_version", lambda: "edited")
    assert costmodel.load_cached_calibration(name, 20000, 2048) is None


def test_kernel_version_is_the_fill_sources_digest():
    from msa_tpu_torch.ops import _build

    assert costmodel.kernel_version() == _build._digest("band_fill") != _build._digest("walk")


def test_calibrate_needs_a_card(monkeypatch):
    assert costmodel.calibrate(device=CPU) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert costmodel.calibrate() is None


# -- snapshots-off fill ----------------------------------------------------------


@pytest.mark.parametrize("m,n,rb", [(300, 250, 128), (180, 410, 128), (260, 90, 100)])
def test_snapshots_off_scores(m, n, rb):
    from msa_tpu.ops.pallas_nw import nw_score_pallas

    genes = _genes(m + n, [m, n])
    pairs = [(0, 1), (1, 0)]
    lengths = [m, n]
    table = torch.from_numpy(bf.gene_table(genes))
    off = bf.plan_pairs(lengths, pairs, rb, 64, snaps=False)
    on = bf.plan_pairs(lengths, pairs, rb, 64)
    assert off.snaps_len == 0 and on.snaps_len > 0
    assert (off.params[:, bf.P_S] == 0).all()
    got, full = bf.band_fill(table, off, 3, 2), bf.band_fill(table, on, 3, 2)
    assert got.snaps.numel() == 0
    assert torch.equal(got.score, full.score)
    assert torch.equal(got.rows, full.rows)
    want = [nw_score_pallas(genes[i], genes[j], 3, 2, rb=128, interpret=True, unroll=1)
            for i, j in pairs]
    assert got.score.tolist() == want == [nw_score_numpy(genes[i], genes[j], 3, 2) for i, j in pairs]
    assert bf.nw_score(genes, pairs, 3, 2, device=CPU, rb=rb).tolist() == want


# -- sharded scores and the device split -----------------------------------------


def test_sharded_pair_scores_match_jax(monkeypatch):
    from msa_tpu.parallel.engine import sharded_pair_scores as jax_sharded_pair_scores
    from msa_tpu.parallel.mesh import get_mesh

    monkeypatch.setattr(mesh, "local_devices", lambda config: [CPU] * 3)
    # The genes of test_parallel.py:41-55, then a seeded set.
    for genes in [("AGGGCT", "AGGCA", "AAAGGGCT", "ACGTACGT", "TTTT", "GATTACA"),
                  tuple(_genes(19, [90, 130, 17, 200, 64]))]:
        got = engine.sharded_pair_scores(genes, 3, 2, config=TorchConfig(rb=48, device="cpu"))
        want = jax_sharded_pair_scores(genes, 3, 2, mesh=get_mesh())
        oracle = [nw_score_numpy(genes[t.i], genes[t.j], 3, 2) for t in pair_task_list(len(genes))]
        assert got.dtype == np.int64
        assert got.tolist() == np.asarray(want).tolist() == oracle


@pytest.fixture
def shards_seen(monkeypatch):
    """Records the pairs of every pipeline call (batched or conveyor)."""
    seen = []
    for module, name in ((batch, "align_pairs_batched"), (conv, "align_pairs_conveyor")):
        real = getattr(module, name)

        def spy(genes, pairs, *a, _real=real, **kw):
            seen.append(list(pairs))
            return _real(genes, pairs, *a, **kw)

        monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.parametrize("fill_mode", ["banded", "conveyor"])
def test_multi_device_split(monkeypatch, shards_seen, data_dir, fill_mode):
    problem = parse_file(str(data_dir / "mseq1.dat"))
    genes = problem.genes
    cfg = TorchConfig(rb=16, snap_k=8, rb_conveyor=16, host_threshold=0, device="cpu",
                      fill_mode=fill_mode)
    one = kway.align_kway(problem, config=cfg)
    assert len(shards_seen) == 1
    shards_seen.clear()
    monkeypatch.setattr(mesh, "local_devices", lambda config: [CPU] * 3)
    three = kway.align_kway(problem, config=cfg)
    assert (three.chain_hash, three.penalties) == (MSEQ1_HASH, MSEQ1_PENALTIES)
    assert (one.chain_hash, one.penalties) == (three.chain_hash, three.penalties)
    costs = [(t, len(genes[t.i]) * len(genes[t.j])) for t in pair_task_list(len(genes))]
    want = [[(t.i, t.j) for t in shard] for shard in jax_schedule.lpt_schedule(costs, 3)]
    assert sorted(shards_seen) == sorted(want)


def test_run_batched_keeps_input_order(monkeypatch):
    """Shards that finish in reverse order still come back in task order."""
    def slow_first(genes, pairs, pxy, pgap, *, device, rb, snap_k, on_result=None, config=None,
                   job=None):
        time.sleep(0.3 if (1, 0) in pairs else 0.0)
        out = [(10 * i + j, f"{i}", f"{j}") for i, j in pairs]
        for idx, triple in enumerate(out):
            on_result(idx, triple)
        return out

    monkeypatch.setattr(batch, "align_pairs_batched", slow_first)
    monkeypatch.setattr(mesh, "local_devices", lambda config: [CPU] * 4)
    genes = ["A" * n for n in (5, 9, 13, 17, 21, 25)]
    cfg = TorchConfig(host_threshold=0, device="cpu", fill_mode="banded")
    aligner = kway.KWayAligner(3, 2, config=cfg)
    tasks = pair_task_list(len(genes))
    fired = []
    got = aligner._run_batched(genes, tasks, lambda t, triple: fired.append(t.task_id))
    assert got == [(10 * t.i + t.j, f"{t.i}", f"{t.j}") for t in tasks]
    assert sorted(fired) == [t.task_id for t in tasks]


def test_local_devices(monkeypatch):
    assert mesh.local_devices(TorchConfig(device="cpu")) == [CPU]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mesh.local_devices(TorchConfig(device="cpu")) == [CPU]
    with pytest.raises(RuntimeError, match="--platform cpu"):
        mesh.local_devices(TorchConfig())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert mesh.local_devices(TorchConfig()) == cards
    assert mesh.local_devices(TorchConfig(local_devices=2)) == cards[:2]
    assert mesh.local_devices(TorchConfig(device="cuda")) == cards
    assert mesh.local_devices(TorchConfig(device="cuda:3")) == [cards[3]]


# -- the journal repair ---------------------------------------------------------


def _journal_workload(fill_mode):
    """Four genes, six pairs, and a config that runs them in several walk
    launches: the conveyor in four fill segments, the banded pipeline in
    waves under a forced budget."""
    genes = _genes(23, [260, 190, 230, 150])
    pairs = [(i, j) for i in range(1, 4) for j in range(i)]
    sizes = batch.pair_bytes(bf.plan_pairs([len(g) for g in genes], pairs, 64, 32))
    cfg = TorchConfig(rb=64, rb_conveyor=64, snap_k=32, host_threshold=0, device="cpu",
                      fill_mode=fill_mode, fill_segments=4,
                      hbm_budget=2 * max(int(sizes.max()), int(sizes.sum()) // 4))
    return Problem(pxy=3, pgap=2, genes=tuple(genes)), cfg


def _journal(path):
    with open(path) as f:
        return {rec["task_id"]: (rec["penalty"], rec["hash"]) for rec in map(json.loads, f)}


@pytest.mark.parametrize("fill_mode", ["conveyor", "banded"])
def test_journal_keeps_pairs_decoded_before_a_failed_walk(tmp_path, monkeypatch, fill_mode):
    problem, cfg = _journal_workload(fill_mode)
    module = conv if fill_mode == "conveyor" else batch
    real_walk = module.walk
    walked = []

    def counting(table, plan, *a):
        walked.append(plan.num_pairs)
        return real_walk(table, plan, *a)

    monkeypatch.setattr(module, "walk", counting)
    clean = kway.KWayAligner(3, 2, config=cfg).align_tasks(
        problem.genes, pair_task_list(problem.k), checkpoint=str(tmp_path / "clean.jsonl"))
    launches, counts = len(walked), list(walked)
    assert launches >= (2 if fill_mode == "conveyor" else 3)
    assert sum(counts) == problem.num_pairs

    def failing_last(table, plan, *a):
        walked.append(plan.num_pairs)
        if len(walked) == launches:
            raise RuntimeError("walk launch failed")
        return real_walk(table, plan, *a)

    walked.clear()
    monkeypatch.setattr(module, "walk", failing_last)
    path = str(tmp_path / "journal.jsonl")
    with pytest.raises(RuntimeError, match="walk launch failed"):
        kway.align_kway(problem, config=cfg, checkpoint=path)
    kept = _journal(path)
    assert len(kept) == sum(counts[:-1]) > 0
    by_id = {r.task_id: (r.penalty, r.problem_hash) for r in clean}
    assert all(by_id[tid] == rec for tid, rec in kept.items())

    # The resumed run aligns only the rest and folds the uninterrupted chain.
    walked.clear()
    monkeypatch.setattr(module, "walk", counting)
    resumed = kway.align_kway(problem, config=cfg, checkpoint=path)
    assert sum(walked) == problem.num_pairs - len(kept)
    want = kway.align_kway(problem, config=cfg)
    assert (resumed.chain_hash, resumed.penalties) == (want.chain_hash, want.penalties)
    assert len(_journal(path)) == problem.num_pairs


def test_conveyor_split_fires_each_pair_once():
    """Over the device-memory budget the halves report with caller indices."""
    genes = _genes(7, [300, 250, 200, 150])
    pairs = [(i, j) for i in range(1, 4) for j in range(i)]
    full = conv.plan_sweeps(genes, pairs, 64, 32, conveyors=1).snapshot_bytes
    cfg = TorchConfig(rb_conveyor=64, snap_k=32, conveyors=1, hbm_budget=int(full * 0.8))
    fired = []
    got = conv.align_pairs_conveyor(genes, pairs, 3, 2, device=CPU, config=cfg,
                                    on_result=lambda idx, triple: fired.append((idx, triple)))
    assert sorted(fired) == list(enumerate(got))


# -- the CLI: one process, two processes ----------------------------------------


def test_cli_batched_single_process(data_dir, capsys):
    from msa_tpu_torch.cli import main

    assert main(["--batched", "--platform", "cpu", "--input", str(data_dir / "mseq1.dat")]) == 0
    lines = capsys.readouterr().out.split("\n")
    assert lines[1] == MSEQ1_HASH
    assert lines[2] == "".join(f"{p} " for p in MSEQ1_PENALTIES)


def test_cli_profile_dir_writes_a_trace(data_dir, tmp_path, capsys, monkeypatch):
    from msa_tpu_torch.cli import main

    monkeypatch.setenv("MSA_TPU_TORCH_HOST_THRESHOLD", "0")
    monkeypatch.setenv("MSA_TPU_TORCH_RB", "16")
    monkeypatch.setenv("MSA_TPU_TORCH_SNAP_K", "8")
    monkeypatch.setenv("MSA_TPU_TORCH_FILL_MODE", "banded")
    assert main(["--batched", "--platform", "cpu", "--profile-dir", str(tmp_path),
                 "--input", str(data_dir / "mseq.dat")]) == 0
    assert capsys.readouterr().out.split("\n")[2] == "5 4 9 "
    traces = list(tmp_path.glob("trace-*.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]


def test_cli_bad_coordinator_exits_nonzero(data_dir):
    out = subprocess.run(
        [sys.executable, "-m", "msa_tpu_torch.cli", "--distributed", "--coordinator", "nohost",
         "--num-processes", "2", "--process-id", "0", "--input", str(data_dir / "mseq.dat")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and "HOST:PORT" in out.stderr and out.stdout == ""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(backend="numpy", extra_args=(), extra_env=None):
    """Two ``msa_tpu_torch.cli --distributed`` processes on mseq1; (stdout, stderr) each."""
    port = _free_port()
    env = dict(os.environ, MSA_TPU_TORCH_LOG="INFO", **(extra_env or {}))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "msa_tpu_torch.cli", "--distributed",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(pid), "--platform", "cpu", "--backend", backend,
             "--input", str(REPO / "data" / "mseq1.dat"), *extra_args],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        outs.append((out, err))
    return outs


def _shard_logs(outs):
    logs = []
    for _, err in outs:
        line = next(ln for ln in err.splitlines() if "msa_tpu_torch.engine: shard " in ln)
        logs.append(json.loads(line.split("shard ", 1)[1]))
    return logs


def _assert_golden(outs):
    lines = outs[0][0].split("\n")
    assert lines[0].startswith("Time: ") and lines[0].endswith(" us")
    assert lines[1] == MSEQ1_HASH
    assert lines[2] == "".join(f"{p} " for p in MSEQ1_PENALTIES)
    assert outs[1][0] == ""  # process 1 prints nothing


def test_two_process_golden_mseq1():
    outs = _launch()
    _assert_golden(outs)
    logs = _shard_logs(outs)
    assert [log["process"] for log in logs] == [0, 1]
    assert sum(log["pairs"] for log in logs) == 36
    # The default policy is "calibrated"; with no card it falls back to lpt.
    assert {log["policy"] for log in logs} == {"lpt"}


@pytest.mark.parametrize("fill_mode", ["banded", "conveyor"])
def test_two_process_device_pipeline_golden(fill_mode):
    """Each process's shard through fill + walk (plain versions, small geometry)."""
    outs = _launch(backend="auto", extra_env={
        "MSA_TPU_TORCH_HOST_THRESHOLD": "0", "MSA_TPU_TORCH_FILL_MODE": fill_mode,
        "MSA_TPU_TORCH_RB": "16", "MSA_TPU_TORCH_SNAP_K": "8", "MSA_TPU_TORCH_RB_CONVEYOR": "16",
    })
    _assert_golden(outs)


def test_two_process_checkpoint_journals(tmp_path):
    outs = _launch(extra_args=["--checkpoint", str(tmp_path / "j-{proc}.jsonl")])
    _assert_golden(outs)
    seen = {}
    for pid in (0, 1):
        for tid in _journal(tmp_path / f"j-{pid}.jsonl"):
            assert tid not in seen, "task journaled by both processes"
            seen[tid] = pid
    assert sorted(seen) == list(range(36))
    assert {pid for pid in seen.values()} == {0, 1}


# -- the kernel build across processes ------------------------------------------


def test_build_in_two_processes_at_once(tmp_path):
    """A fake nvcc writes its -o file and lingers; both builds must install it."""
    lib = REPO / "msa_tpu" / "native" / "libmsanative.so"  # any loadable library
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'while [ "$#" -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        f'cp "{lib}" "$out"\n'
        "sleep 2\n"
    )
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    code = (
        "import ctypes\n"
        "from msa_tpu_torch.ops import _build\n"
        f"_build.BUILD = {str(build)!r}\n"
        "_build.build_all(['band_fill'])\n"
        "ctypes.CDLL(_build._lib_path('band_fill'))\n"
    )
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    procs = [
        subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                         stderr=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    for p in procs:
        _, err = p.communicate(timeout=60)
        assert p.returncode == 0, err[-2000:]
    assert [f.name for f in build.iterdir()] == [pathlib.Path(_lib_name()).name]


def _lib_name():
    from msa_tpu_torch.ops import _build

    return _build._lib_path("band_fill")
