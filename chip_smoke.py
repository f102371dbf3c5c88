"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits nonzero:

1. setup: CUDA, nvcc, the card's name and power limit; build both kernels
   from ``msa_tpu_torch/csrc`` (one nvcc per source, in parallel);
2. the fill kernel against ``band_fill_ref`` on the card, on three pairs of
   2,000-5,000 characters at rb = 1023 (several bands, several snapshots a
   band) and on one pair at the main path's geometry (rb = 8191, 3 bands):
   score, bottom rows and every snapshot entry that is a DP cell must be
   equal as int32;
3. the walk kernel against ``walk_ref`` on the same fill output: move words
   and counts equal, alignments equal to the native host oracle;
4. big13 end to end through ``msa_tpu_torch.cli`` with ``--backend cuda``:
   the full golden chain hash and all 78 penalties, both kernels launched,
   all 78 pairs on the device, twice; each kernel alone on big13; then
   mseq1, which stays on the host, and the other bundled datasets (permuted
   big13, and the two xulin sets against their recorded host-oracle
   goldens in data/host_goldens.jsonl, skewed pairs included);
5. one JSON line of the kernels' launches, errors and times, then the last
   line ``{"ok": true, "device": {...}}``.

It needs the repository around it and a CUDA device, and exits nonzero
without either.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time

# Golden output of the reference for data/mseq-big13-example.txt
# (the same values gate bench.py).
BIG13_HASH = "c0befee8737ac74a1ece5abae5cca722c2eaf2bf028aaca8f3f6607204b7e68ea0707a881d5512a723439ab67007e5301a9c126272a3ff2ad96923b0dcf27dab"
BIG13_PENALTIES = [int(v) for v in """31202 48016 25007 56880 53193 37279 52116 30000 32754 48092 60756 61018 60977 48923 33238 66240 50320 59270 40544 49432 35042 78083 68543 50000 49163 48080 20000 44441 86911 70000 67514 57881 40000 46264 26560 27675 95621 87344 76149 60000 62871 53120 38797 41672 27581 104197 94673 80000 75191 65682 56240 51869 42800 40810 29031 112962 100000 90000 83981 74245 64669 54941 45332 35586 33228 33143 120000 110000 102209 92694 80000 75951 60000 57329 40000 38890 30859 15323 """.split()]
MSEQ1_HASH_PREFIX = "4d676f40ea4c1e6b"
BIG13_2_HASH_PREFIX = "7af9b197a65577f9"  # BASELINE.md, permuted big13


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card, by CUDA events, after a warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def random_genes(rng, lengths):
    return ["".join(rng.choice(list("ACGT"), n)) for n in lengths]


def check_case(name, genes, pairs, rb, snap_k, pxy=3, pgap=2):
    """Fill and walk kernels against their plain versions on one workload."""
    import numpy as np
    import torch

    from msa_tpu.native import nw_align_native
    from msa_tpu.utils.alignment import moves_to_alignment
    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.ops import walk as wk
    from msa_tpu_torch.state import valid_snapshot_cells

    plan = bf.plan_pairs([len(g) for g in genes], pairs, rb, snap_k)
    table = torch.from_numpy(bf.gene_table(genes)).cuda()

    fill = bf.band_fill(table, plan, pxy, pgap)
    ref, fill_plain_ms = host_ms(lambda: bf.band_fill_ref(table, plan, pxy, pgap))
    fill_ms = cuda_ms(lambda: bf.band_fill(table, plan, pxy, pgap), reps=3)
    valid = torch.from_numpy(
        np.concatenate([valid_snapshot_cells(plan, p).reshape(-1)
                        for p in range(plan.num_pairs)])
    ).cuda()
    fill_err = max(
        (fill.score - ref.score).abs().max().item(),
        (fill.rows - ref.rows).abs().max().item(),
        (fill.snaps - ref.snaps)[valid].abs().max().item(),
    )
    if fill_err != 0:
        raise AssertionError(f"{name}: fill kernel differs from band_fill_ref by {fill_err}")
    phase("fill_vs_plain", case=name, pairs=plan.num_pairs, rb=rb, snap_k=snap_k,
          bands=[int(b) for b in plan.params[:, 4]],
          snapshots_per_band=[int(s) for s in plan.params[:, 5]],
          max_abs_err=fill_err, all_entries_equal=torch.equal(fill.snaps, ref.snaps),
          ms=fill_ms, plain_ms=fill_plain_ms)

    words, counts = wk.walk(table, plan, fill, pxy, pgap)
    (rwords, rcounts), walk_plain_ms = host_ms(lambda: wk.walk_ref(table, plan, fill, pxy, pgap))
    walk_ms = cuda_ms(lambda: wk.walk(table, plan, fill, pxy, pgap), reps=3)
    walk_err = max((words - rwords).abs().max().item(), (counts - rcounts).abs().max().item())
    if walk_err != 0:
        raise AssertionError(f"{name}: walk kernel differs from walk_ref by {walk_err}")
    words, counts, scores = words.cpu().numpy(), counts.cpu().numpy(), fill.score.cpu().numpy()
    for p, (i, j) in enumerate(pairs):
        off = int(plan.params[p, bf.P_MOVES_OFF])
        moves = wk.decode_moves(words[None, off:], counts[p:p + 1])
        got = (int(scores[p]), *moves_to_alignment(genes[i], genes[j], moves))
        if got != nw_align_native(genes[i], genes[j], pxy, pgap):
            raise AssertionError(f"{name}: pair {p} alignment differs from the host oracle")
    phase("walk_vs_plain", case=name, moves=[int(c) for c in counts],
          max_abs_err=walk_err, alignments="equal to nw_align_native",
          ms=walk_ms, plain_ms=walk_plain_ms)
    return {"fill": (fill_err, fill_ms, fill_plain_ms), "walk": (walk_err, walk_ms, walk_plain_ms)}


def run_cli(args):
    from msa_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(args)
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {args} returned {rc}")
    return buf.getvalue().split("\n"), seconds


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from msa_tpu.utils.msaio import parse_file
    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.ops import _build
    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.ops import walk as wk

    # 1. setup
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    phase("setup", torch=torch.__version__, cuda=torch.version.cuda,
          nvcc=_build.nvcc_path(), card=smi, build_seconds=build_s,
          ptxas=[line.strip() for log in logs.values() for line in log.splitlines()
                 if "registers" in line or "spill" in line])
    _build.load("band_fill")
    _build.load("walk")

    # 2-3. kernels against their plain versions
    rng = np.random.default_rng(2024)
    small = random_genes(rng, [2600, 3400, 4100])
    check_case("small", small, [(1, 0), (2, 0), (2, 1)], rb=1023, snap_k=1024)
    main_geom = random_genes(rng, [20000, 17000])
    cfg = TorchConfig()
    timed = check_case("main_geometry", main_geom, [(0, 1)], rb=cfg.rb, snap_k=cfg.snap_k)

    # 4. big13 end to end on the card
    problem = parse_file("data/mseq-big13-example.txt")
    genes = problem.genes
    cells = sum(len(genes[i]) * len(genes[j]) for i in range(len(genes)) for j in range(i))
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        for counted in (bf.band_fill, wk.walk):
            counted.launches = 0
            counted.pairs = 0
        lines, seconds = run_cli(
            ["--backend", "cuda", "--input", "data/mseq-big13-example.txt"]
        )
        launches = {"band_fill": bf.band_fill.launches, "walk": wk.walk.launches}
        device_pairs = {"band_fill": bf.band_fill.pairs, "walk": wk.walk.pairs}
        if lines[1] != BIG13_HASH:
            raise AssertionError(f"big13 hash {lines[1]} is not the golden hash")
        if lines[2].split() != [str(p) for p in BIG13_PENALTIES]:
            raise AssertionError("big13 penalties differ from the golden penalties")
        if min(launches.values()) < 1 or set(device_pairs.values()) != {78}:
            raise AssertionError(f"big13 did not run on the kernels: {launches} {device_pairs}")
        runs.append(seconds)
    plan = bf.plan_pairs(
        [len(g) for g in genes],
        [(i, j) for i in range(1, len(genes)) for j in range(i)], cfg.rb, cfg.snap_k,
    )
    phase("big13_e2e", hash=lines[1], penalties=len(BIG13_PENALTIES), seconds=runs,
          gcups=[cells / t / 1e9 for t in runs], cells=cells, launches=launches,
          device_pairs=device_pairs, snapshot_bytes=plan.snapshot_bytes,
          peak_device_bytes=torch.cuda.max_memory_allocated(), card=smi)

    # Where the end-to-end time goes: each kernel alone on big13, by events.
    table = torch.from_numpy(bf.gene_table(genes)).cuda()
    holder = {}

    def fill_once():
        holder["fill"] = bf.band_fill(table, plan, problem.pxy, problem.pgap)

    fill_ms = cuda_ms(fill_once, reps=1)
    walk_ms = cuda_ms(lambda: wk.walk(table, plan, holder["fill"], problem.pxy, problem.pgap), reps=1)
    phase("big13_kernels", fill_ms=fill_ms, walk_ms=walk_ms,
          fill_gcups=cells / fill_ms / 1e6,
          rest_of_e2e_ms=min(runs) * 1e3 - fill_ms - walk_ms, card=smi)

    lines, seconds = run_cli(["--backend", "cuda", "--input", "data/mseq1.dat"])
    if not lines[1].startswith(MSEQ1_HASH_PREFIX):
        raise AssertionError(f"mseq1 hash {lines[1]} is not the golden hash")
    phase("mseq1_host", hash_prefix=lines[1][:16], seconds=seconds)

    with open("data/host_goldens.jsonl") as f:
        goldens = [json.loads(line) for line in f]
    goldens.append({"dataset": "data/mseq-big13-example2.txt",
                    "chain_hash": BIG13_2_HASH_PREFIX, "penalties": None})
    for gold in goldens:
        bf.band_fill.pairs = 0
        lines, seconds = run_cli(["--backend", "cuda", "--input", gold["dataset"]])
        if not lines[1].startswith(gold["chain_hash"]):
            raise AssertionError(f"{gold['dataset']}: hash {lines[1]} is not the golden hash")
        if gold["penalties"] is not None and lines[2].split() != [str(p) for p in gold["penalties"]]:
            raise AssertionError(f"{gold['dataset']}: penalties differ from the golden")
        phase("conformance", dataset=gold["dataset"], hash_prefix=lines[1][:16],
              device_pairs=bf.band_fill.pairs, seconds=seconds)

    # 5. summary
    sources = {
        "band_fill": ("msa_tpu_torch/csrc/band_fill.cu", "msa_tpu/ops/pallas_nw.py:79"),
        "walk": ("msa_tpu_torch/csrc/walk.cu", "msa_tpu/ops/pallas_walk.py:80"),
    }
    kernels = []
    for name, key in (("band_fill", "fill"), ("walk", "walk")):
        err, ms, plain_ms = timed[key]
        kernels.append({"name": name, "route": "cuda", "source": sources[name][0],
                        "replaces": sources[name][1], "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
