"""What each part of the redesigned banded fill pays, on one NVIDIA card.

    python3 fill_ablation.py

Builds variants of ``msa_tpu_torch/csrc/band_fill.cu``, each the source with
one part taken back out, and times each on big13's banded fill (rb 8191,
snapshots on) by CUDA events, in turns (base, variants, variants reversed,
base):

- ``base``: the kernel as it is;
- ``no_pipelining``: a band waits for its producer's whole bottom row
  before its first step, so a pair's bands run one after another (on
  whichever SMs take them), as in the one-block-per-pair fill before; the
  difference to ``base`` is what the pipelining pays;
- ``no_dpx``: ``min(p2s + sub, t2)`` written as plain min and add, not the
  DPX ``__viaddmin_s32``;
- ``chunk_256``: the base binary with 256-step chunks (waits, staging and
  snapshots' boundaries four times as often; a band trails its producer by
  rb + 256 steps, not rb + 1024);
- ``relay_always``: the main path through the instance with the relay of a
  striped lone pair (``ops/nw_striped.py``; its two tests, once an item and
  once a chunk, never true there); the difference to ``base`` is what
  making the relay a template flag saves.

Each variant also fills the main geometry's pair (20,000 x 17,000, the
seed of ``chip_smoke.py``) at rb 1023, 20 bands, against the base's output.

Every variant's scores must equal the golden penalties. Prints the card's
name and power limit, ptxas's registers and spills and SASS counts for each
variant, one JSON line per timing, and a summary line last. Needs the
repository around it and a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

BASE_NEED = "const int need = min(n, c1);"
BASE_CELL = "b[c] = __viaddmin_s32(dg, x[c] == y[c] ? 0 : pxy, t2);"
BASE_RELAY_ON = "const bool relay_on = relay_out >= 0 || relay_in >= 0;"
# (file in csrc/, anchor, replacement) of each variant.
PATCHES = {
    "base": [],
    "no_pipelining": [("band_fill.cu", BASE_NEED, "const int need = n;")],
    "no_dpx": [("common.cuh", BASE_CELL, "b[c] = min(dg + (x[c] == y[c] ? 0 : pxy), t2);")],
    "relay_always": [("band_fill.cu", BASE_RELAY_ON, "const bool relay_on = true;")],
}


def build(name, patches):
    """Compile one variant into build/ablation/<name>/; (library, ptxas and SASS lines)."""
    from msa_tpu_torch.ops import _build

    out_dir = os.path.join(_build.BUILD, "ablation", name)
    os.makedirs(out_dir, exist_ok=True)
    # A patched header in out_dir shadows the one in csrc/ (-I).
    for fname in {"band_fill.cu"} | {f for f, _, _ in patches}:
        with open(os.path.join(_build.CSRC, fname)) as f:
            src = f.read()
        for file, old, new in patches:
            if file != fname:
                continue
            if src.count(old) != 1:
                raise AssertionError(f"{name}: the patch anchor {old!r} is not in {fname} once")
            src = src.replace(old, new)
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(src)
    cu = os.path.join(out_dir, "band_fill.cu")
    lib = os.path.join(out_dir, "libband_fill.so")
    nvcc = _build.nvcc_path()
    log = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", lib, cu],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         check=True).stdout
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    info = {"ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln],
            "sass": {op: sass.count(op) for op in ("VIADDMNMX", "IMNMX", "LDL", "STL", "BAR.SYNC")}}
    handle = ctypes.CDLL(lib)
    handle.band_fill.argtypes = _build.SIGNATURES["band_fill"]
    handle.band_fill.restype = ctypes.c_int
    return handle, info


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fill_ablation: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from chip_smoke import BIG13_PENALTIES, cuda_ms, random_genes
    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.ops import _build
    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.utils.msaio import parse_file

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = {}
    for name, patches in PATCHES.items():
        libs[name], info = build(name, patches)
        print(json.dumps({"variant": name, **info}), flush=True)

    problem = parse_file("data/mseq-big13-example.txt")
    genes = problem.genes
    pairs = [(i, j) for i in range(1, len(genes)) for j in range(i)]
    cfg = TorchConfig()
    plan = bf.plan_pairs([len(g) for g in genes], pairs, cfg.rb, cfg.snap_k)
    runs = {"base": plan, "no_pipelining": plan, "no_dpx": plan, "relay_always": plan,
            "chunk_256": bf.Plan(plan.params, plan.rb, plan.snap_k, plan.rows_len,
                                 plan.snaps_len, plan.items, 256)}
    table = torch.from_numpy(bf.gene_table(genes)).cuda()
    rng = np.random.default_rng(2024)
    random_genes(rng, [2600, 3400, 4100])
    main_geom = random_genes(rng, [20000, 17000])  # chip_smoke.py's main geometry
    plan20 = bf.plan_pairs([20000, 17000], [(0, 1)], 1023, cfg.snap_k)
    table20 = torch.from_numpy(bf.gene_table(main_geom)).cuda()
    want20 = None
    order = ["base", "no_pipelining", "no_dpx", "chunk_256", "relay_always"]
    times = {name: [] for name in order}
    for name in order + order[::-1]:
        # The wrapper launches whatever library is loaded under its name.
        _build._LIBS["band_fill"] = libs[name if name in libs else "base"]
        holder = {}

        def fill():
            holder["out"] = bf.band_fill(table, runs[name], problem.pxy, problem.pgap)

        ms = cuda_ms(fill, reps=2)
        if holder["out"].score.tolist() != BIG13_PENALTIES:
            raise AssertionError(f"{name}: big13 scores differ from the golden penalties")
        del holder["out"]
        times[name].append(ms)

        def fill20():
            holder["out"] = bf.band_fill(table20, plan20, problem.pxy, problem.pgap)

        ms20 = cuda_ms(fill20, reps=3)
        got20 = holder.pop("out")
        want20 = got20 if want20 is None else want20
        if not all(torch.equal(a, b) for a, b in zip(
                (got20.score, got20.rows, got20.snaps), (want20.score, want20.rows, want20.snaps))):
            raise AssertionError(f"{name}: the 20-band fill differs from the base's")
        print(json.dumps({"variant": name, "big13_fill_ms": ms, "blocks": bf.band_fill.blocks,
                          "twenty_bands_fill_ms": ms20, "card": smi}), flush=True)
    print(json.dumps({"big13_fill_ms": times, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
