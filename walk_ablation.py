"""What parts of the walk kernel's design pay, on one NVIDIA card.

    python3 walk_ablation.py

Builds variants of ``msa_tpu_torch/csrc/walk.cu`` into
``msa_tpu_torch/build/ablation/`` and times each on big13's walk (the
banded fill's layout at the default rb and snap_k) by CUDA events, in turns
(each variant, then the variants again in reverse):

- ``retire``: the kernel as it is, lane retirement on;
- ``no_retire``: built with ``-DWALK_RETIRE=0``: every thread runs the
  recurrence on every step, also on the lanes no cell of the walk depends
  on;
- ``cells8``: built with ``-DWALK_CELLS=8``: 8 lanes a thread, one warp on
  each of the SM's four schedulers at snap_k 1,024, 16-bit granules;
- ``moves_twice``: thread 0 follows each segment's moves twice, once
  without emitting them: the difference to ``retire`` is what the longest
  pair's chain of moves costs, and the rest of ``retire`` its recomputes.

Every variant's move words and counts must equal ``retire``'s. ``chip_smoke.py``
runs ``ablate`` as one of its phases; run alone, the script fills big13
itself. Prints the card's name and power limit, ptxas's registers and
spills for each variant, one JSON line per timing and a summary line last.
Needs the repository around it and a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

WALK_START = "      int qq = a;         // window lane of the current cell\n"
DRY_WALK = """\
      {  // the same moves, not emitted; the sum keeps the loop (the count
         // it may write is written again at the end)
        int qq = a, t = steps - 1;
        unsigned int sum = 0;
        while (w0 + qq >= 1 && t >= 0 && dl0 + t + 1 - w0 - qq > 0) {
          const unsigned int g = cone[cone_row<N>(steps - 1 - t) + ka - qq / N];
          const unsigned int mv = (g >> (2 * (qq % N))) & 3;
          sum += mv + 1;
          qq -= mv <= 2;
          t -= 1 + (mv <= 1);
        }
        if (sum == 1u) counts[blockIdx.x] = -1;
      }
"""
VARIANTS = {
    # name: (source patches, extra nvcc flags)
    "retire": ([], []),
    "no_retire": ([], ["-DWALK_RETIRE=0"]),
    "cells8": ([], ["-DWALK_CELLS=8"]),
    "moves_twice": ([(WALK_START, DRY_WALK + WALK_START)], []),
}
TURNS = ["retire", "no_retire", "cells8", "moves_twice",
         "moves_twice", "cells8", "no_retire", "retire"]


def build_variants():
    """Compile every variant at once; {name: (library, ptxas lines)}."""
    from msa_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, "walk.cu")) as f:
        source = f.read()
    nvcc = _build.nvcc_path()
    procs = {}
    for name, (patches, flags) in VARIANTS.items():
        src = source
        for old, new in patches:
            if src.count(old) != 1:
                raise AssertionError(f"{name}: the patch anchor {old!r} is not in the source once")
            src = src.replace(old, new)
        out_dir = os.path.join(_build.BUILD, "ablation", f"walk_{name}")
        os.makedirs(out_dir, exist_ok=True)
        cu = os.path.join(out_dir, "walk.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, "libwalk.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-I", _build.CSRC, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for walk variant {name}:\n{log}")
        handle = ctypes.CDLL(lib)
        handle.walk.argtypes = _build.SIGNATURES["walk"]
        handle.walk.restype = ctypes.c_int
        built[name] = (handle, [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln])
    return built


def ablate(table, wplan, rows, snaps, pxy, pgap, smi, emit):
    """Time each variant on one walk, in TURNS; returns {variant: [ms, ...]}.

    ``emit(name, **fields)`` prints a line. The wrapper launches whatever
    library is loaded under its name; the kernel's own library is put back
    after.
    """
    import torch

    from chip_smoke import cuda_ms
    from msa_tpu_torch.ops import _build
    from msa_tpu_torch.ops import walk as wk

    built = build_variants()
    for name, (_, ptxas) in built.items():
        emit("walk_ablation_build", variant=name, ptxas=ptxas)
    real = _build.load("walk")
    times = {name: [] for name in VARIANTS}
    want = None
    try:
        for name in TURNS:
            _build._LIBS["walk"] = built[name][0]
            holder = {}

            def run():
                holder["out"] = wk.walk(table, wplan, rows, snaps, pxy, pgap)

            ms = cuda_ms(run, reps=2)
            got = holder.pop("out")
            if want is None:
                want = got
            elif not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"walk variant {name} differs from {TURNS[0]}")
            times[name].append(ms)
            emit("walk_ablation", variant=name, ms=ms, card=smi)
    finally:
        _build._LIBS["walk"] = real
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("walk_ablation: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import BIG13_PENALTIES, phase
    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.ops import band_fill as bf
    from msa_tpu_torch.ops import walk as wk
    from msa_tpu_torch.utils.msaio import parse_file

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    problem = parse_file("data/mseq-big13-example.txt")
    genes = problem.genes
    pairs = [(i, j) for i in range(1, len(genes)) for j in range(i)]
    cfg = TorchConfig()
    plan = bf.plan_pairs([len(g) for g in genes], pairs, cfg.rb, cfg.snap_k)
    table = torch.from_numpy(bf.gene_table(genes)).cuda()
    fill = bf.band_fill(table, plan, problem.pxy, problem.pgap)
    if fill.score.tolist() != BIG13_PENALTIES:
        raise AssertionError("big13 scores differ from the golden penalties")
    times = ablate(table, wk.banded_walk_plan(plan), fill.rows, fill.snaps, problem.pxy,
                   problem.pgap, smi, phase)
    print(json.dumps({"big13_walk_ms": times, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
