"""One run of one cell of the benchmark of msa_tpu_torch, on one card.

    python3 benchmark/run.py --workload speccap-closed1 --seed 7 --seconds 51 --trace 0

Set-up makes the cell's problems from the seed (``msabench/generate.py``),
builds the program's configuration (``TorchConfig(local_devices=<chips>)``,
defaults otherwise: the environment is not read) and runs the warm-up jobs,
which build and load the kernels. The window then runs one caller's jobs
back to back, ``align_kway(problem, backend="cuda", keep_alignments=True)``,
for ``--seconds`` (``msabench/window.py``). After it the plain reference
judges the answers (``msabench/judge.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, each read by ``metrics/<name>.py``),
``device``, with ``--trace 1`` a ``breakdown``, what was checked, and last
the numbers compared with their limits, which also end standard error.

Without a card, or with fewer cards than the cell names, it exits 2 and
prints no result; if a module of JAX or of the JAX package was loaded, 3.
``--platform cpu`` runs the kernels' plain versions on the CPU (tests only),
``--benchmark`` reads another ``BENCHMARK.json`` (tests only).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _path in (ROOT, HERE):
    if _path not in sys.path:
        sys.path.insert(0, _path)

from msabench import generate, imports, judge, spans, spec, trace, window  # noqa: E402


def card_info(index: int) -> dict:
    """The card's name, and its power limit as ``nvidia-smi`` gives it
    (``nvidia-smi`` ignores ``CUDA_VISIBLE_DEVICES`` and takes its index, UUID
    or bus id)."""
    import torch

    visible = [v.strip() for v in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")]
    card = visible[index] if index < len(visible) and visible[index] else str(index)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "-i", card, "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        limit = f"unknown ({exc.__class__.__name__})"
    return {"kind": torch.cuda.get_device_name(index), "power_limit": limit,
            "visible_cards": torch.cuda.device_count()}


def program_config(platform: str, chips: int):
    from msa_tpu_torch.config import TorchConfig

    if platform == "cpu":
        # Every pair through the plain versions of the device pipeline, at
        # a band height the CPU runs in seconds.
        return TorchConfig(local_devices=chips, device="cpu", host_threshold=0, rb=255,
                           snap_k=128), "auto"
    return TorchConfig(local_devices=chips), "cuda"


def breakdown(tr: trace.Trace) -> dict:
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(tr.kernel_s), "idle_gaps": top(tr.idle_by)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--benchmark", default=os.path.join(ROOT, "BENCHMARK.json"))
    args = ap.parse_args(argv)
    t_start = T0 if argv is None else time.perf_counter()

    cell = spec.cell(args.benchmark, args.workload)
    import torch

    if args.platform == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees"
                  f" {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    device = torch.device("cuda", 0) if args.platform == "cuda" else torch.device("cpu")
    warm, pool = generate.problems(cell.config, cell.traffic, args.seed)
    if cell.traffic["callers"] != 1:
        raise ValueError("only a closed loop of one caller is implemented")

    import msa_tpu_torch

    config, backend = program_config(args.platform, cell.chips)
    warm_inputs = [msa_tpu_torch.parse_input(p.text()) for p in warm]
    inputs = [msa_tpu_torch.parse_input(p.text()) for p in pool]

    def call(problem):
        return msa_tpu_torch.align_kway(problem, backend=backend, keep_alignments=True,
                                        config=config)

    for problem in warm_inputs:
        call(problem)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    every = cell.traffic["keep_every"]
    places = generate.kept_places(args.seed, every)

    def keep(n: int) -> bool:
        return n // every >= len(places) or n % every == places[n // every]

    tr = None
    if args.trace:
        recorder = spans.Spans()
        with trace.profiled() as prof, recorder.installed():
            jobs, window_s = window.closed_loop(call, inputs, args.seconds, keep, recorder)
        tr = trace.read(prof, jobs)
    else:
        jobs, window_s = window.closed_loop(call, inputs, args.seconds, keep)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    run = window.Run(setup_s=setup_s, window_s=window_s, jobs=jobs,
                     cells=sum(pool[j.problem].cells() for j in jobs if j.error is None),
                     peak_bytes=peak, card=torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu", trace=tr)
    metrics = {}
    for m in cell.per_layer if args.trace else cell.end_to_end:
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    del inputs, warm_inputs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    correct, compared, checked = judge.judge(jobs, pool, cell.config, args.seed, device)
    checked["judge_s"] = time.perf_counter() - t_judge
    print(f"setup {setup_s:.2f} s, window {window_s:.2f} s, {len(jobs)} jobs,"
          f" judge {checked['judge_s']:.2f} s", file=sys.stderr)
    quarters = [jobs[q * len(jobs) // 4:(q + 1) * len(jobs) // 4] for q in range(4)]
    print("mean job ms by quarter of the window:",
          [round(sum(j.seconds for j in q) / len(q) * 1e3, 1) for q in quarters if q],
          file=sys.stderr)

    bad = imports.found()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "count": cell.chips,
           "memory_peak_bytes": peak}
    dev.update(card_info(0) if device.type == "cuda" else {"kind": "cpu"})
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    result = {"correct": correct, "attempted": len(jobs),
              "failed": sum(j.error is not None for j in jobs), "metrics": metrics,
              "device": dev}
    if tr is not None:
        result["breakdown"] = breakdown(tr)
    result["checked"] = checked
    result["compared"] = {k: {"value": v, "limit": judge.LIMITS[k]} for k, v in compared.items()}
    for k, v in compared.items():
        print(f"compared {k} {v} limit {judge.LIMITS[k]}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
