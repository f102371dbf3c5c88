"""Tables, and a plot where matplotlib imports, of ``sweep.py``'s records.

The port's counterpart of ``scripts/plot_bench.py``: reads the JSON lines
of ``sweep.py`` (``bench_sweep.jsonl`` by default) and prints the e2e grid
as a table, then the band ladder's GCUPS by band height beside the
reference's sequential and 12-node baselines (BASELINE.md). Where
matplotlib imports it also writes the ladder's plot beside the records
(``<records>.png``); where it does not, the table is the output::

    python -m msa_tpu_torch.scripts.plot_bench [bench_sweep.jsonl]
"""

from __future__ import annotations

import json
import os
import sys

BASELINE_SEQ_GCUPS = 0.208  # testing15/sample.txt, 1 core
BASELINE_CLUSTER_GCUPS = 17.77  # 12 nodes x 16 cores


def main(path: str = "bench_sweep.jsonl") -> int:
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    if not records:
        print("no records")
        return 1

    e2e = [r for r in records if r.get("kernel") == "e2e"]
    if e2e:
        print(f"{'fill':>9} {'snapK':>6} {'rb':>5} {'segs':>5} {'conv':>5} "
              f"{'best':>8} {'vs cluster':>11}")
        for r in e2e:
            print(f"{r['fill_mode']:>9} {r['snap_k']:>6} {r['rb']:>5} {r['fill_segments']:>5} "
                  f"{r['conveyors']:>5} {r['gcups_best']:>8.1f} "
                  f"{r['gcups_best'] / BASELINE_CLUSTER_GCUPS:>10.1f}x")
    ladder = [r for r in records if r.get("kernel") == "band_score"]
    if not ladder:
        return 0
    print(f"{'rb':>8} {'GCUPS':>8} {'vs 1-core':>10} {'vs cluster':>11}")
    for r in ladder:
        print(f"{r['rb']:>8} {r['gcups']:>8.1f} {r['gcups'] / BASELINE_SEQ_GCUPS:>9.0f}x "
              f"{r['gcups'] / BASELINE_CLUSTER_GCUPS:>10.1f}x")
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return 0
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot([r["rb"] for r in ladder], [r["gcups"] for r in ladder], "o-",
            label="msa_tpu_torch (1 card)")
    ax.axhline(BASELINE_CLUSTER_GCUPS, ls="--", c="gray", label="reference 12-node cluster")
    ax.set_xscale("log", base=2)
    ax.set_xlabel("band height rb")
    ax.set_ylabel("GCUPS")
    ax.legend()
    fig.tight_layout()
    png = os.path.splitext(path)[0] + ".png"
    fig.savefig(png, dpi=120)
    print(f"wrote {png}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(*sys.argv[1:]))
