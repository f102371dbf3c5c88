"""Golden conformance of the bundled datasets, with the first call recorded apart.

The port's counterpart of ``scripts/tpu_conformance.py`` and
``scripts/warm_latency.py``. Each dataset runs in a fresh process, which
records two things apart:

- the **first call**: the CUDA context, the kernels' load (built first if
  they are not) and the first ``align_kway`` run, each timed;
- the **warm runs**: three more runs in the same process, each timed, and
  their minimum.

Every run is gated on the dataset's golden (``golden_table``): the
reference's published chain hash for the four golden datasets (the full
hash and penalties where this repo records them), and the recorded host
oracle's hash and penalties (``data/host_goldens.jsonl``) for the two
cross-checked ones. Any mismatch, or a run that fails, makes the exit code 1.
On the card unless ``--platform cpu`` is given::

    python -m msa_tpu_torch.scripts.conformance
    python -m msa_tpu_torch.scripts.conformance --platform cpu \
        --dataset data/mseq.dat --dataset data/mseq1.dat

``--dataset PATH=HASH`` gates PATH on HASH (a prefix of 16 hex characters
or more) instead of its recorded golden. The last line of the output is
``{"rc": N, "failures": F}``; ``--out FILE`` also writes every record as
JSON.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The reference's published outputs (BASELINE.md); big13's in full.
BIG13_HASH = ("c0befee8737ac74a1ece5abae5cca722c2eaf2bf028aaca8f3f6607204b7e68e"
              "a0707a881d5512a723439ab67007e5301a9c126272a3ff2ad96923b0dcf27dab")
BIG13_PENALTIES = [int(v) for v in """31202 48016 25007 56880 53193 37279 52116 30000 32754 48092
60756 61018 60977 48923 33238 66240 50320 59270 40544 49432 35042 78083 68543 50000 49163 48080
20000 44441 86911 70000 67514 57881 40000 46264 26560 27675 95621 87344 76149 60000 62871 53120
38797 41672 27581 104197 94673 80000 75191 65682 56240 51869 42800 40810 29031 112962 100000
90000 83981 74245 64669 54941 45332 35586 33228 33143 120000 110000 102209 92694 80000 75951
60000 57329 40000 38890 30859 15323""".split()]
PUBLISHED = {
    "data/mseq.dat": {"chain_hash": "602d0f604e8fb908", "penalties": [5, 4, 9]},
    "data/mseq1.dat": {"chain_hash": "4d676f40ea4c1e6b", "penalties": None},
    "data/mseq-big13-example.txt": {"chain_hash": BIG13_HASH, "penalties": BIG13_PENALTIES},
    "data/mseq-big13-example2.txt": {"chain_hash": "7af9b197a65577f9", "penalties": None},
}
# No published output: the host oracle's, recorded once with the dataset's sha256.
HOST_GOLDENS = "data/host_goldens.jsonl"
CROSS_CHECK = ("data/xulin_test.txt", "data/xulin_adversarial.dat")
WARM_RUNS = 3
TIMEOUT_S = 900  # a dataset's process, first call and warm runs


def golden_table() -> Dict[str, Dict]:
    """{dataset: {"chain_hash", "penalties", "source"}} of the six bundled
    datasets. A recorded host golden whose sha256 is not its file's raises."""
    table = {path: dict(g, source="published") for path, g in PUBLISHED.items()}
    with open(os.path.join(REPO, HOST_GOLDENS)) as f:
        recorded = {rec["dataset"]: rec for rec in map(json.loads, f)}
    for path in CROSS_CHECK:
        rec = recorded[path]
        with open(os.path.join(REPO, path), "rb") as df:
            if hashlib.sha256(df.read()).hexdigest() != rec["dataset_sha256"]:
                raise ValueError(f"{HOST_GOLDENS}: the record of {path} is for another file")
        table[path] = {"chain_hash": rec["chain_hash"], "penalties": rec["penalties"],
                       "source": HOST_GOLDENS}
    return table


def matches(golden: Dict, chain_hash: str, penalties: List[int]) -> bool:
    """Whether an output equals a golden: the hash (the golden's may be a
    prefix of 16 or more hex characters) and the penalties where recorded."""
    want = golden["chain_hash"]
    if len(want) < 16 or not chain_hash.startswith(want):
        return False
    return golden.get("penalties") is None or list(penalties) == list(golden["penalties"])


def child(dataset: str, platform: str) -> Dict:
    """One dataset in this process: the first call, then the warm runs."""
    t0 = time.perf_counter()
    import torch

    from msa_tpu_torch.config import TorchConfig
    from msa_tpu_torch.models.kway import align_kway
    from msa_tpu_torch.utils.msaio import parse_file

    rec: Dict = {"dataset": dataset, "platform": platform, "import_s": time.perf_counter() - t0}
    config = TorchConfig.from_env()
    if platform == "cpu":
        config.device = "cpu"
        rec["context_s"] = rec["kernel_load_s"] = None
    else:
        from msa_tpu_torch.ops import _build

        t = time.perf_counter()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        rec["context_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for name in _build.SIGNATURES:
            _build.load(name)
        rec["kernel_load_s"] = time.perf_counter() - t
    problem = parse_file(os.path.join(REPO, dataset))
    runs = []
    for _ in range(1 + WARM_RUNS):
        t = time.perf_counter()
        result = align_kway(problem, config=config)
        runs.append({"seconds": time.perf_counter() - t, "chain_hash": result.chain_hash,
                     "penalties": result.penalties})
    rec["first_run_s"] = runs[0]["seconds"]
    rec["first_call_s"] = sum(rec[k] or 0.0 for k in ("context_s", "kernel_load_s", "first_run_s"))
    rec["warm_s"] = [r["seconds"] for r in runs[1:]]
    rec["warm_min_s"] = min(rec["warm_s"])
    rec["outputs"] = [{"chain_hash": r["chain_hash"], "penalties": r["penalties"]} for r in runs]
    return rec


def run_dataset(dataset: str, golden: Dict, platform: str) -> Dict:
    """``child`` in a fresh process, its every output gated on ``golden``."""
    cmd = [sys.executable, "-m", "msa_tpu_torch.scripts.conformance", "--child", dataset,
           "--platform", platform]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT_S)
    process_s = time.perf_counter() - t0
    if proc.returncode != 0:
        return {"dataset": dataset, "ok": False, "process_s": process_s,
                "error": proc.stderr[-2000:]}
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    outputs = rec.pop("outputs")
    rec["ok"] = all(matches(golden, o["chain_hash"], o["penalties"]) for o in outputs)
    rec["hash_prefix"] = outputs[0]["chain_hash"][:16]
    rec["golden"] = golden.get("source", "given")
    rec["process_s"] = process_s
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dataset", action="append", default=None, metavar="PATH[=HASH]",
                    help="a dataset to run (default: all six), optionally with its golden hash")
    ap.add_argument("--out", default=None, help="write every record to this JSON file")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.platform)), flush=True)
        return 0

    table = golden_table()
    chosen = {}
    for spec in args.dataset or list(table):
        path, _, want = spec.partition("=")
        chosen[path] = {"chain_hash": want, "penalties": None, "source": "given"} if want \
            else table[path]
    records = []
    for path, golden in chosen.items():
        rec = run_dataset(path, golden, args.platform)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    failures = sum(not r["ok"] for r in records)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    print(json.dumps({"rc": 1 if failures else 0, "failures": failures}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
