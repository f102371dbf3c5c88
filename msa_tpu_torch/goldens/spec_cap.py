"""The spec-cap pair: one 100,352 x 100,000 pair at the assignment's length cap.

``make_pair`` builds the pair from a seed exactly as ``scripts/spec_cap.py``
does (numpy ``default_rng(2026)``, ACGT, x then y). Its oracle,
``spec_cap.json`` beside this file, holds the penalty and ``pair_hash`` of
both orientations from the port's blocked host oracle
(``ops/reference.py::nw_align_numpy_blocked``), about 7 minutes an
orientation on one CPU core. Re-derive it with::

    python -m msa_tpu_torch.goldens.spec_cap            # both orientations
    python -m msa_tpu_torch.goldens.spec_cap --orient 0  # x against y only
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Tuple

import numpy as np

M, N, SEED, ALPHABET, PXY, PGAP = 100_352, 100_000, 2026, "ACGT", 3, 2
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "spec_cap.json")


def make_pair(m: int = M, n: int = N, seed: int = SEED) -> Tuple[str, str]:
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(ALPHABET.encode(), dtype=np.uint8)
    x = alpha[rng.integers(0, 4, size=m)].tobytes().decode("ascii")
    y = alpha[rng.integers(0, 4, size=n)].tobytes().decode("ascii")
    return x, y


def load() -> Dict:
    """The oracle: ``{"xy": {...}, "yx": {...}}``, one record an orientation."""
    with open(GOLDEN) as f:
        return json.load(f)


def derive(orient: int) -> Dict:
    from msa_tpu_torch.ops.reference import nw_align_numpy_blocked
    from msa_tpu_torch.utils.hashing import pair_hash

    x, y = make_pair()
    a, b = (x, y) if orient == 0 else (y, x)
    t0 = time.time()
    penalty, a1, a2 = nw_align_numpy_blocked(a, b, PXY, PGAP)
    print(f"orientation {orient}: host oracle {time.time() - t0:.1f} s", file=sys.stderr)
    return {"m": len(a), "n": len(b), "seed": SEED, "alphabet": ALPHABET,
            "pxy": PXY, "pgap": PGAP, "penalty": int(penalty),
            "pair_hash": pair_hash(a1, a2), "align_len": len(a1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--orient", type=int, choices=(0, 1), default=None,
                    help="0: x against y, 1: y against x (default both)")
    ap.add_argument("--out", default=GOLDEN)
    args = ap.parse_args(argv)
    keys = ("xy", "yx")
    out = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)
    for o in ((0, 1) if args.orient is None else (args.orient,)):
        out[keys[o]] = derive(o)
        print(json.dumps({keys[o]: out[keys[o]]}), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
