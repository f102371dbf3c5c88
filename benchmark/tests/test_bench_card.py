"""The plain reference on the card, at the cells' own sizes (``-m cuda``).

On the card's machine: ``python -m pytest benchmark/tests -q -m cuda``.
"""

import os
import random

import numpy as np
import pytest
import torch

from reference import hashing, nw, tasks

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The spec-cap pair (numpy default_rng(2026), ACGT, 100,352 then 100,000) and
# its oracle from the program's blocked host oracle
# (msa_tpu_torch/goldens/spec_cap.json): penalty and pair hash, both ways.
SPEC_CAP = {
    "xy": (124321, "513107a95a72d19f99118e724fd10c88aaf035ccacf3f2ec4ad343c56f72fa58"
                   "643f19fb7803f23d1404c79c7fffcb51b9f620a36c0f21c9660d2e0e32c9cdde"),
    "yx": (124321, "68b26067d081b7808ce22f802458248e1ffac807ab83c757b7c920b5d8b42728"
                   "bbb3d7eab191e077dba4f34c01ecd10e4ebac2ce7874a6042e247910ee673eea"),
}
# The reference program's golden hash of data/mseq-big13-example.txt
# (testing15/sample.txt).
BIG13_HASH = ("c0befee8737ac74a1ece5abae5cca722c2eaf2bf028aaca8f3f6607204b7e68e"
              "a0707a881d5512a723439ab67007e5301a9c126272a3ff2ad96923b0dcf27dab")


@pytest.mark.cuda
def test_the_card_and_the_cpu_give_the_same_answers(card):
    rng = random.Random(4)
    pairs = [("".join(rng.choice("ACGT") for _ in range(m)),
              "".join(rng.choice("ACGT") for _ in range(n)))
             for m, n in ((1500, 1300), (700, 1400), (1000, 1000))]
    for left_first in (False, True):
        assert (nw.align(pairs, 3, 2, card, left_first=left_first)
                == nw.align(pairs, 3, 2, torch.device("cpu"), left_first=left_first))


@pytest.mark.cuda
def test_the_spec_cap_pair_both_ways(card):
    rng = np.random.default_rng(2026)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    x = alpha[rng.integers(0, 4, size=100_352)].tobytes().decode()
    y = alpha[rng.integers(0, 4, size=100_000)].tobytes().decode()
    got = nw.align([(x, y), (y, x)], 3, 2, card)
    for (penalty, a1, a2), key in zip(got, ("xy", "yx")):
        assert (penalty, hashing.pair_hash(a1, a2)) == SPEC_CAP[key]


@pytest.mark.cuda
def test_big13_gives_the_reference_programs_golden_hash(card):
    path = os.path.join(ROOT, "data", "mseq-big13-example.txt")
    if not os.path.exists(path):
        pytest.skip("data/mseq-big13-example.txt is not in this checkout")
    with open(path) as f:
        tokens = f.read().split()
    pxy, pgap, k = (int(t) for t in tokens[:3])
    genes = tokens[3 : 3 + k]
    res = nw.align([(genes[i], genes[j]) for i, j in tasks.pairs(k)], pxy, pgap, card)
    assert hashing.chain(hashing.pair_hash(a, b) for _, a, b in res) == BIG13_HASH
    assert [p for p, _, _ in res][:3] == [31202, 48016, 25007]
