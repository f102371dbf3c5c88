"""The plain reference against the reference program's golden outputs, and
against the program's own host oracle at small sizes."""

import random

import pytest
import torch

from reference import alignment, hashing, nw, tasks

CPU = torch.device("cpu")

# The reference program's bundled inputs and golden outputs
# (testing15/mseq-*.out, docs/Project2B.pdf p.7): pxy, pgap, sequences,
# the chain hash's first 16 hex digits, the penalties.
GOLDENS = {
    "mseq.dat": (3, 2, ["AGGGCT", "AGGCA", "AAAGGGCT"], "602d0f604e8fb908", [5, 4, 9]),
    "mseq1.dat": (3, 2, ["AGGGCT", "AGGCA", "AAAGGGCT", "AGGGCTAGGGCT", "AGGCAAGGCA",
                         "AAAGGGCTAAAGGGCT", "AGGGCTAGGGCTAGGGCTAGGGCT", "AGGCAAGGCAAGGCAAGGCA",
                         "AAAGGGCTAAAGGGCT"], "4d676f40ea4c1e6b",
                  [5, 4, 9, 12, 14, 11, 11, 10, 11, 10, 20, 22, 16, 8, 15, 36, 38, 32, 24, 28,
                   22, 31, 30, 27, 22, 20, 22, 20, 20, 22, 16, 8, 15, 0, 22, 22]),
}


def kway(genes, pxy, pgap, device=CPU, **kw):
    pairs = [(genes[i], genes[j]) for i, j in tasks.pairs(len(genes))]
    res = nw.align(pairs, pxy, pgap, device, **kw)
    return hashing.chain(hashing.pair_hash(a, b) for _, a, b in res), [p for p, _, _ in res]


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_reference_gives_the_golden_outputs(name):
    pxy, pgap, genes, prefix, penalties = GOLDENS[name]
    chain, got = kway(genes, pxy, pgap)
    assert chain.startswith(prefix) and len(chain) == 128
    assert got == penalties


def random_pairs(rng, count, longest, alphabet):
    return [("".join(rng.choice(alphabet) for _ in range(rng.randint(1, longest))),
             "".join(rng.choice(alphabet) for _ in range(rng.randint(1, longest))))
            for _ in range(count)]


@pytest.mark.parametrize("seed, longest, alphabet, pxy, pgap, budget", [
    (0, 40, "ACGT", 3, 2, None),
    (1, 90, "AC", 3, 2, None),
    (2, 150, "ACGT", 5, 1, None),
    (3, 200, "ACGT", 3, 2, 600_000),  # several batches
    (4, 70, "A", 3, 2, None),
])
def test_reference_equals_the_programs_host_oracle(seed, longest, alphabet, pxy, pgap, budget):
    from msa_tpu_torch.ops.reference import nw_align_numpy

    pairs = random_pairs(random.Random(seed), 7, longest, alphabet)
    got = nw.align(pairs, pxy, pgap, CPU, budget=budget)
    assert got == [nw_align_numpy(x, y, pxy, pgap) for x, y in pairs]


def test_the_control_keeps_every_penalty_and_breaks_some_strings():
    rng = random.Random(0)
    pairs = [("".join(rng.choice("ACGT") for _ in range(200)),
              "".join(rng.choice("ACGT") for _ in range(180))) for _ in range(6)]
    good = nw.align(pairs, 3, 2, CPU)
    control = nw.align(pairs, 3, 2, CPU, left_first=True)
    assert [c[0] for c in control] == [g[0] for g in good]
    assert sum(c[1:] != g[1:] for c, g in zip(control, good)) >= 3


def test_rows_past_a_block_and_skewed_pairs():
    from msa_tpu_torch.ops.reference import nw_align_numpy

    rng = random.Random(9)
    x = "".join(rng.choice("ACGT") for _ in range(nw.ROWS * 3 + 5))
    pairs = [(x, "ACGT"), ("ACGT", x), (x, x[::-1]), ("A", "C")]
    assert nw.align(pairs, 3, 2, CPU) == [nw_align_numpy(a, b, 3, 2) for a, b in pairs]


def test_strings_fill_and_trim_as_the_reference_program():
    # One diagonal from (1, 1): the rest of x is completed from its prefix.
    assert alignment.strings("AC", "C", [alignment.DIAG]) == ("AC", "_C")
    # A walk that ends on the border i == 0 leaves y's prefix to fill.
    assert alignment.strings("G", "TG", [alignment.DIAG]) == ("_G", "TG")
    with pytest.raises(ValueError):
        alignment.strings("AA", "AA", [alignment.DIAG])


def test_pair_hash_and_chain():
    a = hashing.pair_hash("A_C", "AGC")
    assert a == hashing.sha512_hex(hashing.sha512_hex("A_C") + hashing.sha512_hex("AGC"))
    assert hashing.chain([a]) == hashing.sha512_hex(a)
    assert hashing.chain([]) == ""
