"""The port's striped route for a lone pair (``ops/nw_striped.py``) on the CPU.

The same pairs, made from a numpy seed, go through the JAX package's
``msa_tpu.ops.nw_striped.nw_align_band_striped`` on the 8 virtual CPU
devices (tests/conftest.py) and through the port's on ``[cpu] * D``:
penalty and both alignment strings equal exactly. The gathered striped
state equals ``band_fill_ref``'s on the same plan at tolerance 0. Also the
stripe plan and its windows, the checks that refuse a device list, and the
spec-cap oracle.
"""

from __future__ import annotations

import functools
import json
import pathlib

import numpy as np
import pytest
import torch

from msa_tpu.ops.nw_striped import nw_align_band_striped as jax_striped
from msa_tpu.ops.reference import nw_align_numpy
from msa_tpu.parallel.mesh import get_mesh
from msa_tpu_torch.ops import band_fill as bf
from msa_tpu_torch.ops import nw_striped as ns
from msa_tpu_torch.parallel import mesh

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
# The cases of tests/test_parallel.py:212-216: (m, n, pxy, pgap, K), with a
# port band height that gives every stripe several bands at D = 8.
CASES = {
    "301x287": (301, 287, 3, 2, 64, 16),
    "850x1100": (850, 1100, 5, 1, 128, 48),
    "2100x1900": (2100, 1900, 3, 2, 256, 128),
}


def _pair(m, n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), m)), "".join(rng.choice(list("ACGT"), n))


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    m, n, pxy, pgap, kc, _ = CASES[name]
    x, y = _pair(m, n, m * 7 + n)
    return x, y, jax_striped(x, y, pxy, pgap, get_mesh(8), kchunk=kc)


@pytest.mark.parametrize("stripes", [2, 3, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_striped_alignment_matches_jax(case, stripes):
    m, n, pxy, pgap, kc, rb = CASES[case]
    x, y, want = _jax_case(case)
    plan = bf.plan_pairs([m, n], [(0, 1)], rb, kc)
    assert all(s.num_items >= 2 for s in bf.plan_stripes(plan, stripes))
    got = ns.nw_align_band_striped(x, y, pxy, pgap, [CPU] * stripes, rb=rb, snap_k=kc)
    assert got == want == nw_align_numpy(x, y, pxy, pgap)


def test_more_stripes_than_bands_matches_jax():
    m, n, pxy, pgap, kc, _ = CASES["301x287"]
    x, y, want = _jax_case("301x287")
    plan = bf.plan_pairs([m, n], [(0, 1)], 128, kc)
    assert int(plan.params[0, bf.P_NB]) == 3
    assert ns.nw_align_band_striped(x, y, pxy, pgap, [CPU] * 8, rb=128, snap_k=kc) == want


@pytest.mark.parametrize("stripes", [1, 2, 3, 5, 12])
def test_gathered_state_equals_one_fill(stripes):
    """The striped plain version's gathered state is what one fill writes:
    score, rows and every snapshot entry (unwritten slots included)."""
    x, y = _pair(400, 230, 3)
    plan = bf.plan_pairs([400, 230], [(0, 1)], 40, 64)
    table = torch.from_numpy(bf.gene_table([x, y]))
    want = bf.band_fill_ref(table, plan, 3, 2)
    got = ns.striped_fill([table] * stripes, plan, [CPU] * stripes, 3, 2)
    assert torch.equal(got.score, want.score)
    assert torch.equal(got.rows, want.rows)
    assert torch.equal(got.snaps, want.snaps)


def test_band_range_of_the_plain_fill():
    """``band_fill_ref`` over a stripe reads its first band's top row from
    the window it is given and writes that window's entries only: the
    stripe's snapshots, its bands' bottom rows, the score with the last."""
    x, y = _pair(300, 170, 5)
    plan = bf.plan_pairs([300, 170], [(0, 1)], 50, 32)
    table = torch.from_numpy(bf.gene_table([x, y]))
    full = bf.band_fill_ref(table, plan, 3, 2)
    for s in bf.plan_stripes(plan, 3)[1:]:  # bands 2-3 (relaying band 3's row), then 4-5
        part = bf.empty_state(plan, CPU, s)
        part.rows[:170] = full.rows[s.rows_base : s.rows_base + 170]
        bf.band_fill_ref(table, plan, 3, 2, stripe=s, out=part)
        assert torch.equal(part.rows, full.rows[s.rows_base : s.rows_base + s.rows_len])
        assert torch.equal(part.snaps, full.snaps[s.snaps_base : s.snaps_base + s.snaps_len])
        assert torch.equal(part.score, full.score if s.hi == 6 else torch.zeros_like(full.score))


@pytest.mark.parametrize("nb,stripes", [(13, 2), (13, 4), (20, 4), (3, 8), (7, 7), (1, 3), (5, 1)])
def test_plan_stripes_covers_every_band_once(nb, stripes):
    plan = bf.plan_pairs([nb * 10 - 3, 90], [(0, 1)], 10, 32)
    assert int(plan.params[0, bf.P_NB]) == nb
    cut = bf.plan_stripes(plan, stripes)
    assert len(cut) == stripes
    sizes = [s.num_items for s in cut]
    assert sizes == [nb // stripes + (c < nb % stripes) for c in range(stripes)]
    bands = [int(b) for s in cut for b in s.items[:, 1]]
    assert bands == list(range(nb))  # each band once, stripes in order, ticket order inside
    assert [int(v) for s in cut for v in s.items[:, 2]] == list(range(nb))  # slots of the pair
    for c, s in enumerate(cut):
        assert (s.lo, s.hi) == ((s.items[0, 1], s.items[-1, 1] + 1) if s.num_items else (s.lo, s.lo))
        last = c == stripes - 1 or not cut[c + 1].num_items
        assert s.relay == (-1 if last or not s.num_items else s.hi - 1)
    with pytest.raises(ValueError, match="one pair"):
        bf.plan_stripes(bf.plan_pairs([50, 40], [(0, 1), (1, 0)], 10, 32), 2)


@pytest.mark.parametrize("nb,stripes", [(13, 2), (13, 4), (20, 4), (3, 8), (7, 7), (1, 3), (5, 1)])
def test_stripe_windows_partition_the_layout(nb, stripes):
    """Stripe 0 holds the whole layout; each later stripe a window of its
    bands' snapshots and of the rows from the one relayed in to its relay
    band's. What each stripe owns (what the gather copies) covers every
    entry of the pair's rows and snapshots exactly once."""
    plan = bf.plan_pairs([nb * 10 - 3, 90], [(0, 1)], 10, 32)
    per_band = int(plan.params[0, bf.P_S]) * 3 * 11
    cut = bf.plan_stripes(plan, stripes)
    assert (cut[0].rows_base, cut[0].rows_len, cut[0].snaps_base, cut[0].snaps_len) == (
        0, plan.rows_len, 0, plan.snaps_len)
    rows = np.zeros(plan.rows_len, int)
    snaps = np.zeros(plan.snaps_len, int)
    for c, s in enumerate(cut):
        if c == 0:
            rows[: max(s.hi - 1, 0) * 90] += 1
            snaps[: s.hi * per_band] += 1
            continue
        assert s.snaps_len == s.num_items * per_band
        assert s.rows_len == (s.num_items + (s.relay >= 0)) * 90 if s.num_items else s.rows_len == 0
        rows[s.rows_base : s.rows_base + s.num_items * 90] += 1
        snaps[s.snaps_base : s.snaps_base + s.snaps_len] += 1
    assert (rows == 1).all() and (snaps == 1).all()


CARD = [torch.device("cuda", i) for i in range(3)]


@pytest.mark.parametrize("devices,grids,resident,fits", [
    ([CARD[0]] * 2, [7, 6], 132, True),
    ([CARD[0]] * 4, [4, 3, 3, 3], 13, True),
    ([CARD[0]] * 4, [4, 3, 3, 3], 12, False),
    ([CARD[0], CARD[1], CARD[0], CARD[1]], [40, 40, 40, 40], 100, True),
    ([CARD[0], CARD[1], CARD[0], CARD[1]], [60, 40, 60, 40], 100, False),
    ([CARD[0]] * 3, [90, 50, 0], 132, False),
])
def test_check_stripes_co_residency(devices, grids, resident, fits):
    args = (devices, grids, lambda dev: resident, lambda a, b: True)
    if fits:
        mesh.check_stripes(*args)
    else:
        with pytest.raises(RuntimeError, match="resident"):
            mesh.check_stripes(*args)


def test_check_stripes_needs_peer_access():
    pairs = []

    def access(a, b):
        pairs.append((a, b))
        return (a, b) != (1, 2)

    mesh.check_stripes([CARD[0], CARD[1]], [5, 5], lambda dev: 132, access)
    with pytest.raises(RuntimeError, match="no peer access"):
        mesh.check_stripes(CARD, [5, 5, 5], lambda dev: 132, access)
    # An empty stripe receives nothing, so it needs no access.
    mesh.check_stripes(CARD, [5, 5, 0], lambda dev: 132, access)
    assert (1, 2) in pairs and all(a != b for a, b in pairs)


def test_striped_fill_refuses_other_devices():
    plan = bf.plan_pairs([60, 50], [(0, 1)], 16, 32)
    table = torch.zeros((2, 60), dtype=torch.uint8)
    with pytest.raises(ValueError, match="cuda devices or on the cpu"):
        ns.striped_fill([table, table], plan, [CPU, torch.device("meta")], 3, 2)


def test_spec_cap_golden_agrees_with_the_jax_record():
    """The port's JSON oracle of the spec-cap pair against the JAX package's
    recorded score (artifacts/spec_cap_r5.json); no pickle is read."""
    from msa_tpu_torch.goldens import spec_cap

    gold = spec_cap.load()
    with open(REPO / "artifacts" / "spec_cap_r5.json") as f:
        record = json.load(f)
    assert gold["xy"]["penalty"] == gold["yx"]["penalty"] == record["score"]
    assert (gold["xy"]["m"], gold["xy"]["n"]) == (record["m"], record["n"])
    assert (gold["yx"]["m"], gold["yx"]["n"]) == (record["n"], record["m"])
    x, y = spec_cap.make_pair(1000, 900)
    assert (len(x), len(y)) == (1000, 900) and set(x + y) == set("ACGT")
