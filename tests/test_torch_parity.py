"""The parity map in code: every module of the JAX side has its counterpart.

Each ``.py`` under ``msa_tpu/`` and ``scripts/``, and the root ``bench.py``,
maps to the file of the port that does its work, which must exist, or to the
reason it is not ported, quoted from ``ROADMAP.md``'s "Do not port" list. A
module of the JAX side with no entry fails. The ``pl.pallas_call`` sites of
``msa_tpu/`` are exactly the three TPU kernels, each with its CUDA source.
The package's top-level names are ``msa_tpu``'s, and a bare import of the
port loads no torch. Plain path checks; nothing here runs a kernel.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
T = "msa_tpu_torch/"
SKIP = "do not port: "

PARITY = {
    "bench.py": T + "scripts/bench.py",
    "msa_tpu/__init__.py": T + "__init__.py",
    "msa_tpu/cli.py": T + "cli.py",
    "msa_tpu/config.py": T + "config.py",
    "msa_tpu/models/__init__.py": T + "models/__init__.py",
    "msa_tpu/models/kway.py": T + "models/kway.py",
    "msa_tpu/models/pairwise.py": T + "models/pairwise.py",
    "msa_tpu/native/__init__.py": T + "native.py",
    "msa_tpu/native/build.py": T + "native.py",
    "msa_tpu/native/lib.py": T + "native.py",
    "msa_tpu/ops/__init__.py": T + "ops/__init__.py",
    "msa_tpu/ops/batch.py": T + "ops/batch.py",
    "msa_tpu/ops/buckets.py": SKIP + "`ops/buckets.py`",
    "msa_tpu/ops/conveyor.py": T + "ops/conveyor.py",
    "msa_tpu/ops/nw_jax.py": T + "ops/nw_torch.py",
    "msa_tpu/ops/nw_sp.py": SKIP + "`ops/nw_sp.py` (an oracle)",
    "msa_tpu/ops/nw_striped.py": T + "ops/nw_striped.py",
    "msa_tpu/ops/pallas_nw.py": T + "ops/band_fill.py",
    "msa_tpu/ops/pallas_walk.py": T + "ops/walk.py",
    "msa_tpu/ops/reference.py": T + "ops/reference.py",
    "msa_tpu/parallel/__init__.py": T + "parallel/__init__.py",
    "msa_tpu/parallel/costmodel.py": T + "parallel/costmodel.py",
    "msa_tpu/parallel/engine.py": T + "parallel/engine.py",
    "msa_tpu/parallel/mesh.py": T + "parallel/mesh.py",
    "msa_tpu/parallel/schedule.py": T + "parallel/schedule.py",
    "msa_tpu/utils/__init__.py": T + "utils/__init__.py",
    "msa_tpu/utils/alignment.py": T + "utils/alignment.py",
    "msa_tpu/utils/checkpoint.py": T + "utils/checkpoint.py",
    "msa_tpu/utils/hashing.py": T + "utils/hashing.py",
    "msa_tpu/utils/jaxenv.py": SKIP + "`utils/jaxenv.py`",
    "msa_tpu/utils/logging.py": T + "utils/logging.py",
    "msa_tpu/utils/msaio.py": T + "utils/msaio.py",
    "msa_tpu/utils/tasks.py": T + "utils/tasks.py",
    "msa_tpu/utils/timing.py": T + "utils/timing.py",
    "scripts/ab_compare.py": T + "scripts/ab_compare.py",
    "scripts/gen_workload.py": T + "scripts/gen_workload.py",
    "scripts/plot_bench.py": T + "scripts/plot_bench.py",
    "scripts/scaling_curve.py": T + "scripts/scaling_curve.py",
    "scripts/schedule_compare.py": T + "scripts/schedule_compare.py",
    "scripts/spec_cap.py": T + "goldens/spec_cap.py",
    "scripts/sweep.py": T + "scripts/sweep.py",
    # Its first-call and warm records are conformance's.
    "scripts/tpu_conformance.py": T + "scripts/conformance.py",
    "scripts/warm_latency.py": T + "scripts/conformance.py",
    **{f"scripts/{name}.py": SKIP + "the Mosaic profilers `scripts/profile_*` and"
       " `scripts/microbench_sweep.py`"
       for name in ("microbench_sweep", "profile_batch_split", "profile_conveyor",
                    "profile_conveyor_isolate", "profile_conveyor_stages", "profile_e2e",
                    "profile_walk_micro", "profile_walk_only")},
}

# (file, line of pl.pallas_call) -> (the function that reaches it, its CUDA source)
PALLAS_SITES = {
    ("msa_tpu/ops/pallas_nw.py", 293): ("_band_sweep_call", T + "csrc/band_fill.cu"),
    ("msa_tpu/ops/pallas_walk.py", 559): ("_walk_call", T + "csrc/walk.cu"),
    ("msa_tpu/ops/conveyor.py", 598): ("_conveyor_fill_segment", T + "csrc/conveyor_fill.cu"),
}


def _jax_modules():
    files = [*(REPO / "msa_tpu").rglob("*.py"), *(REPO / "scripts").rglob("*.py"),
             REPO / "bench.py"]
    return sorted(str(p.relative_to(REPO)) for p in files)


def _do_not_port():
    text = (REPO / "ROADMAP.md").read_text()
    section = text.split("**Do not port:**", 1)[1].split("\n#", 1)[0]
    return " ".join(section.split())


def test_every_jax_module_has_an_entry():
    missing = [m for m in _jax_modules() if m not in PARITY]
    assert not missing, f"JAX modules with no counterpart or reason in the parity map: {missing}"
    assert not set(PARITY) - set(_jax_modules()), "entries for modules that are gone"


@pytest.mark.parametrize("module", sorted(PARITY))
def test_counterpart_exists_or_reason_is_roadmaps(module):
    target = PARITY[module]
    if target.startswith(SKIP):
        assert target[len(SKIP):] in _do_not_port(), f"{module}: reason not in ROADMAP.md"
    else:
        assert (REPO / target).is_file(), f"{module} -> {target} does not exist"


def test_pallas_call_sites_are_the_three_ported_kernels():
    sites = {}
    for path in sorted((REPO / "msa_tpu").rglob("*.py")):
        rel = str(path.relative_to(REPO))
        lines = path.read_text().splitlines()
        for no, line in enumerate(lines, 1):
            if re.search(r"\bpl\.pallas_call\(", line):
                # The enclosing top-level function: the nearest `def` at column 0 above.
                func = next(m.group(1) for l in reversed(lines[:no])
                            if (m := re.match(r"def (\w+)\(", l)))
                sites[(rel, no)] = func
    assert set(sites) == set(PALLAS_SITES)
    for site, (func, source) in PALLAS_SITES.items():
        assert sites[site] == func
        assert (REPO / source).is_file()
        assert PARITY[site[0]].startswith(T)


def test_top_level_api_is_msa_tpus_and_imports_no_torch():
    code = """
import sys
import msa_tpu_torch
assert "torch" not in sys.modules, "a bare import loaded torch"
from msa_tpu_torch.models import kway
from msa_tpu_torch.utils import msaio
for name, mod in (("parse_input", msaio), ("format_output", msaio),
                  ("KWayAligner", kway), ("align_kway", kway)):
    assert getattr(msa_tpu_torch, name) is getattr(mod, name), name
with open("data/mseq1.dat") as f:
    problem = msa_tpu_torch.parse_input(f.read())
print(msa_tpu_torch.align_kway(problem, backend="native").chain_hash)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    import msa_tpu

    with open(REPO / "data" / "mseq1.dat") as f:
        want = msa_tpu.align_kway(msa_tpu.parse_input(f.read()), backend="native").chain_hash
    assert out.stdout.strip().splitlines()[-1] == want
    assert set(msa_tpu.__dict__) >= set(__import__("msa_tpu_torch").__all__)
    with pytest.raises(AttributeError):
        __import__("msa_tpu_torch").no_such_name
