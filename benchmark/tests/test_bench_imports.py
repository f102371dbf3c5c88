"""The check that nothing of JAX or of the JAX package is loaded, and that
the reference loads nothing of the program."""

import os
import subprocess
import sys
import types

from msabench import imports

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_names_are_compared_whole():
    mods = ["jax.numpy", "jaxlib", "msa_tpu.cli", "msa_tpu_torch.ops", "flaxen", "numpy"]
    assert imports.found(mods) == ["jax", "jaxlib", "msa_tpu"]
    assert imports.found(["msa_tpu_torch", "msabench.judge"]) == []


def test_the_reference_loads_nothing_of_the_program_or_of_jax():
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {BENCH!r})\n"
        "from reference import nw, tasks, hashing\n"
        "res = nw.align([('ACGTAC', 'AGTC')], 3, 2, torch.device('cpu'))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd="/")
    assert proc.returncode == 0, proc.stderr
    tops = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert not tops & {"msa_tpu_torch", "msa_tpu", "jax", "jaxlib", "flax", "msabench"}


def test_a_run_that_loaded_jax_exits_3_and_prints_no_result(tmp_path, capsys, monkeypatch):
    from test_bench_run import CUT, cut_benchmark, run

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", CUT, "--seed", "3", "--seconds", "0.5",
                   "--platform", "cpu", "--benchmark", cut_benchmark(tmp_path)])
    out, err = capsys.readouterr()
    assert rc == 3 and out.strip() == "" and "jax" in err
