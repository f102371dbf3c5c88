"""The control (``control.py``): the reference with its tie-break broken, put
in the program's place, must fail the comparison on every seed."""

import importlib.util
import json
import os

from test_bench_run import CUT, cut_benchmark

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec_ = importlib.util.spec_from_file_location("bench_control", os.path.join(BENCH, "control.py"))
control = importlib.util.module_from_spec(spec_)
spec_.loader.exec_module(control)


def test_the_control_fails_on_every_seed(tmp_path, capsys):
    bench = cut_benchmark(tmp_path, lengths=(300, 260, 220, 180), check_pairs=3)
    rc = control.main(["--workload", CUT, "--seeds", "1,2,3,4", "--platform", "cpu",
                       "--benchmark", bench])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert rc == 0 and len(lines) == 4
    for line in lines:
        assert line["failed_the_check"] is True
        assert line["compared"]["penalties_wrong"]["value"] == 0
        assert line["compared"]["alignments_wrong"]["value"] >= 1
