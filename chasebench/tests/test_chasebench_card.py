"""On the card: one short run of each cell through ``run.py`` comes out
correct with the contract's line, and the control at the cell's own size
comes out not correct.  Skipped where no CUDA device is found; on the
chip::

    PYTHONPATH=src python3 -m pytest -q chasebench/tests -m card
"""
import json
import subprocess
import sys
import time

import pytest

from conftest import ROOT

with open(ROOT / "BENCHMARK.json") as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chasebench" / "run.py"), "--workload",
         cell, "--seed", str(2**31 + 101), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(card, bench, cell):
    from chasebench import harness
    result = harness.run_cell(bench, harness.by_name(bench["workloads"], cell),
                              2**31 + 202, 1.0, False, device=card,
                              started=time.perf_counter(), control=True,
                              log=lambda msg: None)
    assert not result["correct"]
