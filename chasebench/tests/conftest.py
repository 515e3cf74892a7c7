"""Shared pieces of the benchmark's own tests (run them with
``PYTHONPATH=src python -m pytest chasebench/tests`` from the root).

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them where no CUDA device is present; the rest run on
the CPU at a small size, the vectors' width kept at 512."""
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _path in (ROOT / "src", ROOT):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

# the size a test run holds: rows cut, widths kept; IVF lists cut with them
SMALL = {"data": {"rows": 20000, "modes": 16}}
SMALL_INDEX = {"nlist": 64}
SMALL_MIX = {"pool": 400, "list_size": 20, "check_queries": 400,
             "warmup": 1}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips where none is found)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run these tests on the chip")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


# cells that PERF.md's open questions hold, with the entries only they
# use, kept tested on the CPU so that a later PR brings a cell back by its
# entries alone: the single-dict mix, and the IVF configuration under
# chase with its readers (out until real embeddings are in the repository)
SINGLE = {"name": "laion1m-flat-q1-single", "config": "laion1m-flat",
          "traffic": "q1-single", "chips": 1}
IVF = {"name": "laion1m-ivf256-chase-q1-b100",
       "config": "laion1m-ivf256-chase", "traffic": "q1-b100", "chips": 1}
KEPT = {
    "configs": [{"name": "laion1m-ivf256-chase",
                 "file": "chasebench/configs/laion1m-ivf256-chase.json"}],
    "end_to_end": [{"name": "recall", "unit": "ratio", "better": "higher",
                    "bound": 0.01, "source": "host_clock",
                    "workloads": [IVF["name"]]}],
    "per_layer": [{"name": "ivf.rounds", "unit": "count", "better": "lower",
                   "source": "program_counter", "layer": "IVF probes",
                   "moves": "qps", "workloads": [IVF["name"]]}],
}


def with_kept(bench):
    """``bench`` with the kept entries added."""
    return {k: v + KEPT.get(k, []) if isinstance(v, list) else v
            for k, v in bench.items()}


def run_small(bench, workload, *, seed=7, seconds=0.3, trace=False,
              control=False):
    """One run of ``workload`` (a cell's name, or a cell) on the CPU at the
    small size."""
    import torch

    from chasebench import harness
    bench = with_kept(bench)
    cell = workload if isinstance(workload, dict) else harness.by_name(
        bench["workloads"], workload)
    config = harness.load_json(
        ROOT / harness.by_name(bench["configs"], cell["config"])["file"])
    overrides = dict(SMALL)
    if config["index"] is not None:
        overrides["index"] = SMALL_INDEX
    return harness.run_cell(bench, cell, seed, seconds, trace,
                            device=torch.device("cpu"),
                            started=time.perf_counter(), overrides=overrides,
                            mix_overrides=SMALL_MIX, control=control,
                            log=lambda msg: None)
