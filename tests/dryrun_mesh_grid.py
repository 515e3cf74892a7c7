"""The dry-run's per-device grid under ``tiny`` (2 x 2) at --smoke-config,
shared by ``tests/test_torch_dryrun_mesh*.py`` (one file per group of
shapes, so that ``--dist loadfile`` spreads them).

The reference's records (``repro.launch.dryrun.run_cell``: its
SPMD-partitioned HLO on 8 fake CPU devices) come from one subprocess while
the port counts the same cells here (``launch/dryrun.py``: DTensors of
``meta`` blocks over a fake process group).  Each cell holds:

* ``flops_per_device`` is the reference's exactly, but for the SSD's
  backward reductions in the mamba2 and zamba2 training steps
  (``repro_torch.testing.ssd_backward_gap``);
* the argument bytes per device are the reference's ``memory.
  argument_bytes``, less 4 bytes in the decode cells: the cache's ``pos``
  is a host int in the port and an int32 array in the reference;
* the collective bytes are nonzero (printed beside the reference's, not
  held equal: the port's redistributions are not XLA's);
* a ``long_500k`` cell of a full-attention arch is skipped by both.
"""
import json
import os
import subprocess
import sys

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.testing import ssd_backward_gap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bytes a port record holds fewer of: the decode cache's int32 ``pos``
POS_BYTES = {"train_4k": 0, "prefill_32k": 0, "decode_32k": 4,
             "long_500k": 4}

REF_CODE = r"""
import json, sys
from repro.launch.dryrun import run_cell
cells = json.loads(sys.argv[1])
recs = [run_cell(a, s, "tiny", smoke_config=True) for a, s in cells]
for r in recs:
    r.pop("traceback", None)
print(json.dumps(recs))
"""


def cells(*shapes) -> list:
    """Every arch at each of ``shapes``."""
    return [(a, s) for s in shapes for a in configs.ARCH_IDS]


def ids(cells) -> list:
    return ["-".join(c) for c in cells]


def records(cells) -> dict:
    """(reference record, port record) per cell."""
    env = dict(os.environ)
    env["REPRO_DRYRUN_XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.Popen([sys.executable, "-c", REF_CODE,
                             json.dumps(cells)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = [dryrun.run_cell(a, s, "tiny", smoke_config=True)
                for a, s in cells]
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    ref = json.loads(out.strip().splitlines()[-1])
    return dict(zip(cells, zip(ref, port)))


def check(ref: dict, rec: dict, cell) -> None:
    """One cell's test (the module doc's rules)."""
    if ref["status"] == "skipped":
        assert rec["status"] == "skipped" and cell[1] == "long_500k"
        return
    assert ref["status"] == "ok"
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == ref["chips"] == 4
    assert rec["cost"]["flops_per_device"] + ssd_backward_gap(*cell) == \
        ref["cost"]["flops_per_device"]
    assert rec["memory"]["argument_bytes"] == \
        rec["argument_bytes_per_device"] == \
        ref["memory"]["argument_bytes"] - POS_BYTES[cell[1]]
    coll = sum(rec["collective_bytes"].values())
    print(cell, "collective bytes: port", rec["collective_bytes"],
          "reference", ref["collective_bytes"])
    assert coll > 0 and rec["roofline"]["collective_s"] > 0
    assert rec["peak_bytes"] <= 80e9 and rec["fits_hbm"]
