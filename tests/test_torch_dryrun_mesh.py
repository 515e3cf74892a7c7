"""The port's dry-run under a mesh of more than one device (DTensors of
``meta`` blocks over a fake process group, ``launch/dryrun.py``) against
the reference's on 8 fake CPU devices (its SPMD-partitioned HLO), on the
CPU.

For qwen2-1.5b and moonshot-v1-16b-a3b x ``train_4k`` and ``decode_32k``
at ``--smoke-config`` under ``tiny`` (2 x 2), read in one reference
subprocess:

* ``flops_per_device`` is the reference's exactly (40,894,464; 212,992;
  106,168,320; 1,732,608): every product is split as GSPMD splits it;
* the argument bytes per device are the reference's ``memory.
  argument_bytes``, less 4 bytes in the decode cells: the cache's ``pos``
  is a host int in the port and an int32 array in the reference;
* the collective bytes are nonzero (printed beside the reference's, not
  held equal: DTensor's redistributions are not XLA's).

``tiny_multi`` (2 x 2 x 2) exits 0, and no process group outlives a
cell.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a in ("qwen2-1.5b", "moonshot-v1-16b-a3b")
         for s in ("train_4k", "decode_32k")]
# bytes a port record holds fewer of: the decode cache's int32 ``pos``
POS_BYTES = {"train_4k": 0, "decode_32k": 4}

REF_CODE = r"""
import json, sys
from repro.launch.dryrun import run_cell
cells = json.loads(sys.argv[1])
print(json.dumps([run_cell(a, s, "tiny", smoke_config=True)
                  for a, s in cells]))
"""


@pytest.fixture(scope="module")
def records():
    """(reference record, port record) per cell; the reference runs in a
    subprocess while the port counts its cells here."""
    env = dict(os.environ)
    env["REPRO_DRYRUN_XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.Popen([sys.executable, "-c", REF_CODE,
                             json.dumps(CELLS)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = [dryrun.run_cell(a, s, "tiny", smoke_config=True)
                for a, s in CELLS]
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    ref = json.loads(out.strip().splitlines()[-1])
    return dict(zip(CELLS, zip(ref, port)))


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_tiny_mesh_per_device_costs_match_reference(records, cell):
    ref, rec = records[cell]
    assert ref["status"] == "ok"
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == ref["chips"] == 4
    assert rec["cost"]["flops_per_device"] == \
        ref["cost"]["flops_per_device"]
    assert rec["memory"]["argument_bytes"] == \
        rec["argument_bytes_per_device"] == \
        ref["memory"]["argument_bytes"] - POS_BYTES[cell[1]]
    coll = sum(rec["collective_bytes"].values())
    print(cell, "collective bytes: port", rec["collective_bytes"],
          "reference", ref["collective_bytes"])
    assert coll > 0 and rec["roofline"]["collective_s"] > 0
    assert rec["peak_bytes"] <= 80e9 and rec["fits_hbm"]


def test_tiny_multi_exits_zero(capsys):
    import torch.distributed as dist
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "prefill_32k",
                        "--mesh", "tiny_multi", "--smoke-config"]) == 0
    assert " ok " in capsys.readouterr().out
    assert not dist.is_initialized()


def test_counter_counts_one_device_of_dtensors():
    """Under DTensors the counter counts the local ops on this rank's
    blocks: a product split over its rows counts a quarter of the whole,
    one with its contraction split counts its local half (the partial
    result's reduction is an all-reduce of the local block's bytes), the
    arguments are the local blocks' bytes, and a plain tensor beside them
    (replicated) counts whole."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.dist.sharding import DistSpec, resolve_mesh
    from repro_torch.roofline import analyze
    mesh = resolve_mesh(DistSpec((2, 2), ("data", "model")), "cpu")

    def dt(shape, placements, dmesh):
        local = [s // 2 if any(p == Shard(i) for p in placements) else s
                 for i, s in enumerate(shape)]
        return DTensor.from_local(torch.empty(local, device="meta"), dmesh,
                                  placements, run_check=False)

    with dryrun.per_device(mesh) as dmesh:
        x = dt((8, 16), [Shard(0), Replicate()], dmesh)
        w = dt((16, 4), [Replicate(), Shard(0)], dmesh)

        def step(x, w):
            y = x @ w                  # contraction split over model
            with implicit_replication():
                z = y.full_tensor() + torch.ones(8, 4, device="meta")
            return z @ torch.ones(4, 2, device="meta")

        cost = analyze(step, x, w)
    assert cost.argument_bytes == (4 * 16 + 8 * 4) * 4
    # the local product: (4, 8) @ (8, 4); then the plain (8, 4) @ (4, 2)
    assert cost.flops["fp32"] == 2 * 4 * 8 * 4 + 2 * 8 * 4 * 2
    assert cost.collective_bytes["all-reduce"] == 4 * 4 * 4
    assert cost.collective_bytes["all-gather"] == 4 * 4 * 4
