"""The port's dry-run under a mesh of more than one device (DTensors of
``meta`` blocks over a fake process group, ``launch/dryrun.py``) against
the reference's on 8 fake CPU devices (its SPMD-partitioned HLO), on the
CPU.

Every arch at ``train_4k`` and ``decode_32k`` at ``--smoke-config`` under
``tiny`` (2 x 2), read in one reference subprocess, holds the rules of
``tests/dryrun_mesh_grid.py`` (``prefill_32k`` and ``long_500k`` are in
``test_torch_dryrun_mesh_prefill.py`` and ``_long.py``): FLOPs per
device exactly the reference's (the SSM steps but for the SSD's backward
reductions), argument bytes per device the reference's, collectives
nonzero.

The port's partitioner holds on its own (:func:`test_merged_split_view_
is_placed_by_the_port`): a view that merges two split dimensions keeps
both splits when the blocks stay contiguous and gathers the minor one
when they would be strided, whatever the installed DTensor's view
strategy does.  ``tiny_multi`` (2 x 2 x 2) exits 0, and no process group
outlives a cell.
"""
import pytest

import dryrun_mesh_grid as grid
from repro_torch.launch import dryrun

CELLS = grid.cells("train_4k", "decode_32k")


@pytest.fixture(scope="module")
def records():
    return grid.records(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids=grid.ids(CELLS))
def test_tiny_mesh_per_device_costs_match_reference(records, cell):
    grid.check(*records[cell], cell)


def test_ssd_gap_is_the_one_device_gap_split_four_ways():
    """The SSM training cells' allowance is the documented one-device gap
    (524,288 FLOPs of the smoke mamba2 step, the same rule at mesh
    ``one``) over the batch's 2-way and the SSM heads' 2-way split; every
    other cell has none."""
    from repro_torch.testing import ssd_backward_gap as gap
    assert gap("mamba2-370m", "train_4k", "one") == 524_288
    assert gap("mamba2-370m", "train_4k") == 524_288 // 4
    assert gap("zamba2-1.2b", "train_4k") == 2 * 524_288 // 4
    assert gap("mamba2-370m", "decode_32k") == 0
    assert gap("qwen2-1.5b", "train_4k") == 0


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


@pytest.mark.parametrize("batch", [2, 4])
def test_merged_split_view_is_placed_by_the_port(batch):
    """A (B, H, S, E) DTensor split over ``data`` on B and over ``model``
    on H, flattened to (B·H, S, E) and through a ``bmm``: with one row of
    B on a device (B = 2) the merged dimension keeps both splits (a
    contiguous quarter of B·H on each device, no collective); with two (B
    = 4) the ``model`` split would be strided, so the view gathers H over
    ``model`` first (one all-gather of the block) and keeps ``data``'s.
    The placements are the port's rule (``launch/dryrun.py``
    ``_view_placements``), not the installed DTensor's view strategy:
    torch 2.13's keeps a strided shard there, torch 2.11's gathers."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.dist.sharding import DistSpec, resolve_mesh
    from repro_torch.roofline import analyze
    heads, seq, emb = 4, 8, 16
    mesh = resolve_mesh(DistSpec((2, 2), ("data", "model")), "cpu")
    seen = {}

    def step(x):
        flat = x.reshape(batch * heads, seq, emb)
        seen["placements"] = tuple(flat.placements)
        seen["block"] = tuple(flat.to_local().shape)
        return torch.bmm(flat, flat.transpose(1, 2))

    with dryrun.per_device(mesh) as dmesh:
        block = torch.empty(batch // 2, heads // 2, seq, emb, device="meta")
        x = DTensor.from_local(block, dmesh, [Shard(0), Shard(1)],
                               run_check=False)
        cost = analyze(dryrun._on_dtensors(step), x)
    rows = batch * heads // 4 if batch == 2 else batch * heads // 2
    assert seen["block"] == (rows, seq, emb)
    assert seen["placements"] == ((Shard(0), Shard(0)) if batch == 2
                                  else (Shard(0), Replicate()))
    assert cost.flops["fp32"] == 2 * rows * seq * emb * seq
    gathered = 0 if batch == 2 else block.numel() * 4
    assert cost.collective_bytes["all-gather"] == gathered
    assert sum(cost.collective_bytes.values()) == gathered
