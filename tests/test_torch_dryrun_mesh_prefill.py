"""The port's per-device dry-run under ``tiny`` (2 x 2) against the
reference's at every arch's ``prefill_32k`` at --smoke-config, on the CPU:
the rules of ``tests/dryrun_mesh_grid.py`` (FLOPs per device exactly the
reference's, argument bytes per device the reference's, collectives
nonzero).  The other shapes are in
``test_torch_dryrun_mesh.py`` and ``_long.py``."""
import pytest

import dryrun_mesh_grid as grid

CELLS = grid.cells("prefill_32k")


@pytest.fixture(scope="module")
def records():
    return grid.records(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids=grid.ids(CELLS))
def test_tiny_mesh_per_device_costs_match_reference(records, cell):
    grid.check(*records[cell], cell)
