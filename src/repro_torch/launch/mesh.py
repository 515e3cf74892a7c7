"""Meshes of the port (the port of ``src/repro/launch/mesh.py``).

Functions, so importing this module touches no device state.  A mesh is
``dist.sharding.Mesh``: ``torch.device`` s on named axes.  On ``cuda`` it
takes the first n devices, or raises ``DeviceCountError`` naming the
count; on ``cpu`` every entry is the CPU (the analogue of the reference's
fake CPU devices).  One process drives every device of a mesh: the
compressed DP step, ``launch.train --mesh`` and MoE's shard_map path run
each shard in turn; the dry-run counts one device's share on DTensors.
"""
from __future__ import annotations

from ..dist.sharding import DistSpec, Mesh, resolve_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> Mesh:
    """16 x 16 (one pod, 256 devices) or 2 x 16 x 16 (two pods, 512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes`` on ``device``'s type."""
    return resolve_mesh(DistSpec(tuple(shape), tuple(axes)), device)
