"""``shard_map`` in one process: one body per shard, two drivers (the port
of the reference's ``jax.experimental.shard_map``, which its
``models/moe.py`` uses).

A *body* is a generator function of one shard's blocks.  It yields each
collective it needs as a request (:func:`all_gather`, :func:`psum`,
:func:`pmean`, :func:`axis_index`), receives the answer, and returns its
outputs.  :func:`shard_map` runs it under one of two drivers:

* **plain tensors**: every shard of the mesh, in lock step and in shard
  order (C order over the mesh's axes, ``Mesh.flat``).  Each shard's
  blocks are cut by ``in_specs`` and moved to its device; at each request
  the driver answers every shard from its group (the shards that differ
  only on the request's axes): ``psum`` adds the group's partials in shard
  order on the first member's device, ``all_gather`` concatenates them.
  The outputs' blocks are reassembled by ``out_specs``.
* **DTensors** (the dry-run's per-device count, ``launch/dryrun.py``):
  ``local_map`` over the DTensors' ``DeviceMesh``.  This process is one
  rank and runs its own shard only; the requests become
  ``torch.distributed`` functional collectives, so the operation counter
  sees each one with its bytes.  An input's gradient is partial on every
  mesh axis it is not split over: each shard's share of it differs.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from .sharding import (NamedSharding, ShardedLeaf, entry_size, is_dtensor,
                       placements)


def all_gather(t: torch.Tensor, axis: str, dim: int):
    """Request: ``t``'s blocks over mesh axis ``axis``, concatenated along
    ``dim`` (``lax.all_gather(..., tiled=True)``)."""
    return ("all_gather", t, axis, dim)


def psum(t: torch.Tensor, axes):
    """Request: the sum of ``t`` over the mesh axes ``axes``."""
    return ("psum", t, _axes(axes))


def pmean(t: torch.Tensor, axes):
    """Request: the mean of ``t`` over the mesh axes ``axes``."""
    return ("pmean", t, _axes(axes))


def axis_index(axis: str):
    """Request: this shard's coordinate on mesh axis ``axis``."""
    return ("axis_index", axis)


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def shard_map(body: Callable, mesh, in_specs: Sequence, out_specs: Sequence,
              args: Sequence) -> tuple:
    """Run ``body`` over ``mesh`` on ``args`` split by ``in_specs`` (one
    spec tuple per argument); its outputs are placed by ``out_specs``.
    DTensor arguments (all of them DTensors) take the ``local_map``
    driver, plain ones the lock-step loop."""
    if any(is_dtensor(a) for a in args):
        return _local_map(body, mesh, in_specs, out_specs, args)
    return _lock_step(body, mesh, in_specs, out_specs, args)


# -- plain tensors: every shard in this process ------------------------------

def _lock_step(body, mesh, in_specs, out_specs, args) -> tuple:
    devs = mesh.flat
    coords = [dict(zip(mesh.axis_names, map(int, np.unravel_index(
        i, mesh.devices.shape)))) for i in range(len(devs))]
    gens = [body(*[a[NamedSharding(mesh, spec).block_slices(a.shape, i)]
                   .to(dev) for a, spec in zip(args, in_specs)])
            for i, dev in enumerate(devs)]
    answers: list = [None] * len(gens)
    while True:
        reqs, outs = [], []
        for g, answer in zip(gens, answers):
            try:
                reqs.append(g.send(answer))
            except StopIteration as stop:
                outs.append(stop.value)
        if outs:
            if reqs:
                raise RuntimeError("the shards of a shard_map body left it "
                                   "at different collectives")
            break
        answers = _answer(reqs, coords, devs)
    result = []
    for k, spec in enumerate(out_specs):
        blocks = tuple(o[k] for o in outs)
        sh = NamedSharding(mesh, tuple(spec))
        shape = tuple(b * entry_size(mesh, e) for b, e in zip(
            blocks[0].shape, tuple(spec) + (None,) * blocks[0].ndim))
        result.append(ShardedLeaf(sh, shape, blocks).full())
    return tuple(result)


def _answer(reqs: list, coords: list, devs: list) -> list:
    kind = reqs[0][0]
    if any(r[0] != kind for r in reqs):
        raise RuntimeError(f"shard_map body: shards asked for different "
                           f"collectives ({sorted({r[0] for r in reqs})})")
    if kind == "axis_index":
        return [c[r[1]] for r, c in zip(reqs, coords)]
    axes = (reqs[0][2],) if kind == "all_gather" else reqs[0][2]
    groups: dict = {}
    for i, c in enumerate(coords):
        key = tuple(v for a, v in c.items() if a not in axes)
        groups.setdefault(key, []).append(i)
    out: list = [None] * len(reqs)
    for members in groups.values():
        ts = [reqs[i][1] for i in members]
        dev = ts[0].device
        if kind == "all_gather":
            r = torch.cat([t.to(dev) for t in ts], dim=reqs[0][3])
        else:
            r = ts[0]
            for t in ts[1:]:
                r = r + t.to(dev)
            if kind == "pmean":
                r = r / len(ts)
        for i in members:
            out[i] = r.to(devs[i])
    return out


# -- DTensors: this rank's shard, functional collectives ---------------------

class _AllReduceSum(torch.autograd.Function):
    """``psum`` of one shard's partial: the output is replicated over the
    group and each partial enters it once, so the gradient passes through
    unchanged."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed._functional_collectives as fc
        out = fc.all_reduce(t, "sum", group)
        return out.wait() if hasattr(out, "wait") else out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _collective(req, dmesh):
    import torch.distributed._functional_collectives as fc
    names = tuple(dmesh.mesh_dim_names)
    kind = req[0]
    if kind == "axis_index":
        return dmesh.get_local_rank(names.index(req[1]))
    if kind == "all_gather":
        _, t, axis, dim = req
        gather = getattr(fc, "all_gather_single_autograd", None) \
            or fc.all_gather_tensor_autograd
        out = gather(
            t, gather_dim=dim, group=(dmesh, names.index(axis)))
        return out.wait() if hasattr(out, "wait") else out
    _, t, axes = req
    for a in axes:
        t = _AllReduceSum.apply(t, (dmesh, names.index(a)))
    if kind == "pmean":
        t = t / math.prod(dmesh.size(names.index(a)) for a in axes)
    return t


def _local_map(body, mesh, in_specs, out_specs, args) -> tuple:
    from torch.distributed.tensor import DTensor, Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    dmesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    if tuple(dmesh.mesh_dim_names) != tuple(mesh.axis_names):
        raise ValueError(f"DTensor mesh axes {dmesh.mesh_dim_names} are not "
                         f"the active mesh's {mesh.axis_names}")
    in_pl = [tuple(placements(NamedSharding(mesh, tuple(s))))
             for s in in_specs]
    grad_pl = [tuple(p if isinstance(p, Shard) else Partial() for p in pl)
               for pl in in_pl]
    out_pl = [tuple(placements(NamedSharding(mesh, tuple(s))))
              for s in out_specs]

    def local(*blocks):
        g = body(*blocks)
        answer = None
        while True:
            try:
                req = g.send(answer)
            except StopIteration as stop:
                return stop.value
            answer = _collective(req, dmesh)

    fn = local_map(local, out_placements=tuple(out_pl),
                   in_placements=tuple(in_pl),
                   in_grad_placements=tuple(grad_pl), device_mesh=dmesh,
                   redistribute_inputs=True)
    return tuple(fn(*args))
