"""Dry-run: count every (arch × shape × mesh) cell on ``meta`` tensors (the
port of ``src/repro/launch/dryrun.py``).

For each cell this produces, with zero device allocation:
  * the memory a step holds: argument, temporary, output and aliased
    bytes and their peak (``roofline.op_counter``'s live-storage count in
    place of ``compiled.memory_analysis()``) — does the cell fit one card?
  * FLOPs of the matrix products by dtype and bytes touched (the counter
    in place of the HLO analyzer), collective bytes,
  * the arguments' bytes on one device under the sharding policy
    (``shardspec.tree_shardings``, the reference's ``in_shardings``;
    every one read at mesh ``one``),
  * the three roofline terms against one H100 SXM, the dominant one and
    the MODEL_FLOPS ratio.  The memory term reads the bytes the step must
    move (``OpCost.moved_bytes``: arguments read, new outputs written),
    not the eager ops' bytes, which exceed XLA's fused bytes and move
    with the implementation; their time is beside it as ``eager_bytes_s``.

The state, the inputs (``launch/inputs.py``) and the decode cache are
built on ``meta``, and the train step, the prefill or the decode step runs
once under the counter: eager torch has no trace without a run, so
``lower_s`` is the seconds of that meta run and ``compile_s`` is 0.

Meshes: ``one`` (the default) is the 1 × 1 ``("data", "model")`` mesh, the
one mesh a single card holds.  ``single`` (16 × 16), ``multi`` (2 × 16 ×
16), ``tiny`` (2 × 2) and ``tiny_multi`` (2 × 2 × 2) are the reference's
meshes of more than one device (``both`` runs ``single`` and ``multi``).
Under them a record is one device's: where the reference reads XLA's
SPMD-partitioned HLO, the port runs the step on DTensors (``per_device``):
this process is rank 0 of a fake process group as large as the mesh, each
argument is a DTensor of ``meta`` blocks placed as
``shardspec.tree_shardings`` says, and the counter counts device 0's local
ops and the collectives that redistribution issues.  Where the counts
depend on it, the split is the port's own rule, GSPMD's, not the installed
DTensor's strategy, so every torch version counts the same: einsums and
matrix products run as ``dot_general`` s (:class:`_Products`); views,
embedding lookups, pads, flips and elementwise ops whose operands split
different dimensions over one axis are placed below autograd
(:class:`_Reshard`); a product whose output a later op splits over an
axis the product left idle is split there in a second pass
(:class:`_Consumers`).  DTensor propagates the rest (under
``implicit_replication``: a tensor the model makes, such as positions, is
replicated).  An argument no op reads is left out of the argument bytes,
as ``jax.jit`` drops it.  The group is set up and torn down around each
cell.

Usage:
  python -m repro_torch.launch.dryrun --arch all --shape all \
      --out experiments/dryrun/one.json
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k \
      --mesh tiny --smoke-config
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b,mamba2-370m \
      --shape train_4k,decode_32k --smoke-config
"""
import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_IDS, SHAPES, get_config, get_shape
from ..configs.shapes import ShapeConfig
from ..dist.sharding import is_dtensor, logical_axis_rules, placements
from ..models import forward, init_cache, init_params
from ..models.config import ModelConfig
from ..roofline.analysis import roofline_terms
from ..roofline.hw import H100_SXM
from ..roofline.op_counter import analyze
from ..serving.decode import build_serve_step
from ..training import (AdamWConfig, TrainState, TrainStepConfig,
                        adamw_init, build_train_step)
from ..training.train_state import prng_key
from .inputs import input_specs
from .mesh import make_mesh, make_production_mesh
from .shardspec import (_map_with_path, batch_logical_axes,
                        cache_logical_axes, device_bytes, keystr,
                        moe_rules_patch, param_logical_axes, rules_for,
                        tree_flatten_with_path, tree_shardings)

BIG_PARAM_THRESHOLD = 50e9    # bf16 optimizer moments above this
MESHES = ("one", "single", "multi", "tiny", "tiny_multi")


def _mesh_for(kind: str):
    """The mesh of ``--mesh kind``, of CPU devices: the dry-run counts on
    ``meta`` and moves nothing."""
    if kind == "one":
        return make_mesh((1, 1), ("data", "model"), device="cpu")
    if kind == "single":
        return make_production_mesh(device="cpu")
    if kind == "multi":
        return make_production_mesh(multi_pod=True, device="cpu")
    if kind == "tiny":
        return make_mesh((2, 2), ("data", "model"), device="cpu")
    if kind == "tiny_multi":
        return make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    raise ValueError(kind)


@contextlib.contextmanager
def per_device(mesh):
    """This process as rank 0 of a fake process group as large as
    ``mesh`` (its collectives move nothing), for the enclosed region;
    yields the DTensor ``DeviceMesh`` over it.  Torn down on exit, so no
    group outlives the region."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry-run's per-device count needs its own")
    n = int(mesh.devices.size)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield DeviceMesh("cpu", torch.arange(n).reshape(mesh.devices.shape),
                         mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()


def as_dtensors(tree, shardings, dmesh):
    """``tree`` with each tensor leaf a DTensor of ``meta`` blocks, placed
    as its ``shardings`` entry says (``dist.sharding.placements``)."""
    from torch.distributed.tensor import DTensor
    by_path = {keystr(p): sh for p, sh in tree_flatten_with_path(shardings)}

    def leaf(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        sh = by_path[keystr(path)]
        block = torch.empty(sh.shard_shape(x.shape), dtype=x.dtype,
                            device="meta")
        return DTensor.from_local(block, dmesh, placements(sh),
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())

    return _map_with_path(leaf, tree)


def _as_dtensor(x, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _wrap(local, mesh, placements):
    """The DTensor of this device's ``local`` block (its global shape and
    strides follow the block's, every split even)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements, run_check=False)


class _Consumers:
    """GSPMD's backward propagation, in the one case the counts see: a
    product that leaves a mesh axis idle (no operand splits anything over
    it) could split a free index over it for free (slicing the replicated
    operand that has it), and GSPMD does where a later op splits that
    value there.  Eager ops cannot look ahead, so the step runs again:
    each pass follows every such free index (``origins``: a tensor's
    dimension -> (product, index, idle axes)) through elementwise ops,
    views and later products, and an op that slices that dimension over
    one of those axes asks for it (``asked``); the next pass splits those
    products so (``split``).  Products are numbered in call order, which
    the placements do not change."""

    def __init__(self, split=frozenset()):
        from torch.utils.weak import WeakIdKeyDictionary
        self.split = split
        self.asked: set = set()
        self.origins = WeakIdKeyDictionary()
        self.products = 0

    def of(self, x) -> dict:
        return self.origins.get(x, {}) if is_dtensor(x) else {}

    def sliced(self, x, d: int, m: int) -> None:
        """``x``'s dimension ``d``, whole on axis ``m``, is split there."""
        origin = self.of(x).get(d)
        if origin is not None and m in origin[2]:
            self.asked.add((origin[0], origin[1], m))

    def follow(self, x, out, dims: dict) -> None:
        """``out`` takes ``x``'s origins through ``dims`` (its dimension
        -> ``out``'s); a dimension ``x`` held whole on an axis that
        ``out`` splits asks for that split."""
        from torch.distributed.tensor import Replicate, Shard
        if not self.of(x) or not is_dtensor(out):
            return
        got = self.origins.setdefault(out, {})
        for d, origin in self.of(x).items():
            if dims.get(d) is None:
                continue
            got.setdefault(dims[d], origin)
            for m, (p, q) in enumerate(zip(x.placements, out.placements)):
                if isinstance(p, Replicate) and q == Shard(dims[d]):
                    self.sliced(x, d, m)


def _dot(spec: str, a, b, consumers):
    """``torch.einsum(spec, a, b)`` for two operands, split over the mesh
    as GSPMD splits a ``dot_general`` (the port's rule, whatever the
    installed DTensor's product strategies are):

    * a partial operand is reduced first;
    * each mesh axis keeps the index that an operand splits over it (an
      index of both operands is split in both; an operand without it is
      sliced, which moves nothing); where the two operands split different
      indices over one axis, the larger operand keeps its split (on a tie
      the second, the newer intermediate of a contraction path) and the
      other is resharded;
    * an axis that splits a contracted index leaves the product partial,
      and it is reduced at once, as GSPMD reduces at the dot; a mesh axis
      that splits nothing then splits the first operand's rows (its first
      free index it divides), which its replicated operands allow for
      free, and the rows go back to that axis whole after the product;
    * a mesh axis that a later op splits a free index over (``consumers``,
      :class:`_Consumers`) splits it here;
    * the local einsum runs on this device's blocks, so the counter counts
      one device's FLOPs."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    index = consumers.products
    consumers.products += 1
    mesh = (a if is_dtensor(a) else b).device_mesh
    given = (a, b)
    a, b = (_reduced(_as_dtensor(x, mesh)) for x in (a, b))
    ins, out = spec.split("->")
    la, lb = ins.split(",")
    size = dict(zip(la, a.shape)) | dict(zip(lb, b.shape))

    def split(x, letters, m):
        p = x.placements[m]
        return letters[p.dim] if isinstance(p, Shard) else None

    plan, ways = [], dict.fromkeys(size, 1)

    def take(m, letters):
        n = mesh.size(m)
        c = next((c for c in letters
                  if c and size[c] % (ways[c] * n) == 0), None)
        if c:
            ways[c] *= n
        return c

    free = [c for c in out if (c in la) != (c in lb)]
    for m in range(mesh.ndim):
        sa, sb = split(a, la, m), split(b, lb, m)
        order = (sa, sb) if a.numel() > b.numel() else (sb, sa)
        plan.append(take(m, order) or take(m, [
            c for c in free if (index, c, m) in consumers.split]))
    idle = []
    if any(c and c not in out for c in plan):
        rows = [c for c in out if c in la and c not in lb]
        idle = [m for m, c in enumerate(plan) if c is None]
        plan = [c or take(m, rows) for m, c in enumerate(plan)]

    def target(letters):
        return [Shard(letters.index(c)) if c and c in letters
                else Replicate() for c in plan]

    def grads(letters):
        # a replicated operand's gradient is partial where the product's
        # other operand splits a free index
        return [Partial() if c and c in out and c not in letters else p
                for c, p in zip(plan, target(letters))]

    xa = a.redistribute(mesh, target(la)).to_local(grad_placements=grads(la))
    xb = b.redistribute(mesh, target(lb)).to_local(grad_placements=grads(lb))
    y = torch.einsum(spec, xa, xb)
    placements = [Shard(out.index(c)) if c and c in out
                  else Partial() if c else Replicate() for c in plan]
    y = _wrap(y, mesh, placements)
    if any(isinstance(placements[m], Shard) for m in idle):
        # the rows go back where the product's operands left them
        y = y.redistribute(mesh, [Replicate() if m in idle else p
                                  for m, p in enumerate(placements)])
    y = _reduced(y)
    for x, letters in zip(given, (la, lb)):
        for m, p in enumerate(target(letters) if is_dtensor(x) else ()):
            if isinstance(p, Shard) and m not in idle \
                    and not isinstance(x.placements[m], Shard):
                consumers.sliced(x, p.dim, m)
        consumers.follow(x, y, {d: out.index(c) for d, c in enumerate(letters)
                                if c in out})
    unsplit = frozenset(m for m, c in enumerate(plan) if c is None)
    if unsplit:
        got = consumers.origins.setdefault(y, {})
        for c in free:
            got.setdefault(out.index(c), (index, c, unsplit))
    return y


def _path(spec: str, shapes: list) -> list:
    """The pairwise contraction order of an einsum: ``opt_einsum``'s
    ``auto`` path, as ``torch.einsum`` and ``jnp.einsum`` take it (each
    step removes a pair and appends its result)."""
    if len(shapes) == 2:
        return [(0, 1)]
    import opt_einsum
    return opt_einsum.contract_path(spec, *shapes, shapes=True,
                                    optimize="auto")[0]


def _einsum(spec: str, ops, consumers):
    """``torch.einsum`` of DTensors as pairwise :func:`_dot` s, or None
    where the port's rule does not apply (an ellipsis, one operand)."""
    spec = spec.replace(" ", "")
    if "..." in spec or "->" not in spec or len(ops) < 2:
        return None
    ins, out = spec.split("->")
    items = list(zip(ins.split(","), ops))
    for i, j in _path(spec, [tuple(x.shape) for x in ops]):
        (si, xi), (sj, xj) = items[i], items[j]
        items = [it for k, it in enumerate(items) if k not in (i, j)]
        keep = set(out).union(*(s for s, _ in items))
        so = out if not items else "".join(
            dict.fromkeys(c for c in si + sj if c in keep))
        items.append((so, _dot(f"{si},{sj}->{so}", xi, xj, consumers)))
    return items[0][1]


def _matmul(a, b, consumers):
    """``a @ b`` (or ``bmm``) of DTensors as a :func:`_dot` (the
    reference's ``@`` is a ``dot_general`` over the free dimensions;
    torch's folds them first): a matrix on the right, or equal batch
    dimensions; None for another broadcast (DTensor takes it)."""
    if b.ndim == 2 and a.ndim >= 1:
        rows = "abcdefghij"[:a.ndim - 1]
        return _dot(f"{rows}k,kn->{rows}n", a, b, consumers)
    if a.ndim == b.ndim >= 3 and a.shape[:-2] == b.shape[:-2]:
        batch = "abcdefghij"[:a.ndim - 2]
        return _dot(f"{batch}mk,{batch}kn->{batch}mn", a, b, consumers)
    return None


def _view_groups(in_shape, out_shape) -> list:
    """The view's dimension groups: (input dims, output dims) of equal
    products, size-1 dimensions left out (they are never split)."""
    ins = [d for d, n in enumerate(in_shape) if n != 1]
    outs = [d for d, n in enumerate(out_shape) if n != 1]
    groups, i, j = [], 0, 0
    while i < len(ins):
        gi, gj = [ins[i]], [outs[j]]
        pi, pj = in_shape[ins[i]], out_shape[outs[j]]
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj:
                gi.append(ins[i])
                pi, i = pi * in_shape[ins[i]], i + 1
            else:
                gj.append(outs[j])
                pj, j = pj * out_shape[outs[j]], j + 1
        groups.append((gi, gj))
    return groups


def _view_placements(in_shape, placements, out_shape, sizes) -> tuple:
    """The port's rule for a view of a split tensor (GSPMD's reshape
    sharding, whatever the installed DTensor's view strategy is): within
    each group of dimensions the view merges or splits, the mesh axes
    that split it (major dimension first, each dimension's axes in mesh
    order) cut its flat range into contiguous chunks, and the view keeps
    each cut that lands on an output dimension it divides.  A cut that
    would be strided (a more major dimension of the group still has more
    than one element on a device, an axis out of mesh order, an output
    dimension it does not divide) is gathered, and so is every later cut
    of that group.  Returns (the input's placements with those axes
    gathered, the output's placements)."""
    from torch.distributed.tensor import Replicate, Shard
    kept, out = list(placements), list(placements)
    for gi, gj in _view_groups(in_shape, out_shape):
        cuts, major, last, clean = [], 1, -1, True
        for d in gi:
            axes = [m for m, p in enumerate(placements)
                    if isinstance(p, Shard) and p.dim == d]
            for m in axes:
                clean = clean and major == 1 and m > last
                if clean:
                    cuts.append(m)
                    last = m
                else:
                    kept[m] = out[m] = Replicate()
            ways = math.prod(sizes[m] for m in axes if m in cuts)
            major *= in_shape[d] // ways
        local = {d: out_shape[d] for d in gj}
        k, clean = 0, True
        for m in cuts:
            while k < len(gj) and local[gj[k]] == 1:
                k += 1
            clean = clean and k < len(gj) and local[gj[k]] % sizes[m] == 0
            if clean:
                local[gj[k]] //= sizes[m]
                out[m] = Shard(gj[k])
            else:
                kept[m] = out[m] = Replicate()
    return kept, out


class _Reshard(TorchDispatchMode):
    """The port's partitioner below autograd, where the reference's
    GSPMD and the installed DTensor could split differently:

    * a view of a DTensor is placed by :func:`_view_placements`, never by
      DTensor's view strategy (torch 2.11's gathers a merge of two split
      dimensions where 2.13's keeps a strided shard);
    * a constant pad or a flip runs on this device's block, the padded
      or flipped dimensions gathered first (torch 2.11's pad strategy
      fails on the SSM's causal conv, and it has none for the flip in
      ``cumsum``'s backward);
    * an embedding lookup (``index`` on dimension 0) of a table split over
      its rows is a masked local gather reduced over those axes, as
      GSPMD's gather (DTensor would move the table);
    * a masked partial output (a gather over a split vocabulary) is
      reduced at once: DTensor loses its mask through a later view
      (``gather(...)[..., 0]``) and fails where it reduces;
    * any other op whose sharding DTensor cannot propagate (torch 2.11's
      ``index_put`` strategy, an embedding's backward, fails on its own
      negative dimension) runs on its inputs gathered whole;
    * a matrix product that reaches this level (the products the
      function-level rule, :func:`_einsum` / :func:`_matmul`, did not
      take) takes no partial operand: it is reduced first.

    All are redistributions, so the counter below counts their
    collectives."""

    def __init__(self, consumers):
        super().__init__()
        self.consumers = consumers

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _view_ops() and is_dtensor(args[0]):
            out = self._view(func, *args, **kwargs)
            if out is not None:
                groups = _view_groups(tuple(args[0].shape), tuple(out.shape))
                self.consumers.follow(args[0], out, {
                    gi[0]: gj[0] for gi, gj in groups
                    if len(gi) == len(gj) == 1})
                return out
        if func is torch.ops.aten.index.Tensor and is_dtensor(args[0]):
            out = self._lookup(func, *args)
            if out is not None:
                return out
        if func is torch.ops.aten.constant_pad_nd.default \
                and is_dtensor(args[0]):
            return self._pad(func, *args, **kwargs)
        if func is torch.ops.aten.flip.default and is_dtensor(args[0]):
            return self._flip(func, *args)
        if func._overloadpacket in flop_registry:
            args = tuple(_reduced(_below(a)) for a in args)
        elif torch.Tag.pointwise in func.tags:
            given = args
            args = _first_split_wins(args)
        try:
            out = func(*args, **kwargs)
        except RuntimeError as e:
            if ("Sharding propagation failed" in str(e)
                    and not func._schema.is_mutable):
                out = func(*tree_map(_whole, args),
                           **tree_map(_whole, kwargs))
            else:
                raise
        if is_dtensor(out) and any(type(p).__name__.endswith("MaskPartial")
                                   for p in out.placements):
            from torch.distributed.tensor import Replicate
            out = _below(out).redistribute(out.device_mesh, [
                Replicate() if type(p).__name__.endswith("MaskPartial")
                else p for p in out.placements])
        if torch.Tag.pointwise in func.tags and is_dtensor(out):
            for x in given:
                if is_dtensor(x):
                    lead = out.ndim - x.ndim
                    self.consumers.follow(x, out, {
                        d: d + lead for d in range(x.ndim)
                        if x.shape[d] == out.shape[d + lead]})
        return out

    @staticmethod
    def _view(func, x, shape):
        from torch.distributed.tensor import Partial, Replicate, Shard
        if any(type(p) not in (Shard, Replicate, Partial)
               for p in x.placements):
            return None
        mesh = x.device_mesh
        shape = list(shape)
        if -1 in shape:
            shape[shape.index(-1)] = x.numel() // -math.prod(shape)
        sizes = [mesh.size(m) for m in range(mesh.ndim)]
        kept, out = _view_placements(tuple(x.shape), x.placements, shape,
                                     sizes)
        if kept != list(x.placements):
            x = _below(x).redistribute(mesh, kept)
        local = list(shape)
        for m, p in enumerate(out):
            if isinstance(p, Shard):
                local[p.dim] //= sizes[m]
        return _wrap(func(x._local_tensor, local), mesh, out)

    @staticmethod
    def _pad(func, x, pad, value=0):
        from torch.distributed.tensor import Replicate, Shard
        padded = {x.ndim - 1 - i // 2 for i, n in enumerate(pad) if n}
        want = [Replicate() if p.is_partial() or (
            isinstance(p, Shard) and p.dim in padded) else p
            for p in x.placements]
        if want != list(x.placements):
            x = _below(x).redistribute(x.device_mesh, want)
        return _wrap(func(x._local_tensor, pad, value), x.device_mesh, want)

    @staticmethod
    def _flip(func, x, dims):
        from torch.distributed.tensor import Replicate, Shard
        flipped = {d % x.ndim for d in dims}
        want = [Replicate() if isinstance(p, Shard) and p.dim in flipped
                else p for p in x.placements]
        if want != list(x.placements):
            x = _below(x).redistribute(x.device_mesh, want)
        return _wrap(func(x._local_tensor, dims), x.device_mesh, want)

    @staticmethod
    def _lookup(func, table, indices):
        from torch.distributed.tensor import Partial, Replicate, Shard
        if len(indices) != 1 or indices[0] is None:
            return None
        mesh = table.device_mesh
        idx = _as_dtensor(indices[0], mesh)
        placements, masked = [], False
        for pt, pi in zip(table.placements, idx.placements):
            if type(pt) not in (Shard, Replicate) \
                    or type(pi) not in (Shard, Replicate) \
                    or (isinstance(pt, Shard) and isinstance(pi, Shard)):
                return None
            if isinstance(pt, Shard):
                masked |= pt.dim == 0
                placements.append(Partial() if pt.dim == 0
                                  else Shard(idx.ndim + pt.dim - 1))
            else:
                placements.append(pi)
        if not masked:
            return None
        local = func(table._local_tensor, [idx._local_tensor])
        return _reduced(_wrap(local, mesh, placements))


def _first_split_wins(args) -> tuple:
    """The operands of an elementwise op, each split over a mesh axis where
    the first operand that splits that axis splits it (its dimensions
    aligned from the right, as broadcasting aligns them): GSPMD's operand
    order where two operands split different dimensions over one axis
    (DTensor's strategy could keep either)."""
    from torch.distributed.tensor import Replicate, Shard
    ts = [a for a in args if is_dtensor(a)]
    if len(ts) < 2:
        return args
    n = max(t.ndim for t in ts)
    want = {}
    for t in ts:
        for m, p in enumerate(t.placements):
            if isinstance(p, Shard):
                want.setdefault(m, p.dim + n - t.ndim)

    def moved(t):
        pl = list(t.placements)
        for m, d in want.items():
            if isinstance(pl[m], Shard) and pl[m].dim + n - t.ndim != d:
                k = d - (n - t.ndim)
                pl[m] = Shard(k) if 0 <= k and t.shape[k] > 1 \
                    and t.shape[k] % t.device_mesh.size(m) == 0 \
                    else Replicate()
        return t if pl == list(t.placements) else \
            _below(t).redistribute(t.device_mesh, pl)

    return tuple(moved(a) if is_dtensor(a) else a for a in args)


def _below(x):
    """``x`` for a redistribution below autograd (in a dispatch mode): a
    DTensor that requires grad is detached first.  With grad mode off (a
    backward) autograd would detach the redistribution's output in place,
    and torch 2.11's DTensor has no strategy for ``detach_``; autograd
    above the mode records the op whatever its inputs say."""
    return x.detach() if is_dtensor(x) and x.requires_grad else x


def _whole(x):
    """``x`` whole on every device, if it is a DTensor (below autograd)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return _below(x).redistribute(x.device_mesh,
                                  [Replicate()] * x.device_mesh.ndim)


def _reduced(x):
    """``x`` with its partial mesh axes reduced, if it is such a DTensor."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def _view_ops() -> frozenset:
    aten = torch.ops.aten
    return frozenset({aten.view.default, aten._unsafe_view.default})


class _Products(TorchFunctionMode):
    """The function-level half of the port's partitioner: ``torch.einsum``
    and ``@`` / ``matmul`` / ``bmm`` of DTensors run as :func:`_einsum` /
    :func:`_matmul` (GSPMD's ``dot_general`` over the free and batch
    dimensions), before torch folds them into ``bmm`` s through views."""

    def __init__(self, consumers):
        super().__init__()
        self.consumers = consumers

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = None
        if not kwargs:
            if func is torch.einsum:
                ops = args[1:]
                if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                    ops = tuple(ops[0])
                if any(is_dtensor(x) for x in ops):
                    out = _einsum(args[0], ops, self.consumers)
            elif func in _MATMULS and len(args) == 2 \
                    and any(is_dtensor(x) for x in args):
                out = _matmul(*args, self.consumers)
        return func(*args, **kwargs) if out is None else out


_MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
            torch.bmm, torch.Tensor.bmm)


def _on_dtensors(fn, consumers=None):
    """``fn`` under ``implicit_replication`` and the port's partitioner
    (:class:`_Products`, :class:`_Reshard`, sharing ``consumers``)."""
    consumers = consumers or _Consumers()

    def run(*args):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication(), _Products(consumers), \
                _Reshard(consumers):
            return fn(*args)
    return run


def _per_device_cost(fn, args, shardings, dmesh):
    """One device's count of ``fn(*args)`` on DTensors placed as
    ``shardings`` say, and those DTensors: the step runs again while a
    pass finds products that their consumers split (:class:`_Consumers`),
    at most three times."""
    split: set = set()
    for _ in range(3):
        consumers = _Consumers(frozenset(split))
        dargs = as_dtensors(args, shardings, dmesh)
        cost = analyze(_on_dtensors(fn, consumers), *dargs)
        if consumers.asked <= split:
            break
        split |= consumers.asked
    return cost, dargs


def _unread_paths(leaves, cost) -> frozenset:
    """The ``keystr`` paths of the arguments no op read (``jax.jit`` drops
    them, and its argument bytes leave them out)."""
    def storage(t):
        while hasattr(t, "_local_tensor"):
            t = t._local_tensor
        return id(t.untyped_storage())

    return frozenset(keystr(p) for p, t in tree_flatten_with_path(leaves)
                     if isinstance(t, torch.Tensor)
                     and storage(t) in cost.unread_arguments)


def _opt_config(cfg: ModelConfig) -> AdamWConfig:
    big = cfg.num_params_estimate() > BIG_PARAM_THRESHOLD
    return AdamWConfig(m_dtype="bfloat16" if big else "float32",
                       v_dtype="bfloat16" if big else "float32")


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_active = cfg.active_params_estimate()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # decode: one token


def train_step_config(cfg: ModelConfig, shape: ShapeConfig
                      ) -> TrainStepConfig:
    """The microbatch policy (validated against per-cell peak HBM in the
    reference): >100B: 8; >3B or SSM/hybrid (SSD chunk tensors ∝ tokens):
    4; else 1 — and 1 where the batch does not divide; bf16 accumulators
    past 100B."""
    nparams = cfg.num_params_estimate()
    if nparams > 100e9:
        mb = 8
    elif nparams > 3e9 or cfg.ssm is not None:
        mb = 4
    else:
        mb = 1
    if shape.global_batch % mb:
        mb = 1
    accum = "bfloat16" if nparams > 100e9 else "float32"
    return TrainStepConfig(microbatches=mb, accum_dtype=accum)


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: dict):
    """The cell's step function, its ``meta`` arguments and their
    placements under the policy (the reference's ``in_shardings``): (fn,
    args, shardings, chips); ``fn(*args)`` runs the step."""
    specs = input_specs(cfg, shape)
    chips = int(mesh.devices.size)
    params = init_params(torch.Generator(), cfg, device="meta")

    if shape.kind == "train":
        opt_cfg = _opt_config(cfg)
        train_step = build_train_step(cfg, opt_cfg,
                                      train_step_config(cfg, shape))
        state = TrainState.create(params, adamw_init(opt_cfg, params),
                                  prng_key(0, "meta"))
        shardings = (tree_shardings(state, mesh, rules, param_logical_axes),
                     tree_shardings(specs, mesh, rules, batch_logical_axes))
        return train_step, (state, specs), shardings, chips

    in_key = "tokens" if cfg.input_mode == "tokens" else "embeds"
    x = specs[in_key]
    params_sh = tree_shardings(params, mesh, rules, param_logical_axes)
    x_sh = tree_shardings({in_key: x}, mesh, rules,
                          batch_logical_axes)[in_key]
    if shape.kind == "prefill":
        def prefill_step(params, x):
            with torch.no_grad():
                logits, _ = forward(params, cfg, **{in_key: x})
            return logits[:, -1, :].clone()

        return prefill_step, (params, x), (params_sh, x_sh), chips

    # decode: the cache is updated in place (aliased to the output)
    serve_step = build_serve_step(cfg)

    def decode_fn(params, cache, x):
        with torch.no_grad():
            return serve_step(params, cache, **{in_key: x})

    cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    cache_sh = tree_shardings(cache, mesh, rules, cache_logical_axes)
    return decode_fn, (params, cache, x), (params_sh, cache_sh, x_sh), chips


def run_cell(arch: str, shape_name: str, mesh_kind: str = "one",
             smoke_config: bool = False,
             global_batch: int | None = None) -> dict:
    """One cell's record; ``global_batch`` cuts the shape's batch (one
    card's cell of a shape)."""
    cfg = get_config(arch, smoke=smoke_config)
    shape = get_shape(shape_name, smoke=smoke_config)
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=global_batch)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "kind": shape.kind, "global_batch": shape.global_batch}
    if shape_name == "long_500k" and not cfg.supports_long_context:
        rec["status"] = "skipped"
        rec["reason"] = ("pure full-attention arch: long_500k requires "
                         "sub-quadratic attention (DESIGN.md "
                         "§Arch-applicability)")
        return rec
    t0 = time.time()
    try:
        mesh = _mesh_for(mesh_kind)
        rules = moe_rules_patch(cfg, rules_for(cfg, shape, mesh))
        with logical_axis_rules(rules, mesh):
            fn, args, shardings, chips = lower_cell(cfg, shape, mesh, rules)
            if chips == 1:
                cost, leaves = analyze(fn, *args), args
            else:
                with per_device(mesh) as dmesh:
                    cost, leaves = _per_device_cost(fn, args, shardings,
                                                    dmesh)
            arg_bytes = device_bytes(args, shardings,
                                     _unread_paths(leaves, cost))
        t_lower = time.time() - t0
        del fn, args, leaves
        mf = model_flops_for(cfg, shape)
        terms = roofline_terms({"flops": cost.flops_total,
                                "bytes accessed": cost.moved_bytes,
                                "flops_by_dtype": cost.flops},
                               cost.collective_bytes, chips, mf)
        rec.update({
            "status": "ok",
            "chips": chips,
            "lower_s": round(t_lower, 2),
            "compile_s": 0.0,
            "memory": cost.memory(),
            "cost": {"flops_per_device": cost.flops_total,
                     "bytes_per_device": cost.bytes,
                     "moved_bytes_per_device": cost.moved_bytes,
                     "flops_by_dtype": dict(cost.flops)},
            "collective_bytes": dict(cost.collective_bytes),
            "roofline": {
                "compute_s": terms.compute_s,
                "memory_s": terms.memory_s,
                "eager_bytes_s": cost.bytes / H100_SXM.hbm_bw,
                "collective_s": terms.collective_s,
                "dominant": terms.dominant,
                "model_flops": terms.model_flops,
                "hlo_flops_total": terms.hlo_flops_total,
                "useful_flops_fraction": terms.useful_flops_fraction,
                "roofline_fraction": terms.roofline_fraction,
                "step_lower_bound_s": terms.step_time_lower_bound_s,
            },
        })
        rec["peak_bytes"] = cost.peak_bytes
        rec["argument_bytes_per_device"] = arg_bytes
        rec["fits_hbm"] = bool(cost.peak_bytes <= H100_SXM.hbm_bytes)
    except Exception as e:    # noqa: BLE001 — sweep must survive cell bugs
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="one",
                    choices=["one", "single", "multi", "both", "tiny",
                             "tiny_multi"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--smoke-config", action="store_true",
                    help="reduced model configs (CI)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = (["single", "multi"] if args.mesh == "both"
              else [args.mesh])
    for mesh_kind in meshes:
        _mesh_for(mesh_kind)            # raises before any work

    records = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                rec = run_cell(arch, shape, mesh_kind, args.smoke_config)
                records.append(rec)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" dominant={r['dominant']}"
                             f" frac={r['roofline_fraction']:.3f}"
                             f" lower={rec['lower_s']:.1f}s")
                elif status == "error":
                    extra = " " + rec["error"][:160]
                print(f"[dryrun] {arch:24s} {shape:12s} {mesh_kind:6s} "
                      f"{status}{extra}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"[dryrun] wrote {len(records)} records to {args.out}")
    bad = [r for r in records if r["status"] == "error"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
