"""Logical-axis sharding rules plus the engine's corpus-sharding handles
(the port of ``src/repro/dist/sharding.py``).

**Logical-axis rules** (`logical_axis_rules` / `constrain`): model code
names axes ("batch", "heads", ...) and a launcher binds those names to
mesh axes through a rules dict.  With no rules or no mesh active, or on a
mesh of one device, `constrain` returns its input, so single-device
serving pays no sharding tax.  On a mesh of more than one device it
computes the reference's guarded spec (:func:`guarded_spec`): a plain
tensor comes back as it is (one process holds the whole value, as
``with_sharding_constraint`` leaves values alone), and a DTensor (the
dry-run's per-device count, ``launch/dryrun.py``) is redistributed to that
placement.  :class:`NamedSharding` is the placement the sharding policy
(``launch/shardspec.py``) gives a leaf: a mesh and one mesh-axis entry per
dimension; :func:`placements` maps it onto DTensor placements, and
:class:`ShardedLeaf` holds one device's block of a leaf per mesh device
(``checkpoint.restore(..., shardings)``).

``torch.distributed`` is imported only where a DTensor is handled.

**Corpus sharding for distributed hybrid queries:**

The reference is one controller: one process calls ``Statement.execute``
and ``shard_map`` fans the scan out over the devices of a mesh.  The port
keeps that shape in one process: each shard's rows sit on one
``torch.device`` of the mesh, each shard runs the fused kernels on its
device, and the hierarchical merge gathers the (Q, k) candidates of each
mesh axis onto one device, innermost axis first
(``dist/collectives.py``).  On the CPU every shard is the CPU (the
analogue of the reference's fake CPU devices); on the card a mesh of n
shards needs n CUDA devices.

* :class:`DistSpec` is the fingerprintable mesh description that rides
  ``EngineOptions.dist`` (a plan compiled for one mesh misses the plan
  cache on any other);
* :func:`resolve_mesh` turns a spec into a :class:`Mesh` of devices;
* :class:`ShardedCorpus` is the row-sharded corpus handle the catalog
  registers, so every plan on a (table, column) reuses ONE placement.  A
  shard whose rows already sit on its device and need no padding is a
  view of the catalog's tensor: one shard on the card copies nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import sys
import threading
from typing import Any, Mapping, Sequence

import numpy as np
import torch


_STATE = threading.local()


def _stack() -> list:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


@contextlib.contextmanager
def logical_axis_rules(rules: Mapping[str, Any], mesh=None):
    """Activate a logical->mesh axis mapping for the enclosed region (a
    stack per thread; ``mesh`` is a :class:`Mesh` or None)."""
    _stack().append((dict(rules), mesh))
    try:
        yield
    finally:
        _stack().pop()


def current_rules() -> dict | None:
    """The innermost active logical-axis rules dict, or None."""
    s = _stack()
    return s[-1][0] if s else None


def current_mesh():
    """The innermost active mesh bound by logical_axis_rules, or None."""
    s = _stack()
    return s[-1][1] if s else None


def logical_to_spec(logical_axes: Sequence, rules: Mapping[str, Any]) -> tuple:
    """Map logical axis names through the rules to PartitionSpec entries."""
    out = []
    for name in logical_axes:
        entry = rules.get(name) if name is not None else None
        if isinstance(entry, (list, tuple)):
            entry = tuple(entry) if entry else None
        out.append(entry)
    return tuple(out)


def entry_axes(entry) -> tuple:
    """The mesh axes a spec entry (a mesh axis, a tuple of them, or None)
    names, major to minor."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def entry_size(mesh, entry) -> int:
    """The device count a spec entry splits a dimension over."""
    return math.prod(mesh.shape[a] for a in entry_axes(entry))


def guarded_spec(shape: Sequence[int], logical_axes: Sequence, rules,
                 mesh) -> tuple:
    """The reference's ``constrain`` spec: the rules' entry per dimension,
    or None where its axes hold one device or do not divide the
    dimension.  An entry naming a mesh axis that an earlier dimension
    already splits over is None too (FSDP's ``embed`` on the batch's
    ``data`` axis), where the reference raises ``DuplicateSpecError``."""
    spec = list(logical_to_spec(logical_axes, rules))
    spec += [None] * (len(shape) - len(spec))
    out, used = [], set()
    for dim, entry in zip(shape, spec):
        size = entry_size(mesh, entry)
        names = set(entry_axes(entry))
        keep = size > 1 and dim % size == 0 and not names & used
        out.append(entry if keep else None)
        used |= names if keep else set()
    return tuple(out)


def dtensor_type():
    """``DTensor`` if ``torch.distributed.tensor`` was imported (no DTensor
    can exist before), else None; imports nothing."""
    mod = sys.modules.get("torch.distributed.tensor")
    return getattr(mod, "DTensor", None)


def is_dtensor(x) -> bool:
    dt = dtensor_type()
    return dt is not None and isinstance(x, dt)


def constrain(x, logical_axes: Sequence):
    """The reference's sharding constraint by logical names.  ``x`` itself
    when no rules or mesh are active, when the mesh holds one device, or
    when ``x`` is a plain tensor (one process holds the whole value); a
    DTensor is redistributed to :func:`guarded_spec`'s placement."""
    s = _stack()
    if not s:
        return x
    rules, mesh = s[-1]
    if rules is None or mesh is None or mesh.devices.size <= 1 \
            or not is_dtensor(x):
        return x
    want = placements(NamedSharding(
        mesh, guarded_spec(x.shape, logical_axes, rules, mesh)))
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


def placements(sharding: "NamedSharding") -> list:
    """The DTensor placements of a :class:`NamedSharding`, one per mesh
    axis: ``Shard(d)`` on each axis that dimension ``d``'s entry names,
    ``Replicate()`` elsewhere.  A dimension split over a tuple of axes is
    split major to minor in the tuple's order, as a ``PartitionSpec``
    does; DTensor splits in mesh-axis order, so a tuple out of that order
    (or an axis named twice) raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(sharding.mesh.axis_names)
    out: list = [Replicate()] * len(names)
    used: set = set()
    for dim, entry in enumerate(sharding.spec):
        idx = [names.index(a) for a in entry_axes(entry)]
        if idx != sorted(idx) or used & set(idx) or len(set(idx)) < len(idx):
            raise ValueError(
                f"spec {sharding.spec}: entry {entry} must name mesh axes "
                f"once each in the mesh's order {names}")
        used |= set(idx)
        for i in idx:
            out[i] = Shard(dim)
    return out


class DeviceCountError(RuntimeError):
    """A :class:`DistSpec` names more shards than the machine has devices
    of the catalog's type."""


@dataclasses.dataclass(frozen=True)
class DistSpec:
    """Fingerprintable mesh description for ``EngineOptions.dist``.

    ``mesh_shape[i]`` is the device count along ``axes[i]``; the shard
    count is their product.  Hierarchical merges run innermost axis first
    (``axes[-1]``), then outward — ``merge_depth`` is ``len(axes)``.  The
    stable ``repr`` folds into ``EngineOptions.fingerprint()``, so another
    mesh shape OR axis name misses the plan cache."""
    mesh_shape: tuple[int, ...] = (1,)
    axes: tuple[str, ...] = ("data",)

    def __post_init__(self):
        object.__setattr__(self, "mesh_shape", tuple(self.mesh_shape))
        object.__setattr__(self, "axes", tuple(self.axes))
        if len(self.mesh_shape) != len(self.axes):
            raise ValueError(
                f"mesh_shape {self.mesh_shape} and axes {self.axes} must "
                f"have the same length")
        if not self.axes:
            raise ValueError("DistSpec needs at least one mesh axis")
        if len(set(self.axes)) != len(self.axes):
            raise ValueError(f"duplicate mesh axis names: {self.axes}")
        if any((not isinstance(s, int)) or s < 1 for s in self.mesh_shape):
            raise ValueError(
                f"mesh_shape entries must be ints >= 1, got {self.mesh_shape}")

    @property
    def num_shards(self) -> int:
        """Total corpus shard count (product of the mesh axis sizes)."""
        return math.prod(self.mesh_shape)

    @property
    def merge_depth(self) -> int:
        """Hierarchical-merge levels: one per mesh axis (innermost first)."""
        return len(self.axes)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices laid out on named axes: ``devices`` is an object array of
    ``torch.device`` of the mesh's shape (C order = shard order)."""
    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict:
        """Axis name -> size (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def flat(self) -> list:
        """The devices in shard order."""
        return list(self.devices.reshape(-1))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement on a mesh (``jax.sharding.NamedSharding``):
    ``spec[i]`` is the mesh axis (a name, a tuple of names, or None for
    whole) that dimension ``i`` is split over."""
    mesh: Any
    spec: tuple

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        """One device's block of an array of ``shape`` placed so."""
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(d // entry_size(self.mesh, e)
                     for d, e in zip(shape, spec))

    def block_slices(self, shape: Sequence[int], device: int) -> tuple:
        """The slices of an array of ``shape`` that device ``device`` (its
        index in ``mesh.flat``) holds: a dimension split over a tuple of
        axes is cut major to minor in the tuple's order."""
        coords = dict(zip(self.mesh.axis_names, np.unravel_index(
            device, self.mesh.devices.shape)))
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        out = []
        for entry, block in zip(spec, self.shard_shape(shape)):
            k = 0
            for a in entry_axes(entry):
                k = k * self.mesh.shape[a] + int(coords[a])
            out.append(slice(k * block, (k + 1) * block))
        return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedLeaf:
    """A leaf placed on a mesh of more than one device, as
    ``jax.device_put(x, sharding)`` places it: ``blocks[i]`` is device
    ``i``'s block (``sharding.shard_shape``) on ``mesh.flat[i]``; a
    replicated dimension is whole in every block."""
    sharding: NamedSharding
    shape: tuple
    blocks: tuple

    @classmethod
    def place(cls, x: torch.Tensor, sharding: NamedSharding
              ) -> "ShardedLeaf":
        """Each device's block of ``x``, copied onto that device."""
        flat = sharding.mesh.flat
        return cls(sharding, tuple(x.shape), tuple(
            x[sharding.block_slices(x.shape, i)].to(
                device=dev, copy=True) for i, dev in enumerate(flat)))

    @property
    def device_count(self) -> int:
        """The devices holding a block (``len(sharding.device_set)``)."""
        return len(self.blocks)

    def full(self) -> torch.Tensor:
        """The whole value, reassembled from the blocks on the first
        device."""
        first = self.blocks[0]
        out = torch.empty(self.shape, dtype=first.dtype, device=first.device)
        for i, block in enumerate(self.blocks):
            out[self.sharding.block_slices(self.shape, i)] = block.to(
                first.device)
        return out


@functools.lru_cache(maxsize=None)
def _mesh(spec: DistSpec, kind: str) -> Mesh:
    n = spec.num_shards
    if kind == "cuda":
        have = torch.cuda.device_count()
        if have < n:
            raise DeviceCountError(
                f"DistSpec {spec} needs {n} CUDA devices, have {have}: "
                f"each shard sits on a device of its own")
        devs = [torch.device("cuda", i) for i in range(n)]
    elif kind == "cpu":
        devs = [torch.device("cpu")] * n
    else:
        raise DeviceCountError(f"DistSpec runs on cuda or cpu, not {kind}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(spec.mesh_shape), spec.axes)


def resolve_mesh(spec: DistSpec, device="cuda") -> Mesh:
    """The mesh a :class:`DistSpec` describes on ``device``'s type (built
    once per spec and type, so every plan of a spec shares one placement).
    On ``cuda`` it takes the first ``num_shards`` devices and raises
    :class:`DeviceCountError`, naming the count, when there are fewer; on
    ``cpu`` every shard is the CPU."""
    return _mesh(spec, torch.device(device).type)


def _shard_shape(mesh: Mesh, axes: tuple) -> int:
    if tuple(axes) != tuple(mesh.axis_names):
        raise ValueError(f"corpus axes {axes} must be the mesh's axes "
                         f"{mesh.axis_names} (engine meshes are dedicated)")
    return mesh.devices.size


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedCorpus:
    """A row-sharded corpus and its global row ids, pinned to one mesh.

    Rows are zero-padded up to a multiple of the shard count
    (``num_rows`` keeps the real count); pad rows carry ``row_id = -1`` and
    are masked out of every scan.  ``shards[s]`` holds shard ``s``'s rows
    on ``mesh.flat[s]`` (global rows ``s * rows_per`` on), ``row_ids[s]``
    their global ids, and ``shared_masks[s]`` the shard's ``row_ids >= 0``
    mask, or None where the shard has no pad row (the kernels' unmasked
    path)."""
    mesh: Mesh
    axes: tuple[str, ...]
    shards: tuple
    row_ids: tuple
    shared_masks: tuple
    num_rows: int

    @classmethod
    def build(cls, mesh: Mesh, corpus: torch.Tensor,
              axes: Sequence[str] = ("data",)) -> "ShardedCorpus":
        """Row-shard ``corpus`` over ``axes``, zero-padding to
        divisibility.  A shard already on its device with no pad row is a
        view of ``corpus`` (no copy)."""
        axes = tuple(axes)
        shards = _shard_shape(mesh, axes)
        n = int(corpus.shape[0])
        per = -(-n // shards)
        parts, ids, masks = [], [], []
        for s, dev in enumerate(mesh.flat):
            lo, hi = s * per, (s + 1) * per
            rows = corpus[min(lo, n):min(hi, n)]
            if rows.shape[0] < per:
                rows = torch.cat([rows.to(torch.float32), rows.new_zeros(
                    (per - rows.shape[0], corpus.shape[1]),
                    dtype=torch.float32)])
            parts.append(rows.to(device=dev, dtype=torch.float32))
            gid = torch.arange(lo, hi, dtype=torch.int32, device=dev)
            ids.append(torch.where(gid < n, gid, -1))
            masks.append(None if hi <= n else ids[-1] >= 0)
        return cls(mesh, axes, tuple(parts), tuple(ids), tuple(masks), n)

    @property
    def num_shards(self) -> int:
        """Corpus shard count."""
        return len(self.shards)

    @property
    def padded_rows(self) -> int:
        """Row count after divisibility padding."""
        return sum(int(s.shape[0]) for s in self.shards)

    @property
    def spec(self) -> DistSpec:
        """The :class:`DistSpec` of this handle's mesh (the catalog's
        registry key)."""
        return DistSpec(tuple(int(s) for s in self.mesh.devices.shape),
                        tuple(self.mesh.axis_names))

    def matches(self, spec: DistSpec) -> bool:
        """True iff this handle's mesh is the one ``spec`` describes."""
        return (self.axes == spec.axes
                and tuple(self.mesh.devices.shape) == spec.mesh_shape
                and tuple(self.mesh.axis_names) == spec.axes)
