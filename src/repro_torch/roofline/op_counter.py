"""What one eager call does: matrix-product FLOPs by dtype, bytes touched,
collective bytes, hand-written kernel launches and live memory (the
port's counterpart of ``src/repro/roofline/hlo_analyzer.py``).

The reference reads these off XLA's compiled per-device HLO, walking while
bodies by their trip counts.  The port has no HLO: :func:`analyze` runs
the function once under a ``TorchDispatchMode`` that sees every aten op,
so every loop iteration is counted as it runs and no trip count is needed.

* **FLOPs** of matrix products (``mm``, ``bmm``, ``addmm``, convolutions,
  attention ops: the formulas of ``torch.utils.flop_counter``; an einsum
  reaches it as ``bmm``), split by the product's dtype: ``"bf16"`` (bf16
  and fp16), ``"fp32"`` and ``"fp64"``.  A hand-written kernel's
  operations count as fp32: its tiles do fp32 FMAs on the CUDA cores.
* **Bytes touched**: each op's tensor operands plus its outputs; views
  (an output that aliases an input without writing it) and bare
  allocations count nothing.  Eager bytes are op by op, so they exceed the
  bytes of XLA's fused kernels and move with the implementation: hold
  FLOPs, not bytes, to the reference, and bound a step's memory time by
  :attr:`OpCost.moved_bytes`, the bytes any implementation must move.
* **Collective bytes** under the reference's five kinds, recorded by the
  port's collective functions (:func:`collective`); at one device nothing
  moves and they read 0.
* **Kernel launches**: each kernel wrapper reports its launch with the
  operations and bytes of its roofline bound (:func:`counted`) and the
  ops inside the wrapper are not counted, so one plan counts the same on
  the CPU (the plain version) and on the card (the CUDA kernel, which no
  dispatch mode sees).  The plain rowwise distance
  (``core.expr.distance_values``, the scan of a plan that runs no kernel)
  is counted the same way, by the kernels' formula, as an op of its own:
  its elementwise products and sums are no matrix product, and XLA's
  cost analysis counts them as FLOPs.
* **Live memory**: every storage an op allocates is live until it is
  freed (an autograd-saved tensor and a checkpoint's recompute included);
  with the call's arguments this gives the peak, as
  ``memory_analysis()`` reports argument, temporary, output and aliased
  bytes.  On ``meta`` tensors nothing is allocated, so a full-size step
  costs only Python time.
* **One device of a mesh** (the dry-run under a mesh of more than one
  device): on DTensors the counter lets DTensor run each op and counts the
  local ops it issues on this rank's blocks, so FLOPs, bytes and live
  memory are one device's, as XLA's per-device HLO gives them (a plain
  tensor beside them is replicated and counts whole).  The ``torch.
  distributed`` functional collectives that redistribution and the MoE's
  ``local_map`` issue count their input bytes under the reference's kinds.
  The FakeTensor runs of DTensor's sharding propagation count nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import sys
import threading
import weakref
from typing import Callable, NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .. import tracing

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
DTYPES = ("bf16", "fp32", "fp64")

# allocations without a read or a write of their own, and views whose
# schema does not mark the output as an alias of the input
_NO_BYTES = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                       "new_empty_strided", "lift_fresh", "_unsafe_view",
                       "_reshape_alias"})

# the functional collectives' ops (``torch.distributed``'s
# ``_c10d_functional`` namespaces) by the reference's kinds
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_FUNCOL_NAMESPACES = frozenset({"_c10d_functional",
                                "_c10d_functional_autograd",
                                "c10d_functional"})

_STATE = threading.local()


class Work(NamedTuple):
    """A kernel launch's work: the operations it does and the bytes it
    must move (each input read once, each output written once)."""
    ops: float
    nbytes: float


def dtype_class(dtype: torch.dtype) -> str:
    """The product class a dtype's FLOPs count under."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    return "fp64" if dtype == torch.float64 else "fp32"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtensor_type():
    """``DTensor`` once ``torch.distributed.tensor`` is imported (no DTensor
    exists before), else None."""
    mod = sys.modules.get("torch.distributed.tensor")
    return getattr(mod, "DTensor", None)


def _tensors(tree) -> list:
    """The tensor leaves of a tree of dicts, lists, tuples and
    dataclasses; a DTensor's leaf is this rank's block."""
    if isinstance(tree, torch.Tensor):
        while hasattr(tree, "_local_tensor"):
            tree = tree._local_tensor
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _tensors(getattr(tree, f.name))]
    return []


def _storages(tree) -> dict:
    """id -> (storage, bytes) of the distinct storages a tree's tensors
    sit on."""
    out = {}
    for t in _tensors(tree):
        s = t.untyped_storage()
        out[id(s)] = (s, s.nbytes())
    return out


@dataclasses.dataclass
class OpCost:
    """What a counted call did.  ``flops`` by product class (kernel
    operations under ``"fp32"``), ``bytes`` touched, ``collective_bytes`` by
    kind, ``kernels[name] = {"launches", "ops", "bytes"}``, ``per_op[name]
    = {"calls", "flops", "bytes"}``, ``events`` the ops and launches in call
    order as (name, operand shapes and dtypes, flops, bytes); memory in
    bytes: the arguments read (``unread_arguments``: the storages of those
    never read), the outputs (``alias_bytes`` of them on argument
    storages) and the peak of everything live at once."""
    flops: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(DTYPES, 0.0))
    bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    kernels: dict = dataclasses.field(default_factory=dict)
    per_op: dict = dataclasses.field(default_factory=dict)
    events: list = dataclasses.field(default_factory=list)
    argument_bytes: int = 0
    unread_arguments: frozenset = frozenset()
    output_bytes: int = 0
    alias_bytes: int = 0
    peak_bytes: int = 0

    @property
    def flops_total(self) -> float:
        return float(sum(self.flops.values()))

    @property
    def kernel_ops(self) -> float:
        """Operations of the hand-written kernels' launches."""
        return float(sum(k["ops"] for k in self.kernels.values()))

    @property
    def collective_total(self) -> float:
        return float(sum(self.collective_bytes.values()))

    @property
    def moved_bytes(self) -> int:
        """The bytes any implementation of the call must move: every
        argument read once and every new output written once (an output
        updated in place on an argument's storage counts as read only).
        Saved activations and temporaries are left out, so this is a lower
        bound."""
        return self.argument_bytes + self.output_bytes - self.alias_bytes

    @property
    def temp_bytes(self) -> int:
        """Peak bytes that were neither arguments nor new outputs."""
        return max(0, self.peak_bytes - self.argument_bytes
                   - self.output_bytes + self.alias_bytes)

    def memory(self) -> dict:
        """``memory_analysis()``'s fields."""
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes,
                "alias_bytes": self.alias_bytes}


class OpCounter(TorchDispatchMode):
    """The dispatch mode behind :func:`analyze` (see the module doc).
    ``arguments(tree)`` registers the call's inputs, ``outputs(tree)`` its
    result; :func:`counted` wrappers and :func:`collective` report into
    the counter active on their thread."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self._quiet = 0
        self._live: dict[int, int] = {}
        self._live_bytes = 0
        self._args: dict = {}
        self._read: set = set()
        self._finalizers: list = []

    def __enter__(self):
        _stack().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _stack().remove(self)
            for f in self._finalizers:
                f.detach()
            self._finalizers.clear()

    # -- memory -------------------------------------------------------------

    def _hold(self, key: int, storage, nbytes: int) -> None:
        self._live[key] = nbytes
        self._live_bytes += nbytes
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live_bytes)
        self._finalizers.append(weakref.finalize(storage, self._free, key))

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def arguments(self, tree) -> None:
        """Register the call's inputs: live throughout, counted as
        argument bytes."""
        for key, (s, n) in _storages(tree).items():
            if key not in self._live:
                self._args[key] = n
                self.cost.argument_bytes += n
                self._hold(key, s, n)

    def outputs(self, tree) -> None:
        """Register the call's result: output bytes, and of them the bytes
        on argument storages (updated in place) as aliased."""
        for key, (_s, n) in _storages(tree).items():
            self.cost.output_bytes += n
            self._read.add(key)         # an argument passed through is used
            if key in self._args:
                self.cost.alias_bytes += n

    # -- dispatch -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        dtensor = _dtensor_type()
        if dtensor is not None and any(issubclass(t, dtensor)
                                       for t in types):
            return NotImplemented       # DTensor runs it: count its ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        self._read.update(id(t.untyped_storage()) for t in ins)
        if dtensor is not None and any(isinstance(t, FakeTensor)
                                       for t in outs or ins):
            return out                  # sharding propagation's shape run
        alias = any(r.alias_info is not None for r in func._schema.returns)
        if not alias:
            for t in outs:
                s = t.untyped_storage()
                if id(s) not in self._live:
                    self._hold(id(s), s, s.nbytes())
        if not self._quiet:
            self._count(func, args, kwargs, out, ins, outs, alias)
        return out

    def _count(self, func, args, kwargs, out, ins, outs, alias) -> None:
        packet = func._overloadpacket
        if func.namespace in _FUNCOL_NAMESPACES:
            kind = _COLLECTIVE_OPS.get(packet.__name__)
            if kind is not None:
                self.cost.collective_bytes[kind] += float(
                    sum(map(_nbytes, ins)))
                self._op(str(func), ins, 0.0, 0)
            return
        flops = 0.0
        if packet in flop_registry and outs:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            self.cost.flops[dtype_class(outs[0].dtype)] += flops
        view = alias and not any(r.alias_info.is_write
                                 for r in func._schema.returns
                                 if r.alias_info is not None)
        nbytes = 0
        if not view and packet.__name__ not in _NO_BYTES:
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self._op(str(func), ins, flops, nbytes)

    def _op(self, name: str, ins: list, flops: float, nbytes: float) -> None:
        self.cost.bytes += nbytes
        row = self.cost.per_op.setdefault(
            name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        self.cost.events.append(
            (name, tuple((tuple(t.shape), t.dtype) for t in ins), flops,
             nbytes))

    # -- kernels and collectives ---------------------------------------------

    @contextlib.contextmanager
    def _region(self, name: str, work: Callable[[], Work], kernel: bool,
                ins: list):
        """Record ``work`` once as a kernel launch or as one plain op, and
        none of the ops inside; a region inside another records nothing."""
        outer = self._quiet
        self._quiet += 1
        try:
            if not outer:
                w = work()
                ops, nbytes = float(w.ops), float(w.nbytes)
                self.cost.flops["fp32"] += ops
                if kernel:
                    row = self.cost.kernels.setdefault(
                        name, {"launches": 0, "ops": 0.0, "bytes": 0.0})
                    row["launches"] += 1
                    row["ops"] += ops
                    row["bytes"] += nbytes
                    self.cost.bytes += nbytes
                    self.cost.events.append((f"kernel {name}", (), ops,
                                             nbytes))
                else:
                    self._op(name, ins, ops, nbytes)
            yield
        finally:
            self._quiet -= 1


def _stack() -> list:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


def active() -> OpCounter | None:
    """The innermost counter active on this thread, or None."""
    s = _stack()
    return s[-1] if s else None


def counted(work: Callable[..., Work], kernel: bool = True):
    """Decorator of a kernel wrapper: with a counter active, each call
    records one launch of the wrapper's kernel with ``work(*args, **kw)``
    of the call's own arguments (evaluated only then, uncounted), and none
    of the ops inside the call are counted; without one it adds nothing
    but the check.  With ``kernel=False`` the call is recorded as one
    plain op of that work instead (its operations as fp32 FLOPs).  A
    kernel's call is the span ``repro_torch.kernel.<wrapper>``
    (:mod:`repro_torch.tracing`)."""
    def deco(fn):
        label = tracing.KERNEL + fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with tracing.span(label) if kernel else tracing.NULL:
                c = active()
                if c is None:
                    return fn(*args, **kw)
                ins = [t for t in tree_flatten((args, kw))[0]
                       if isinstance(t, torch.Tensor)]
                with c._region(fn.__name__, lambda: work(*args, **kw),
                               kernel, ins):
                    return fn(*args, **kw)
        return wrapper
    return deco


def collective(kind: str, nbytes: float) -> None:
    """Record ``nbytes`` moved between devices by a collective of ``kind``
    (one of :data:`COLLECTIVES`) into the active counter, if any."""
    c = active()
    if c is not None:
        c.cost.collective_bytes[kind] += float(nbytes)


def analyze(fn: Callable, *args, **kw) -> OpCost:
    """Run ``fn(*args, **kw)`` once under a counter and return what it
    did; the result is discarded.  An argument no op reads (and ``fn``
    does not return) leaves the argument bytes and the peak, as
    ``jax.jit`` drops unused arguments; ``unread_arguments`` holds their
    storages."""
    with OpCounter() as counter:
        counter.arguments((args, kw))
        out = fn(*args, **kw)
        counter.outputs(out)
        del out
    cost = counter.cost
    unread = {k: n for k, n in counter._args.items()
              if k not in counter._read}
    cost.unread_arguments = frozenset(unread)
    cost.argument_bytes -= sum(unread.values())
    cost.peak_bytes -= sum(unread.values())
    return cost


def _fmt_operands(operands: tuple) -> str:
    return " ".join(f"{str(dt).replace('torch.', '')}{list(shape)}"
                    for shape, dt in operands)


class Lowered:
    """A counted run of a plan, as ``jax.stages.Lowered`` reads:
    ``as_text()`` lists its ops and kernel launches, ``cost_analysis()``
    gives ``{"flops", "bytes accessed"}``, and ``compile()`` returns an
    object that answers the same (itself: eager torch compiles nothing)."""

    def __init__(self, cost: OpCost):
        self.cost = cost

    def as_text(self) -> str:
        c = self.cost
        lines = [f"# {len(c.events)} ops and launches: flops="
                 f"{c.flops_total:.6e} bytes={c.bytes:.6e} kernel launches="
                 f"{sum(k['launches'] for k in c.kernels.values())}"]
        for name, operands, flops, nbytes in c.events:
            lines.append(f"{name} {_fmt_operands(operands)} flops={flops:g} "
                         f"bytes={nbytes:g}".replace("  ", " "))
        return "\n".join(lines)

    def cost_analysis(self) -> dict:
        return {"flops": self.cost.flops_total,
                "bytes accessed": self.cost.bytes}

    def compile(self) -> "Lowered":
        return self


def lower(fn: Callable, *args, **kw) -> Lowered:
    """:func:`analyze` as a :class:`Lowered`."""
    return Lowered(analyze(fn, *args, **kw))


def report(cost: OpCost, top: int = 12) -> str:
    """The per-op breakdown: totals, collective bytes by kind, kernel
    launches, and the ``top`` ops by FLOPs and by bytes."""
    by = " ".join(f"{k}={v:.3e}" for k, v in cost.flops.items())
    lines = [f"flops={cost.flops_total:.3e} ({by}) bytes={cost.bytes:.3e} "
             f"collective={cost.collective_total:.3e}"]
    for kind, b in sorted(cost.collective_bytes.items()):
        if b:
            lines.append(f"  {kind:20s} {b:.3e} B")
    if cost.kernels:
        lines.append("kernel launches:")
        for name, k in sorted(cost.kernels.items()):
            lines.append(f"  {name:48s} {k['launches']:d} ops={k['ops']:.3e} "
                         f"bytes={k['bytes']:.3e}")
    for key in ("flops", "bytes"):
        lines.append(f"top ops by {key}:")
        rows = sorted(((name, row) for name, row in cost.per_op.items()
                       if row[key]), key=lambda kv: -kv[1][key])
        for name, row in rows[:top]:
            lines.append(f"  {name:48s} {row[key]:.3e} ({row['calls']} "
                         f"calls)")
    return "\n".join(lines)
