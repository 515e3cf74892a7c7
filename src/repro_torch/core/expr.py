"""Scalar / vector expression IR for predicates and projections.

Mirrors CHASE §6's db-dialect extensions: distance functions
(``L2Distance`` / ``InnerProduct``) are expression nodes over a first-class
vector column, so the optimizer can *see* them — the prerequisite for the map
operator rewrite (R1) and for routing a predicate ``DISTANCE(...) <= r`` to the
ANN range-scan physical operator instead of a brute-force filter.

Expressions evaluate columnar over a Table (every node returns an (N,)
tensor, or (N, dim) for vector-valued nodes); :func:`evaluate_batch` adds a
leading query axis and returns (Q, N).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Iterator, Sequence

import torch

from .. import tracing
from ..roofline.op_counter import Work, counted
from .schema import Metric, Table


class Expr:
    """Base expression node; operator overloads build trees Python-side."""

    def children(self) -> Sequence["Expr"]:
        """Direct child expressions (empty for leaves)."""
        return ()

    # -- convenience builders -------------------------------------------------
    def __lt__(self, o): return Cmp("<", self, wrap(o))
    def __le__(self, o): return Cmp("<=", self, wrap(o))
    def __gt__(self, o): return Cmp(">", self, wrap(o))
    def __ge__(self, o): return Cmp(">=", self, wrap(o))

    def eq(self, o):
        """Build an equality comparison (``=``; ``==`` is identity here)."""
        return Cmp("=", self, wrap(o))

    def ne(self, o):
        """Build an inequality comparison (``<>``)."""
        return Cmp("<>", self, wrap(o))

    def __and__(self, o): return BoolOp("and", (self, wrap(o)))
    def __or__(self, o): return BoolOp("or", (self, wrap(o)))
    def __invert__(self): return BoolOp("not", (self,))
    def __add__(self, o): return Arith("+", self, wrap(o))
    def __sub__(self, o): return Arith("-", self, wrap(o))
    def __mul__(self, o): return Arith("*", self, wrap(o))


def wrap(v) -> Expr:
    """Lift a Python value into the IR (passthrough for Expr nodes)."""
    return v if isinstance(v, Expr) else Const(v)


@dataclasses.dataclass(frozen=True, eq=False)
class Column(Expr):
    """A (possibly table-qualified) column reference."""
    name: str
    table: str | None = None   # qualifier, e.g. "users.embedding"

    def __repr__(self):
        return f"{self.table}.{self.name}" if self.table else self.name


@dataclasses.dataclass(frozen=True, eq=False)
class Const(Expr):
    """A literal constant (number, bool, or array-like)."""
    value: Any

    def __repr__(self):
        return repr(self.value)


@dataclasses.dataclass(frozen=True, eq=False)
class Param(Expr):
    """A `${name}` placeholder bound at execution time (query vector, radius...)."""
    name: str

    def __repr__(self):
        return f"${{{self.name}}}"


@dataclasses.dataclass(frozen=True, eq=False)
class Cmp(Expr):
    """A binary comparison (``< <= > >= = <>``)."""
    op: str  # < <= > >= = <>
    lhs: Expr
    rhs: Expr

    def children(self):
        """Direct child expressions: (lhs, rhs)."""
        return (self.lhs, self.rhs)

    def __repr__(self):
        return f"({self.lhs!r} {self.op} {self.rhs!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class BoolOp(Expr):
    """A boolean connective over operand expressions (``and/or/not``)."""
    op: str  # and / or / not
    operands: tuple[Expr, ...]

    def children(self):
        """Direct child expressions: the operands."""
        return self.operands

    def __repr__(self):
        if self.op == "not":
            return f"(not {self.operands[0]!r})"
        return "(" + f" {self.op} ".join(map(repr, self.operands)) + ")"


@dataclasses.dataclass(frozen=True, eq=False)
class Arith(Expr):
    """A binary arithmetic expression (``+ - * /``)."""
    op: str  # + - * /
    lhs: Expr
    rhs: Expr

    def children(self):
        """Direct child expressions: (lhs, rhs)."""
        return (self.lhs, self.rhs)

    def __repr__(self):
        return f"({self.lhs!r} {self.op} {self.rhs!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class Distance(Expr):
    """DISTANCE(vector_expr, vector_expr) — the hybrid-query pivot node.

    ``metric`` resolves from the column's declared metric at bind time.
    Under similarity metrics (IP/cosine) the paper's convention is that
    ``ORDER BY DISTANCE(...)`` ranks most-similar first and
    ``DISTANCE(...) <= r`` means similarity >= r (LAION uses inner product with
    threshold 0.8); the engine normalizes both through :meth:`score`.
    """
    lhs: Expr
    rhs: Expr
    metric: Metric | None = None

    def children(self):
        """Direct child expressions: (lhs, rhs)."""
        return (self.lhs, self.rhs)

    def __repr__(self):
        return f"DISTANCE({self.lhs!r}, {self.rhs!r})"


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def as_tensor(value, device) -> torch.Tensor:
    """A bind or constant as a tensor on ``device``, with the reference's
    32-bit canonicalization: float64 becomes float32 and int64 becomes
    int32, so ``price < p`` compares in the same precision as the JAX
    package does (a float64 ``p`` would otherwise flip rows at the
    boundary).  A host value moving to a device counts as an upload
    (:func:`repro_torch.tracing.count_upload`)."""
    tracing.count_upload(value, device)
    t = torch.as_tensor(value)
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    elif t.dtype == torch.int64:
        t = t.to(torch.int32)
    return t.to(device)


def on_device(value, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)``, counting an
    upload where a host value moves to a device
    (:func:`repro_torch.tracing.count_upload`)."""
    tracing.count_upload(value, device)
    return torch.as_tensor(value, dtype=dtype, device=device)


def distance_values_work(metric: Metric, x: torch.Tensor,
                         q: torch.Tensor) -> Work:
    """:func:`distance_values`' work by the kernels' formula: 2·D
    operations a row of the broadcast; x and q read once, the fp32 values
    written once."""
    rows = torch.broadcast_shapes(x.shape[:-1], q.shape[:-1]).numel()
    return Work(2 * rows * x.shape[-1],
                x.numel() * x.element_size() + q.numel() * q.element_size()
                + rows * 4)


@counted(distance_values_work, kernel=False)
def distance_values(metric: Metric, x: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
    """Rowwise distance/similarity between (..., d) x and q (broadcast
    over the leading axes)."""
    x = x.to(torch.float32)
    q = q.to(torch.float32)
    if metric == Metric.L2:
        d = x - q
        return torch.sum(d * d, dim=-1)
    if metric == Metric.INNER_PRODUCT:
        return torch.sum(x * q, dim=-1)
    if metric == Metric.COSINE:
        num = torch.sum(x * q, dim=-1)
        den = (torch.linalg.vector_norm(x, dim=-1)
               * torch.linalg.vector_norm(q, dim=-1) + 1e-12)
        return num / den
    raise ValueError(metric)


def order_key(metric: Metric, values: torch.Tensor) -> torch.Tensor:
    """Map raw distance/similarity to an ascending sort key (smaller = better)."""
    return -values if metric.is_similarity() else values


# the per-backend matmul settings that full_fp32 pins and restores
_MATMUL_BACKENDS = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
# those settings are process-wide: one scope at a time (re-entrant), so a
# thread's restore never lands inside another thread's scope
_PRECISION_LOCK = threading.RLock()


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """Run the fp32 products inside in full fp32 (no TF32 on the card, no
    bf16 passes on the CPU), whatever matmul precision the caller set, and
    restore the caller's settings afterwards, also on an exception.

    The plain paths are the card's correctness yardstick, so their keys
    must not follow ``torch.set_float32_matmul_precision``.  The legacy
    setting and the per-backend ones (``torch.backends.cuda.matmul`` and
    ``torch.backends.mkldnn.matmul`` ``.fp32_precision``) are saved apart
    and restored in that order.  Torch refuses to read the legacy setting
    once a caller has set only the per-backend ones; the legacy one is then
    at its default, "highest".

    The settings are process-wide, so the scope holds a re-entrant lock:
    threads that run plain paths at once (a server draining on worker
    threads) take turns, and none restores the caller's settings while
    another is inside."""
    with _PRECISION_LOCK:
        saved = [m.fp32_precision for m in _MATMUL_BACKENDS]
        try:
            legacy = torch.get_float32_matmul_precision()
        except RuntimeError:
            legacy = "highest"
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(legacy)
            for m, p in zip(_MATMUL_BACKENDS, saved):
                m.fp32_precision = p


def pairwise_order_keys(metric: Metric, corpus: torch.Tensor,
                        queries: torch.Tensor) -> torch.Tensor:
    """(Q, N) order keys of every (query, corpus row) pair: one fp32
    ``torch.matmul`` (under :func:`full_fp32`) plus the metric epilogue, in
    the fused kernels' float order (‖x‖² − 2ip + ‖q‖² for L2,
    −ip/(‖x‖‖q‖ + 1e-12) for cosine)."""
    corpus = corpus.to(torch.float32)
    queries = queries.to(torch.float32)
    with full_fp32():
        ip = torch.matmul(queries, corpus.T)                   # (Q, N)
    if metric == Metric.INNER_PRODUCT:
        return -ip
    xx = torch.sum(corpus * corpus, dim=-1)[None, :]
    qq = torch.sum(queries * queries, dim=-1)[:, None]
    if metric == Metric.L2:
        return (xx - 2.0 * ip) + qq
    if metric == Metric.COSINE:
        return -(ip / (torch.sqrt(xx) * torch.sqrt(qq) + 1e-12))
    raise ValueError(metric)


def in_range(metric: Metric, values: torch.Tensor, radius) -> torch.Tensor:
    """``DISTANCE(x,q) <= radius`` under the paper's convention."""
    return values >= radius if metric.is_similarity() else values <= radius


class Bindings(dict):
    """Parameter name → value (query vectors, thresholds, K...)."""


_CMP = {"<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge,
        "=": torch.eq, "<>": torch.ne}
_ARITH = {"+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div}


def evaluate_expr(expr: Expr, column, param, device) -> torch.Tensor:
    """The one expression interpreter: ``column(Column node)`` and
    ``param(name)`` decide the shapes the leaves take."""
    def ev(e: Expr) -> torch.Tensor:
        if isinstance(e, Column):
            return column(e)
        if isinstance(e, Const):
            return as_tensor(e.value, device)
        if isinstance(e, Param):
            return param(e.name)
        if isinstance(e, Cmp):
            return _CMP[e.op](ev(e.lhs), ev(e.rhs))
        if isinstance(e, BoolOp):
            if e.op == "not":
                return ~ev(e.operands[0])
            vals = [ev(o) for o in e.operands]
            out = vals[0]
            for v in vals[1:]:
                out = (out & v) if e.op == "and" else (out | v)
            return out
        if isinstance(e, Arith):
            return _ARITH[e.op](ev(e.lhs), ev(e.rhs))
        if isinstance(e, Distance):
            metric = e.metric or Metric.INNER_PRODUCT
            return distance_values(metric, ev(e.lhs), ev(e.rhs))
        raise TypeError(f"cannot evaluate {type(e)}")

    return ev(expr)


def evaluate(expr: Expr, table: Table, binds: Bindings,
             prefix_cols: dict[str, torch.Tensor] | None = None
             ) -> torch.Tensor:
    """Columnar evaluation of ``expr`` over ``table`` for ONE bind set.

    ``prefix_cols`` supplies extra computed columns (e.g. the map operator's
    ``__sim``) that shadow schema columns."""
    pc = prefix_cols or {}
    return evaluate_expr(
        expr, lambda c: pc[c.name] if c.name in pc else table[c.name],
        lambda name: as_tensor(binds[name], table.device), table.device)


def evaluate_batch(expr: Expr, table: Table, binds: Bindings,
                   qn: int) -> torch.Tensor:
    """Columnar evaluation for ``qn`` bind sets at once -> (Q, N).

    Every bind carries a leading Q axis and evaluates as a ``(Q, 1, ...)``
    column against ``(1, N, ...)`` table columns, so broadcasting yields the
    per-query (Q, N) mask layout the batched kernels consume (the torch form
    of the reference's ``jax.vmap`` over the single-query evaluator)."""
    def column(c: Column) -> torch.Tensor:
        return table[c.name].unsqueeze(0)

    out = evaluate_expr(expr, column,
                        stacked_param(binds, qn, 1, table.device),
                        table.device)
    return out.expand(qn, table.num_rows)


def stacked_param(binds: Bindings, qn: int, trailing: int, device):
    """``param`` for :func:`evaluate_expr` over stacked binds: each bind's
    leading Q axis, followed by ``trailing`` unit axes that broadcast
    against the table columns."""
    def param(name: str) -> torch.Tensor:
        v = as_tensor(binds[name], device)
        if v.ndim == 0 or v.shape[0] != qn:
            raise ValueError(f"bind {name!r} lacks the leading Q={qn} axis: "
                             f"shape {tuple(v.shape)}")
        return v.reshape((qn,) + (1,) * trailing + tuple(v.shape[1:]))

    return param


# -- structural helpers used by the semantic analyzer -----------------------

def walk(expr: Expr):
    """Yield ``expr`` and every descendant, pre-order."""
    yield expr
    for c in expr.children():
        yield from walk(c)


def find_distance(expr: Expr) -> Distance | None:
    """First :class:`Distance` node in the tree, or None."""
    for node in walk(expr):
        if isinstance(node, Distance):
            return node
    return None


def contains_distance(expr: Expr) -> bool:
    """True iff the tree contains a :class:`Distance` node."""
    return find_distance(expr) is not None


def split_conjuncts(expr: Expr | None) -> list[Expr]:
    """Flatten nested ANDs into a conjunct list."""
    if expr is None:
        return []
    if isinstance(expr, BoolOp) and expr.op == "and":
        out: list[Expr] = []
        for o in expr.operands:
            out.extend(split_conjuncts(o))
        return out
    return [expr]


def conjoin(exprs: Sequence[Expr]) -> Expr | None:
    """AND a conjunct list back together (None/identity for 0/1 items)."""
    exprs = list(exprs)
    if not exprs:
        return None
    if len(exprs) == 1:
        return exprs[0]
    return BoolOp("and", tuple(exprs))
