"""Volcano-style iterator engine — the *interpreted* baseline (CHASE §2.4).

The paper argues that tuple-at-a-time iterator execution (repeated ``Next``
virtual calls, unpredictable branches) is a dominant overhead that code
generation removes.  This module implements that traditional engine honestly:
every operator is a Python iterator pulling one tuple dict at a time; every
distance is a per-tuple numpy dot.  Counters (next-calls, distance evals,
predicate evals) feed the Table-5-analogue comparison.

The catalog may live on the card: a ``Scan`` copies each column to the host
once (one copy per distinct tensor, so the ``vec`` / ``embedding`` aliases
of one tensor share it), and a parameter bound to a tensor is copied to
the host once, when the :class:`Interpreter` is built.  Everything after
that is host numpy, as in the reference, and both copies count in the
interpreter's time.  Like the reference, a ``Scan`` visits all
``num_rows`` rows and does not read ``Table.valid``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np
import torch

from .expr import (Arith, BoolOp, Cmp, Column, Const, Distance, Expr, Param)
from .plan import (Filter, Join, Limit, Map, OrderBy, PlanNode, Project, Scan,
                   WindowRank)
from .schema import Catalog, Metric
from .sql import _Aliased


@dataclasses.dataclass
class Counters:
    """Interpreter overhead counters (the Table-5-analogue measurables)."""
    next_calls: int = 0
    distance_evals: int = 0
    predicate_evals: int = 0
    tuples_materialized: int = 0


def _host(v: Any) -> Any:
    """A bind value on the host: tensors become numpy, others pass."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


class Interpreter:
    """Tuple-at-a-time Volcano evaluator over a catalog (see module doc)."""

    def __init__(self, catalog: Catalog, binds: dict[str, Any]):
        self.catalog = catalog
        self.binds = {k: _host(v) for k, v in binds.items()}
        self.counters = Counters()

    # -- per-tuple expression evaluation (the slow path, on purpose) --------
    def eval_expr(self, e: Expr, t: dict) -> Any:
        """Evaluate an expression against ONE tuple dict (counted)."""
        if isinstance(e, Column):
            key = f"{e.table}.{e.name}" if e.table else e.name
            if key in t:
                return t[key]
            return t[e.name]
        if isinstance(e, Const):
            return e.value
        if isinstance(e, Param):
            return self.binds[e.name]
        if isinstance(e, Cmp):
            lo = self.eval_expr(e.lhs, t)
            hi = self.eval_expr(e.rhs, t)
            self.counters.predicate_evals += 1
            op = e.op
            # paper convention: DISTANCE(x,q) <= r means "within radius r";
            # under similarity metrics (IP/cosine) the raw value ranks
            # inversely, so the comparison flips (the compiled engine's
            # in_range() rule)
            if isinstance(e.lhs, Distance):
                metric = e.lhs.metric or Metric.INNER_PRODUCT
                if metric.is_similarity():
                    op = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                          "=": "=", "<>": "<>"}[op]
            return {"<": lo < hi, "<=": lo <= hi, ">": lo > hi,
                    ">=": lo >= hi, "=": lo == hi, "<>": lo != hi}[op]
        if isinstance(e, BoolOp):
            if e.op == "not":
                return not self.eval_expr(e.operands[0], t)
            if e.op == "and":
                return all(self.eval_expr(o, t) for o in e.operands)
            return any(self.eval_expr(o, t) for o in e.operands)
        if isinstance(e, Arith):
            lo = self.eval_expr(e.lhs, t)
            hi = self.eval_expr(e.rhs, t)
            return {"+": lo + hi, "-": lo - hi, "*": lo * hi,
                    "/": lo / hi}[e.op]
        if isinstance(e, Distance):
            x = np.asarray(self.eval_expr(e.lhs, t), dtype=np.float32)
            q = np.asarray(self.eval_expr(e.rhs, t), dtype=np.float32)
            self.counters.distance_evals += 1
            metric = e.metric or Metric.INNER_PRODUCT
            if metric == Metric.L2:
                d = x - q
                return float(np.dot(d, d))
            if metric == Metric.INNER_PRODUCT:
                return float(np.dot(x, q))
            return float(np.dot(x, q)
                         / (np.linalg.norm(x) * np.linalg.norm(q) + 1e-12))
        raise TypeError(type(e))

    def order_value(self, e: Expr, t: dict) -> float:
        """Ascending sort key; similarity metrics sort descending raw."""
        v = self.eval_expr(e, t)
        if isinstance(e, Distance):
            metric = e.metric or Metric.INNER_PRODUCT
            if metric.is_similarity():
                return -v
        return v

    # -- iterator construction ----------------------------------------------
    def run(self, plan: PlanNode) -> list[dict]:
        """Drain the plan's iterator tree into a list of tuple dicts."""
        out = []
        for t in self.iterate(plan):
            self.counters.next_calls += 1
            out.append(t)
        return out

    def iterate(self, node: PlanNode) -> Iterator[dict]:
        """Build the pull-based iterator for one plan node (recursive)."""
        if isinstance(node, Scan):
            tab = self.catalog.table(node.table)
            host: dict[int, np.ndarray] = {}
            cols = {}
            for n, v in tab.columns.items():
                if id(v) not in host:
                    host[id(v)] = v.detach().cpu().numpy()
                cols[n] = host[id(v)]
            alias = node.alias or node.table
            names = list(cols)
            for i in range(tab.num_rows):
                self.counters.next_calls += 1
                t = {}
                for n in names:
                    v = cols[n][i]
                    t[n] = v
                    t[f"{alias}.{n}"] = v
                    t[f"{node.table}.{n}"] = v
                yield t
            return
        if isinstance(node, Filter):
            for t in self.iterate(node.child):
                self.counters.next_calls += 1
                if self.eval_expr(node.predicate, t):
                    yield t
            return
        if isinstance(node, Map):
            for t in self.iterate(node.child):
                self.counters.next_calls += 1
                t = dict(t)
                t[node.name] = self.eval_expr(node.expr, t)
                yield t
            return
        if isinstance(node, OrderBy):
            rows = [(self.order_value(node.key, t), i, t)
                    for i, t in enumerate(self.iterate(node.child))]
            self.counters.tuples_materialized += len(rows)
            rows.sort(key=lambda r: (r[0], r[1]))
            for _, _, t in rows:
                self.counters.next_calls += 1
                yield t
            return
        if isinstance(node, Limit):
            k = node.k if isinstance(node.k, int) else int(self.binds[node.k])
            for i, t in enumerate(self.iterate(node.child)):
                if i >= k:
                    return
                self.counters.next_calls += 1
                yield t
            return
        if isinstance(node, Join):
            right_rows = list(self.iterate(node.right))
            self.counters.tuples_materialized += len(right_rows)
            for lt in self.iterate(node.left):
                for rt in right_rows:
                    self.counters.next_calls += 1
                    merged = {**lt, **rt}
                    if node.condition is None or self.eval_expr(
                            node.condition, merged):
                        yield merged
            return
        if isinstance(node, WindowRank):
            rows = list(self.iterate(node.child))
            self.counters.tuples_materialized += len(rows)
            groups: dict[tuple, list] = {}
            for t in rows:
                key = tuple(_hashable(self.eval_expr(p, t))
                            for p in node.partition_by)
                groups.setdefault(key, []).append(t)
            for key, grp in groups.items():
                scored = [(self.order_value(node.order_by, t), i, t)
                          for i, t in enumerate(grp)]
                scored.sort(key=lambda r: (r[0], r[1]))
                for rank, (_, _, t) in enumerate(scored, start=1):
                    self.counters.next_calls += 1
                    t = dict(t)
                    t[node.rank_name] = rank
                    yield t
            return
        if isinstance(node, Project):
            for t in self.iterate(node.child):
                self.counters.next_calls += 1
                yield {name: self.eval_expr(e, t) for name, e in node.outputs}
            return
        if isinstance(node, _Aliased):
            for t in self.iterate(node.child):
                t = dict(t)
                for k in list(t.keys()):
                    if "." not in str(k):
                        t[f"{node.alias}.{k}"] = t[k]
                yield t
            return
        raise NotImplementedError(f"interpreter: {type(node).__name__}")


def _hashable(v):
    if isinstance(v, np.ndarray):
        return v.tobytes()
    if isinstance(v, (np.generic,)):
        return v.item()
    return v


def run_interpreted(sql: str, catalog: Catalog, binds: dict[str, Any]):
    """Parse + execute on the iterator engine. Returns (rows, counters)."""
    from .sql import parse_sql
    interp = Interpreter(catalog, binds)
    plan = parse_sql(sql)
    rows = interp.run(plan)
    return rows, interp.counters
