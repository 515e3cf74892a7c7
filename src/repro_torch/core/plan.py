"""Logical plan IR — the `relalg` dialect analogue (CHASE §6).

Nodes are immutable dataclasses forming a tree.  The semantic analyzer
(:mod:`repro_torch.core.semantics`) pattern-matches these trees against the paper's
hybrid-query patterns (§4) and the rewriter (:mod:`repro_torch.core.rewriter`)
produces new trees containing the CHASE-specific operators:

* :class:`Map`          — R1: materialize index-scan similarity into `__sim`
* :class:`KnnSubquery`  — R2: decoupled entity-centric VKNN-SF pipeline
* :class:`UpdateState`  — R3: category-convergence tracking for early stop

Physical selection then lowers this tree to executors (the `subop` analogue).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .expr import Expr, Distance


class PlanNode:
    """Base logical-plan node (an immutable tree; see module docstring)."""

    def children(self) -> Sequence["PlanNode"]:
        """Direct child plan nodes (empty for leaves)."""
        return ()

    def pretty(self, indent: int = 0) -> str:
        """Indented multi-line rendering of the subtree (for explain())."""
        pad = "  " * indent
        head = f"{pad}{self.label()}"
        lines = [head]
        for c in self.children():
            lines.append(c.pretty(indent + 1))
        return "\n".join(lines)

    def label(self) -> str:
        """One-line node description used by :meth:`pretty`."""
        return type(self).__name__


@dataclasses.dataclass(frozen=True, eq=False)
class Scan(PlanNode):
    """Full table scan (the relational leaf)."""
    table: str
    alias: str | None = None

    def label(self):
        a = f" AS {self.alias}" if self.alias and self.alias != self.table else ""
        return f"Scan[{self.table}{a}]"


@dataclasses.dataclass(frozen=True, eq=False)
class Filter(PlanNode):
    """Row selection by a boolean predicate expression."""
    child: PlanNode
    predicate: Expr

    def children(self):
        return (self.child,)

    def label(self):
        return f"Filter[{self.predicate!r}]"


@dataclasses.dataclass(frozen=True, eq=False)
class Map(PlanNode):
    """Compute expression -> new column.  CHASE's R1 target: when ``expr`` is
    ``FromIndexScan`` the column is *wired* from the scan's similarity output
    instead of being recomputed (relalg.map in Fig. 7b)."""
    child: PlanNode
    name: str
    expr: Expr | None            # None => wired from index scan similarity
    from_index_scan: bool = False

    def children(self):
        return (self.child,)

    def label(self):
        src = "<index-scan sim>" if self.from_index_scan else repr(self.expr)
        return f"Map[{self.name} := {src}]"


@dataclasses.dataclass(frozen=True, eq=False)
class OrderBy(PlanNode):
    """Sort by one key expression."""
    child: PlanNode
    key: Expr
    # ascending in *order-key* space; Distance keys are normalized by metric.

    def children(self):
        return (self.child,)

    def label(self):
        return f"OrderBy[{self.key!r}]"


@dataclasses.dataclass(frozen=True, eq=False)
class Limit(PlanNode):
    """Keep the first k rows (k may be a static-bind parameter name)."""
    child: PlanNode
    k: "int | str"   # int or param name

    def children(self):
        return (self.child,)

    def label(self):
        return f"Limit[{self.k}]"


@dataclasses.dataclass(frozen=True, eq=False)
class Project(PlanNode):
    """Output projection: (name, expression) pairs."""
    child: PlanNode
    outputs: tuple[tuple[str, Expr], ...]   # (output name, expr)

    def children(self):
        return (self.child,)

    def label(self):
        cols = ", ".join(n for n, _ in self.outputs)
        return f"Project[{cols}]"


@dataclasses.dataclass(frozen=True, eq=False)
class Join(PlanNode):
    """Inner join on an optional condition (vector joins carry the
    DISTANCE predicate here before rewriting)."""
    left: PlanNode
    right: PlanNode
    condition: Expr | None

    def children(self):
        return (self.left, self.right)

    def label(self):
        return f"Join[{self.condition!r}]"


@dataclasses.dataclass(frozen=True, eq=False)
class WindowRank(PlanNode):
    """RANK() OVER (PARTITION BY ... ORDER BY ...) AS name."""
    child: PlanNode
    partition_by: tuple[Expr, ...]
    order_by: Expr
    rank_name: str = "rank"

    def children(self):
        return (self.child,)

    def label(self):
        parts = ", ".join(map(repr, self.partition_by))
        return f"WindowRank[partition=({parts}) order={self.order_by!r} as {self.rank_name}]"


# ---------------------------------------------------------------------------
# CHASE-introduced logical operators (products of rewriting, §4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class IndexScan(PlanNode):
    """ANN-index-backed scan.  ``mode``:
    * 'topk'  — Topk interface (Q1/Q4): ordered traversal, emits sims
    * 'range' — RangeSearch interface (Q2/Q3/Q5/Q6): Algorithm 1
    Residual structured predicate is applied inline (fused)."""
    table: str
    vector_column: str
    query: Expr                    # Param or Column (join side)
    mode: str                      # 'topk' | 'range'
    k: "int | str | None" = None
    radius: Expr | None = None
    predicate: Expr | None = None
    alias: str | None = None
    emit_similarity: bool = True   # CHASE physical-op change (§5.1)

    def label(self):
        extra = f" k={self.k}" if self.mode == "topk" else f" radius={self.radius!r}"
        pred = f" pred={self.predicate!r}" if self.predicate is not None else ""
        return (f"IndexScan[{self.table}.{self.vector_column} <*> {self.query!r}"
                f" mode={self.mode}{extra}{pred} emit_sim={self.emit_similarity}]")


@dataclasses.dataclass(frozen=True, eq=False)
class KnnSubquery(PlanNode):
    """R2 product: per-row-of-left VKNN-SF against right's ANN index
    (scan→orderBy→limit pipeline with the join as pipeline breaker)."""
    left: PlanNode                # query table pipeline
    right_table: str
    vector_column: str
    left_vector: Expr             # column of left acting as query vector
    k: "int | str"
    join_predicate: Expr | None   # residual structured join condition
    rank_name: str = "rank"

    def children(self):
        return (self.left,)

    def label(self):
        return (f"KnnSubquery[{self.right_table}.{self.vector_column} per-left-row "
                f"k={self.k} pred={self.join_predicate!r}]")


@dataclasses.dataclass(frozen=True, eq=False)
class UpdateState(PlanNode):
    """R3 product: per-category convergence tracking (Algorithm 2) feeding
    early termination back into the range IndexScan below it."""
    child: PlanNode
    category: Expr
    k: "int | str"

    def children(self):
        return (self.child,)

    def label(self):
        return f"UpdateState[category={self.category!r} K={self.k}]"


# ---------------------------------------------------------------------------
# Tree utilities
# ---------------------------------------------------------------------------

def walk_plan(node: PlanNode):
    """Yield ``node`` and every descendant, pre-order."""
    yield node
    for c in node.children():
        yield from walk_plan(c)


def replace_child(node: PlanNode, old: PlanNode, new: PlanNode) -> PlanNode:
    """Shallow rebuild of ``node`` with ``old`` child replaced by ``new``."""
    kwargs = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        kwargs[f.name] = new if v is old else v
    return type(node)(**kwargs)


def find_first(node: PlanNode, kind) -> Optional[PlanNode]:
    """First node of type ``kind`` in pre-order, or None."""
    for n in walk_plan(node):
        if isinstance(n, kind):
            return n
    return None


def plan_distance(node: PlanNode) -> Distance | None:
    """First Distance expression anywhere in the plan (for metric resolution)."""
    from .expr import find_distance
    for n in walk_plan(node):
        for f in dataclasses.fields(n):
            v = getattr(n, f.name)
            if isinstance(v, Expr):
                d = find_distance(v)
                if d is not None:
                    return d
            if isinstance(v, tuple):
                for item in v:
                    e = item[1] if isinstance(item, tuple) else item
                    if isinstance(e, Expr):
                        d = find_distance(e)
                        if d is not None:
                            return d
    return None
