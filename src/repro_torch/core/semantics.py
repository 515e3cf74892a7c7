"""Semantic analysis: classify a logical plan into the paper's hybrid families.

CHASE §3/§4: the engine traverses the logical plan, checks it against the
hybrid-query patterns, and only then rewrites.  The classifier here is
pattern-structural *and* schema-aware (it verifies that the window partitions
by the query table's primary key for entity-centric queries, that the window
frame spans the whole partition — ours always does, there is no frame syntax —
and that DISTANCE references an indexed vector column), mirroring the paper's
"guarantees alignment with the semantics of a specific category" requirement.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from .expr import (BoolOp, Cmp, Column, Const, Distance, Expr, Param,
                   contains_distance, conjoin, split_conjuncts)
from .plan import (Filter, Join, Limit, OrderBy, PlanNode, Project, Scan,
                   WindowRank)
from .schema import Catalog, ColumnKind
from .sql import _Aliased


class QueryClass(enum.Enum):
    """The paper's hybrid query taxonomy (Q1-Q6) plus NON_HYBRID."""
    VKNN_SF = "vknn_sf"                    # Q1
    DR_SF = "dr_sf"                        # Q2
    DIST_JOIN = "dist_join"                # Q3
    KNN_JOIN = "knn_join"                  # Q4 (entity-centric W-VKNN-SF)
    CATEGORY_PARTITION = "category_part"   # Q5 (category-driven, single table)
    CATEGORY_JOIN = "category_join"        # Q6 (category-driven, join)
    NON_HYBRID = "non_hybrid"


@dataclasses.dataclass
class Analysis:
    """Everything the rewriter / physical layer needs, extracted once."""
    query_class: QueryClass
    plan: PlanNode
    # single-table slots
    table: str | None = None
    alias: str | None = None
    vector_column: str | None = None
    query_expr: Expr | None = None          # Param (or left Column for joins)
    k: "int | str | None" = None
    radius: Expr | None = None
    structured_predicate: Expr | None = None
    # join slots
    left_table: str | None = None
    left_alias: str | None = None
    right_table: str | None = None
    right_alias: str | None = None
    left_vector: str | None = None
    right_vector: str | None = None
    join_predicate: Expr | None = None      # residual (non-distance) condition
    # window slots
    partition_keys: tuple[Expr, ...] = ()
    category_column: Expr | None = None
    rank_name: str = "rank"
    # bookkeeping
    outer_project: tuple[tuple[str, Expr], ...] | None = None
    notes: list[str] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------


def _strip(node: PlanNode):
    """Peel Project/_Aliased wrappers, remembering the outermost projection."""
    outer_proj = None
    while True:
        if isinstance(node, Project):
            if outer_proj is None:
                outer_proj = node.outputs
            node = node.child
        elif isinstance(node, _Aliased):
            node = node.child
        else:
            return node, outer_proj


def _range_conjunct(pred: Expr | None):
    """Split conjuncts into (distance-range conjunct, structured residual).

    Recognizes ``DISTANCE(col, q) <= r`` (and >= under similarity convention —
    normalization happens downstream via the column metric)."""
    dist_c, radius, rest = None, None, []
    for c in split_conjuncts(pred):
        if (dist_c is None and isinstance(c, Cmp) and c.op in ("<=", "<", ">=", ">")
                and isinstance(c.lhs, Distance) and not contains_distance(c.rhs)):
            dist_c, radius = c.lhs, c.rhs
        else:
            rest.append(c)
    return dist_c, radius, conjoin(rest)


def _resolve_scan(node: PlanNode):
    """Return (scan, filter_predicate) for a Filter?->Scan chain, else None."""
    pred = None
    if isinstance(node, Filter):
        pred = node.predicate
        node = node.child
    if isinstance(node, Scan):
        return node, pred
    return None


def _column_of(e: Expr) -> Column | None:
    return e if isinstance(e, Column) else None


def _is_vector_col(catalog: Catalog, table: str, col: Column | None) -> bool:
    if col is None or not catalog.has_table(table):
        return False
    schema = catalog.table(table).schema
    return col.name in schema and schema[col.name].kind == ColumnKind.VECTOR


def _belongs_to(col: Column, table_name: str, alias: str | None) -> bool:
    return col.table in (None, table_name, alias)


def analyze(plan: PlanNode, catalog: Catalog) -> Analysis:
    """Classify ``plan`` and extract rewrite slots.  Never raises on unknown
    shapes — falls back to NON_HYBRID, which executes un-rewritten."""
    node, outer_proj = _strip(plan)

    # --- Peel outer rank filter (WHERE ranked.rank <= K) for window queries
    rank_k: int | str | None = None
    if isinstance(node, Filter):
        c = node.predicate
        if (isinstance(c, Cmp) and c.op in ("<=", "<")
                and isinstance(c.lhs, Column) and isinstance(c.rhs, (Const, Param))):
            inner, proj2 = _strip(node.child)
            if isinstance(inner, WindowRank) and c.lhs.name == inner.rank_name:
                rank_k = (c.rhs.value if isinstance(c.rhs, Const)
                          else c.rhs.name)
                if isinstance(rank_k, (int, float)):
                    rank_k = int(rank_k) - (1 if c.op == "<" else 0)
                if outer_proj is None:
                    outer_proj = proj2
                node = inner

    # ======================= windowed families (Q4/Q5/Q6) ==================
    if isinstance(node, WindowRank):
        return _analyze_window(node, rank_k, outer_proj, catalog, plan)

    # ======================= Limit -> OrderBy (Q1) ==========================
    if isinstance(node, Limit):
        k = node.k
        child = node.child
        if isinstance(child, OrderBy) and isinstance(child.key, Distance):
            scan_info = _resolve_scan(child.child)
            dist = child.key
            vcol = _column_of(dist.lhs) or _column_of(dist.rhs)
            qexpr = dist.rhs if _column_of(dist.lhs) is vcol else dist.lhs
            if scan_info is not None:
                scan, pred = scan_info
                if _is_vector_col(catalog, scan.table, vcol):
                    # pattern: orderBy(D, distance) -> topK  (paper §4.1)
                    return Analysis(
                        QueryClass.VKNN_SF, plan, table=scan.table,
                        alias=scan.alias, vector_column=vcol.name,
                        query_expr=qexpr, k=k, structured_predicate=pred,
                        outer_project=outer_proj)

    # ======================= DR-SF (Q2) and distance join (Q3) =============
    if isinstance(node, Filter) or isinstance(node, Join):
        if isinstance(node, Filter):
            scan_info = _resolve_scan(node)
            if scan_info is not None:
                scan, pred = scan_info
                dist, radius, rest = _range_conjunct(pred)
                if dist is not None:
                    vcol = _column_of(dist.lhs) or _column_of(dist.rhs)
                    qexpr = dist.rhs if _column_of(dist.lhs) is vcol else dist.lhs
                    if _is_vector_col(catalog, scan.table, vcol):
                        return Analysis(
                            QueryClass.DR_SF, plan, table=scan.table,
                            alias=scan.alias, vector_column=vcol.name,
                            query_expr=qexpr, radius=radius,
                            structured_predicate=rest, outer_project=outer_proj)
            # filter above a join: fold predicate into the join condition
            if isinstance(node.child, Join):
                j = node.child
                cond = conjoin(split_conjuncts(j.condition)
                               + split_conjuncts(node.predicate))
                node = Join(j.left, j.right, cond)

        if isinstance(node, Join):
            res = _analyze_dist_join(node, outer_proj, catalog, plan)
            if res is not None:
                return res

    return Analysis(QueryClass.NON_HYBRID, plan, outer_project=outer_proj)


def _analyze_dist_join(node: Join, outer_proj, catalog: Catalog,
                       plan: PlanNode) -> Analysis | None:
    li = _resolve_scan(node.left)
    ri = _resolve_scan(node.right)
    if li is None or ri is None:
        return None
    (lscan, lpred), (rscan, rpred) = li, ri
    dist, radius, rest = _range_conjunct(node.condition)
    if dist is None:
        return None
    lcol, rcol = _column_of(dist.lhs), _column_of(dist.rhs)
    if lcol is None or rcol is None:
        return None
    # orient: lcol belongs to left scan
    if not _belongs_to(lcol, lscan.table, lscan.alias):
        lcol, rcol = rcol, lcol
    if not (_is_vector_col(catalog, lscan.table, lcol)
            and _is_vector_col(catalog, rscan.table, rcol)):
        return None
    residual = conjoin(split_conjuncts(rest) + split_conjuncts(lpred)
                       + split_conjuncts(rpred))
    return Analysis(
        QueryClass.DIST_JOIN, plan,
        left_table=lscan.table, left_alias=lscan.alias,
        right_table=rscan.table, right_alias=rscan.alias,
        left_vector=lcol.name, right_vector=rcol.name,
        radius=radius, join_predicate=residual, outer_project=outer_proj)


def _analyze_window(node: WindowRank, rank_k, outer_proj, catalog: Catalog,
                    plan: PlanNode) -> Analysis:
    order = node.order_by
    if not isinstance(order, Distance) or rank_k is None:
        return Analysis(QueryClass.NON_HYBRID, plan, outer_project=outer_proj)

    child = node.child

    # ---- single-table: Q5 (category partition) -----------------------------
    scan_info = _resolve_scan(child)
    if scan_info is not None:
        scan, pred = scan_info
        dist_c, radius, rest = _range_conjunct(pred)
        vcol = _column_of(order.lhs) or _column_of(order.rhs)
        qexpr = order.rhs if _column_of(order.lhs) is vcol else order.lhs
        if (_is_vector_col(catalog, scan.table, vcol)
                and len(node.partition_by) >= 1):
            cat = node.partition_by[-1]
            # PARTITION BY category ≡ PARTITION BY 1, category (paper §2.4)
            cat_ok = isinstance(cat, Column)
            if cat_ok and dist_c is not None:
                return Analysis(
                    QueryClass.CATEGORY_PARTITION, plan, table=scan.table,
                    alias=scan.alias, vector_column=vcol.name, query_expr=qexpr,
                    k=rank_k, radius=radius, structured_predicate=rest,
                    partition_keys=tuple(node.partition_by),
                    category_column=cat, rank_name=node.rank_name,
                    outer_project=outer_proj)

    # ---- join families: Q4 (entity-centric) / Q6 (category join) ----------
    jnode = child
    extra_pred = None
    if isinstance(jnode, Filter):
        extra_pred = jnode.predicate
        jnode = jnode.child
    if isinstance(jnode, Join):
        li, ri = _resolve_scan(jnode.left), _resolve_scan(jnode.right)
        if li is not None and ri is not None:
            (lscan, lpred), (rscan, rpred) = li, ri
            cond = conjoin(split_conjuncts(jnode.condition)
                           + split_conjuncts(extra_pred))
            dist_c, radius, residual = _range_conjunct(cond)
            residual = conjoin(split_conjuncts(residual)
                               + split_conjuncts(lpred) + split_conjuncts(rpred))
            lcol = _column_of(order.lhs)
            rcol = _column_of(order.rhs)
            if lcol is not None and rcol is not None:
                if not _belongs_to(lcol, lscan.table, lscan.alias):
                    lcol, rcol = rcol, lcol
                lv = _is_vector_col(catalog, lscan.table, lcol)
                rv = _is_vector_col(catalog, rscan.table, rcol)
                if lv and rv:
                    pk = catalog.table(lscan.table).schema.primary_key
                    parts = node.partition_by
                    first = parts[0] if parts else None
                    pk_first = (isinstance(first, Column) and first.name == pk
                                and _belongs_to(first, lscan.table, lscan.alias))
                    if len(parts) == 1 and pk_first and radius is None:
                        # Q4 pattern: window(Tq ⋈ Tr, partitionBy(pk_q)) (§4.2)
                        return Analysis(
                            QueryClass.KNN_JOIN, plan,
                            left_table=lscan.table, left_alias=lscan.alias,
                            right_table=rscan.table, right_alias=rscan.alias,
                            left_vector=lcol.name, right_vector=rcol.name,
                            k=rank_k, join_predicate=residual,
                            partition_keys=tuple(parts),
                            rank_name=node.rank_name, outer_project=outer_proj)
                    if (len(parts) == 2 and pk_first and radius is not None
                            and isinstance(parts[1], Column)):
                        # Q6 pattern: partitionBy(pk_q, c_r), join ON dist<=R1 (§4.3)
                        return Analysis(
                            QueryClass.CATEGORY_JOIN, plan,
                            left_table=lscan.table, left_alias=lscan.alias,
                            right_table=rscan.table, right_alias=rscan.alias,
                            left_vector=lcol.name, right_vector=rcol.name,
                            k=rank_k, radius=radius, join_predicate=residual,
                            partition_keys=tuple(parts),
                            category_column=parts[1],
                            rank_name=node.rank_name, outer_project=outer_proj)

    return Analysis(QueryClass.NON_HYBRID, plan, outer_project=outer_proj)
