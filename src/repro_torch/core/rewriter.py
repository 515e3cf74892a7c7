"""Logical plan rewriting — CHASE §4 (R1/R2/R3).

Consumes an :class:`~repro_torch.core.semantics.Analysis` and emits the rewritten
logical plan tree.  The rewritten tree is what the physical layer lowers and
what tests assert against (plan-shape equivalence to the paper's Figures
4b/5b/6b); it is also pretty-printable for EXPLAIN-style output.
"""
from __future__ import annotations

from .expr import (Cmp, Column, Const, Distance, Param, split_conjuncts,
                   walk)
from .plan import (Filter, IndexScan, Join, KnnSubquery, Limit, Map, OrderBy,
                   PlanNode, Project, Scan, UpdateState, WindowRank)
from .semantics import Analysis, QueryClass

SIM_COL = "__sim"

# comparison direction when an atom is flipped to column-on-the-left form
_FLIP_OP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
            "=": "=", "<>": "<>", "!=": "!="}


def selectivity_atoms(a: Analysis) -> list[dict]:
    """Threshold atoms of the structured/join predicates, in a form the
    adaptive optimizer can estimate selectivity for (DESIGN.md §14).

    Each atom is ``{"table", "column", "op", "param", "value"}`` — a
    column-vs-threshold comparison in column-on-the-left form, where the
    threshold is either a bind parameter (``param`` set) or a literal
    (``value`` set).  Conjuncts that are not simple threshold comparisons
    (distance terms, OR trees, column-vs-column join residuals, arithmetic)
    are skipped — the estimator stays conservative rather than guessing."""
    atoms: list[dict] = []
    for pred in (a.structured_predicate, a.join_predicate):
        for conj in split_conjuncts(pred):
            if not isinstance(conj, Cmp) or conj.op not in _FLIP_OP:
                continue
            if any(isinstance(node, Distance) for node in walk(conj)):
                continue
            for lhs, rhs, op in ((conj.lhs, conj.rhs, conj.op),
                                 (conj.rhs, conj.lhs, _FLIP_OP[conj.op])):
                if (isinstance(lhs, Column)
                        and isinstance(rhs, (Param, Const))):
                    atoms.append({
                        "table": lhs.table, "column": lhs.name, "op": op,
                        "param": rhs.name if isinstance(rhs, Param)
                        else None,
                        "value": rhs.value if isinstance(rhs, Const)
                        else None})
                    break
    return atoms


def rewrite(a: Analysis) -> PlanNode:
    """Apply the rewrite rule for the detected hybrid family."""
    if a.query_class == QueryClass.VKNN_SF:
        return _rewrite_vknn(a)
    if a.query_class == QueryClass.DR_SF:
        return _rewrite_drsf(a)
    if a.query_class == QueryClass.DIST_JOIN:
        return _rewrite_dist_join(a)
    if a.query_class == QueryClass.KNN_JOIN:
        return _rewrite_knn_join(a)
    if a.query_class == QueryClass.CATEGORY_PARTITION:
        return _rewrite_category_partition(a)
    if a.query_class == QueryClass.CATEGORY_JOIN:
        return _rewrite_category_join(a)
    return a.plan


def _project(a: Analysis, child: PlanNode) -> PlanNode:
    if a.outer_project:
        return Project(child, a.outer_project)
    return child


def _rewrite_vknn(a: Analysis) -> PlanNode:
    """R1 (Fig. 4b): IndexScan(topk, emits sim) -> Map(__sim) ->
    OrderBy(__sim) -> Limit.  The orderBy key is *replaced* with the
    materialized column so no distance is recomputed."""
    scan = IndexScan(a.table, a.vector_column, a.query_expr, mode="topk",
                     k=a.k, predicate=a.structured_predicate, alias=a.alias)
    mapped = Map(scan, SIM_COL, None, from_index_scan=True)
    ordered = OrderBy(mapped, Column(SIM_COL))
    limited = Limit(ordered, a.k)
    return _project(a, limited)


def _rewrite_drsf(a: Analysis) -> PlanNode:
    """Q2: route the distance predicate to the RangeSearch interface (§5.2)
    instead of a brute filter; structured residual fuses into the scan."""
    scan = IndexScan(a.table, a.vector_column, a.query_expr, mode="range",
                     radius=a.radius, predicate=a.structured_predicate,
                     alias=a.alias)
    return _project(a, Map(scan, SIM_COL, None, from_index_scan=True))


def _rewrite_dist_join(a: Analysis) -> PlanNode:
    """Q3: right side becomes a per-left-row range IndexScan; the join keeps
    only the residual structured condition."""
    left = Scan(a.left_table, a.left_alias)
    right = IndexScan(a.right_table, a.right_vector,
                      Column(a.left_vector, table=a.left_alias), mode="range",
                      radius=a.radius, predicate=None, alias=a.right_alias)
    joined = Join(left, right, a.join_predicate)
    return _project(a, Map(joined, SIM_COL, None, from_index_scan=True))


def _rewrite_knn_join(a: Analysis) -> PlanNode:
    """R2 (Fig. 5b): decouple orderBy from the window, insert an explicit
    limit; scan+orderBy+limit form one ANN-servable pipeline per left row."""
    left = Scan(a.left_table, a.left_alias)
    return _project(a, KnnSubquery(
        left, a.right_table, a.right_vector,
        Column(a.left_vector, table=a.left_alias), a.k,
        a.join_predicate, a.rank_name))


def _rewrite_category_partition(a: Analysis) -> PlanNode:
    """R3 (Fig. 6b): insert updateState between the range IndexScan and the
    window so the scan can stop at R2 <= R1."""
    scan = IndexScan(a.table, a.vector_column, a.query_expr, mode="range",
                     radius=a.radius, predicate=a.structured_predicate,
                     alias=a.alias)
    upd = UpdateState(scan, a.category_column, a.k)
    win = WindowRank(Map(upd, SIM_COL, None, from_index_scan=True),
                     a.partition_keys, Column(SIM_COL), a.rank_name)
    ranked = Filter(win, Column(a.rank_name) <= a.k)
    return _project(a, ranked)


def _rewrite_category_join(a: Analysis) -> PlanNode:
    """Q6 = Q3's join shape + R3's updateState per left row."""
    left = Scan(a.left_table, a.left_alias)
    scan = IndexScan(a.right_table, a.right_vector,
                     Column(a.left_vector, table=a.left_alias), mode="range",
                     radius=a.radius, predicate=None, alias=a.right_alias)
    upd = UpdateState(scan, a.category_column, a.k)
    joined = Join(left, upd, a.join_predicate)
    win = WindowRank(Map(joined, SIM_COL, None, from_index_scan=True),
                     a.partition_keys, Column(SIM_COL), a.rank_name)
    ranked = Filter(win, Column(a.rank_name) <= a.k)
    return _project(a, ranked)
