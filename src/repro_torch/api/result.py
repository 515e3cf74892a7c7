"""Structured results for the session API.

The legacy execute surfaces returned raw pytrees whose keys varied by query
class (``ids`` vs ``qid``/``tid``, optional ``count``/``rank``).  The session
API wraps every execution in :class:`Result` / :class:`ResultBatch`:

* the raw tree stays reachable (``res.data`` and ``res["ids"]``) so the
  wrappers are bit-transparent — parity tests compare leaves directly;
* uniform accessors (``ids``, ``order_keys``, ``valid``, ``counters``) work
  across all six query classes;
* ``explain()`` returns a live :class:`ExplainReport` — plan-cache hit,
  chosen batch lowering, and the *current* ``BucketedExecutor`` state
  (compiled buckets, trace counts), so serving regressions are diagnosable
  without a debugger.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from .hints import ExecutionHints


@dataclasses.dataclass(frozen=True)
class ExplainReport:
    """One execution's (or prepared statement's) explain snapshot.

    ``buckets`` / ``trace_counts`` reflect the executor state at the moment
    ``explain()`` was called — live, not frozen at prepare time."""
    sql: str
    engine: str
    query_class: str
    plan_key: str                       # fingerprint digest (cache identity)
    cache_hit: bool
    batch_native: bool
    batch_lowering: str                 # human-readable chosen lowering
    buckets: tuple[int, ...]            # compiled bucket executables (sorted)
    trace_counts: dict[int, int]        # bucket -> times (re)traced
    logical_plan: str
    rewritten_plan: str
    path: str | None = None             # single | batch | bucketed | effort
    bucket: int | None = None           # bucket this execution ran in
    num_queries: int | None = None
    hints: ExecutionHints | None = None
    effort: dict | None = None          # n_light / n_heavy split, if any
    opt: dict | None = None             # advisor decision (DESIGN.md §14)
    shards: int | None = None           # corpus shard count (dist plans)
    merge_depth: int | None = None      # hierarchical-merge levels (dist)
    degraded: dict | None = None        # overload level/budget, if degraded
    freshness: dict | None = None       # live-corpus state, if one attached
    aot: dict | None = None             # persistent-plan-cache counters +
                                        # per-bucket disk loads (§15)

    def render(self) -> str:
        """Multi-line text form (what ``print(explain())`` shows)."""
        out = [f"-- engine: {self.engine}",
               f"-- class:  {self.query_class}",
               f"-- plan:   {self.plan_key} "
               f"({'cache hit' if self.cache_hit else 'compiled'})",
               f"-- batch:  {self.batch_lowering}"]
        if self.shards is not None:
            out.append(f"-- dist:   shards={self.shards} "
                       f"merge_depth={self.merge_depth}")
        out.append(f"-- buckets: {list(self.buckets)} "
                   f"trace_counts={self.trace_counts}")
        if self.path is not None:
            exec_line = f"-- exec:   path={self.path}"
            if self.bucket is not None:
                exec_line += f" bucket={self.bucket}"
            if self.num_queries is not None:
                exec_line += f" queries={self.num_queries}"
            out.append(exec_line)
        if self.effort is not None:
            out.append(f"-- effort: {self.effort}")
        if self.opt is not None:
            out.append(f"-- opt:    {self.opt}")
        if self.aot is not None:
            out.append(f"-- aot:    hits={self.aot.get('hits')} "
                       f"misses={self.aot.get('misses')} "
                       f"corrupt={self.aot.get('corrupt')} "
                       f"stale={self.aot.get('stale')} "
                       f"saves={self.aot.get('saves')} "
                       f"loaded={self.aot.get('loaded')}")
        if self.degraded is not None:
            out.append(f"-- DEGRADED: overload level="
                       f"{self.degraded.get('level')} "
                       f"probe_budget={self.degraded.get('probe_budget')}")
        if self.freshness is not None:
            out.append(f"-- live:   delta_rows="
                       f"{self.freshness.get('delta_rows')} "
                       f"tombstones={self.freshness.get('tombstones')} "
                       f"lsn={self.freshness.get('lsn')} "
                       f"last_compact_lsn="
                       f"{self.freshness.get('last_compact_lsn')}")
        out += ["-- logical plan:", self.logical_plan,
                "-- rewritten plan:", self.rewritten_plan]
        return "\n".join(out)

    def __str__(self) -> str:
        return self.render()


class Result:
    """A single query's structured result (leaves have no leading Q axis)."""

    def __init__(self, data: dict, explain_fn: Callable[[], ExplainReport]):
        self.data = data
        self._explain_fn = explain_fn

    # -- raw-tree transparency ---------------------------------------------
    def __getitem__(self, key: str):
        return self.data[key]

    def __contains__(self, key: str) -> bool:
        return key in self.data

    def keys(self):
        """Raw output-tree keys (dict-transparent surface)."""
        return self.data.keys()

    def get(self, key: str, default=None):
        """dict.get over the raw output tree."""
        return self.data.get(key, default)

    # -- uniform accessors --------------------------------------------------
    @property
    def ids(self):
        """Result row ids (``ids`` for single-table classes, ``tid`` —
        the right-side target ids — for the join families)."""
        return self.data["ids"] if "ids" in self.data else self.data["tid"]

    @property
    def order_keys(self):
        """Raw similarity/distance values the ordering ran on (the map
        operator's ``__sim`` — never recomputed downstream)."""
        return self.data["sim"]

    @property
    def valid(self):
        """Per-result validity mask (False lanes are empty buffer slots)."""
        return self.data["valid"]

    @property
    def counters(self) -> dict:
        """Per-query execution counters (probes, distance evals, ...)."""
        return self.data.get("stats", {})

    def explain(self) -> ExplainReport:
        """Live execution report (cache hit, lowering, executor state)."""
        return self._explain_fn()

    def __repr__(self):
        keys = ",".join(sorted(self.data))
        return f"{type(self).__name__}(keys=[{keys}])"


class ResultBatch(Result):
    """A batched execution's structured result: every leaf carries a leading
    Q axis; ``len()`` is the number of queries and ``query(i)`` slices one
    query's view (host-side — never triggers a recompile)."""

    def __init__(self, data: dict, explain_fn: Callable[[], ExplainReport],
                 num_queries: int):
        super().__init__(data, explain_fn)
        self.num_queries = num_queries

    def __len__(self) -> int:
        return self.num_queries

    def query(self, i: int) -> Result:
        """One query's view of the batch (host-side slice; no recompile)."""
        if not -self.num_queries <= i < self.num_queries:
            raise IndexError(f"query index {i} out of range for batch of "
                             f"{self.num_queries}")

        def slice_tree(v: Any):
            if isinstance(v, dict):
                return {k: slice_tree(x) for k, x in v.items()}
            return v[i]

        return Result(slice_tree(self.data), self._explain_fn)
