"""The session API: ``connect(catalog) -> Database``, ``db.prepare(sql) ->
Statement``, ONE ``Statement.execute`` front door.

* ``Statement.execute(binds)`` routes by shape — a single bind dict runs the
  single-query pipeline, a list of dicts (or a stacked dict with a leading
  Q axis) runs the size-bucketed path; ``ExecutionHints(exact_shape=True)``
  runs the exact-shape batch (the bit-parity reference).
* ``Database`` fronts a **normalized plan cache**: the key is the
  canonicalized logical-plan fingerprint (whitespace / parameter-rename /
  conjunct-order variants collapse to one key) plus the ``EngineOptions``
  fingerprint plus the canonicalized static binds, LRU-bounded.  A hit
  reuses the compiled plan AND its bucket executors.

* ``db.serve(statement)`` wraps :class:`~repro_torch.serving.scheduler.
  BatchScheduler` for submit/poll serving on the same cached executors
  (a :class:`~repro_torch.serving.scheduler.ResilientScheduler` when a
  degradation ``policy`` or ``faults`` is given).

Every query class (Q1–Q6) prepares under every engine, the default
``EngineOptions()`` included, and probes a registered IVF index where the
reference's plan does (``core/physical.py``); everything else runs the
flat path.

* ``db.attach_live(table, column, path)`` makes a (table, vector column)
  pair mutable (:mod:`repro_torch.data.mutations`): ``db.insert`` /
  ``db.delete`` / ``db.compact`` reach every prepared statement on it at
  its next execute, and ``explain()`` reports the corpus's freshness.
* ``connect(cat, adaptive=True)`` attaches a
  :class:`~repro_torch.opt.LoweringAdvisor`: a batched execution with no
  execution knob takes the advisor's path (``path="opt"``; lock-step or
  effort-bucketed, bit-identical either way) and feeds its counters back;
  ``db.advise(sql)`` scores the plan's lanes.
* ``EngineOptions(dist=DistSpec(...))`` runs every class on the sharded
  fused flat scan; ``explain()`` reports ``shards`` and ``merge_depth``.

* ``connect(cat, aot_cache_path=dir)`` attaches the on-disk plan cache
  (:mod:`repro_torch.core.aot`): a prepare in a new process restores the
  plan's analysis and rewritten plan from disk (no ``analyze`` or
  ``rewrite``), a bucket's first execute restores its entry and writes the
  kernel libraries it needs back into ``build/kernels/`` (no ``nvcc``),
  and ``cache_info().aot`` / ``explain().aot`` report the counters.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any

import numpy as np

from .. import tracing
from ..core.compiler import (CompiledQuery, StalePlanError, compile_plan,
                             fingerprint_digest, plan_fingerprint, _scan_of,
                             _stacked_qn)
from ..core.expr import Param
from ..core.physical import EngineOptions
from ..core.schema import Catalog
from ..core.sql import parse_sql
from .hints import ExecutionHints
from .result import ExplainReport, Result, ResultBatch

NO_HINTS = ExecutionHints()


@dataclasses.dataclass(frozen=True)
class CacheInfo:
    """Plan-cache statistics snapshot (functools-style).  ``aot`` is the
    on-disk cache's counter snapshot (hits / misses / corrupt / stale /
    errors / saves) when the session connected with ``aot_cache_path``,
    else None."""
    hits: int
    misses: int
    entries: int
    evictions: int = 0
    max_entries: "int | None" = None
    aot: "dict | None" = None


@dataclasses.dataclass
class _CacheEntry:
    """One normalized plan: the compiled artifact plus ITS parameter names in
    canonical slot order (variants translate their names slot-by-slot).
    ``evicted`` flips when the LRU bound or a stale-plan invalidation drops
    the entry; Statements holding it re-prepare on their next execute."""
    compiled: CompiledQuery
    param_order: tuple[str, ...]
    fingerprint: str
    evicted: bool = False


def connect(catalog: Catalog, options: EngineOptions | None = None,
            max_cached_plans: int | None = 128, adaptive: bool = False,
            stats_path: str | None = None,
            aot_cache_path: str | None = None,
            **option_overrides) -> "Database":
    """Open a session over a catalog — the one front door to the engine.

    Plans run on the device the catalog's tables live on.
    ``option_overrides`` are convenience kwargs onto :class:`EngineOptions`
    (``connect(cat, engine="brute", use_pallas=True)``); ``max_cached_plans``
    bounds the normalized plan cache (LRU; None = unbounded).
    ``adaptive=True`` attaches a :class:`~repro_torch.opt.LoweringAdvisor`:
    batched executions feed runtime stats back and get predicted probe
    budgets, hints always winning; ``stats_path`` persists and restores its
    stats store there (the reference's JSON: either package reads the
    other's file).  ``aot_cache_path`` names a directory for the on-disk
    plan cache: entries persist write-through and restore on restart with
    no front-end pass and no kernel build, so a new process preparing a
    statement seen before is warm."""
    if option_overrides:
        options = dataclasses.replace(options or EngineOptions(),
                                      **option_overrides)
    return Database(catalog, options or EngineOptions(),
                    max_cached_plans=max_cached_plans, adaptive=adaptive,
                    stats_path=stats_path, aot_cache_path=aot_cache_path)


class Database:
    """A connection-like session: catalog + options + normalized plan cache
    (LRU-bounded by ``max_cached_plans``), with ``adaptive`` the session's
    lowering advisor, and with ``aot_cache_path`` the on-disk plan cache
    (``aot_cache``)."""

    def __init__(self, catalog: Catalog, options: EngineOptions | None = None,
                 max_cached_plans: int | None = 128, adaptive: bool = False,
                 stats_path: str | None = None,
                 aot_cache_path: str | None = None):
        if max_cached_plans is not None and max_cached_plans < 1:
            raise ValueError(
                f"max_cached_plans must be >= 1 or None, "
                f"got {max_cached_plans}")
        self.catalog = catalog
        self.options = options or EngineOptions()
        self.max_cached_plans = max_cached_plans
        self.advisor = None
        if adaptive:
            from ..opt import LoweringAdvisor
            self.advisor = LoweringAdvisor(catalog, stats_path=stats_path)
        self.aot_cache = None
        if aot_cache_path is not None:
            from ..core.aot import AOTPlanCache
            self.aot_cache = AOTPlanCache(aot_cache_path)
        self._cache: "collections.OrderedDict[tuple, _CacheEntry]" = (
            collections.OrderedDict())
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    # -- prepared statements ------------------------------------------------

    def prepare(self, sql: str, hints: ExecutionHints | None = None,
                options: EngineOptions | None = None,
                **static_binds) -> "Statement":
        """Parse, normalize, and compile (or reuse) a statement.

        ``hints`` become the statement's default execution hints; a
        ``join_lowering`` or ``rescore_factor`` hint is compile-affecting and
        folds into the options fingerprint.  ``static_binds`` resolve
        shape-forming parameters (K values) and are part of the cache key in
        canonical slot order."""
        hints = hints or NO_HINTS
        base_options = options or self.options
        eff_options = base_options
        if hints.join_lowering is not None:
            eff_options = dataclasses.replace(
                eff_options, join_lowering=hints.join_lowering)
        if hints.rescore_factor is not None:
            eff_options = dataclasses.replace(
                eff_options, rescore_factor=hints.rescore_factor)
        plan = parse_sql(sql)
        fp, param_order = plan_fingerprint(plan)
        key = (fp, eff_options.fingerprint(),
               self._static_key(static_binds, param_order))
        entry = self._cache.get(key)
        if entry is not None:
            try:
                entry.compiled.ensure_fresh()
            except StalePlanError:
                self._evict(key)
                entry = None
        if entry is None:
            self._misses += 1
            compiled = self._compile(sql, plan, eff_options,
                                     dict(static_binds), key)
            entry = _CacheEntry(compiled, param_order, fp)
            self._cache[key] = entry
            self._trim()
            cache_hit = False
        else:
            self._hits += 1
            self._cache.move_to_end(key)
            cache_hit = True
        return Statement(self, sql, entry, param_order, hints, cache_hit,
                         base_options, dict(static_binds))

    def execute(self, sql: str, binds=None,
                hints: ExecutionHints | None = None, **static_binds):
        """One-shot convenience: ``prepare`` (cached) + ``execute``."""
        return self.prepare(sql, hints=hints, **static_binds).execute(binds)

    def _compile(self, sql: str, plan, options: EngineOptions,
                 static_binds: dict, key: tuple) -> CompiledQuery:
        """Compile a plan-cache miss.  Under the on-disk cache the plan's
        portable part is restored from any valid entry of the plan (no
        ``analyze`` or ``rewrite``), and the fresh executor is routed
        through the cache: persisted buckets restore, cold ones persist
        write-through, which makes LRU eviction evict to disk."""
        if self.aot_cache is None:
            return compile_plan(sql, plan, self.catalog, options,
                                static_binds)
        from ..core.aot import plan_binding
        compiled = None
        found = self.aot_cache.restore_plan(key, self.catalog)
        if found is not None:
            parts, binding, path = found
            try:
                compiled = compile_plan(sql, plan, self.catalog, options,
                                        static_binds, restored=parts)
            except Exception as exc:                   # noqa: BLE001
                self.aot_cache.reject(path, "corrupt",
                                      f"restored plan does not compile "
                                      f"({type(exc).__name__}: {exc})")
        if compiled is None:
            compiled = compile_plan(sql, plan, self.catalog, options,
                                    static_binds)
            binding = plan_binding(self.aot_cache, key, self.catalog,
                                   compiled.analysis, options)
        compiled.executor.attach_aot(binding)
        return compiled

    def cache_info(self) -> CacheInfo:
        """Hits / misses / live entries / evictions of the plan cache, plus
        the on-disk cache's counter snapshot when ``aot_cache_path`` is
        set."""
        return CacheInfo(self._hits, self._misses, len(self._cache),
                         self._evictions, self.max_cached_plans,
                         aot=(None if self.aot_cache is None
                              else self.aot_cache.stats()))

    def serve(self, statement: "Statement | str", config=None, *,
              max_batch: int = 64, max_wait_ms: float = 2.0,
              pilot_budget: int = 0, policy=None, faults=None,
              **static_binds):
        """A submit/poll server over one prepared statement.

        Wraps :class:`~repro_torch.serving.scheduler.BatchScheduler`:
        requests coalesce under the deadline rule and drain through the
        statement's size-bucketed executor cache (``pilot_budget`` > 0 adds
        two-phase effort-bucketed IVF probing).  Passing a ``policy``
        (:class:`~repro_torch.serving.resilience.DegradePolicy`) or
        ``faults`` (:class:`~repro_torch.serving.faults.FaultInjector`)
        upgrades to a :class:`~repro_torch.serving.scheduler.
        ResilientScheduler` with graceful degradation under overload.  A
        plain scheduler carries the session's advisor, if any."""
        from ..serving.scheduler import (BatchScheduler, ResilientScheduler,
                                         SchedulerConfig)
        if isinstance(statement, str):
            statement = self.prepare(statement, **static_binds)
        elif static_binds:
            raise TypeError(
                f"static binds {sorted(static_binds)} cannot be applied to "
                f"an already-prepared Statement; pass them to prepare(), or "
                f"pass the SQL string to serve()")
        if config is None:
            config = SchedulerConfig(max_batch=max_batch,
                                     max_wait_ms=max_wait_ms,
                                     pilot_budget=pilot_budget)
        if policy is not None or faults is not None:
            return ResilientScheduler(statement, config, policy=policy,
                                      faults=faults)
        return BatchScheduler(statement, config, advisor=self.advisor)

    def advise(self, sql: str, selectivity: float = 1.0,
               **static_binds) -> dict:
        """Prepare-time lowering advice for ``sql``: the cost model's scores
        of the flat / IVF / quantized lanes of this plan's corpus under a
        selectivity estimate, the recommended lane and the constants
        (advisory: execute-time decisions stay within bit-identical effort
        lanes; pick ``EngineOptions`` from the recommendation)."""
        st = self.prepare(sql, **static_binds)
        advisor = self.advisor
        if advisor is None:
            from ..opt import LoweringAdvisor
            advisor = LoweringAdvisor(self.catalog)
        return advisor.score_plan(st.compiled, selectivity=selectivity)

    # -- live corpus mutations ----------------------------------------------

    def attach_live(self, table: str, column: str, path, **kw):
        """Attach a :class:`~repro_torch.data.mutations.LiveCorpus` to a
        (table, vector column) pair, making ``db.insert`` / ``db.delete``
        available and every plan prepared on the pair delta-aware.
        Delegates to :func:`repro_torch.data.mutations.attach_live` (same
        kwargs: ``delta_cap``, ``cap_main``, ``nlist``, ``seed``, ``ids``,
        ...)."""
        from ..data.mutations import attach_live
        return attach_live(self.catalog, table, column, path, **kw)

    def _live_handle(self, table: str, column: str | None):
        """The LiveCorpus a mutation call names (a typed error when the
        pair has none attached, or the column is ambiguous)."""
        from ..serving.resilience import MutationError
        if column is None:
            cols = self.catalog.live_columns(table)
            if len(cols) != 1:
                raise MutationError(
                    f"table {table!r} has {len(cols)} live vector columns "
                    f"({sorted(cols)}); pass column= explicitly" if cols else
                    f"table {table!r} has no live corpus attached; call "
                    f"db.attach_live(table, column, path) first")
            column = cols[0]
        live = self.catalog.live_for(table, column)
        if live is None:
            raise MutationError(
                f"no live corpus attached to ({table!r}, {column!r}); call "
                f"db.attach_live(table, column, path) first")
        return live

    def insert(self, table: str, ids, vectors, columns=None, *,
               column: str | None = None) -> int:
        """Insert rows into a live corpus, visible to every prepared plan
        at its next execute with no executor rebuilt; returns the
        mutation's LSN.  ``column`` may be omitted when the table has
        exactly one live vector column."""
        return self._live_handle(table, column).insert(ids, vectors, columns)

    def delete(self, table: str, ids, *, column: str | None = None) -> int:
        """Tombstone rows of a live corpus by user id (visible at the next
        execute); returns the mutation's LSN."""
        return self._live_handle(table, column).delete(ids)

    def compact(self, table: str, *, column: str | None = None) -> int:
        """Fold a live corpus's delta rows and tombstones back into its main
        segment (rebuilding the IVF when one is registered); returns the
        compaction's LSN."""
        return self._live_handle(table, column).compact()

    def freshness(self, table: str, *, column: str | None = None) -> dict:
        """The live corpus's freshness counters (delta rows, tombstones,
        LSNs): the dict ``explain()`` reports per statement."""
        return self._live_handle(table, column).freshness()

    # -- internals ----------------------------------------------------------

    def _evict(self, key: tuple) -> None:
        entry = self._cache.pop(key, None)
        if entry is not None:
            entry.evicted = True
            self._evictions += 1

    def _trim(self) -> None:
        if self.max_cached_plans is None:
            return
        while len(self._cache) > self.max_cached_plans:
            self._evict(next(iter(self._cache)))

    @staticmethod
    def _static_key(static_binds: dict, param_order: tuple[str, ...]) -> tuple:
        """Static binds keyed by canonical parameter SLOT (rename-proof)."""
        def slot(name: str):
            return (param_order.index(name) if name in param_order
                    else ("name", name))

        def val(v: Any):
            try:
                hash(v)
                return v
            except TypeError:
                return repr(np.asarray(v).tolist())

        return tuple(sorted(
            ((slot(k), val(v)) for k, v in static_binds.items()),
            key=repr))


class Statement:
    """A prepared statement: the cached plan + this statement's bind-name
    translation.  One ``execute`` front door for every execution shape."""

    def __init__(self, db: Database, sql: str, entry: _CacheEntry,
                 param_order: tuple[str, ...], hints: ExecutionHints,
                 cache_hit: bool, base_options: EngineOptions,
                 static_binds: dict):
        self._db = db
        self.sql = sql
        self._entry = entry
        self._param_order = param_order
        self.hints = hints
        self.cache_hit = cache_hit
        # what prepare() saw BEFORE hint folding — a compile-affecting hint
        # re-prepares with the same options base and static binds
        self._base_options = base_options
        self._static_binds = static_binds
        # this statement's param name -> the cached plan's name, slot-aligned
        self._rename = {a: b for a, b in zip(param_order, entry.param_order)
                        if a != b}

    @property
    def compiled(self) -> CompiledQuery:
        """The (shared, cached) compiled handle behind this statement."""
        return self._entry.compiled

    @property
    def executor(self):
        """The shared BucketedExecutor (bucket cache) of the cached plan."""
        return self._entry.compiled.executor

    @property
    def batch_native(self) -> bool:
        """True when the plan's batched lowering is native."""
        return self._entry.compiled.batch_native

    def ensure_fresh(self) -> None:
        """Make this statement's entry current before execution: re-prepare
        through the cache when the entry was evicted or the catalog moved
        structurally under it (:class:`StalePlanError`)."""
        if not self._entry.evicted:
            try:
                self._entry.compiled.ensure_fresh()
                return
            except StalePlanError:
                pass
        fresh = self._db.prepare(self.sql, hints=self.hints,
                                 options=self._base_options,
                                 **self._static_binds)
        self._entry = fresh._entry
        self._rename = fresh._rename
        self.cache_hit = fresh.cache_hit

    def _stack_binds(self, binds_list, stacked) -> dict:
        """Stack bind dicts (or a stacked dict) under the cached plan's
        parameter names (the scheduler contract)."""
        if binds_list is not None:
            binds_list = [self._renamed(b) for b in binds_list]
        if stacked:
            stacked = self._renamed(stacked)
        return self.compiled._stack_binds(binds_list, stacked)

    def execute(self, binds=None, hints: ExecutionHints | None = None):
        """THE execute front door.

        * dict of scalar-per-query binds  -> single-query pipeline,
        * list/tuple of bind dicts        -> size-bucketed batch,
        * stacked dict (leading Q axis)   -> size-bucketed batch,
        * ``hints.exact_shape=True``      -> exact-shape batch.

        Returns :class:`Result` (single) or :class:`ResultBatch` (batch).
        The whole call is the span ``repro_torch.execute``
        (:mod:`repro_torch.tracing`)."""
        with tracing.span(tracing.EXECUTE):
            return self._execute(binds, hints)

    def _execute(self, binds, hints: ExecutionHints | None):
        self.ensure_fresh()
        hints = self.hints if hints is None else hints
        if (hints.join_lowering is not None
                and hints.join_lowering != self.compiled.options.join_lowering
                ) or (hints.rescore_factor is not None
                      and hints.rescore_factor
                      != self.compiled.options.rescore_factor):
            return self._db.prepare(
                self.sql, hints=hints, options=self._base_options,
                **self._static_binds).execute(binds, hints=hints)
        if binds is None:
            binds = {}
        if isinstance(binds, (list, tuple)):
            return self._execute_batch([self._renamed(b) for b in binds],
                                       None, hints)
        if not isinstance(binds, dict):
            raise TypeError(
                f"binds must be a dict (single query), a list of dicts, or "
                f"a stacked dict with a leading Q axis; got {type(binds)}")
        renamed = self._renamed(binds)
        if self._is_stacked(renamed):
            return self._execute_batch(None, renamed, hints)
        hints.validate_for_single()
        with tracing.span(tracing.EXECUTOR):
            out = self.compiled.plan.fn(self.compiled._arrays, dict(renamed))
        report = self._report_fn(path="single", num_queries=1, hints=hints)
        return Result(out, report)

    def _execute_batch(self, binds_list, stacked_binds,
                       hints: ExecutionHints):
        compiled = self.compiled
        hints.validate_for_plan(compiled.batch_native,
                                compiled.plan.batch_reason)
        with tracing.span(tracing.BIND):
            binds = compiled._stack_binds(binds_list, stacked_binds or {})
        qn = _stacked_qn(binds)
        probe_budget = hints.probe_budget
        if isinstance(probe_budget, tuple):
            if len(probe_budget) != qn:
                raise ValueError(
                    f"per-query probe_budget has {len(probe_budget)} "
                    f"entries for a batch of {qn} queries")
            probe_budget = np.asarray(probe_budget, np.int32)
        effort = None
        opt = None
        advisor = self._db.advisor
        if hints.exact_shape:
            path = "batch"
            with tracing.span(tracing.EXECUTOR):
                out = compiled.plan.batch_fn(compiled._arrays, binds)
        elif hints.pilot_budget > 0:
            from ..serving.scheduler import run_effort_bucketed
            path = "effort"
            out, effort = run_effort_bucketed(compiled, binds,
                                              hints.pilot_budget)
        elif (advisor is not None and advisor.enabled and not hints.no_opt
                and probe_budget is None and compiled.batch_native):
            # the adaptive path: hints always win — it is taken only when
            # the caller set no execution knob
            from ..serving.scheduler import run_effort_bucketed
            path = "opt"
            out, effort = run_effort_bucketed(compiled, binds, 0,
                                              advisor=advisor)
            opt = effort.pop("opt", None)
        else:
            path = "bucketed"
            out = compiled.executor(binds, probe_budget=probe_budget)
        bucket = (compiled.executor.bucket_for(qn)
                  if path in ("bucketed", "effort", "opt") else None)
        report = self._report_fn(path=path, bucket=bucket, num_queries=qn,
                                 hints=hints, effort=effort, opt=opt)
        return ResultBatch(out, report, qn)

    def explain(self) -> ExplainReport:
        """Live statement-level report (no execution context)."""
        return self._report_fn()()

    def _report_fn(self, **exec_fields):
        """Build an explain closure: called lazily so ``buckets`` and
        ``trace_counts`` reflect the executor state WHEN explain() runs."""
        def build() -> ExplainReport:
            c = self.compiled
            ex = c.executor
            dist = c.options.dist
            # freshness is read WHEN explain() runs (like trace_counts), so
            # the report reflects mutations that landed after execution
            live = self._db.catalog.live_for(*_scan_of(c.analysis))
            return ExplainReport(
                sql=self.sql,
                engine=c.options.engine,
                query_class=c.analysis.query_class.value,
                plan_key=fingerprint_digest(self._entry.fingerprint),
                cache_hit=self.cache_hit,
                batch_native=c.batch_native,
                batch_lowering=c.plan.batch_reason,
                buckets=tuple(ex.buckets),
                trace_counts=dict(ex.trace_counts),
                logical_plan=c.logical_plan.pretty(),
                rewritten_plan=c.rewritten_plan.pretty(),
                shards=None if dist is None else dist.num_shards,
                merge_depth=None if dist is None else dist.merge_depth,
                freshness=None if live is None else live.freshness(),
                aot=(None if self._db.aot_cache is None else
                     {**self._db.aot_cache.stats(),
                      "loaded": dict(ex.aot_loaded)}),
                **exec_fields)

        return build

    def _renamed(self, binds: dict) -> dict:
        unknown = [k for k in binds if k not in self._param_order]
        if unknown:
            raise ValueError(
                f"unknown bind parameter(s) {sorted(unknown)}; this "
                f"statement's parameters are {sorted(self._param_order)}")
        if not self._rename:
            return binds
        return {self._rename.get(k, k): v for k, v in binds.items()}

    def _is_stacked(self, binds: dict) -> bool:
        """A dict routes to the batch path iff it is stacked: the query
        vector carries (Q, D), or any bind carries a leading Q axis."""
        def ndim(v) -> int:
            return v.ndim if hasattr(v, "ndim") else np.ndim(v)

        qe = self.compiled.analysis.query_expr
        if isinstance(qe, Param) and qe.name in binds:
            return ndim(binds[qe.name]) >= 2
        return any(ndim(v) >= 1 for v in binds.values())

    def __repr__(self):
        return (f"Statement(class={self.compiled.analysis.query_class.value}, "
                f"plan={fingerprint_digest(self._entry.fingerprint)}, "
                f"cache_hit={self.cache_hit})")
