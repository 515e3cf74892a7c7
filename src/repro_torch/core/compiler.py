"""Query compilation: logical plan -> (semantic analysis + rewrite) ->
physical builder -> torch pipeline.

The compilation product is split in two, as in the reference:

* :class:`CompiledPlan` — the shape-independent plan artifact: analysis,
  plans, options, and the single/batch pipeline functions.
* :class:`BucketedExecutor` — the runtime half: a batch of Q queries pads
  up to the enclosing power-of-two bucket, runs with a per-query ``valid``
  lane that makes pad queries inert (the kernels' qvalid lane), and slices
  outputs back to Q.

PyTorch runs eagerly, so there is nothing to trace: a bucket's executor is
a plain closure over the plan, and ``trace_counts[bucket]`` counts the
executor objects built for that bucket.  "Compiled once per bucket" keeps
its meaning — a second batch in the same bucket builds nothing.  With the
on-disk plan cache attached (``core/aot.py``) a bucket restored from disk
builds nothing either: it counts in ``aot_loaded`` instead.

The port compiles all six query classes (Q1 VKNN-SF, Q2 DR-SF, the Q3
distance join, the Q4 KNN join, Q5 category partition, the Q6 category
join) on the flat path, with or without ``EngineOptions.quant``, and over a
registered IVF index under every engine, in both join lowerings, as the
reference lowers them (``core/physical.py``).  Without an index every
engine lowers as the reference lowers a missing index: the flat scan,
``brute_sort`` the Q4 full sort.  Over a live corpus
(``data/mutations.py``) the plans read its segments and merge its delta,
under ``chase`` and ``brute`` in the batch lowering.  Under
``EngineOptions.dist`` the scanned corpus is row-sharded over the spec's
mesh (``dist/sharding.py``) and every class lowers onto the sharded fused
flat scan, a live corpus's main segment included.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Any, Callable

import numpy as np
import torch

from .. import tracing
from ..roofline import op_counter
from .expr import BoolOp, Bindings, Expr, Param, on_device
from .physical import (BATCH_BUILDERS, BUILDERS, JOIN_LOWERING_FAMILIES,
                       EngineOptions, _stacked_qn)
from .plan import PlanNode
from .rewriter import rewrite
from .schema import Catalog
from .semantics import Analysis, QueryClass, analyze
from .sql import parse_sql


class StalePlanError(RuntimeError):
    """A compiled plan's catalog registrations changed in a way that cannot
    be re-bound in place: a table was re-registered (the builders close
    over its predicate columns).  Recovery is a re-prepare; the session API
    does it transparently."""


_SINGLE_TABLE = (QueryClass.VKNN_SF, QueryClass.DR_SF,
                 QueryClass.CATEGORY_PARTITION)


def _scan_of(a: Analysis) -> tuple[str, str]:
    """The (table, vector column) pair a plan's corpus scan reads — the
    pair index / live / sharded registrations key on."""
    if a.query_class in _SINGLE_TABLE:
        return a.table, a.vector_column
    return a.right_table, a.right_vector


def _catalog_dep_keys(a: Analysis, catalog: Catalog,
                      options: EngineOptions) -> tuple:
    """The catalog registration keys a compiled plan captures — what
    :meth:`CompiledQuery.ensure_fresh` watches for version bumps: the
    scanned table, both tables of a join, the scanned column's index, over
    a live corpus its live key (every insert, delete and compaction bumps
    it), under ``dist`` its sharded handle, and under ``quant`` the frozen
    column's quantized twin (a live twin rides the live key: it is cached
    on the corpus).  The keys and their order are the reference's, so a
    version token equals the reference's for the same registrations."""
    scan = _scan_of(a)
    if a.query_class in _SINGLE_TABLE:
        keys = (("table", a.table),)
    else:
        keys = (("table", a.left_table), ("table", a.right_table))
    keys += (("index",) + scan,)
    if options.dist is not None:
        keys += (("sharded",) + scan,)
    live = catalog.live_for(*scan) is not None
    if options.quant is not None and not live:
        keys += (("quantized",) + scan,)
    if live:
        keys += (("live",) + scan,)
    return keys


def _scan_lock(a: Analysis, catalog: Catalog):
    """The scanned column's live-corpus lock (a no-op without one): a
    re-bind gathers the segments and snapshots the versions with no
    mutation in between."""
    live = catalog.live_for(*_scan_of(a))
    return contextlib.nullcontext() if live is None else live._lock


# ---------------------------------------------------------------------------
# plan fingerprinting (the normalized plan-cache key, DESIGN.md §9)
# ---------------------------------------------------------------------------
#
# Two SQL texts that parse to the same logical plan modulo (a) whitespace,
# (b) parameter names, and (c) the order of commutative AND/OR conjuncts
# must share one CompiledPlan — plan reuse across requests is the dominant
# serving cost, and prepared statements arrive in every textual variant.
#
# Canonicalization: parameters are renamed positionally (?0, ?1, ... in
# canonical traversal order) and commutative BoolOp operands are sorted by
# their *name-erased* serialization (params rendered as a bare "?"), so the
# operand order and the positional assignment are both stable across
# variants.  The fingerprint is the canonical serialization; the canonical
# parameter order is returned alongside so a cache hit can translate the
# statement's own bind names onto the cached plan's names.

def _param_slot(params: list, name: str) -> int:
    if name not in params:
        params.append(name)
    return params.index(name)


def _fp_value(v: Any, params: list | None) -> str:
    if isinstance(v, (Expr, PlanNode)):
        return _fp_node(v, params)
    if isinstance(v, tuple):
        return "(" + ",".join(_fp_value(x, params) for x in v) + ")"
    return repr(v)


def _fp_node(n: Any, params: list | None) -> str:
    """Serialize one plan/expr node; ``params is None`` => name-erased mode
    (every parameter renders as "?" — the commutative-sort key)."""
    if isinstance(n, Param):
        return "?" if params is None else f"?{_param_slot(params, n.name)}"
    parts = []
    for f in dataclasses.fields(n):
        v = getattr(n, f.name)
        # Limit.k (and the rewritten nodes' k) may hold a *param name* string
        if f.name == "k" and isinstance(v, str):
            parts.append("?" if params is None
                         else f"?{_param_slot(params, v)}")
            continue
        if (isinstance(n, BoolOp) and f.name == "operands"
                and n.op in ("and", "or")):
            erased = [_fp_node(o, None) for o in n.operands]
            order = sorted(range(len(erased)), key=erased.__getitem__)
            parts.append("(" + ",".join(
                _fp_node(n.operands[i], params) for i in order) + ")")
            continue
        parts.append(_fp_value(v, params))
    return type(n).__name__ + "[" + ";".join(parts) + "]"


def plan_fingerprint(plan: PlanNode) -> tuple[str, tuple[str, ...]]:
    """Canonical fingerprint of a logical plan.

    Returns ``(fingerprint, param_order)``: the fingerprint is identical for
    whitespace / parameter-rename / AND-OR-operand-order variants of the same
    SQL, and ``param_order[i]`` is THIS plan's original name for canonical
    parameter slot ``i`` (two variant plans align slot-by-slot)."""
    params: list[str] = []
    fp = _fp_node(plan, params)
    return fp, tuple(params)


def fingerprint_digest(fp: str) -> str:
    """Short stable digest of a plan fingerprint (for explain/report keys)."""
    return hashlib.sha256(fp.encode()).hexdigest()[:12]


@dataclasses.dataclass
class CompiledPlan:
    """Shape-independent compilation artifact (one per SQL + options).

    ``batch_fn`` has the uniform signature
    ``(arrays, binds, qvalid=None, probe_budget=None)``: every value in
    ``binds`` carries a leading Q axis and ``qvalid`` is an optional (Q,)
    bool marking size-bucket pad queries (inert: no results, zero
    counters)."""
    sql: str
    analysis: Analysis
    logical_plan: PlanNode
    rewritten_plan: PlanNode
    options: EngineOptions
    fn: Callable
    batch_fn: Callable
    batch_native: bool
    batch_reason: str
    static_binds: dict = dataclasses.field(default_factory=dict)


def _bucket_for(qn: int) -> int:
    """Enclosing power-of-two size bucket (1, 2, 4, 8, ...)."""
    if qn < 1:
        raise ValueError(f"batch size must be >= 1, got {qn}")
    return 1 << (qn - 1).bit_length()


def _pad_leading(v, bucket: int) -> np.ndarray:
    """Edge-pad the leading Q axis up to ``bucket`` on the host (pad rows
    repeat the last real row, so they are well-formed binds; the ``valid``
    lane makes them inert)."""
    v = np.asarray(v)
    pad = bucket - v.shape[0]
    if pad == 0:
        return v
    return np.concatenate(
        [v, np.broadcast_to(v[-1:], (pad,) + v.shape[1:])])


def _host(v) -> np.ndarray:
    """A bind as a host array (tensors are copied off their device, which
    waits for the device's stream)."""
    if isinstance(v, torch.Tensor):
        if v.device.type != "cpu":
            tracing.count("syncs")
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class BucketedExecutor:
    """Lazy per-(plan, bucket) executor cache — the serving execution tier.

    One executor exists per power-of-two bucket actually seen;
    ``trace_counts[bucket]`` counts the executors built for it (1 after the
    first batch, and it stays 1).  A batch of Q requests pads to
    ``_bucket_for(Q)``, executes with ``valid[q] = q < Q``, and slices every
    output leaf back to Q.  Pad queries are inert by construction, so
    bucketed results equal an exact-shape ``execute_batch`` bit for bit."""

    def __init__(self, plan: CompiledPlan, arrays: Any):
        self.plan = plan
        self.arrays = arrays
        self._cache: dict[int, Callable] = {}
        self.trace_counts: dict[int, int] = {}
        # on-disk plan cache: binding + executors keyed (bucket, argument
        # signature), and the buckets restored from disk
        self._aot = None
        self._aot_exec: dict[tuple[int, str], Callable] = {}
        self.aot_loaded: dict[int, int] = {}

    def attach_aot(self, binding) -> None:
        """Route this executor through an on-disk plan cache
        (:class:`repro_torch.core.aot.AOTPlanCache`).

        Once attached, a bucket with a valid entry on disk is restored
        (its kernel libraries written back, nothing built:
        ``trace_counts`` stays 0 and ``aot_loaded`` counts it), and a
        bucket without one builds its executor and persists an entry
        write-through after its first execute.  Failure anywhere in the
        persistence path degrades to the plain executor with a typed
        :class:`~repro_torch.core.aot.AOTCacheWarning`."""
        self._aot = binding

    def _run(self, arrays, binds, qvalid, probe_budget):
        return self.plan.batch_fn(arrays, binds, qvalid=qvalid,
                                  probe_budget=probe_budget)

    def bucket_for(self, qn: int) -> int:
        """Enclosing power-of-two bucket a batch of ``qn`` queries runs in."""
        return _bucket_for(qn)

    @property
    def buckets(self) -> list[int]:
        """Buckets with a built executor (sorted)."""
        return sorted(self._cache)

    def executable(self, bucket: int) -> Callable:
        """The (lazily built) executor for one bucket."""
        if bucket not in self._cache:
            self.trace_counts[bucket] = self.trace_counts.get(bucket, 0) + 1
            self._cache[bucket] = self._run
        return self._cache[bucket]

    def run_padded(self, binds: dict, qn: int, probe_budget=None):
        """Execute at bucket granularity WITHOUT slicing outputs back.

        Returns (padded outputs, bucket, valid), so tests can observe that
        pad rows are inert — empty results, zero counters.  The call is
        the span ``repro_torch.executor``."""
        with tracing.span(tracing.EXECUTOR):
            bucket = _bucket_for(qn)
            padded = {k: _pad_leading(v, bucket) for k, v in binds.items()}
            valid = np.arange(bucket) < qn
            if probe_budget is not None:
                budget = np.asarray(probe_budget, np.int32)
                if budget.ndim >= 1 and budget.shape[0] == qn:
                    budget = _pad_leading(budget, bucket)
                probe_budget = budget
            args = (self.arrays, padded, valid, probe_budget)
            if self._aot is not None:
                out = self._aot_call(bucket, args)
            else:
                out = self.executable(bucket)(*args)
            return out, bucket, valid

    # -- on-disk plan cache (core/aot.py) -----------------------------------

    def _aot_call(self, bucket: int, args: tuple):
        """Dispatch one bucket execution through the on-disk cache, keyed
        (bucket, argument signature): a live corpus's growth or an index
        replacement that changes a shape gets an entry of its own."""
        from . import aot as _aot
        sig = _aot.args_signature(args)
        fn = self._aot_exec.get((bucket, sig))
        if fn is not None:
            return fn(*args)
        if self._aot.cache.load(self._aot, bucket, sig):
            # restored from disk: the annex's libraries are in place and
            # no executor object is built for the bucket
            self.trace_counts.setdefault(bucket, 0)
            self.aot_loaded[bucket] = self.aot_loaded.get(bucket, 0) + 1
            self._aot_exec[(bucket, sig)] = self._run
            return self._run(*args)
        return self._aot_compile(bucket, sig, args)

    def _aot_compile(self, bucket: int, sig: str, args: tuple):
        """Cold path under an attached cache: serialize the plan's portable
        part, build the bucket's executor, run it once recording the kernel
        libraries it reaches, persist the entry, return the outputs.  An
        unserializable plan runs the plain executor without persisting
        (serializing builds nothing, so ``trace_counts`` needs no snapshot
        to stay honest)."""
        from ..kernels import build
        from . import aot as _aot
        binding = self._aot
        try:
            portable = _aot.export_plan(self.plan)
        except Exception as exc:                       # noqa: BLE001
            binding.cache.note_unserializable(binding.plan_key, exc)
            fn = self.executable(bucket)
            self._aot_exec[(bucket, sig)] = fn
            return fn(*args)
        fn = self.executable(bucket)
        with build.recording() as used:
            out = fn(*args)
        binding.cache.save(binding, bucket, sig, portable, used)
        self._aot_exec[(bucket, sig)] = fn
        return out

    def __call__(self, binds: dict, probe_budget=None):
        """Bucketed execution: pad -> run the bucket's executor -> slice."""
        qn = _stacked_qn(binds)
        out, _bucket, _valid = self.run_padded(binds, qn, probe_budget)
        return _tree_map(lambda v: v[:qn], out)


@dataclasses.dataclass
class CompiledQuery:
    """User-facing handle: plan artifact + per-bucket executor cache.

    ``__call__`` runs the single-query pipeline; ``execute_batch`` runs the
    exact-shape batch (the bit-parity reference); ``execute_bucketed`` runs
    the size-bucketed serving path."""
    plan: CompiledPlan
    _arrays: Any
    executor: BucketedExecutor
    _catalog: Any = None
    _dep_keys: tuple = ()
    _bound_versions: tuple = ()
    rebinds: int = 0

    @property
    def sql(self) -> str:
        """The statement's original SQL text."""
        return self.plan.sql

    @property
    def analysis(self) -> Analysis:
        """Semantic analysis (query class + extracted slots)."""
        return self.plan.analysis

    @property
    def logical_plan(self) -> PlanNode:
        """The parsed (pre-rewrite) logical plan."""
        return self.plan.logical_plan

    @property
    def rewritten_plan(self) -> PlanNode:
        """The CHASE-rewritten logical plan (R1-R3 applied)."""
        return self.plan.rewritten_plan

    @property
    def options(self) -> EngineOptions:
        """The EngineOptions this plan compiled under."""
        return self.plan.options

    @property
    def batch_native(self) -> bool:
        """True when execute_batch lowers natively."""
        return self.plan.batch_native

    def ensure_fresh(self) -> bool:
        """Re-bind this plan to the catalog's current registrations.

        * unchanged versions — no-op, returns False;
        * a re-registered index or quantized twin — re-gathers the plan's
          tensors into the same ``arrays`` dict (the executor holds that
          very object), counts it in ``rebinds`` and returns True;
        * a re-registered table, or an index appearing where the plan
          compiled without one (the array set changes) — raises
          :class:`StalePlanError` (the builders chose their lowering and
          hold the old table's columns; only a re-prepare fixes it)."""
        if self._catalog is None:
            return False
        with _scan_lock(self.analysis, self._catalog):
            current = self._catalog.version_snapshot(self._dep_keys)
            if current == self._bound_versions:
                return False
            stale = [k[1] for k, old, new in zip(
                self._dep_keys, self._bound_versions, current)
                if old != new and k[0] == "table"]
            if stale:
                raise StalePlanError(
                    f"table(s) {stale} were re-registered after this plan "
                    f"compiled; the plan's predicate columns are frozen at "
                    f"the old table — re-prepare the statement")
            new_arrays = _gather_arrays(self.analysis, self._catalog,
                                        self.options)
            if set(new_arrays) != set(self._arrays):
                raise StalePlanError(
                    f"catalog registration change altered the plan's array "
                    f"set ({sorted(self._arrays)} -> {sorted(new_arrays)}); "
                    f"index presence selects the lowering at compile time "
                    f"— re-prepare the statement")
            self._arrays.clear()
            self._arrays.update(new_arrays)
            self._bound_versions = self._catalog.version_snapshot(
                self._dep_keys)
        self.rebinds += 1
        return True

    def __call__(self, **binds):
        self.ensure_fresh()
        return self.plan.fn(self._arrays, dict(binds))

    def execute_batch(self, binds_list: list[dict] | None = None, **stacked):
        """Execute a parameter-only batch at its exact shape: Q bind sets,
        given as a list of dicts or as keyword binds with a leading Q axis
        (scalars broadcast).  Every output gains a leading Q axis."""
        self.ensure_fresh()
        binds = self._stack_binds(binds_list, stacked)
        return self.plan.batch_fn(self._arrays, binds)

    def execute_bucketed(self, binds_list: list[dict] | None = None,
                         probe_budget=None, **stacked):
        """Size-bucketed batch execution (the serving path): same results as
        :meth:`execute_batch`, run in the enclosing power-of-two bucket."""
        self.ensure_fresh()
        binds = self._stack_binds(binds_list, stacked)
        return self.executor(binds, probe_budget=probe_budget)

    def _stack_binds(self, binds_list, stacked) -> dict:
        if binds_list is not None:
            if stacked:
                raise TypeError("pass binds_list OR keyword binds, not both")
            if not binds_list:
                raise ValueError("binds_list is empty")
            keys = binds_list[0].keys()
            for i, b in enumerate(binds_list):
                missing = keys - b.keys()
                extra = b.keys() - keys
                if missing or extra:
                    offending = sorted(missing | extra)[0]
                    kind = "missing" if offending in missing else "unexpected"
                    raise ValueError(
                        f"ragged binds_list: binds_list[{i}] has {kind} key "
                        f"{offending!r} (binds_list[0] keys: "
                        f"{sorted(keys)})")
            # stacked on the host; the pipeline moves each bind to the
            # device once
            return {k: np.stack([_host(b[k]) for b in binds_list])
                    for k in keys}
        binds = {k: _host(v) for k, v in stacked.items()}
        qe = self.analysis.query_expr
        if isinstance(qe, Param) and qe.name in binds:
            qv = binds[qe.name]
            if qv.ndim != 2:
                raise ValueError(
                    f"execute_batch needs a stacked (Q, D) query vector for "
                    f"${{{qe.name}}}, got shape {qv.shape}; pass a single "
                    f"query through __call__ instead")
            qn = qv.shape[0]
        else:
            dims = [v.shape[0] for v in binds.values() if v.ndim >= 1]
            if not dims:
                raise ValueError("cannot infer batch size from scalar binds; "
                                 "use binds_list")
            qn = dims[0]
        bad = {k: v.shape for k, v in binds.items()
               if v.ndim >= 1 and v.shape[0] != qn}
        if bad:
            raise ValueError(f"stacked binds disagree on batch size {qn}: "
                             f"{bad}")
        return {k: (np.broadcast_to(v, (qn,)) if v.ndim == 0 else v)
                for k, v in binds.items()}

    def lower(self, **binds):
        """The single-query pipeline's ops and kernel launches for these
        binds, for inspection: a ``roofline.op_counter.Lowered``
        (``as_text()``, ``cost_analysis()``, ``compile()``).  Eager torch
        has no trace without a run, so the plan runs once under the
        counter and its answer is discarded; data-dependent paths (the
        IVF rounds) count the rounds these binds run.  The plan cache, the
        catalog and later answers are unchanged."""
        self.ensure_fresh()
        return op_counter.lower(self.plan.fn, self._arrays, dict(binds))

    def lower_batch(self, binds_list: list[dict] | None = None, **stacked):
        """:meth:`lower` of the exact-shape batched pipeline: what
        ``execute_batch`` runs at this Q."""
        self.ensure_fresh()
        binds = self._stack_binds(binds_list, stacked)
        return op_counter.lower(self.plan.batch_fn, self._arrays, binds)

    def export_batch(self, binds_list: list[dict] | None = None,
                     **stacked) -> bytes:
        """Serialize the batched plan's portable part (``core/aot.py``):
        the rewritten plan, analysis, options and static binds.  The binds
        are checked as ``execute_batch`` checks them; the bytes do not
        depend on Q (an eager plan runs every Q).

        The round-trip partner is :meth:`deserialize_batch`: the bytes
        restore, in this or a later process, a callable taking the same
        ``(arrays, binds)`` the batched pipeline takes, equal to
        :meth:`execute_batch` bit for bit."""
        from . import aot as _aot
        self.ensure_fresh()
        self._stack_binds(binds_list, stacked)
        return _aot.export_plan(self.plan)

    @staticmethod
    def deserialize_batch(data: bytes, catalog: Catalog):
        """Restore an :meth:`export_batch` payload to a callable taking
        ``(arrays, binds)``, with no ``analyze`` or ``rewrite``.  Unlike the
        reference's it takes the catalog: the eager builders close over
        the predicate columns, which an exported XLA module carries as
        constants."""
        from . import aot as _aot
        parts = _aot.load_plan(data)
        return _pipelines(parts["analysis"], catalog, parts["options"],
                          parts["static_binds"])[1]

    def explain(self) -> str:
        """Engine/class/lowering summary plus both plan trees, as text."""
        out = [f"-- engine: {self.options.engine}",
               f"-- class:  {self.analysis.query_class.value}",
               f"-- batch:  {self.plan.batch_reason}",
               "-- logical plan:", self.logical_plan.pretty(),
               "-- rewritten plan:", self.rewritten_plan.pretty()]
        return "\n".join(out)


def _gather_arrays(a: Analysis, catalog: Catalog,
                   options: EngineOptions) -> dict:
    """The device tensors a compiled pipeline reads: the scanned corpus, a
    join's left embeddings, the scanned column's IVF index when one is
    registered, Q5/Q6's category column, and under ``quant`` the scanned
    column's quantized twin — built and registered on the catalog at the
    first prepare that needs it, shared by every later one.

    Over a live corpus its segment tensors REPLACE the frozen corpus: the
    padded main segment and its validity lane (the tombstone bitmap), the
    delta segment, and the live scalar columns the predicates and the
    category rank read.  Its quantized twin is cached on the corpus's
    device cache, keyed ``quant:<mode>``, which compaction (the one
    mutation that moves main-segment rows) clears; the delta segment stays
    fp32."""
    table, column = _scan_of(a)
    if a.query_class in _SINGLE_TABLE:
        scanned = catalog.table(a.table)
        arrays = {"corpus": scanned[a.vector_column]}
    else:
        scanned = catalog.table(a.right_table)
        arrays = {"left": catalog.table(a.left_table)[a.left_vector],
                  "corpus": scanned[a.right_vector]}
    index = catalog.index_for(table, column)
    if index is not None:
        arrays["index"] = index
    if a.query_class in (QueryClass.CATEGORY_PARTITION,
                         QueryClass.CATEGORY_JOIN):
        arrays["categories"] = scanned[a.category_column.name]
    live = catalog.live_for(table, column)
    if live is not None:
        arrays.update(live.plan_arrays())
        if "categories" in arrays:
            arrays["categories"] = arrays["live_cols"][
                a.category_column.name]
    if options.dist is not None:
        arrays["sharded"] = _sharded(catalog, live, options, arrays, table,
                                     column)
    if options.quant is not None:
        from ..data.quantized import quantize_corpus
        if live is not None:
            key = f"quant:{options.quant}"
            quant = live._dev.get(key)
            if quant is None:
                quant = quantize_corpus(arrays["corpus"], options.quant)
                live._dev[key] = quant
        else:
            quant = catalog.quantized_for(table, column, options.quant)
            if quant is None:
                quant = quantize_corpus(arrays["corpus"], options.quant)
                catalog.register_quantized(table, column, quant)
        arrays.update(quant.plan_arrays())
        if options.dist is not None:
            arrays["dquant"] = _sharded_quant(catalog, live, options, quant,
                                              arrays["sharded"], table,
                                              column)
    return arrays


def _sharded(catalog: Catalog, live, options: EngineOptions, arrays: dict,
             table: str, column: str):
    """The scanned corpus's :class:`~repro_torch.dist.sharding.
    ShardedCorpus` on the spec's mesh: the catalog's registered handle for
    the spec (registered here at first use), or over a live corpus the one
    cached on its device dict, which compaction (the only mutation that
    moves main-segment rows) clears.  At one shard on the corpus's own
    device the handle is a view of the corpus: nothing is copied."""
    from ..dist.sharding import ShardedCorpus, resolve_mesh
    spec = options.dist
    if live is not None:
        key = f"sharded:{spec!r}"
        sharded = live._dev.get(key)
        if sharded is None:
            sharded = ShardedCorpus.build(
                resolve_mesh(spec, arrays["corpus"].device),
                arrays["corpus"], spec.axes)
            live._dev[key] = sharded
        return sharded
    sharded = catalog.sharded_for(table, column, spec)
    if sharded is None:
        sharded = ShardedCorpus.build(
            resolve_mesh(spec, arrays["corpus"].device), arrays["corpus"],
            spec.axes)
        catalog.register_sharded(table, column, sharded)
    return sharded


def _sharded_quant(catalog: Catalog, live, options: EngineOptions, quant,
                   sharded, table: str, column: str) -> tuple:
    """The quantized twin of each shard, its rows lined up with the
    shard's fp32 rows: the column twin's rows of the shard (a view when
    the shard sits on the twin's device), and the zero rows' twin on the
    divisibility pads (masked by ``row_id = -1``).  Quantization is per
    row, so this is the twin of the padded sharded corpus.  Cached per
    (mode, spec) on the catalog, or on the live corpus's device dict."""
    from ..data.quantized import quantize_corpus
    key = (options.quant, options.dist)
    live_key = f"quant:{options.quant}:dist:{options.dist!r}"
    cached = (live._dev.get(live_key) if live is not None
              else catalog.quantized_for(table, column, key))
    if cached is not None:
        return cached
    full = quant.plan_arrays()
    n, per = quant.qvecs.shape[0], sharded.shards[0].shape[0]
    out = []
    for s, shard in enumerate(sharded.shards):
        lo, hi = min(s * per, n), min((s + 1) * per, n)
        part = {k: v[lo:hi] for k, v in full.items()}
        if hi - lo < per:
            pad = quantize_corpus(shard.new_zeros(
                (per - (hi - lo), shard.shape[1])), options.quant)
            part = {k: torch.cat([part[k].to(shard.device), v])
                    for k, v in pad.plan_arrays().items()}
        out.append({k: v.to(shard.device) for k, v in part.items()})
    out = tuple(out)
    if live is not None:
        live._dev[live_key] = out
    else:
        catalog.register_quantized(table, column, out, key=key)
    return out


def _tree_stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _vmap_fallback(fn: Callable) -> Callable:
    """Loop-of-singles batch fallback with the uniform batch_fn signature
    (the torch form of the reference's vmap-of-scalar fallback): the
    single-query pipeline runs once per bind set and every output leaf is
    stacked.

    Pad queries cannot be skipped here (the scalar pipeline has no valid
    lane), so inertness is enforced on the way out: invalid queries report
    zero counters and all-False validity.  ``probe_budget`` has no lane
    either and is ignored."""

    def bfn(arrs, binds, qvalid=None, probe_budget=None):
        qn = _stacked_qn(binds)
        out = _tree_stack([fn(arrs, {k: v[i] for k, v in binds.items()})
                           for i in range(qn)])
        if qvalid is None:
            return out
        dev = out["valid"].device
        qv = on_device(qvalid, dev, torch.bool)

        def lane(v):
            return qv.reshape((-1,) + (1,) * (v.ndim - 1))

        masked = {}
        for key, v in out.items():
            if key in ("stats", "count"):
                masked[key] = _tree_map(
                    lambda s: torch.where(lane(s), s, 0), v)
            elif v.dtype == torch.bool:
                masked[key] = v & lane(v)
            else:
                masked[key] = v
        return masked

    return bfn


def _batch_lowering(a: Analysis, options: EngineOptions):
    """(batch_builder | None, batch_native, human-readable reason)."""
    qc = a.query_class
    if options.dist is not None:
        spec = options.dist
        mesh = dict(zip(spec.axes, spec.mesh_shape))
        return BATCH_BUILDERS[qc], True, (
            f"native sharded (distributed fused flat scan: "
            f"{spec.num_shards} shard(s) over mesh {mesh}, "
            f"merge depth {spec.merge_depth})")
    if options.join_lowering == "perleft" and qc in JOIN_LOWERING_FAMILIES:
        return None, False, "vmap-of-scalar fallback (perleft join lowering)"
    if qc in JOIN_LOWERING_FAMILIES:
        return BATCH_BUILDERS[qc], True, ("native (bind sets x left rows "
                                          "flattened into one kernel-level "
                                          "query batch)")
    return (BATCH_BUILDERS[qc], True,
            "native (query-tiled kernels / multi-cluster probes)")


def _validate_quant(options: EngineOptions) -> None:
    """Reject option combinations the quantized lowering cannot honor (the
    reference's checks and messages).

    The quantized scan IS the fused batched kernel path: it has no plain
    twin, and the comparison engines' plan-structural inefficiencies would
    be silently bypassed.  IVF probes stay fp32-exact under quant (their
    key-dependent early stop would be perturbed by quantized keys), so
    engine 'chase' composes: over an index it probes in fp32, and only the
    flat scans are quantized."""
    if options.quant is None:
        if options.rescore_factor < 1:
            raise ValueError(
                f"EngineOptions.rescore_factor must be >= 1, got "
                f"{options.rescore_factor}")
        return
    from ..data.quantized import MODES
    if options.quant not in MODES:
        raise ValueError(
            f"EngineOptions.quant must be one of {MODES} (or None), got "
            f"{options.quant!r}")
    if not options.use_pallas:
        raise ValueError(
            "EngineOptions.quant requires use_pallas=True: the quantized "
            "lowering IS the fused kernel path (no plain twin)")
    if options.engine not in ("chase", "brute"):
        raise ValueError(
            f"EngineOptions.quant is exact (fused fp32 rescore) and only "
            f"composes with engine 'chase' or 'brute', not "
            f"{options.engine!r}")
    if options.join_lowering != "batch":
        raise ValueError(
            "EngineOptions.quant requires join_lowering='batch': the "
            "quantized kernels are query-batched; the perleft loop has no "
            "quantized twin")
    if options.rescore_factor < 1:
        raise ValueError(
            f"EngineOptions.rescore_factor must be >= 1, got "
            f"{options.rescore_factor}")


def _validate_dist(options: EngineOptions) -> None:
    """Reject option combinations the sharded lowering cannot honor (the
    reference's checks and messages).  The sharded lowering is the exact
    fused flat scan (the index is bypassed), so the comparison engines
    (pase, vbase, brute_sort), whose measured inefficiency lives in the
    bypassed plan structure, and the perleft join loop cannot compose with
    it."""
    if options.dist is None:
        return
    from ..dist.sharding import DistSpec
    if not isinstance(options.dist, DistSpec):
        raise TypeError(f"EngineOptions.dist must be a DistSpec, got "
                        f"{type(options.dist).__name__}")
    if options.engine not in ("chase", "brute"):
        raise ValueError(
            f"EngineOptions.dist runs the exact distributed flat scan and "
            f"only composes with engine 'chase' or 'brute', not "
            f"{options.engine!r} (the comparison engines' plan-structural "
            f"inefficiencies would be silently bypassed)")
    if options.join_lowering != "batch":
        raise ValueError(
            "EngineOptions.dist requires join_lowering='batch': the sharded "
            "lowering IS a query-batched scan (left rows ride the shard x "
            "tile composition); the perleft loop has no sharded twin")


def _validate_live(a: Analysis, catalog: Catalog,
                   options: EngineOptions) -> None:
    """Reject option combinations the live lowering cannot honor (the
    reference's checks and messages).  The delta merge composes with the
    exact paths only: the comparison engines (pase, vbase, brute_sort)
    model plan-structural inefficiencies of the frozen lowering, and the
    perleft join loop has no delta twin."""
    if catalog.live_for(*_scan_of(a)) is None:
        return
    if options.engine not in ("chase", "brute"):
        raise ValueError(
            f"a live corpus is attached to {'.'.join(_scan_of(a))} and only "
            f"composes with engine 'chase' or 'brute', not "
            f"{options.engine!r}")
    if options.join_lowering != "batch":
        raise ValueError(
            "a live corpus requires join_lowering='batch': the delta merge "
            "rides the query-batched lowering; the perleft loop has no "
            "live twin")


def _single_via_batch(bfn: Callable) -> Callable:
    """Single-query front for sharded, live and quantized plans: they have
    ONE lowering, the query-batched scan (which carries the shard
    composition, the delta merge or the quantized rescore), so the
    single-query pipeline runs it at Q = 1 and
    slices the leading axis off every output leaf (bitwise a one-element
    exact-shape batch)."""

    def fn(arrays, binds):
        stacked = {k: v[None] if isinstance(v, torch.Tensor)
                   else np.asarray(v)[None] for k, v in binds.items()}
        return _tree_map(lambda v: v[0], bfn(arrays, stacked))

    return fn


def _validate_slice(a: Analysis) -> None:
    """Reject what does not lower: a plan that matches no hybrid pattern
    runs on the interpreter engine
    (:func:`repro_torch.core.interpreter.run_interpreted`)."""
    if a.query_class == QueryClass.NON_HYBRID:
        raise NotImplementedError(
            "plan did not match a hybrid pattern; use the interpreter engine "
            "(repro_torch.core.interpreter.run_interpreted)")


def compile_query(sql: str, catalog: Catalog,
                  options: EngineOptions | None = None,
                  **static_binds) -> CompiledQuery:
    """Parse, analyze, rewrite and select physical operators.

    ``static_binds`` resolve parameters that shape the computation (K
    values); runtime parameters are passed at call time.  Each call compiles
    fresh; the session API (:func:`repro_torch.api.connect`) puts a
    normalized plan cache in front."""
    options = options or EngineOptions()
    plan = parse_sql(sql)
    return compile_plan(sql, plan, catalog, options, static_binds)


def _pipelines(a: Analysis, catalog: Catalog, options: EngineOptions,
               static_binds: dict):
    """(single fn, batch fn, batch_native, batch_reason) of an analysed
    plan."""
    batch_builder, batch_native, batch_reason = _batch_lowering(a, options)
    if (options.dist is not None or options.quant is not None
            or catalog.live_for(*_scan_of(a)) is not None):
        # one lowering per dist, live or quant plan: the batched pipeline
        # (which carries the shard composition, the delta merge or the
        # quantized rescore) serves the single query at Q = 1
        bfn = batch_builder(a, catalog, options, Bindings(static_binds))
        fn = _single_via_batch(bfn)
    else:
        fn = BUILDERS[a.query_class](a, catalog, options,
                                     Bindings(static_binds))
        bfn = (batch_builder(a, catalog, options, Bindings(static_binds))
               if batch_native else _vmap_fallback(fn))
    return fn, bfn, batch_native, batch_reason


def compile_plan(sql: str, plan: PlanNode, catalog: Catalog,
                 options: EngineOptions, static_binds: dict,
                 restored: dict | None = None) -> CompiledQuery:
    """Compile an already-parsed logical plan (the plan-cache entry point).

    ``restored`` is the portable part of an on-disk cache entry
    (:func:`repro_torch.core.aot.load_plan`): its analysis and rewritten
    plan stand in for ``analyze`` and ``rewrite``, which are not called."""
    if restored is None:
        a = analyze(plan, catalog)
    else:
        a = restored["analysis"]
    _validate_slice(a)
    _validate_dist(options)
    _validate_live(a, catalog, options)
    _validate_quant(options)
    rewritten = rewrite(a) if restored is None else restored["rewritten_plan"]
    dep_keys = _catalog_dep_keys(a, catalog, options)
    with _scan_lock(a, catalog):
        arrays = _gather_arrays(a, catalog, options)
        # snapshot after _gather_arrays: registering a new twin or sharded
        # handle bumps a key this plan must not see as a change on its first
        # execute
        bound = catalog.version_snapshot(dep_keys)
    fn, bfn, batch_native, batch_reason = _pipelines(a, catalog, options,
                                                     static_binds)
    compiled_plan = CompiledPlan(sql, a, plan, rewritten, options, fn, bfn,
                                 batch_native, batch_reason,
                                 dict(static_binds))
    executor = BucketedExecutor(compiled_plan, arrays)
    return CompiledQuery(compiled_plan, arrays, executor, _catalog=catalog,
                         _dep_keys=dep_keys, _bound_versions=bound)
