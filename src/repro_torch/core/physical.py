"""Physical operators and engine options (CHASE §5), lowered to torch.

Each builder returns a plain function ``fn(arrays, binds) -> outputs`` over
tensors on the catalog's device; the batched builders take
``(arrays, binds, qvalid=None, probe_budget=None)`` with every bind carrying
a leading Q axis.

This slice of the port lowers Q1 (VKNN-SF) under ``engine="brute"``: the
compiled, fused, index-less full scan, which the reference's parity suites
treat as ground truth.  With ``use_pallas`` the scan runs on the fused CUDA
kernels (the option keeps the reference's name); without it, on the plain
torch :class:`~repro_torch.index.flat.FlatIndex`.  The other engines and
query classes are later slices (ROADMAP.md queue 1) and are rejected at
compile time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..index.flat import FlatIndex
from .expr import Bindings, Expr, Param, as_tensor, evaluate, evaluate_batch
from .schema import Catalog, Metric, Table
from .semantics import Analysis, QueryClass


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """Static IVF probe parameters (the engine's physical-operator knobs).

    Carried in :class:`EngineOptions` (and so in its fingerprint) exactly as
    in the reference; the IVF probes that read it are the next slice."""
    max_probes: int = 64            # hard cap on clusters visited
    min_probes: int = 4             # converge-first phase (Alg.1 lines 2-3)
    stop_after_no_improve: int = 4  # top-k adaptive-queue stop (VBASE analogue)
    out_range_stop: int = 2         # Alg.1 `IsAboveN` N, cluster-granular
    capacity: int = 4096            # range-probe result buffer
    termination: str = "counter"    # 'counter' (faithful) | 'bound' (exact)
    probe_batch: int = 1            # clusters gathered per probe round
    no_new_category_stop: int = 2   # Alg.2: clusters w/o new category
    num_categories: int = 0         # static category cardinality (Alg.2)
    k_per_category: int = 10        # Alg.2 K
    probe_budget: int = 0           # per-query cluster budget (0 = unlimited)


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Compile-time engine configuration; every field shapes compilation
    (see :meth:`fingerprint`).  The fields are the reference's, less
    ``interpret_pallas``: here the tensors' device decides where a kernel
    runs."""
    engine: str = "chase"          # chase | vbase | pase | brute | brute_sort
    probe: ProbeConfig = dataclasses.field(default_factory=ProbeConfig)
    pase_oversample: int = 10      # K' = oversample * K
    use_pallas: bool = False       # fused scan kernels for flat scans
    max_pairs: int = 512           # per-left-row buffer for join families
    join_lowering: str = "batch"   # batch | perleft
    dist: Any = None               # sharded scan spec (not yet ported)
    quant: str | None = None       # None | 'int8' | 'bf16' (not yet ported)
    rescore_factor: int = 2

    def fingerprint(self) -> str:
        """Stable serialization for the plan-cache key (the frozen
        dataclass repr covers every field)."""
        return repr(self)


def _metric_of(catalog: Catalog, table: str, column: str) -> Metric:
    return catalog.table(table).schema[column].metric


def _static_int(v, binds: Bindings, what: str) -> int:
    if isinstance(v, int):
        return v
    if isinstance(v, str) and v in binds:
        return int(binds[v])
    raise ValueError(f"{what} must be statically resolvable, got {v!r}")


def _row_mask_fn(pred: Expr | None, table: Table):
    """Predicate -> (binds -> (N,) bool) or None."""
    if pred is None:
        return None

    def fn(binds: Bindings) -> torch.Tensor:
        return evaluate(pred, table, binds).expand(table.num_rows)

    return fn


def _row_mask_batch_fn(pred: Expr | None, table: Table):
    """Predicate -> (binds with a leading Q axis, Q -> (Q, N) bool) or None."""
    if pred is None:
        return None

    def fn(binds: Bindings, qn: int) -> torch.Tensor:
        return evaluate_batch(pred, table, binds, qn)

    return fn


def _flat_topk(opts: EngineOptions, flat: FlatIndex, q, k, row_mask):
    if opts.use_pallas:
        from ..kernels.ops import fused_scan_topk
        return fused_scan_topk(flat.vectors, q, k, row_mask, flat.metric)
    return flat.topk(q, k, row_mask)


def _flat_topk_batch(opts: EngineOptions, metric: Metric, corpus, qs,
                     k: int, row_mask, qvalid=None):
    """Fused flat batched top-k on the query-batched kernel."""
    from ..kernels.ops import fused_scan_topk_batch
    return fused_scan_topk_batch(corpus, qs, k, row_mask, metric,
                                 qvalid=qvalid)


def _flat_evals(qvalid, m: int, n: int, device) -> torch.Tensor:
    """Per-query flat-scan distance-eval counters; size-bucket pad queries
    (qvalid False) contribute zero."""
    evals = torch.full((m,), n, dtype=torch.int32, device=device)
    return evals if qvalid is None else torch.where(qvalid, evals, 0)


# ---------------------------------------------------------------------------
# Q1 — VKNN-SF
# ---------------------------------------------------------------------------

def build_vknn_sf(a: Analysis, catalog: Catalog, opts: EngineOptions,
                  binds_static: Bindings) -> Callable:
    """Q1 (VKNN-SF) single-query pipeline: the brute-force filtered top-k."""
    table = catalog.table(a.table)
    metric = _metric_of(catalog, a.table, a.vector_column)
    k = _static_int(a.k, binds_static, "K")
    mask_fn = _row_mask_fn(a.structured_predicate, table)
    qparam = a.query_expr
    if not isinstance(qparam, Param):
        raise ValueError("VKNN-SF query must be a parameter")

    def fn(arrays, binds):
        corpus = arrays["corpus"]
        dev = corpus.device
        q = as_tensor(binds[qparam.name], dev)
        row_mask = mask_fn(binds) if mask_fn else None
        ids, sims, valid = _flat_topk(opts, FlatIndex(metric, corpus), q, k,
                                      row_mask)
        stats = {"probes": torch.tensor(0, dtype=torch.int32, device=dev),
                 "distance_evals": torch.tensor(corpus.shape[0],
                                                dtype=torch.int32,
                                                device=dev)}
        return {"ids": ids, "sim": sims, "valid": valid, "stats": stats}

    return fn


def build_vknn_sf_batch(a: Analysis, catalog: Catalog, opts: EngineOptions,
                        binds_static: Bindings) -> Callable:
    """Q1 batched: Q bind sets in one query-batched scan."""
    table = catalog.table(a.table)
    metric = _metric_of(catalog, a.table, a.vector_column)
    k = _static_int(a.k, binds_static, "K")
    mask_fn = _row_mask_batch_fn(a.structured_predicate, table)
    qparam = a.query_expr
    if not isinstance(qparam, Param):
        raise ValueError("VKNN-SF query must be a parameter")

    def fn(arrays, binds, qvalid=None, probe_budget=None):
        # probe_budget: flat scans have no probe lane (ignored, as in the
        # reference's brute branch)
        corpus = arrays["corpus"]
        dev = corpus.device
        n = corpus.shape[0]
        qs = as_tensor(binds[qparam.name], dev)                  # (Q, D)
        qn = qs.shape[0]
        if qvalid is not None:
            qvalid = torch.as_tensor(qvalid, dtype=torch.bool, device=dev)
        row_mask = mask_fn(binds, qn) if mask_fn else None       # (Q, N)
        if (opts.use_pallas and qn == 1 and qvalid is None
                and row_mask is None):
            # single-query fast path: one query without a predicate runs
            # the single-query kernel instead of a one-query batch
            from ..kernels.ops import fused_scan_topk
            i1, s1, v1 = fused_scan_topk(corpus, qs[0], k, None, metric)
            ids, sims, valid = i1[None], s1[None], v1[None]
        elif opts.use_pallas:
            ids, sims, valid = _flat_topk_batch(opts, metric, corpus, qs, k,
                                                row_mask, qvalid=qvalid)
        else:
            ids, sims, valid = FlatIndex(metric, corpus).topk(qs, k,
                                                               row_mask)
            if qvalid is not None:
                valid = valid & qvalid[:, None]
                ids = torch.where(valid, ids, -1)
                sims = torch.where(valid, sims, 0.0)
        stats = {"probes": torch.zeros((qn,), dtype=torch.int32, device=dev),
                 "distance_evals": _flat_evals(qvalid, qn, n, dev)}
        return {"ids": ids, "sim": sims, "valid": valid, "stats": stats}

    return fn


BUILDERS = {
    QueryClass.VKNN_SF: build_vknn_sf,
}

BATCH_BUILDERS = {
    QueryClass.VKNN_SF: build_vknn_sf_batch,
}
