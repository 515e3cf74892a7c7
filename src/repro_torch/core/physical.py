"""Physical operators and engine options (CHASE §5), lowered to torch.

Each builder returns a plain function ``fn(arrays, binds) -> outputs`` over
tensors on the catalog's device; the batched builders take
``(arrays, binds, qvalid=None, probe_budget=None)`` with every bind carrying
a leading Q axis.

Engine modes reproduce the paper's comparison systems as query plans:

* ``chase``  — the fused predicate probe of the IVF index, its similarity
               reused downstream (the map operator);
* ``vbase``  — the same incremental probe, but the sort above the scan
               recomputes the similarity (Fig. 1c) and, on Q2, the filter
               runs as a separate operator after an unfiltered scan;
* ``pase``   — an unfiltered fetch of K' = oversample·K, post-filtered
               (Fig. 1b); its range queries cannot use the index (§2.3);
* ``brute``  — the compiled, fused, index-less full scan;
* ``chase_no_updatestate`` — ``chase`` without Algorithm 2's record-table
               early stop on the category classes (Q5, Q6).

Every class takes those branches when an IVF index is registered on the
scanned column (``index/ivf.py``; the probes are plain torch), as the
reference takes them: Q1 and Q2 under ``chase``, ``vbase`` and ``pase``;
Q3 (distance join) under ``chase`` and ``vbase``; Q4 (KNN join) under
``chase`` only; Q5 (category partition) and Q6 (category join) under
``chase`` (the category probe), ``vbase`` and ``chase_no_updatestate``.
Without an index, under ``brute``, and on the other engine and class
pairs, every engine takes the reference's missing-index branch: the flat
scan, or under ``brute_sort`` Q4's full sort.  With ``use_pallas`` the flat
scans run on the fused CUDA kernels (the option keeps the reference's
name); without it, on the plain torch
:class:`~repro_torch.index.flat.FlatIndex`.  With ``quant`` the batched
flat scans stream the corpus's int8 or bf16 twin and re-rank in exact fp32
(``kernels/quant.py``): the answers stay the fp32 kernels' bit for bit.
The IVF probes stay fp32 under ``quant``.  Over a live corpus
(``data/mutations.py``) the batched builders read its segments and merge
its delta segment into every class's result (the live section below).
Under ``dist`` every class lowers onto the sharded fused flat scan (the
sharded section below).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import tracing
from ..dist.collectives import (distributed_range_batch,
                                distributed_range_batch_q,
                                distributed_topk_batch,
                                distributed_topk_batch_q, merge_topk_level)
from ..dist.sharding import DistSpec
from ..index.delta import delta_range_batch, delta_topk_batch
from ..index.flat import (FlatIndex, compact_range, masked_topk,
                          stable_smallest_k)
from ..index.ivf import (ProbeConfig, ivf_range, ivf_range_batch,
                         ivf_range_category, ivf_range_category_batch,
                         ivf_topk, ivf_topk_batch)
from .expr import (Bindings, Column, Expr, Param, as_tensor,
                   distance_values, evaluate, evaluate_batch, evaluate_expr,
                   full_fp32, in_range, on_device, order_key,
                   pairwise_order_keys, stacked_param)
from .schema import Catalog, Metric, Table
from .semantics import Analysis, QueryClass


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Compile-time engine configuration; every field shapes compilation
    (see :meth:`fingerprint`).  The fields are the reference's, less
    ``interpret_pallas``: here the tensors' device decides where a kernel
    runs."""
    # chase | vbase | pase | chase_no_updatestate | brute | brute_sort
    engine: str = "chase"
    probe: ProbeConfig = dataclasses.field(default_factory=ProbeConfig)
    pase_oversample: int = 10      # K' = oversample * K
    use_pallas: bool = False       # fused scan kernels for flat scans
    max_pairs: int = 512           # per-left-row buffer for join families
    join_lowering: str = "batch"   # batch | perleft
    # a DistSpec row-shards the scanned corpus over its mesh and lowers
    # every class onto the sharded fused flat scan (the index is bypassed,
    # so only 'chase' and 'brute' compose); a mesh change misses the cache
    dist: DistSpec | None = None
    # quantized twin streamed by the batched flat scans, re-ranked in exact
    # fp32 (kernels/quant.py); needs use_pallas
    quant: str | None = None       # None | 'int8' | 'bf16'
    # candidate multiple c of the fp32 rescore: the quantized top-k keeps
    # the top-(c·K) rows, the range path replays up to c·capacity rows
    rescore_factor: int = 2

    def fingerprint(self) -> str:
        """Stable serialization for the plan-cache key (the frozen
        dataclass repr covers every field)."""
        return repr(self)


def probe_ceiling(options: EngineOptions) -> int:
    """The probe-budget ceiling of plans compiled under ``options``, which
    the adaptive optimizer clamps predicted budgets to.  0 means the
    lowering has no probe lane: flat scans and the sharded scan run in one
    pass, so a runtime ``probe_budget`` does nothing and effort bucketing
    is pure overhead."""
    if options.engine not in ("chase", "vbase", "pase"):
        return 0
    if options.dist is not None:
        return 0
    return int(options.probe.max_probes)


def _metric_of(catalog: Catalog, table: str, column: str) -> Metric:
    return catalog.table(table).schema[column].metric


def _static_int(v, binds: Bindings, what: str) -> int:
    if isinstance(v, int):
        return v
    if isinstance(v, str) and v in binds:
        return int(binds[v])
    raise ValueError(f"{what} must be statically resolvable, got {v!r}")


def _predicate(device):
    """The span of a structured predicate's evaluation into a row mask on
    ``device`` (:mod:`repro_torch.tracing`)."""
    return tracing.span(tracing.PREDICATE, device)


def _row_mask_fn(pred: Expr | None, table: Table):
    """Predicate -> (binds -> (N,) bool) or None."""
    if pred is None:
        return None

    def fn(binds: Bindings) -> torch.Tensor:
        with _predicate(table.device):
            return evaluate(pred, table, binds).expand(table.num_rows)

    return fn


def _row_mask_batch_fn(pred: Expr | None, table: Table):
    """Predicate -> (binds with a leading Q axis, Q -> (Q, N) bool) or None."""
    if pred is None:
        return None

    def fn(binds: Bindings, qn: int) -> torch.Tensor:
        with _predicate(table.device):
            return evaluate_batch(pred, table, binds, qn)

    return fn


def _owner_fn(ltab: Table, rtab: Table, lalias: str | None,
              ralias: str | None):
    def owner(col: Column) -> str:
        if col.table in (lalias, ltab.name):
            return "l"
        if col.table in (ralias, rtab.name):
            return "r"
        inl = col.name in ltab.schema
        inr = col.name in rtab.schema
        if inl and inr:
            raise ValueError(f"ambiguous column {col.name}")
        return "l" if inl else "r"

    return owner


def _eval_join_pred(pred: Expr, owner, ev_left, ev_right, param,
                    device) -> torch.Tensor:
    """One interpreter for both join-mask lowerings; ``ev_left`` /
    ``ev_right`` / ``param`` decide the leaf shapes (scalar-at-lidx vs
    (L, 1) / (N,) vs (1, N), with a leading bind-set axis when batched)."""
    return evaluate_expr(
        pred, lambda c: ev_left(c.name) if owner(c) == "l"
        else ev_right(c.name), param, device)


def _join_mask_fn(pred: Expr | None, ltab: Table, rtab: Table,
                  lalias: str | None, ralias: str | None):
    """Residual join predicate -> (left_row_idx, binds) -> (Nright,) bool.

    Left columns resolve to scalars at ``left_row_idx``, right columns to
    full columns — the per-left-row filter of the perleft loop."""
    if pred is None:
        return None
    owner = _owner_fn(ltab, rtab, lalias, ralias)

    def fn(lidx: int, binds: Bindings) -> torch.Tensor:
        with _predicate(rtab.device):
            m = _eval_join_pred(
                pred, owner, lambda name: ltab[name][lidx],
                lambda name: rtab[name],
                lambda name: as_tensor(binds[name], rtab.device), rtab.device)
            return m.expand(rtab.num_rows)

    return fn


def _join_mask_batch_fn(pred: Expr | None, ltab: Table, rtab: Table,
                        lalias: str | None, ralias: str | None):
    """Residual join predicate -> (binds, qn=None, right=None) -> (L,
    Nright) bool, ALL left rows at once.

    Left columns evaluate as (L, 1) and right columns as (1, N), so
    broadcasting gives every (left row, right row) pair's mask in one
    columnar pass, the left rows playing Q.  With ``qn`` stacked bind sets
    everything gains a leading axis — binds (Q, 1, 1), left (1, L, 1),
    right (1, 1, N) — and the mask is (Q, L, N) (the reference's
    ``jax.vmap`` over the same function).  ``right`` (a table-like column
    source, e.g. a live segment's :class:`_ColsTable`) replaces the right
    table's columns."""
    if pred is None:
        return None
    owner = _owner_fn(ltab, rtab, lalias, ralias)
    dev = rtab.device

    def fn(binds: Bindings, qn: int | None = None,
           right=None) -> torch.Tensor:
        right = rtab if right is None else right
        lead = () if qn is None else (1,)
        param = (stacked_param(binds, qn, 2, dev) if qn is not None
                 else lambda name: as_tensor(binds[name], dev))
        with _predicate(dev):
            m = _eval_join_pred(
                pred, owner,
                lambda name: ltab[name].reshape(lead + (-1, 1)),
                lambda name: right[name].reshape(lead + (1, -1)), param, dev)
            shape = (ltab.num_rows, right.num_rows)
            return m.expand(shape if qn is None else (qn,) + shape)

    return fn


def _flat_topk(opts: EngineOptions, flat: FlatIndex, q, k, row_mask):
    if opts.use_pallas:
        from ..kernels.ops import fused_scan_topk
        return fused_scan_topk(flat.vectors, q, k, row_mask, flat.metric)
    return flat.topk(q, k, row_mask)


def _flat_topk_batch(opts: EngineOptions, arrays, metric: Metric, corpus,
                     qs, k: int, row_mask, qvalid=None):
    """Fused flat batched top-k on the query-batched kernel, or on the
    quantized twin in ``arrays`` (``qvecs``/``qscales``) when
    ``opts.quant`` is set."""
    if opts.quant is not None:
        from ..kernels.quant import fused_scan_topk_batch_q
        return fused_scan_topk_batch_q(
            corpus, arrays["qvecs"], arrays["qscales"], qs, k, row_mask,
            metric, rescore_factor=opts.rescore_factor, qvalid=qvalid)
    from ..kernels.ops import fused_scan_topk_batch
    return fused_scan_topk_batch(corpus, qs, k, row_mask, metric,
                                 qvalid=qvalid)


def _flat_evals(qvalid, m: int, n: int, device) -> torch.Tensor:
    """Per-query flat-scan distance-eval counters; size-bucket pad queries
    (qvalid False) contribute zero."""
    evals = torch.full((m,), n, dtype=torch.int32, device=device)
    return evals if qvalid is None else torch.where(qvalid, evals, 0)


def _flat_stats(n: int, device, m: int | None = None) -> dict:
    """Flat-scan counters, no probe and every one of the ``n`` rows: scalars
    for one query, (m,) vectors for ``m`` (filled on the device, so a
    per-left-row loop adds no host-to-device copy)."""
    shape = () if m is None else (m,)
    return {"probes": torch.zeros(shape, dtype=torch.int32, device=device),
            "distance_evals": torch.full(shape, n, dtype=torch.int32,
                                         device=device)}


def _stack_rows(rows: list) -> tuple:
    """Per-left-row result tuples (tensors and stats dicts) -> one tuple
    of stacked leaves."""
    return tuple({key: torch.stack([r[j][key] for r in rows])
                  for key in rows[0][j]} if isinstance(rows[0][j], dict)
                 else torch.stack([r[j] for r in rows])
                 for j in range(len(rows[0])))


def _compact(hit: torch.Tensor, raw: torch.Tensor, metric: Metric,
             capacity: int):
    """(..., N) hits and raw values -> (ids, sims, valid) of the best
    ``capacity`` hits of each row (``index.flat.compact_range``)."""
    keys = torch.where(hit, order_key(metric, raw), float("inf"))
    return compact_range(keys, capacity, metric)


def _flat_range_topk_batch(opts: EngineOptions, metric: Metric, corpus, qs,
                           radius, row_mask, capacity: int, qvalid=None,
                           arrays=None):
    """Flat range scan over an (M, d) query batch, compacted to
    ``capacity``.

    The quantized range path (``quant``; its twin's tensors come in the
    plan's ``arrays``), the query-batched range kernel (``use_pallas``) or
    the exact plain scan, one query at a time (the torch form of the
    reference's ``jax.vmap`` over ``FlatIndex.range_mask``).  ``radius`` is
    a scalar or (M,); ``row_mask`` None, shared (N,) or per-query (M, N);
    ``qvalid`` None or (M,) bool (size-bucket pad queries register no hits
    and zero counters).  Results are ordered best-first.  Returns (ids
    (M, P), sims, valid, count (M,), per-row stats) with
    P = min(capacity, N)."""
    m, n = qs.shape[0], corpus.shape[0]
    dev = corpus.device
    cap = min(int(capacity), n)
    radius = on_device(radius, dev, torch.float32).expand(m)
    if opts.quant is not None:
        from ..kernels.quant import fused_range_topk_batch_q
        ids, sims, valid, count = fused_range_topk_batch_q(
            corpus, arrays["qvecs"], arrays["qscales"], arrays["qhalf"],
            arrays["ql1"], arrays["ql2"], qs, radius, row_mask, metric, cap,
            rescore_factor=opts.rescore_factor, qvalid=qvalid)
    elif opts.use_pallas:
        from ..kernels.ops import fused_range_topk_batch
        ids, sims, valid, count = fused_range_topk_batch(
            corpus, qs, radius, row_mask, metric, cap, qvalid=qvalid)
    else:
        flat = FlatIndex(metric, corpus)
        rows = [flat.range_mask(
            qs[i], radius[i],
            row_mask if row_mask is None or row_mask.ndim == 1
            else row_mask[i]) for i in range(m)]
        hit = torch.stack([h for h, _ in rows])
        raw = torch.stack([r for _, r in rows])
        if qvalid is not None:
            hit = hit & qvalid[:, None]
        ids, sims, valid = _compact(hit, raw, metric, cap)
        count = hit.sum(1, dtype=torch.int32)
    stats = {"probes": torch.zeros((m,), dtype=torch.int32, device=dev),
             "distance_evals": _flat_evals(qvalid, m, n, dev)}
    return ids, sims, valid, count, stats


def _stacked_qn(binds: dict) -> int:
    """Leading Q axis of stacked binds."""
    dims = [v.shape[0] for v in binds.values()
            if hasattr(v, "ndim") and v.ndim >= 1]
    if not dims:
        raise ValueError("stacked binds carry no leading batch axis; use "
                         "binds_list")
    return dims[0]


def _flatten_left_batch(lvec: torch.Tensor, binds: dict, mask_b):
    """(Q bind sets x L left rows) -> ONE kernel query batch.

    Replicates the (L, d) left block per bind set and evaluates the
    per-bind join masks into the flattened (Q·L, N) layout (q-major,
    matching ``reshape`` on the outputs).  The replication recomputes the
    (L, N) distances Q-fold — bind sets only vary radius and masks, applied
    after the product — as the reference does."""
    nleft, d = lvec.shape
    qn = _stacked_qn(binds)
    qs = lvec.unsqueeze(0).expand(qn, nleft, d).reshape(-1, d)
    rm = mask_b(binds, qn).reshape(qn * nleft, -1) if mask_b else None
    return qn, nleft, qs, rm


def _join_batch_masks(lvec: torch.Tensor, binds: dict, mask_b, arrays,
                      live: bool):
    """:func:`_flatten_left_batch` plus the delta mask: over a live corpus
    both masks come from its segments (:func:`_live_join_masks`).  Returns
    (qn, nleft, qs, rm, dmask)."""
    if not live:
        return _flatten_left_batch(lvec, binds, mask_b) + (None,)
    qn, nleft, qs, _ = _flatten_left_batch(lvec, binds, None)
    return (qn, nleft, qs) + _live_join_masks(mask_b, arrays, binds, qn,
                                              nleft)


def _flatten_valid_budget(qvalid, probe_budget, qn: int, nleft: int,
                          device):
    """Expand per-bind-set ``qvalid`` (Q,) and ``probe_budget`` (scalar |
    (Q,) | (Q, L)) to the flattened (Q·L,) query-batch layout."""
    fq = (None if qvalid is None else on_device(
        qvalid, device, torch.bool).repeat_interleave(nleft))
    if probe_budget is None:
        fb = None
    else:
        b = on_device(probe_budget, device, torch.int32)
        if b.ndim == 1:
            b = b[:, None]
        fb = b.expand(qn, nleft).reshape(-1)
    return fq, fb


def _radius_batch(radius_expr: Expr, table: Table, binds: dict,
                  qn: int) -> torch.Tensor:
    """The radius of each of ``qn`` stacked bind sets -> (Q,) fp32 (a
    parameter evaluates to its stacked values, a constant broadcasts)."""
    r = evaluate(radius_expr, table, binds).to(torch.float32)
    return r.expand(qn)


# ---------------------------------------------------------------------------
# the sharded lowering, selected by EngineOptions.dist
# ---------------------------------------------------------------------------
#
# A DistSpec row-shards the scanned corpus over a mesh of devices
# (dist/sharding.py); each shard runs the query-tiled fused scan for ALL Q
# queries on its device, then a hierarchical per-query merge
# (dist/collectives.py).  The lowering is exact and engine-independent:
# the index is bypassed (a row-sharded corpus has no co-sharded IVF
# gather), so at one shard every class equals the flat batched path
# (engine 'brute', use_pallas) bit for bit.  The qvalid lane reaches every
# shard: a size-bucket pad query emits nothing and counts nothing.  The
# plan's ``arrays`` carry the ShardedCorpus handle (``sharded``) and, under
# quant, each shard's twin (``dquant``).


def _dist_masks(arrays, rm) -> list:
    """The row mask of each shard: with a predicate (``rm`` (Q, N) or a
    shared (N,)) its columns of the shard, the divisibility-pad columns
    False; without one the shard's shared ``row_ids >= 0`` mask (None on a
    shard with no pad row), so no (Q, N) mask is built."""
    sharded = arrays["sharded"]
    if rm is None:
        return list(sharded.shared_masks)
    n = rm.shape[-1]
    per = sharded.shards[0].shape[0]
    out = []
    for s in range(sharded.num_shards):
        lo, hi = s * per, (s + 1) * per
        part = rm[..., min(lo, n):min(hi, n)]
        if part.shape[-1] < per:
            part = torch.cat([part, part.new_zeros(
                part.shape[:-1] + (per - part.shape[-1],))], dim=-1)
        out.append(part)
    return out


def _dist_topk_core(opts: EngineOptions, metric: Metric, k: int):
    """``(arrays, qs, rm, qvalid) -> (ids, sims, valid, stats)``: the
    sharded twin of the fused flat batched top-k (exact; the counters are
    the flat path's, N distance evals per valid query and no probe)."""
    spec = opts.dist

    def run(arrays, qs, rm, qvalid=None):
        sharded = arrays["sharded"]
        qn, n, dev = qs.shape[0], arrays["corpus"].shape[0], qs.device
        masks = _dist_masks(arrays, rm)
        if opts.quant is not None:
            fn = distributed_topk_batch_q(sharded.mesh, metric, k, spec.axes,
                                          rescore_factor=opts.rescore_factor)
            ids, sims, valid = fn(sharded.shards, arrays["dquant"],
                                  sharded.row_ids, qs, masks, qvalid)
        else:
            fn = distributed_topk_batch(sharded.mesh, metric, k, spec.axes)
            ids, sims, valid = fn(sharded.shards, sharded.row_ids, qs, masks,
                                  qvalid)
        stats = {"probes": torch.zeros((qn,), dtype=torch.int32, device=dev),
                 "distance_evals": _flat_evals(qvalid, qn, n, dev)}
        return ids, sims, valid, stats

    return run


def _dist_range_core(opts: EngineOptions, metric: Metric, capacity: int):
    """``(arrays, qs, radius, rm, qvalid) -> (ids, sims, valid, count,
    stats)``: the sharded twin of :func:`_flat_range_topk_batch`.  The
    buffer is ``min(capacity, N)`` wide whatever the shard count (the
    shards' buffers concatenate and re-truncate best-first at each merge
    level); ``count`` stays exact past truncation (the sum of the shards'
    counts)."""
    spec = opts.dist

    def run(arrays, qs, radius, rm, qvalid=None):
        sharded = arrays["sharded"]
        qn, n, dev = qs.shape[0], arrays["corpus"].shape[0], qs.device
        cap = min(int(capacity), n)
        radius = on_device(radius, dev, torch.float32).expand(qn)
        masks = _dist_masks(arrays, rm)
        if opts.quant is not None:
            fn = distributed_range_batch_q(
                sharded.mesh, metric, cap, spec.axes,
                rescore_factor=opts.rescore_factor)
            ids, sims, valid, count = fn(sharded.shards, arrays["dquant"],
                                         sharded.row_ids, qs, radius, masks,
                                         qvalid)
        else:
            fn = distributed_range_batch(sharded.mesh, metric, cap, spec.axes)
            ids, sims, valid, count = fn(sharded.shards, sharded.row_ids, qs,
                                         radius, masks, qvalid)
        stats = {"probes": torch.zeros((qn,), dtype=torch.int32, device=dev),
                 "distance_evals": _flat_evals(qvalid, qn, n, dev)}
        return ids, sims, valid, count, stats

    return run


# ---------------------------------------------------------------------------
# the IVF engines' post-processing (Q1, Q2)
# ---------------------------------------------------------------------------

def _recompute(metric: Metric, corpus, qs, ids) -> torch.Tensor:
    """VBASE's redundant work: the raw metric of each (Q, P) buffered row
    against its query, computed again from the corpus in full fp32."""
    with full_fp32():
        return distance_values(metric, corpus[ids.clamp_min(0).long()],
                               qs[:, None, :])


def _resort_redundant(metric: Metric, corpus, qs, ids, valid, k: int):
    """VBASE's Fig. 1c inefficiency: the sort operator recomputes
    vec <*> query for the (Q, k) tuples the scan already scored."""
    raw = _recompute(metric, corpus, qs, ids)
    keys = torch.where(valid, order_key(metric, raw), float("inf"))
    keys2, idx = stable_smallest_k(keys, k)
    ids2 = torch.take_along_dim(ids, idx.long(), dim=-1)
    valid2 = torch.isfinite(keys2)
    sims = torch.where(valid2, -keys2 if metric.is_similarity() else keys2,
                       0.0)
    return torch.where(valid2, ids2, -1), sims, valid2


def _pase_post(metric: Metric, ids, sims, valid, rm, k: int):
    """PASE's post-filter over its (Q, K') unfiltered fetch: drop the rows
    the predicate rejects and keep the first k survivors (the fetch is in
    ascending key order already)."""
    if rm is not None:
        valid = valid & torch.where(
            ids >= 0, torch.take_along_dim(rm, ids.clamp_min(0).long(), -1),
            False)
    valid = valid & (torch.cumsum(valid, -1) <= k)
    keys = torch.where(valid, order_key(metric, sims), float("inf"))
    vals, sel = stable_smallest_k(keys, k)
    v = torch.isfinite(vals)
    sel = sel.clamp_min(0).long()
    return (torch.where(v, torch.take_along_dim(ids, sel, -1), -1),
            torch.where(v, torch.take_along_dim(sims, sel, -1), 0.0), v)


def _vbase_range_post(metric: Metric, corpus, qs, ids, valid, radius, rm):
    """VBASE's range filter as a separate operator above an unfiltered
    scan: it recomputes each buffered row's similarity for the range check,
    then applies the predicate.  Returns (sims, valid, count): the count is
    the rows that pass, and the recomputation adds no evals to the
    counters (the reference's Q3 joins count none; Q2 adds them itself)."""
    raw = _recompute(metric, corpus, qs, ids)
    v = valid & in_range(metric, raw, radius[:, None])
    if rm is not None:
        v = v & torch.take_along_dim(rm, ids.clamp_min(0).long(), dim=-1)
    return torch.where(v, raw, 0.0), v, v.sum(-1, dtype=torch.int32)


def _extra_evals(stats: dict, extra: int, qvalid) -> dict:
    """``stats`` with ``extra`` distance evals added to every live query."""
    ev = stats["distance_evals"]
    add = torch.full_like(ev, extra)
    if qvalid is not None:
        add = torch.where(qvalid, add, 0)
    return {**stats, "distance_evals": ev + add}


# ---------------------------------------------------------------------------
# the live-corpus lowering, selected by an attached LiveCorpus
# ---------------------------------------------------------------------------
#
# When catalog.live_for(scanned table, scanned column) is attached, the
# batched builders swap two things into the pipeline and leave the rest:
#
# 1. The masks come from the LIVE tensors: the main segment's validity lane
#    (the tombstone bitmap) ANDed with the predicate over the live scalar
#    columns, the same row-mask layout every kernel and IVF probe takes, so
#    a tombstoned row is inert as a pad row is.  The delta segment gets the
#    same at its own width.
# 2. After the main-segment result (IVF or flat, unchanged code), the delta
#    segment is scanned by the plain flat scan and merged in as one more
#    level of the per-query merge (index/delta.py, dist/collectives.py).
#    Merged ids >= cap_main name delta slots (LiveCorpus.user_ids maps
#    them back).
#
# Live plans compose with the exact engines only (chase and brute; see
# compiler._validate_live), and the single-query path runs the batched
# lowering at Q = 1 (compiler._single_via_batch), so no single builder has
# a live branch.  The delta range merge re-sorts each query's buffer
# best-first, so live IVF range results are best-first even with no delta
# row (frozen IVF plans keep probe discovery order).


class _ColsTable:
    """The live segment's scalar columns standing in for a :class:`Table`
    in expression evaluation (which reads only ``table[name]``, ``device``
    and ``num_rows``)."""

    def __init__(self, cols: dict, valid: torch.Tensor):
        self._cols = cols
        self.device = valid.device
        self.num_rows = valid.shape[0]

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._cols[name]


def _live_scan_masks(pred: Expr | None, arrays, binds, qn: int):
    """Live (main, delta) row masks of the scan classes (Q1, Q2, Q5).

    With a structured predicate each is per query, (Q, cap_main) and (Q,
    delta_cap): the segment's validity lane (tombstones and empty slots)
    ANDed with the predicate over the live scalar columns.  Without one
    the validity lanes come back 1-D: the kernels take their shared-mask
    path, which keeps a live scan at a frozen scan's cost, and the IVF
    probes take a shared mask as it is."""
    mv, dv = arrays["live_main_valid"], arrays["live_delta_valid"]
    if pred is None:
        return mv, dv

    def seg(cols, valid):
        with _predicate(valid.device):
            return evaluate_batch(pred, _ColsTable(cols, valid), binds,
                                  qn) & valid[None, :]

    return seg(arrays["live_cols"], mv), seg(arrays["live_dcols"], dv)


def _live_join_masks(mask_b, arrays, binds, qn: int, nleft: int):
    """Live (main, delta) masks of the join classes in the flattened (Q·L,
    segment) layout of :func:`_flatten_left_batch`: the join predicate with
    the right columns read from the live segments (the left side stays
    frozen: only the scanned column is live), ANDed with each segment's
    validity lane."""
    mv, dv = arrays["live_main_valid"], arrays["live_delta_valid"]

    def seg(cols, valid):
        if mask_b is None:
            return valid[None, :].expand(qn * nleft, -1)
        m = mask_b(binds, qn, _ColsTable(cols, valid))
        return m.reshape(qn * nleft, -1) & valid[None, :]

    return seg(arrays["live_cols"], mv), seg(arrays["live_dcols"], dv)


def _merge_delta_topk(metric: Metric, arrays, qs, k: int, dmask, qvalid,
                      ids, sims, valid, stats):
    """Merge the delta segment's top-k into a main-segment (Q, k) result.

    The main candidates are merge side A, so equal keys go main first and
    an empty delta leaves the main result bit for bit; that licenses the
    skip below: with no live delta row (the plan's ``live_has_delta``, the
    host's knowledge at re-bind time, so no device sync) the scan and the
    merge are not run.  The scan adds delta_cap distance evals per valid
    query to the counters when it runs."""
    if not arrays["live_has_delta"]:
        return ids, sims, valid, stats
    delta = arrays["live_delta_vec"]
    dkeys, dgids = delta_topk_batch(metric, delta, qs, k, dmask, qvalid,
                                    arrays["corpus"].shape[0])
    mkeys = torch.where(valid, order_key(metric, sims), float("inf"))
    ids, sims, valid = merge_topk_level(metric, mkeys,
                                        torch.where(valid, ids, -1), dkeys,
                                        dgids, k)
    evals = _flat_evals(qvalid, qs.shape[0], delta.shape[0], qs.device)
    return ids, sims, valid, {**stats, "distance_evals":
                              stats["distance_evals"] + evals}


def _merge_delta_range(metric: Metric, arrays, qs, radius, capacity: int,
                       dmask, qvalid, ids, sims, valid, count, stats):
    """Merge the delta segment's range hits into a main-segment result.

    The merged buffer is ``min(capacity, main width + delta width)`` wide
    and best-first; ``count`` stays exact past truncation (the main count
    plus the delta's exact count).  The counters as in
    :func:`_merge_delta_topk`, but with no skip: the merge is what sorts IVF
    range hits best-first, an order the live range classes keep at any
    delta fill."""
    delta = arrays["live_delta_vec"]
    dkeys, dgids, dcount = delta_range_batch(
        metric, delta, qs, radius, dmask, qvalid, arrays["corpus"].shape[0],
        int(capacity))
    mkeys = torch.where(valid, order_key(metric, sims), float("inf"))
    w = min(int(capacity), ids.shape[1] + dkeys.shape[1])
    ids, sims, valid = merge_topk_level(metric, mkeys,
                                        torch.where(valid, ids, -1), dkeys,
                                        dgids, w)
    evals = _flat_evals(qvalid, qs.shape[0], delta.shape[0], qs.device)
    return ids, sims, valid, count + dcount, {
        **stats, "distance_evals": stats["distance_evals"] + evals}


# ---------------------------------------------------------------------------
# Q1 — VKNN-SF
# ---------------------------------------------------------------------------

def build_vknn_sf(a: Analysis, catalog: Catalog, opts: EngineOptions,
                  binds_static: Bindings) -> Callable:
    """Q1 (VKNN-SF) single-query pipeline: the filtered top-k by engine
    mode (the IVF probe with an index, else the flat scan)."""
    table = catalog.table(a.table)
    metric = _metric_of(catalog, a.table, a.vector_column)
    k = _static_int(a.k, binds_static, "K")
    mask_fn = _row_mask_fn(a.structured_predicate, table)
    qparam = a.query_expr
    if not isinstance(qparam, Param):
        raise ValueError("VKNN-SF query must be a parameter")
    index = catalog.index_for(a.table, a.vector_column)
    cfg = opts.probe

    def fn(arrays, binds):
        corpus = arrays["corpus"]
        dev = corpus.device
        q = as_tensor(binds[qparam.name], dev)
        row_mask = mask_fn(binds) if mask_fn else None
        if opts.engine == "chase" and index is not None:
            ids, sims, valid, stats = ivf_topk(arrays["index"], corpus, q, k,
                                               row_mask, cfg)
        elif opts.engine == "vbase" and index is not None:
            ids, _sims, valid, stats = ivf_topk(arrays["index"], corpus, q,
                                                k, row_mask, cfg)
            ids, sims, valid = (v[0] for v in _resort_redundant(
                metric, corpus, q[None], ids[None], valid[None], k))
            stats = _extra_evals(stats, k, None)
        elif opts.engine == "pase" and index is not None:
            kk = min(opts.pase_oversample * k, corpus.shape[0])
            ids_o, sims_o, valid_o, stats = ivf_topk(arrays["index"], corpus,
                                                     q, kk, None, cfg)
            ids, sims, valid = (v[0] for v in _pase_post(
                metric, ids_o[None], sims_o[None], valid_o[None],
                None if row_mask is None else row_mask[None], k))
        else:  # brute (the LingoDB-V analogue) or no index
            ids, sims, valid = _flat_topk(opts, FlatIndex(metric, corpus), q,
                                          k, row_mask)
            stats = _flat_stats(corpus.shape[0], dev)
        return {"ids": ids, "sim": sims, "valid": valid, "stats": stats}

    return fn


def build_vknn_sf_batch(a: Analysis, catalog: Catalog, opts: EngineOptions,
                        binds_static: Bindings) -> Callable:
    """Q1 batched: Q bind sets on the batched IVF probe, or in one
    query-batched flat scan."""
    table = catalog.table(a.table)
    metric = _metric_of(catalog, a.table, a.vector_column)
    k = _static_int(a.k, binds_static, "K")
    mask_fn = _row_mask_batch_fn(a.structured_predicate, table)
    qparam = a.query_expr
    if not isinstance(qparam, Param):
        raise ValueError("VKNN-SF query must be a parameter")
    index = catalog.index_for(a.table, a.vector_column)
    cfg = opts.probe
    live = catalog.live_for(a.table, a.vector_column) is not None
    dist = (_dist_topk_core(opts, metric, k) if opts.dist is not None
            else None)

    def fn(arrays, binds, qvalid=None, probe_budget=None):
        corpus = arrays["corpus"]
        dev = corpus.device
        n = corpus.shape[0]
        qs = as_tensor(binds[qparam.name], dev)                  # (Q, D)
        qn = qs.shape[0]
        if qvalid is not None:
            qvalid = on_device(qvalid, dev, torch.bool)
        if live:
            row_mask, dmask = _live_scan_masks(a.structured_predicate,
                                               arrays, binds, qn)
        else:
            row_mask = mask_fn(binds, qn) if mask_fn else None   # (Q, N)
        probe = dict(cfg=cfg, probe_budget=probe_budget, qvalid=qvalid)
        if dist is not None:
            ids, sims, valid, stats = dist(arrays, qs, row_mask, qvalid)
        elif opts.engine == "chase" and index is not None:
            ids, sims, valid, stats = ivf_topk_batch(
                arrays["index"], corpus, qs, k, row_mask, **probe)
        elif opts.engine == "vbase" and index is not None:
            ids, _sims, valid, stats = ivf_topk_batch(
                arrays["index"], corpus, qs, k, row_mask, **probe)
            ids, sims, valid = _resort_redundant(metric, corpus, qs, ids,
                                                 valid, k)
            stats = _extra_evals(stats, k, qvalid)
        elif opts.engine == "pase" and index is not None:
            kk = min(opts.pase_oversample * k, n)
            ids_o, sims_o, valid_o, stats = ivf_topk_batch(
                arrays["index"], corpus, qs, kk, None, **probe)
            ids, sims, valid = _pase_post(metric, ids_o, sims_o, valid_o,
                                          row_mask, k)
        else:  # brute or no index; probe_budget has no lane on a flat scan
            if (opts.use_pallas and opts.quant is None and qn == 1
                    and qvalid is None and row_mask is None):
                # single-query fast path: one query without a predicate
                # runs the single-query kernel instead of a one-query batch
                # (not under quant, whose only lowering is the batched one)
                from ..kernels.ops import fused_scan_topk
                i1, s1, v1 = fused_scan_topk(corpus, qs[0], k, None, metric)
                ids, sims, valid = i1[None], s1[None], v1[None]
            elif opts.use_pallas:
                ids, sims, valid = _flat_topk_batch(
                    opts, arrays, metric, corpus, qs, k, row_mask,
                    qvalid=qvalid)
            else:
                ids, sims, valid = FlatIndex(metric, corpus).topk(
                    qs, k, row_mask)
                if qvalid is not None:
                    valid = valid & qvalid[:, None]
                    ids = torch.where(valid, ids, -1)
                    sims = torch.where(valid, sims, 0.0)
            stats = {"probes": torch.zeros((qn,), dtype=torch.int32,
                                           device=dev),
                     "distance_evals": _flat_evals(qvalid, qn, n, dev)}
        if live:
            ids, sims, valid, stats = _merge_delta_topk(
                metric, arrays, qs, k, dmask, qvalid, ids, sims, valid,
                stats)
        return {"ids": ids, "sim": sims, "valid": valid, "stats": stats}

    return fn


# ---------------------------------------------------------------------------
# Q2 — DR-SF
# ---------------------------------------------------------------------------

def build_dr_sf(a: Analysis, catalog: Catalog, opts: EngineOptions,
                binds_static: Bindings) -> Callable:
    """Q2 (DR-SF) single-query pipeline: the filtered range probe by engine
    mode.  As in the reference, the flat single-query plan (``pase``,
    ``brute`` or no index) runs the exact plain scan
    (``FlatIndex.range_mask``) whatever ``use_pallas`` says: the reference
    lowers it without a kernel."""
    table = catalog.table(a.table)
    metric = _metric_of(catalog, a.table, a.vector_column)
    mask_fn = _row_mask_fn(a.structured_predicate, table)
    qparam = a.query_expr
    index = catalog.index_for(a.table, a.vector_column)
    cfg = opts.probe
    capacity = cfg.capacity
    radius_expr = a.radius

    def fn(arrays, binds):
        corpus = arrays["corpus"]
        dev = corpus.device
        n = corpus.shape[0]
        q = as_tensor(binds[qparam.name], dev)
        radius = evaluate(radius_expr, table, binds)
        row_mask = mask_fn(binds) if mask_fn else None
        if opts.engine == "chase" and index is not None:
            ids, sims, valid, count, stats = ivf_range(
                arrays["index"], corpus, q, radius, row_mask, cfg)
        elif opts.engine == "vbase" and index is not None:
            # scan without the fused predicate; the filter is an operator
            # of its own that recomputes each row's similarity
            ids, _sims, valid, _count, stats = ivf_range(
                arrays["index"], corpus, q, radius, None, cfg)
            sims, valid, count = (v[0] for v in _vbase_range_post(
                metric, corpus, q[None], ids[None], valid[None],
                on_device(radius, dev, torch.float32).reshape(1),
                None if row_mask is None else row_mask[None]))
            stats = _extra_evals(stats, capacity, None)
        else:
            # PASE/pgvector cannot route range queries to the index (§2.3)
            hit, raw = FlatIndex(metric, corpus).range_mask(q, radius,
                                                            row_mask)
            ids, sims, valid = _compact(hit, raw, metric, min(capacity, n))
            count = hit.sum(dtype=torch.int32)
            stats = _flat_stats(n, dev)
        return {"ids": ids, "sim": sims, "valid": valid, "count": count,
                "stats": stats}

    return fn


def build_dr_sf_batch(a: Analysis, catalog: Catalog, opts: EngineOptions,
                      binds_static: Bindings) -> Callable:
    """Q2 batched: Q bind sets on the batched IVF probe, or on the
    query-batched range kernel."""
    table = catalog.table(a.table)
    metric = _metric_of(catalog, a.table, a.vector_column)
    mask_fn = _row_mask_batch_fn(a.structured_predicate, table)
    qparam = a.query_expr
    index = catalog.index_for(a.table, a.vector_column)
    cfg = opts.probe
    radius_expr = a.radius
    live = catalog.live_for(a.table, a.vector_column) is not None
    dist = (_dist_range_core(opts, metric, cfg.capacity)
            if opts.dist is not None else None)

    def fn(arrays, binds, qvalid=None, probe_budget=None):
        corpus = arrays["corpus"]
        dev = corpus.device
        qs = as_tensor(binds[qparam.name], dev)                  # (Q, D)
        qn = qs.shape[0]
        radius = _radius_batch(radius_expr, table, binds, qn)
        if qvalid is not None:
            qvalid = on_device(qvalid, dev, torch.bool)
        if live:
            row_mask, dmask = _live_scan_masks(a.structured_predicate,
                                               arrays, binds, qn)
        else:
            row_mask = mask_fn(binds, qn) if mask_fn else None   # (Q, N)
        probe = dict(cfg=cfg, probe_budget=probe_budget, qvalid=qvalid)
        if dist is not None:
            ids, sims, valid, count, stats = dist(arrays, qs, radius,
                                                  row_mask, qvalid)
        elif opts.engine == "chase" and index is not None:
            ids, sims, valid, count, stats = ivf_range_batch(
                arrays["index"], corpus, qs, radius, row_mask, **probe)
        elif opts.engine == "vbase" and index is not None:
            ids, _sims, valid, _count, stats = ivf_range_batch(
                arrays["index"], corpus, qs, radius, None, **probe)
            sims, valid, count = _vbase_range_post(
                metric, corpus, qs, ids, valid, radius, row_mask)
            stats = _extra_evals(stats, cfg.capacity, qvalid)
        else:
            # PASE/pgvector cannot route range queries to the index (§2.3)
            ids, sims, valid, count, stats = _flat_range_topk_batch(
                opts, metric, corpus, qs, radius, row_mask, cfg.capacity,
                qvalid=qvalid, arrays=arrays)
        if live:
            ids, sims, valid, count, stats = _merge_delta_range(
                metric, arrays, qs, radius, cfg.capacity, dmask, qvalid, ids,
                sims, valid, count, stats)
        return {"ids": ids, "sim": sims, "valid": valid, "count": count,
                "stats": stats}

    return fn


# ---------------------------------------------------------------------------
# Q3 — distance join
# ---------------------------------------------------------------------------
#
# Batch-native lowering (the default): the left side of a vector join IS a
# query batch, so the left embeddings ride one (L, d) batch through the
# batched IVF probe or the query-tiled range kernel — per-left-row join
# predicates become the (L, N) mask they consume, and stats come back as
# per-left (L,) arrays.  The per-left-row loop survives behind
# join_lowering='perleft' as the measured baseline: one single-query probe,
# or one single-query range kernel launch, per left row.  Flat plans emit
# best-first per left row; IVF plans emit probe discovery order (at
# probe_batch 1 the batch lowering equals the perleft loop row for row).


def _dist_join_core(a: Analysis, catalog: Catalog, opts: EngineOptions):
    """(arrays, qs (M, d), radius, rm (M, N) | None) -> Q3 result batch:
    the batched range probe under ``chase`` and ``vbase`` over an index,
    else the flat range scan."""
    metric = _metric_of(catalog, a.right_table, a.right_vector)
    index = catalog.index_for(a.right_table, a.right_vector)
    cfg = dataclasses.replace(opts.probe, capacity=opts.max_pairs)
    live = catalog.live_for(a.right_table, a.right_vector) is not None
    dist = (_dist_range_core(opts, metric, opts.max_pairs)
            if opts.dist is not None else None)

    def main(arrays, qs, radius, rm, qvalid, probe_budget):
        corpus = arrays["corpus"]
        if dist is not None:
            return dist(arrays, qs, radius, rm, qvalid)
        if opts.engine not in ("chase", "vbase") or index is None:
            # the flat scan has no probe lane: probe_budget does nothing
            return _flat_range_topk_batch(opts, metric, corpus, qs, radius,
                                          rm, opts.max_pairs, qvalid=qvalid,
                                          arrays=arrays)
        probe = dict(cfg=cfg, probe_budget=probe_budget, qvalid=qvalid)
        if opts.engine == "chase":
            return ivf_range_batch(arrays["index"], corpus, qs, radius, rm,
                                   **probe)
        ids, _sims, valid, _count, stats = ivf_range_batch(
            arrays["index"], corpus, qs, radius, None, **probe)
        return (ids, *_vbase_range_post(metric, corpus, qs, ids, valid,
                                        radius, rm), stats)

    def core(arrays, qs, radius, rm, qvalid=None, probe_budget=None,
             dmask=None):
        radius = on_device(radius, qs.device,
                           torch.float32).expand(qs.shape[0])
        out = main(arrays, qs, radius, rm, qvalid, probe_budget)
        if not live:
            return out
        return _merge_delta_range(metric, arrays, qs, radius, opts.max_pairs,
                                  dmask, qvalid, *out)

    return core


def _join_output(ids, sims, valid, counts, stats) -> dict:
    nleft = ids.shape[0]
    qid = torch.arange(nleft, dtype=torch.int32, device=ids.device)
    return {"qid": qid[:, None].expand(ids.shape), "tid": ids, "sim": sims,
            "valid": valid, "count": counts, "stats": stats}


def build_dist_join(a: Analysis, catalog: Catalog, opts: EngineOptions,
                    binds_static: Bindings) -> Callable:
    """Q3 (distance join): the left rows ride ONE query batch (see the
    section comment; ``join_lowering='perleft'`` keeps the loop)."""
    if opts.join_lowering == "perleft":
        return _build_dist_join_perleft(a, catalog, opts, binds_static)
    ltab, rtab = catalog.table(a.left_table), catalog.table(a.right_table)
    mask_b = _join_mask_batch_fn(a.join_predicate, ltab, rtab, a.left_alias,
                                 a.right_alias)
    core = _dist_join_core(a, catalog, opts)
    radius_expr = a.radius

    def fn(arrays, binds):
        radius = evaluate(radius_expr, rtab, binds)
        rm = mask_b(binds) if mask_b else None                  # (L, N)
        return _join_output(*core(arrays, arrays["left"], radius, rm))

    return fn


def build_dist_join_batch(a: Analysis, catalog: Catalog, opts: EngineOptions,
                          binds_static: Bindings) -> Callable:
    """Q bind sets x L left rows, flattened into ONE kernel query batch."""
    ltab, rtab = catalog.table(a.left_table), catalog.table(a.right_table)
    mask_b = _join_mask_batch_fn(a.join_predicate, ltab, rtab, a.left_alias,
                                 a.right_alias)
    live = catalog.live_for(a.right_table, a.right_vector) is not None
    core = _dist_join_core(a, catalog, opts)
    radius_expr = a.radius

    def fn(arrays, binds, qvalid=None, probe_budget=None):
        lvec = arrays["left"]
        qn, nleft, qs, rm, dmask = _join_batch_masks(lvec, binds, mask_b,
                                                     arrays, live)
        fq, fb = _flatten_valid_budget(qvalid, probe_budget, qn, nleft,
                                       lvec.device)
        radius = _radius_batch(radius_expr, rtab, binds, qn)
        ids, sims, valid, counts, stats = core(
            arrays, qs, radius.repeat_interleave(nleft), rm, qvalid=fq,
            probe_budget=fb, dmask=dmask)
        shape = (qn, nleft, ids.shape[1])
        qid = torch.arange(nleft, dtype=torch.int32, device=ids.device)
        return {"qid": qid[None, :, None].expand(shape),
                "tid": ids.reshape(shape), "sim": sims.reshape(shape),
                "valid": valid.reshape(shape),
                "count": counts.reshape(qn, nleft),
                "stats": {k: v.reshape(qn, nleft) for k, v in stats.items()}}

    return fn


def _build_dist_join_perleft(a: Analysis, catalog: Catalog,
                             opts: EngineOptions,
                             binds_static: Bindings) -> Callable:
    """The per-left-row baseline: one probe or scan per left row — under
    ``chase`` and ``vbase`` over an index the single-query range probe,
    else with ``use_pallas`` one launch of the single-query range kernel
    each (the matvec-shaped loop the query-tiled lowering replaces; it is
    not batched on purpose)."""
    ltab, rtab = catalog.table(a.left_table), catalog.table(a.right_table)
    metric = _metric_of(catalog, a.right_table, a.right_vector)
    pair_mask = _join_mask_fn(a.join_predicate, ltab, rtab, a.left_alias,
                              a.right_alias)
    index = catalog.index_for(a.right_table, a.right_vector)
    probed = opts.engine in ("chase", "vbase") and index is not None
    cfg = dataclasses.replace(opts.probe, capacity=opts.max_pairs)
    radius_expr = a.radius

    def fn(arrays, binds):
        lvec = arrays["left"]
        corpus = arrays["corpus"]
        dev = corpus.device
        n = corpus.shape[0]
        radius = evaluate(radius_expr, rtab, binds)
        cap = min(opts.max_pairs, n)
        rows = []
        for i in range(lvec.shape[0]):
            rm = pair_mask(i, binds) if pair_mask else None
            if probed and opts.engine == "chase":
                rows.append(ivf_range(arrays["index"], corpus, lvec[i],
                                      radius, rm, cfg))
                continue
            if probed:   # vbase: an unfiltered probe, then the filter
                ids, _sims, valid, _count, stats = ivf_range(
                    arrays["index"], corpus, lvec[i], radius, None, cfg)
                post = _vbase_range_post(
                    metric, corpus, lvec[i:i + 1], ids[None], valid[None],
                    on_device(radius, dev, torch.float32).reshape(1),
                    None if rm is None else rm[None])
                rows.append((ids, *(v[0] for v in post), stats))
                continue
            if opts.use_pallas:
                from ..kernels.ops import fused_range_scan
                hit, raw, count = fused_range_scan(corpus, lvec[i], radius,
                                                   rm, metric)
            else:
                hit, raw = FlatIndex(metric, corpus).range_mask(
                    lvec[i], radius, rm)
                count = hit.sum(dtype=torch.int32)
            rows.append(_compact(hit, raw, metric, cap) + (count,))
        out = _stack_rows(rows)
        if not probed:
            out += (_flat_stats(n, dev, lvec.shape[0]),)
        return _join_output(*out)

    return fn


# ---------------------------------------------------------------------------
# Q4 — entity-centric KNN join
# ---------------------------------------------------------------------------

def _flat_topk_rows(flat: FlatIndex, qs, k: int, rm):
    """The plain per-query top-k over an (M, d) batch, one query at a time
    (the torch form of the reference's ``jax.vmap`` over ``FlatIndex.topk``):
    each row is the single-query scan's answer bit for bit, so the batch and
    perleft lowerings agree exactly."""
    rows = [flat.topk(qs[i], k, None if rm is None else rm[i])
            for i in range(qs.shape[0])]
    return tuple(torch.stack(c) for c in zip(*rows))


def _sort_keys(opts: EngineOptions, metric: Metric, corpus, qs):
    """(M, N) order keys for the full-sort plan: the pairwise-key kernel
    with ``use_pallas``, else one plain row at a time (so that a row's keys
    do not depend on the batch it rides in)."""
    if opts.use_pallas:
        from ..kernels.ops import pairwise_keys
        return pairwise_keys(qs, corpus, metric)
    return torch.cat([pairwise_order_keys(metric, corpus, qs[i:i + 1])
                      for i in range(qs.shape[0])])


def _full_sort_topk(opts: EngineOptions, metric: Metric, corpus, qs, k: int,
                    rm, qvalid=None):
    """The Fig. 5a plan: the window sorts the WHOLE partition
    (|B| log |B|) per left row — the full sort is the measured
    inefficiency.  ``torch.sort(stable=True)``, so ties go to the lowest
    id as ``jnp.argsort`` sends them."""
    keys = _sort_keys(opts, metric, corpus, qs)                  # (M, N)
    # after the pairwise-key kernel, the sort is its stage 2
    with (tracing.span(tracing.STAGE2, keys.device) if opts.use_pallas
          else tracing.NULL):
        if rm is not None:
            keys = keys.masked_fill(~rm, float("inf"))
        if qvalid is not None:
            keys = keys.masked_fill(~qvalid[:, None], float("inf"))
        return compact_range(keys, k, metric)


def _knn_join_core(a: Analysis, catalog: Catalog, opts: EngineOptions,
                   k: int):
    """(arrays, qs (M, d), rm (M, N) | None) -> (ids, sims, valid, stats):
    the batched top-k probe under ``chase`` over an index (the paper's
    headline path), else the flat scan; ``vbase`` and ``pase`` take the
    flat scan over an index too, as in the reference."""
    metric = _metric_of(catalog, a.right_table, a.right_vector)
    index = catalog.index_for(a.right_table, a.right_vector)
    live = catalog.live_for(a.right_table, a.right_vector) is not None
    dist = (_dist_topk_core(opts, metric, k) if opts.dist is not None
            else None)

    def main(arrays, qs, rm, qvalid, probe_budget):
        corpus = arrays["corpus"]
        m, n = qs.shape[0], corpus.shape[0]
        if dist is not None:
            return dist(arrays, qs, rm, qvalid)
        if opts.engine == "chase" and index is not None:
            return ivf_topk_batch(arrays["index"], corpus, qs, k, rm,
                                  opts.probe, probe_budget=probe_budget,
                                  qvalid=qvalid)
        # the flat scans have no probe lane: probe_budget does nothing
        if opts.engine == "brute_sort":
            ids, sims, valid = _full_sort_topk(opts, metric, corpus, qs, k,
                                               rm, qvalid)
        elif opts.use_pallas:   # brute (compiled top-k; LingoDB-V-like)
            ids, sims, valid = _flat_topk_batch(opts, arrays, metric, corpus,
                                                qs, k, rm, qvalid=qvalid)
        else:
            ids, sims, valid = _flat_topk_rows(FlatIndex(metric, corpus), qs,
                                               k, rm)
            if qvalid is not None:
                valid = valid & qvalid[:, None]
                ids = torch.where(valid, ids, -1)
                sims = torch.where(valid, sims, 0.0)
        stats = {"probes": torch.zeros((m,), dtype=torch.int32,
                                       device=corpus.device),
                 "distance_evals": _flat_evals(qvalid, m, n, corpus.device)}
        return ids, sims, valid, stats

    def core(arrays, qs, rm, qvalid=None, probe_budget=None, dmask=None):
        out = main(arrays, qs, rm, qvalid, probe_budget)
        if not live:
            return out
        return _merge_delta_topk(metric, arrays, qs, k, dmask, qvalid, *out)

    return core


def _ranks(k: int, shape, device) -> torch.Tensor:
    return torch.arange(1, k + 1, dtype=torch.int32,
                        device=device).expand(shape)


def build_knn_join(a: Analysis, catalog: Catalog, opts: EngineOptions,
                   binds_static: Bindings) -> Callable:
    """Q4 (entity-centric KNN join): the per-left top-k as one query batch
    (``join_lowering='perleft'`` keeps the loop)."""
    if opts.join_lowering == "perleft":
        return _build_knn_join_perleft(a, catalog, opts, binds_static)
    ltab, rtab = catalog.table(a.left_table), catalog.table(a.right_table)
    k = _static_int(a.k, binds_static, "K")
    mask_b = _join_mask_batch_fn(a.join_predicate, ltab, rtab, a.left_alias,
                                 a.right_alias)
    core = _knn_join_core(a, catalog, opts, k)

    def fn(arrays, binds):
        lvec = arrays["left"]                                   # (L, d)
        rm = mask_b(binds) if mask_b else None                  # (L, N)
        ids, sims, valid, stats = core(arrays, lvec, rm)
        qid = torch.arange(lvec.shape[0], dtype=torch.int32,
                           device=ids.device)
        return {"qid": qid[:, None].expand(ids.shape), "tid": ids,
                "sim": sims, "valid": valid,
                "rank": _ranks(k, ids.shape, ids.device), "stats": stats}

    return fn


def build_knn_join_batch(a: Analysis, catalog: Catalog, opts: EngineOptions,
                         binds_static: Bindings) -> Callable:
    """Q bind sets x L left rows, flattened into ONE kernel query batch."""
    ltab, rtab = catalog.table(a.left_table), catalog.table(a.right_table)
    k = _static_int(a.k, binds_static, "K")
    mask_b = _join_mask_batch_fn(a.join_predicate, ltab, rtab, a.left_alias,
                                 a.right_alias)
    live = catalog.live_for(a.right_table, a.right_vector) is not None
    core = _knn_join_core(a, catalog, opts, k)

    def fn(arrays, binds, qvalid=None, probe_budget=None):
        lvec = arrays["left"]
        qn, nleft, qs, rm, dmask = _join_batch_masks(lvec, binds, mask_b,
                                                     arrays, live)
        fq, fb = _flatten_valid_budget(qvalid, probe_budget, qn, nleft,
                                       lvec.device)
        ids, sims, valid, stats = core(arrays, qs, rm, qvalid=fq,
                                       probe_budget=fb, dmask=dmask)
        shape = (qn, nleft, k)
        qid = torch.arange(nleft, dtype=torch.int32, device=ids.device)
        return {"qid": qid[None, :, None].expand(shape),
                "tid": ids.reshape(shape), "sim": sims.reshape(shape),
                "valid": valid.reshape(shape),
                "rank": _ranks(k, shape, ids.device),
                "stats": {key: v.reshape(qn, nleft)
                          for key, v in stats.items()}}

    return fn


def _build_knn_join_perleft(a: Analysis, catalog: Catalog,
                            opts: EngineOptions,
                            binds_static: Bindings) -> Callable:
    """The per-left-row baseline: one probe or scan per left row — under
    ``chase`` over an index the single-query top-k probe; else under
    ``brute_sort`` one full sort each, and otherwise with ``use_pallas``
    one launch of the single-query top-k kernel each."""
    ltab, rtab = catalog.table(a.left_table), catalog.table(a.right_table)
    metric = _metric_of(catalog, a.right_table, a.right_vector)
    k = _static_int(a.k, binds_static, "K")
    pair_mask = _join_mask_fn(a.join_predicate, ltab, rtab, a.left_alias,
                              a.right_alias)
    probed = (opts.engine == "chase"
              and catalog.index_for(a.right_table, a.right_vector)
              is not None)

    def fn(arrays, binds):
        lvec = arrays["left"]
        corpus = arrays["corpus"]
        dev = corpus.device
        n = corpus.shape[0]
        flat = FlatIndex(metric, corpus)
        rows = []
        for i in range(lvec.shape[0]):
            rm = pair_mask(i, binds) if pair_mask else None
            if probed:
                rows.append(ivf_topk(arrays["index"], corpus, lvec[i], k, rm,
                                     opts.probe))
            elif opts.engine == "brute_sort":
                rows.append(tuple(v[0] for v in _full_sort_topk(
                    opts, metric, corpus, lvec[i:i + 1], k,
                    None if rm is None else rm[None])))
            else:
                rows.append(_flat_topk(opts, flat, lvec[i], k, rm))
        ids, sims, valid, *stats = _stack_rows(rows)
        nleft = ids.shape[0]
        stats = stats[0] if probed else _flat_stats(n, dev, nleft)
        qid = torch.arange(nleft, dtype=torch.int32, device=dev)
        return {"qid": qid[:, None].expand(ids.shape), "tid": ids,
                "sim": sims, "valid": valid,
                "rank": _ranks(k, ids.shape, dev), "stats": stats}

    return fn


# ---------------------------------------------------------------------------
# Q5 / Q6 — category-driven
# ---------------------------------------------------------------------------

def _rank_per_category(metric: Metric, ids, keys, valid, cats, C: int,
                       K: int):
    """(..., P) result buffers -> (..., C, K) per-category top-K: the window
    operator over the range scan's output, for one buffer or a batch of
    them at once (the reference's ``_rank_per_category`` and
    ``_rank_per_category_batch``).  It consumes the scan's similarity
    through ``keys`` (the map-operator contract) and sorts stably, so equal
    keys keep their buffer order, as ``lax.top_k`` keeps it."""
    c = torch.arange(C, dtype=cats.dtype, device=cats.device)[:, None]
    member = valid[..., None, :] & (cats[..., None, :] == c)     # (..., C, P)
    ck, cids, cvalid = masked_topk(keys[..., None, :].expand(member.shape),
                                   ids[..., None, :], member, K)
    sims = torch.where(cvalid, -ck if metric.is_similarity() else ck, 0.0)
    return cids, sims, cvalid


def _ranked_buffer(metric: Metric, cats, ids, sims, valid, C: int, k: int,
                   dcats=None):
    """A best-first range buffer -> its per-category ranking.  The keys are
    rebuilt from the buffer's own sims (not from the corpus), so the rank
    orders exactly what the scan emitted.  With ``dcats`` (a live delta
    segment's categories) an id >= len(cats) reads its category there."""
    keys = torch.where(valid, order_key(metric, sims), float("inf"))
    safe = ids.clamp_min(0).long()
    n = cats.shape[0]
    if dcats is None:
        bcats = cats[safe]
    else:
        bcats = torch.where(safe < n, cats[safe.clamp_max(n - 1)],
                            dcats[(safe - n).clamp(0, dcats.shape[0] - 1)])
    bcats = torch.where(valid, bcats, -1)
    return _rank_per_category(metric, ids, keys, valid, bcats, C, k)


# the engines whose Q5 / Q6 plans probe an IVF index when one is registered
# (pase cannot route a range query to the index, paper §2.3)
_CATEGORY_PROBE_ENGINES = ("chase", "vbase", "chase_no_updatestate")


def _category_probe(opts: EngineOptions, metric: Metric, cfg: ProbeConfig,
                    index, corpus, cats, qs, radius, rm, probe_budget=None,
                    qvalid=None):
    """The IVF range probe of Q5 / Q6 over an (M, d) batch or one (d,)
    query (the single-query probe): ``chase`` keeps Algorithm 2's record
    table and its early stop (updateState), ``vbase`` and
    ``chase_no_updatestate`` run the plain range probe, and ``vbase`` then
    recomputes every buffered row's similarity (Fig. 1c).  Returns (ids,
    sims, valid, stats)."""
    if qs.ndim == 1:
        if opts.engine == "chase":
            ids, sims, valid, _c, stats = ivf_range_category(
                index, corpus, cats, qs, radius, rm, cfg)
        else:
            ids, sims, valid, _c, stats = ivf_range(index, corpus, qs,
                                                    radius, rm, cfg)
        if opts.engine == "vbase":
            sims = torch.where(valid, _recompute(metric, corpus, qs[None],
                                                 ids[None])[0], 0.0)
        return ids, sims, valid, stats
    probe = dict(cfg=cfg, probe_budget=probe_budget, qvalid=qvalid)
    if opts.engine == "chase":
        ids, sims, valid, _c, stats = ivf_range_category_batch(
            index, corpus, cats, qs, radius, rm, **probe)
    else:
        ids, sims, valid, _c, stats = ivf_range_batch(index, corpus, qs,
                                                      radius, rm, **probe)
    if opts.engine == "vbase":
        sims = torch.where(valid, _recompute(metric, corpus, qs, ids), 0.0)
    return ids, sims, valid, stats


def _category_core(opts: EngineOptions, metric: Metric, index, C: int,
                   k: int, vbase_extra_evals: bool,
                   live_cat_col: str | None = None):
    """(arrays, qs (M, d), radius, rm (M, N) | None) -> (M, C, K) ranked
    batch.  Shared by the Q5 bind-batch lowering and the Q6 left-row batch:
    one batched IVF probe (under the probe engines over an index) or one
    flat range scan of the (M, d) query batch, then the window rank for all
    M queries at once.  ``vbase_extra_evals`` counts vbase's recomputation
    as ``capacity`` evals per live query (Q5; the reference's Q6 counts
    none).  Over a live corpus (``live_cat_col``, the category column) the
    delta segment merges in LOSSLESSLY (main plus delta buffer widths: the
    window rank reads the whole buffer, so a truncation would drop
    per-category candidates a frozen plan keeps), and merged delta ids
    read their category from the live delta columns."""
    cfg = dataclasses.replace(opts.probe, num_categories=C, k_per_category=k)
    probed = index is not None and opts.engine in _CATEGORY_PROBE_ENGINES
    dist = (_dist_range_core(opts, metric, cfg.capacity)
            if opts.dist is not None else None)

    def core(arrays, qs, radius, rm, qvalid=None, probe_budget=None,
             dmask=None):
        corpus, cats = arrays["corpus"], arrays["categories"]
        radius = on_device(radius, qs.device,
                           torch.float32).expand(qs.shape[0])
        if dist is not None:
            ids, sims, valid, _count, stats = dist(arrays, qs, radius, rm,
                                                   qvalid)
        elif probed:
            ids, sims, valid, stats = _category_probe(
                opts, metric, cfg, arrays["index"], corpus, cats, qs, radius,
                rm, probe_budget, qvalid)
            if opts.engine == "vbase" and vbase_extra_evals:
                stats = _extra_evals(stats, cfg.capacity, qvalid)
        else:
            # the flat scan has no probe lane: probe_budget does nothing
            ids, sims, valid, _count, stats = _flat_range_topk_batch(
                opts, metric, corpus, qs, radius, rm, cfg.capacity,
                qvalid=qvalid, arrays=arrays)
        dcats = None
        if live_cat_col is not None:
            width = ids.shape[1] + arrays["live_delta_vec"].shape[0]
            ids, sims, valid, _count, stats = _merge_delta_range(
                metric, arrays, qs, radius, width, dmask, qvalid, ids, sims,
                valid, torch.zeros_like(ids[:, 0]), stats)
            dcats = arrays["live_dcols"][live_cat_col]
        cids, csims, cvalid = _ranked_buffer(metric, cats, ids, sims, valid,
                                             C, k, dcats)
        return cids, csims, cvalid, stats

    return core


def _category_of(table: Table, a: Analysis) -> int:
    col = a.category_column.name
    C = table.schema[col].num_categories
    if not C:
        raise ValueError(f"category column {col} needs num_categories")
    return C


def _categories(C: int, shape, device) -> torch.Tensor:
    """The category index of each (..., C, K) slot."""
    return torch.arange(C, dtype=torch.int32,
                        device=device)[:, None].expand(shape)


def _single_range(metric: Metric, corpus, q, radius, row_mask,
                  capacity: int):
    """The reference's kernel-less single-query range lowering: the plain
    flat scan and a top-``capacity`` of its hits, capped at N."""
    hit, raw = FlatIndex(metric, corpus).range_mask(q, radius, row_mask)
    return _compact(hit, raw, metric, min(capacity, corpus.shape[0]))


def build_category_partition(a: Analysis, catalog: Catalog,
                             opts: EngineOptions,
                             binds_static: Bindings) -> Callable:
    """Q5 (category-driven, single table): the range probe (with
    updateState's early stop under ``chase``) or scan, then the
    per-category rank.  As in the reference, the single-query flat plan
    runs the exact plain scan whatever ``use_pallas`` says, and ``vbase``
    counts its recomputation as ``capacity`` evals."""
    table = catalog.table(a.table)
    metric = _metric_of(catalog, a.table, a.vector_column)
    k = _static_int(a.k, binds_static, "K")
    C = _category_of(table, a)
    mask_fn = _row_mask_fn(a.structured_predicate, table)
    qparam = a.query_expr
    radius_expr = a.radius
    cfg = dataclasses.replace(opts.probe, num_categories=C, k_per_category=k)
    probed = (catalog.index_for(a.table, a.vector_column) is not None
              and opts.engine in _CATEGORY_PROBE_ENGINES)

    def fn(arrays, binds):
        corpus = arrays["corpus"]
        dev = corpus.device
        q = as_tensor(binds[qparam.name], dev)
        radius = evaluate(radius_expr, table, binds)
        row_mask = mask_fn(binds) if mask_fn else None
        if probed:
            ids, sims, valid, stats = _category_probe(
                opts, metric, cfg, arrays["index"], corpus,
                arrays["categories"], q, radius, row_mask)
            if opts.engine == "vbase":
                stats = _extra_evals(stats, cfg.capacity, None)
        else:
            ids, sims, valid = _single_range(metric, corpus, q, radius,
                                             row_mask, cfg.capacity)
            stats = _flat_stats(corpus.shape[0], dev)
        cids, csims, cvalid = _ranked_buffer(metric, arrays["categories"],
                                             ids, sims, valid, C, k)
        return {"ids": cids, "sim": csims, "valid": cvalid,
                "category": _categories(C, cids.shape, dev), "stats": stats}

    return fn


def build_category_partition_batch(a: Analysis, catalog: Catalog,
                                   opts: EngineOptions,
                                   binds_static: Bindings) -> Callable:
    """Q5 over Q bind sets: one batched range scan + one window rank."""
    table = catalog.table(a.table)
    metric = _metric_of(catalog, a.table, a.vector_column)
    k = _static_int(a.k, binds_static, "K")
    C = _category_of(table, a)
    mask_fn = _row_mask_batch_fn(a.structured_predicate, table)
    qparam = a.query_expr
    live = catalog.live_for(a.table, a.vector_column) is not None
    core = _category_core(opts, metric,
                          catalog.index_for(a.table, a.vector_column), C, k,
                          vbase_extra_evals=True,
                          live_cat_col=(a.category_column.name if live
                                        else None))
    radius_expr = a.radius

    def fn(arrays, binds, qvalid=None, probe_budget=None):
        dev = arrays["corpus"].device
        qs = as_tensor(binds[qparam.name], dev)                  # (Q, D)
        qn = qs.shape[0]
        radius = _radius_batch(radius_expr, table, binds, qn)
        if qvalid is not None:
            qvalid = on_device(qvalid, dev, torch.bool)
        dmask = None
        if live:
            row_mask, dmask = _live_scan_masks(a.structured_predicate,
                                               arrays, binds, qn)
        else:
            row_mask = mask_fn(binds, qn) if mask_fn else None   # (Q, N)
        cids, csims, cvalid, stats = core(arrays, qs, radius, row_mask,
                                          qvalid=qvalid,
                                          probe_budget=probe_budget,
                                          dmask=dmask)
        return {"ids": cids, "sim": csims, "valid": cvalid,
                "category": _categories(C, cids.shape, dev), "stats": stats}

    return fn


def _category_join_output(cids, csims, cvalid, stats, C: int) -> dict:
    nleft = cids.shape[0]
    qid = torch.arange(nleft, dtype=torch.int32, device=cids.device)
    return {"qid": qid[:, None, None].expand(cids.shape), "tid": cids,
            "sim": csims, "valid": cvalid,
            "category": _categories(C, cids.shape, cids.device),
            "stats": stats}


def build_category_join(a: Analysis, catalog: Catalog, opts: EngineOptions,
                        binds_static: Bindings) -> Callable:
    """Q6 (category-driven join): Q5's scan + rank for every left row, as
    one query batch (``join_lowering='perleft'`` keeps the loop)."""
    if opts.join_lowering == "perleft":
        return _build_category_join_perleft(a, catalog, opts, binds_static)
    ltab, rtab = catalog.table(a.left_table), catalog.table(a.right_table)
    metric = _metric_of(catalog, a.right_table, a.right_vector)
    k = _static_int(a.k, binds_static, "K")
    C = _category_of(rtab, a)
    mask_b = _join_mask_batch_fn(a.join_predicate, ltab, rtab, a.left_alias,
                                 a.right_alias)
    # the reference's Q6 counts no evals for vbase's recomputation, in
    # either lowering
    core = _category_core(opts, metric,
                          catalog.index_for(a.right_table, a.right_vector),
                          C, k, vbase_extra_evals=False)
    radius_expr = a.radius

    def fn(arrays, binds):
        radius = evaluate(radius_expr, rtab, binds)
        rm = mask_b(binds) if mask_b else None                  # (L, N)
        return _category_join_output(*core(arrays, arrays["left"], radius,
                                           rm), C)

    return fn


def build_category_join_batch(a: Analysis, catalog: Catalog,
                              opts: EngineOptions,
                              binds_static: Bindings) -> Callable:
    """Q bind sets x L left rows, flattened into ONE kernel query batch."""
    ltab, rtab = catalog.table(a.left_table), catalog.table(a.right_table)
    metric = _metric_of(catalog, a.right_table, a.right_vector)
    k = _static_int(a.k, binds_static, "K")
    C = _category_of(rtab, a)
    mask_b = _join_mask_batch_fn(a.join_predicate, ltab, rtab, a.left_alias,
                                 a.right_alias)
    live = catalog.live_for(a.right_table, a.right_vector) is not None
    # the reference's Q6 counts no evals for vbase's recomputation, in
    # either lowering
    core = _category_core(opts, metric,
                          catalog.index_for(a.right_table, a.right_vector),
                          C, k, vbase_extra_evals=False,
                          live_cat_col=(a.category_column.name if live
                                        else None))
    radius_expr = a.radius

    def fn(arrays, binds, qvalid=None, probe_budget=None):
        lvec = arrays["left"]
        qn, nleft, qs, rm, dmask = _join_batch_masks(lvec, binds, mask_b,
                                                     arrays, live)
        fq, fb = _flatten_valid_budget(qvalid, probe_budget, qn, nleft,
                                       lvec.device)
        radius = _radius_batch(radius_expr, rtab, binds, qn)
        cids, csims, cvalid, stats = core(
            arrays, qs, radius.repeat_interleave(nleft), rm, qvalid=fq,
            probe_budget=fb, dmask=dmask)
        shape = (qn, nleft, C, k)
        qid = torch.arange(nleft, dtype=torch.int32, device=lvec.device)
        return {"qid": qid[None, :, None, None].expand(shape),
                "tid": cids.reshape(shape), "sim": csims.reshape(shape),
                "valid": cvalid.reshape(shape),
                "category": _categories(C, shape, lvec.device),
                "stats": {key: v.reshape(qn, nleft)
                          for key, v in stats.items()}}

    return fn


def _build_category_join_perleft(a: Analysis, catalog: Catalog,
                                 opts: EngineOptions,
                                 binds_static: Bindings) -> Callable:
    """The per-left-row baseline: Q5's single-query plan once per left row
    — the single-query probe over an index under the probe engines (no
    extra evals for vbase), else the plain flat scan (the reference lowers
    it without a kernel)."""
    ltab, rtab = catalog.table(a.left_table), catalog.table(a.right_table)
    metric = _metric_of(catalog, a.right_table, a.right_vector)
    k = _static_int(a.k, binds_static, "K")
    C = _category_of(rtab, a)
    pair_mask = _join_mask_fn(a.join_predicate, ltab, rtab, a.left_alias,
                              a.right_alias)
    radius_expr = a.radius
    cfg = dataclasses.replace(opts.probe, num_categories=C, k_per_category=k)
    probed = (catalog.index_for(a.right_table, a.right_vector) is not None
              and opts.engine in _CATEGORY_PROBE_ENGINES)

    def fn(arrays, binds):
        lvec = arrays["left"]
        corpus, cats = arrays["corpus"], arrays["categories"]
        dev = corpus.device
        n = corpus.shape[0]
        radius = evaluate(radius_expr, rtab, binds)
        rows = []
        for i in range(lvec.shape[0]):
            rm = pair_mask(i, binds) if pair_mask else None
            if probed:
                ids, sims, valid, *stats = _category_probe(
                    opts, metric, cfg, arrays["index"], corpus, cats,
                    lvec[i], radius, rm)
            else:
                ids, sims, valid = _single_range(metric, corpus, lvec[i],
                                                 radius, rm, cfg.capacity)
                stats = []
            rows.append(_ranked_buffer(metric, cats, ids, sims, valid, C, k)
                        + tuple(stats))
        out = _stack_rows(rows)
        if not probed:
            out += (_flat_stats(n, dev, lvec.shape[0]),)
        return _category_join_output(*out, C)

    return fn


BUILDERS = {
    QueryClass.VKNN_SF: build_vknn_sf,
    QueryClass.DR_SF: build_dr_sf,
    QueryClass.DIST_JOIN: build_dist_join,
    QueryClass.KNN_JOIN: build_knn_join,
    QueryClass.CATEGORY_PARTITION: build_category_partition,
    QueryClass.CATEGORY_JOIN: build_category_join,
}

# Every class has a NATIVE batched lowering; the join families flatten
# (bind sets x left rows) into one kernel-level query batch.  The
# loop-of-singles fallback remains only for join_lowering='perleft'
# (core/compiler.py gates it — the measured baseline).
BATCH_BUILDERS = {
    QueryClass.VKNN_SF: build_vknn_sf_batch,
    QueryClass.DR_SF: build_dr_sf_batch,
    QueryClass.DIST_JOIN: build_dist_join_batch,
    QueryClass.KNN_JOIN: build_knn_join_batch,
    QueryClass.CATEGORY_PARTITION: build_category_partition_batch,
    QueryClass.CATEGORY_JOIN: build_category_join_batch,
}

# the join classes whose lowering obeys opts.join_lowering: 'perleft' swaps
# their single-call builder for the per-left loop AND forces the
# loop-of-singles execute_batch fallback (Q5 has no left side, so its
# batching never degrades).
JOIN_LOWERING_FAMILIES = frozenset({
    QueryClass.DIST_JOIN, QueryClass.KNN_JOIN, QueryClass.CATEGORY_JOIN,
})
