"""Public contracts of the fused scans and the pairwise key matrix: mask
layout, the kernels' stage 1, and the stage-2 merges and compactions in
plain torch (a batched range compaction runs on the card instead, up to
``range_scan.APPEND_WIDTH``, and plain torch only recomputes the queries
past its buffer).

The top-k wrappers take any k >= 1, as the reference does.  The plan is
chosen on the host by k before any launch: up to ``MAX_K`` (the lists the
top-k kernels keep in shared memory) the fused top-k kernels, above it the
range kernels at an infinite radius (every live row a hit, keys bit for bit
the top-k kernels' keys) and a stable smallest-k over the row keys, so a
longer answer's first ``MAX_K`` entries are the ``MAX_K`` answer.

The kernels take ragged N, D and Q and mask the edge themselves, so none of
the reference's padding helpers is needed: the only layout work left is
viewing a bool mask as the int8 the kernels read (no copy), the per-query
valid lane, and the radius as an fp32 order key.

Each stage 2 after a kernel is the span ``repro_torch.stage2``
(:mod:`repro_torch.tracing`), timed on the card's stream too.
"""
from __future__ import annotations

import torch

from .. import tracing
from ..core.expr import on_device, order_key
from ..core.schema import Metric
from ..index.flat import compact_range, stable_smallest_k
from . import distance
from .range_scan import (APPEND_WIDTH, range_scan, range_scan_batch,
                         range_topk_batch)
from .scan_topk import MAX_K, scan_topk, scan_topk_batch

INF = float("inf")


def _stage2(device: torch.device):
    """The span of a stage 2 on ``device``."""
    return tracing.span(tracing.STAGE2, device)


def _mask_i8(mask: torch.Tensor | None) -> torch.Tensor | None:
    """A bool (N,) / (Q, N) mask as the int8 the kernels read (a view)."""
    if mask is None:
        return None
    return mask.to(torch.bool).contiguous().view(torch.int8)


def _merge(keys: torch.Tensor, ids: torch.Tensor, k: int, metric: Metric):
    """Stage 2: the k best of each row of candidates.

    Candidates come split by split, each split's list ascending by (key,
    id), and splits cover ascending row ranges, so among equal keys the
    candidate position order IS the row-id order: a stable sort on the key
    alone keeps the reference's lowest-id tie-break."""
    out_keys, pos = stable_smallest_k(keys, k)
    valid = torch.isfinite(out_keys)
    out_ids = torch.where(
        valid, torch.take_along_dim(ids, pos.clamp_min(0).long(), dim=-1), -1)
    sims = torch.where(
        valid, -out_keys if metric.is_similarity() else out_keys, 0.0)
    return out_ids, sims, valid


def _check_limit(k: int) -> None:
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")


def fused_scan_topk(corpus: torch.Tensor, query: torch.Tensor, k: int,
                    row_mask: torch.Tensor | None, metric: Metric):
    """Fused single-query scan + filter + top-k (drop-in for
    ``FlatIndex.topk``), any k >= 1: up to ``MAX_K`` the single-query
    top-k kernel and its stage-2 merge, above it the single-query range
    kernel at an infinite radius and a stable smallest-k over its keys.
    Returns (ids (k,), sims raw-metric (k,), valid (k,))."""
    _check_limit(k)
    corpus = corpus.to(torch.float32).contiguous()
    query = query.to(torch.float32).reshape(-1).contiguous()
    mask = _mask_i8(row_mask)
    if k > MAX_K:
        keys, _hits, _count = range_scan(
            corpus, query, torch.full((1,), INF, device=corpus.device), mask,
            metric)
        with _stage2(keys.device):
            return compact_range(keys, k, metric)
    keys, ids = scan_topk(corpus, query, mask, k, metric)
    with _stage2(keys.device):
        return _merge(keys.reshape(-1), ids.reshape(-1), k, metric)


def fused_scan_topk_batch(corpus: torch.Tensor, queries: torch.Tensor,
                          k: int, row_mask: torch.Tensor | None,
                          metric: Metric,
                          qvalid: torch.Tensor | None = None):
    """Batched fused scan + filter + top-k: Q queries in one launch, any
    k >= 1: up to ``MAX_K`` the batched top-k kernel and its stage-2
    merge, above it the batched range kernel at infinite radii and a
    stable smallest-k over each query's (N,) keys.

    ``row_mask`` is None, a shared (N,) mask, or a per-query (Q, N) mask;
    ``qvalid`` (None | (Q,) bool) marks size-bucket pad queries, which emit
    no candidates (all ids -1).  Returns (ids (Q, k), sims raw-metric
    (Q, k), valid (Q, k))."""
    _check_limit(k)
    corpus = corpus.to(torch.float32).contiguous()
    queries = queries.to(torch.float32).contiguous()
    mask = _mask_i8(row_mask)
    qv = None if qvalid is None else _mask_i8(qvalid)
    if k > MAX_K:
        keys, _hits, _counts = range_scan_batch(
            corpus, queries,
            torch.full((queries.shape[0],), INF, device=corpus.device), mask,
            qv, metric)
        with _stage2(keys.device):
            return compact_range(keys, k, metric)
    keys, ids = scan_topk_batch(corpus, queries, mask, qv, k, metric)
    with _stage2(keys.device):
        return _merge(keys, ids, k, metric)


def _radius_keys(radius, metric: Metric, qn: int,
                 device: torch.device) -> torch.Tensor:
    """A raw radius (scalar or (Q,)) as (Q,) fp32 order keys on ``device``
    (rounded to fp32 first, as the reference does)."""
    r = on_device(radius, device, torch.float32)
    return order_key(metric, r.expand(qn)).contiguous()


def _raw(keys: torch.Tensor, hit: torch.Tensor, metric: Metric):
    """Raw metric values on the hits, 0 elsewhere."""
    return torch.where(hit, -keys if metric.is_similarity() else keys, 0.0)


def fused_range_scan(corpus: torch.Tensor, query: torch.Tensor, radius,
                     row_mask: torch.Tensor | None, metric: Metric):
    """Fused single-query range scan (drop-in for ``FlatIndex.range_mask``).
    ``radius`` is a raw metric value (a number or a 0-d tensor).  Returns
    (hit (N,), raw sims (N,), count, a 0-d int32)."""
    corpus = corpus.to(torch.float32).contiguous()
    keys, hits, count = range_scan(
        corpus, query.to(torch.float32).reshape(-1).contiguous(),
        _radius_keys(radius, metric, 1, corpus.device),
        _mask_i8(row_mask), metric)
    hit = hits.view(torch.bool)
    return hit, _raw(keys, hit, metric), count


def _range_batch(corpus: torch.Tensor, queries: torch.Tensor, radius,
                 row_mask: torch.Tensor | None, metric: Metric,
                 qvalid: torch.Tensor | None):
    """The batched kernel on the public inputs: (keys, hit, counts)."""
    corpus = corpus.to(torch.float32).contiguous()
    queries = queries.to(torch.float32).contiguous()
    qv = None if qvalid is None else _mask_i8(qvalid)
    keys, hits, counts = range_scan_batch(
        corpus, queries,
        _radius_keys(radius, metric, queries.shape[0], corpus.device),
        _mask_i8(row_mask), qv, metric)
    return keys, hits.view(torch.bool), counts


def fused_range_scan_batch(corpus: torch.Tensor, queries: torch.Tensor,
                           radius, row_mask: torch.Tensor | None,
                           metric: Metric,
                           qvalid: torch.Tensor | None = None):
    """Batched fused range scan.  ``radius`` is a scalar or (Q,) raw values;
    ``row_mask`` None, shared (N,) or per-query (Q, N); ``qvalid``
    (None | (Q,) bool) marks size-bucket pad queries, which register no hits
    and a zero count.  Returns (hit (Q, N), raw sims (Q, N), counts (Q,))."""
    keys, hit, counts = _range_batch(corpus, queries, radius, row_mask,
                                     metric, qvalid)
    return hit, _raw(keys, hit, metric), counts


def fused_range_topk_batch(corpus: torch.Tensor, queries: torch.Tensor,
                           radius, row_mask: torch.Tensor | None,
                           metric: Metric, capacity: int,
                           qvalid: torch.Tensor | None = None):
    """Fused range scan + per-query compaction to a fixed result buffer: the
    best ``capacity`` hits of each query, ascending by order key, equal keys
    lowest id first.  Inputs as :func:`fused_range_scan_batch`.  Returns
    (ids (Q, capacity), sims raw-metric, valid (Q, capacity), count (Q,)
    total hits before truncation).

    Up to ``range_scan.APPEND_WIDTH`` the kernel compacts on the card
    (``range_topk_batch``: only the hits are sorted); stage 2 reads the
    counts on the host (one sync) and recomputes each query with more hits
    than ``capacity`` on the dense path below, counted as
    ``range_overflows``.  The dense path, and every capacity above the
    bound: the kernel's keys are already +inf off the hits, and on a hit
    they equal the reference's ``order_key(raw)`` bit for bit, so the
    compaction sorts them directly instead of rebuilding them from the raw
    values.  Both give the same answer bit for bit."""
    if not 1 <= capacity <= APPEND_WIDTH:
        keys, _hit, counts = _range_batch(corpus, queries, radius, row_mask,
                                          metric, qvalid)
        with _stage2(keys.device):
            return compact_range(keys, capacity, metric) + (counts,)
    corpus = corpus.to(torch.float32).contiguous()
    queries = queries.to(torch.float32).contiguous()
    dev = corpus.device
    mask = _mask_i8(row_mask)
    rk = _radius_keys(radius, metric, queries.shape[0], dev)
    qv = None if qvalid is None else _mask_i8(qvalid)
    ids, sims, valid, counts = range_topk_batch(corpus, queries, rk, mask,
                                                qv, metric, capacity)
    with _stage2(dev):
        if dev.type != "cpu":
            tracing.count("syncs")
        over = torch.nonzero(counts.cpu() > capacity).flatten()
        if len(over):
            tracing.count("range_overflows", len(over))
            idx = on_device(over, dev, torch.long)
            if dev.type == "cpu":
                # a row of the plain scan depends on the batch around it
                # (the CPU's matmul), a row of the kernel's does not
                keys = range_scan_batch(corpus, queries, rk, mask, qv,
                                        metric)[0][idx]
            else:
                keys = range_scan_batch(
                    corpus, queries[idx], rk[idx],
                    mask if mask is None or mask.ndim == 1 else mask[idx],
                    None, metric)[0]
            ids[idx], sims[idx], valid[idx] = compact_range(keys, capacity,
                                                            metric)
    return ids, sims, valid, counts


def pairwise_keys(queries: torch.Tensor, corpus: torch.Tensor,
                  metric: Metric) -> torch.Tensor:
    """(Q, N) fp32 order-key matrix (smaller = better) of every (query,
    corpus row) pair.  Inputs of any float dtype (bf16 included) are cast
    to fp32, as the reference op does."""
    return distance.pairwise_keys(queries.to(torch.float32).contiguous(),
                                  corpus.to(torch.float32).contiguous(),
                                  metric)
