"""Public contracts of the fused scans: mask layout, the kernels' stage 1,
and the stage-2 merge in plain torch.

The kernels take ragged N, D and Q and mask the edge themselves, so none of
the reference's padding helpers is needed: the only layout work left is
viewing a bool mask as the int8 the kernels read (no copy) and the per-query
valid lane.
"""
from __future__ import annotations

import torch

from ..core.schema import Metric
from ..index.flat import stable_smallest_k
from .scan_topk import scan_topk, scan_topk_batch


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


def fused_scan_topk(corpus: torch.Tensor, query: torch.Tensor, k: int,
                    row_mask: torch.Tensor | None, metric: Metric):
    """Fused single-query scan + filter + top-k (drop-in for
    ``FlatIndex.topk``).  Returns (ids (k,), sims raw-metric (k,),
    valid (k,))."""
    keys, ids = scan_topk(corpus.to(torch.float32).contiguous(),
                          query.to(torch.float32).reshape(-1).contiguous(),
                          _mask_i8(row_mask), k, metric)
    return _merge(keys.reshape(-1), ids.reshape(-1), k, metric)


def fused_scan_topk_batch(corpus: torch.Tensor, queries: torch.Tensor,
                          k: int, row_mask: torch.Tensor | None,
                          metric: Metric,
                          qvalid: torch.Tensor | None = None):
    """Batched fused scan + filter + top-k: Q queries in one launch.

    ``row_mask`` is None, a shared (N,) mask, or a per-query (Q, N) mask;
    ``qvalid`` (None | (Q,) bool) marks size-bucket pad queries, which emit
    no candidates (all ids -1).  Returns (ids (Q, k), sims raw-metric
    (Q, k), valid (Q, k))."""
    qv = None if qvalid is None else _mask_i8(qvalid)
    keys, ids = scan_topk_batch(corpus.to(torch.float32).contiguous(),
                                queries.to(torch.float32).contiguous(),
                                _mask_i8(row_mask), qv, k, metric)
    return _merge(keys, ids, k, metric)
