"""Pure-torch oracles of the fused scan kernels (the ``ref.py`` contract):
the semantic ground truth, written from the expression evaluator rather than
from the kernels' matmul-plus-epilogue form."""
from __future__ import annotations

import torch

from ..core.expr import distance_values, full_fp32, order_key
from ..core.schema import Metric
from ..index.flat import stable_smallest_k


def keys_ref(corpus: torch.Tensor, query: torch.Tensor,
             metric: Metric) -> torch.Tensor:
    """(N,) order keys (ascending-better) of corpus rows vs a single query."""
    return order_key(metric, distance_values(metric, corpus, query))


def scan_topk_ref(corpus: torch.Tensor, query: torch.Tensor, k: int,
                  row_mask: torch.Tensor | None, metric: Metric):
    """Fused scan+filter+topk oracle. Returns (ids, keys, valid)."""
    keys = keys_ref(corpus, query, metric)
    if row_mask is not None:
        keys = keys.masked_fill(~row_mask, float("inf"))
    out_keys, idx = stable_smallest_k(keys, k)
    valid = torch.isfinite(out_keys)
    return torch.where(valid, idx, -1), out_keys, valid


def range_scan_ref(corpus: torch.Tensor, query: torch.Tensor, radius_key,
                   row_mask: torch.Tensor | None, metric: Metric):
    """Fused range scan oracle. Returns (hit mask (N,), keys (N,))."""
    keys = keys_ref(corpus, query, metric)
    hit = keys <= radius_key
    if row_mask is not None:
        hit = hit & row_mask
    return hit, keys


def pairwise_keys_ref(queries: torch.Tensor, corpus: torch.Tensor,
                      metric: Metric) -> torch.Tensor:
    """(Q, N) order-key matrix oracle, in the reference's float order:
    q2 − 2ip + c2 for L2, −ip / (‖q‖·‖c‖ + 1e-12) for cosine."""
    q = queries.to(torch.float32)
    c = corpus.to(torch.float32)
    with full_fp32():
        ip = q @ c.T
    if metric == Metric.INNER_PRODUCT:
        return -ip
    if metric == Metric.L2:
        q2 = torch.sum(q * q, dim=1, keepdim=True)
        c2 = torch.sum(c * c, dim=1)
        return q2 - 2.0 * ip + c2[None, :]
    if metric == Metric.COSINE:
        qn = torch.linalg.vector_norm(q, dim=1, keepdim=True)
        cn = torch.linalg.vector_norm(c, dim=1)
        return -(ip / (qn * cn[None, :] + 1e-12))
    raise ValueError(metric)
