"""Brute-force (exact) index: the plain-torch flat scan taken when
``EngineOptions.use_pallas`` is False (and by the single-query Q2 plan,
which the reference lowers without a kernel), and the stable smallest-k
every top-k and range compaction in the port goes through.

``torch.topk`` does not keep ``lax.top_k``'s order among equal keys (lowest
index first), so the port selects with a stable sort instead.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.expr import distance_values, in_range, pairwise_order_keys
from ..core.schema import Metric


def stable_smallest_k(keys: torch.Tensor,
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries along the last axis, ascending, equal keys
    in index order.  Returns (values, int32 indices); where ``k`` exceeds
    the axis the tail is +inf with index -1."""
    vals, idx = torch.sort(keys, dim=-1, stable=True)
    vals, idx = vals[..., :k], idx[..., :k].to(torch.int32)
    short = k - vals.shape[-1]
    if short > 0:
        pad = vals.shape[:-1] + (short,)
        vals = torch.cat([vals, vals.new_full(pad, float("inf"))], dim=-1)
        idx = torch.cat([idx, idx.new_full(pad, -1)], dim=-1)
    return vals, idx


def compact_range(keys: torch.Tensor, capacity: int, metric: Metric):
    """The best ``capacity`` hits of each row of (..., N) order keys that
    are +inf off the hits: ascending by key, equal keys lowest id first.
    Returns (ids, raw sims, valid), each (..., capacity); empty slots hold
    id -1 and sim 0.  The sims are the keys turned back into raw values,
    which is exact (a negation or the identity)."""
    vals, sel = stable_smallest_k(keys, capacity)
    valid = torch.isfinite(vals)
    ids = torch.where(valid, sel, -1)
    sims = torch.where(valid, -vals if metric.is_similarity() else vals, 0.0)
    return ids, sims, valid


def masked_topk(keys: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Smallest-k by key among masked rows along the last axis.  Returns
    (keys, ids, valid); empty slots hold +inf and id -1."""
    keyed = keys.masked_fill(~mask, float("inf"))
    sel_keys, idx = stable_smallest_k(keyed, k)
    valid = torch.isfinite(sel_keys)
    sel_ids = torch.take_along_dim(ids.expand_as(keys),
                                   idx.clamp_min(0).long(), dim=-1)
    return sel_keys, torch.where(valid, sel_ids, -1), valid


@dataclasses.dataclass
class FlatIndex:
    """Exact scan over an (N, d) corpus with a given metric."""
    metric: Metric
    vectors: torch.Tensor

    @property
    def num_rows(self) -> int:
        """Corpus row count."""
        return int(self.vectors.shape[0])

    def topk(self, query: torch.Tensor, k: int,
             row_mask: torch.Tensor | None = None):
        """Exact filtered top-k for a (d,) query or a (Q, d) batch;
        ``row_mask`` is None, (N,) or (Q, N).  Returns (ids, sims (raw
        metric), valid), each with the query's leading axes."""
        single = query.ndim == 1
        qs = query[None] if single else query
        keys = pairwise_order_keys(self.metric, self.vectors, qs)  # (Q, N)
        n = self.num_rows
        mask = (torch.ones((1, n), dtype=torch.bool, device=keys.device)
                if row_mask is None else row_mask)
        ids = torch.arange(n, dtype=torch.int32, device=keys.device)
        sel_keys, sel_ids, valid = masked_topk(keys, ids, mask, k)
        sims = torch.where(
            valid, -sel_keys if self.metric.is_similarity() else sel_keys,
            0.0)
        if single:
            return sel_ids[0], sims[0], valid[0]
        return sel_ids, sims, valid

    def range_mask(self, query: torch.Tensor, radius,
                   row_mask: torch.Tensor | None = None):
        """Exact range query for one (d,) query: the reference's rowwise
        distance (Σ(x−q)² for L2, not the kernels' expanded form) and the
        paper's ``DISTANCE <= radius`` convention.  Returns ((N,) hit mask,
        (N,) raw sims)."""
        raw = distance_values(self.metric, self.vectors, query)
        hit = in_range(self.metric, raw, radius)
        if row_mask is not None:
            hit = hit & row_mask
        return hit, raw
