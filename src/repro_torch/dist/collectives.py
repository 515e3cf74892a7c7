"""Query collectives of the port.  Only the plain per-query merge level is
here so far: the live corpus merges its delta segment into the main result
through it (``data/mutations.py``).  The sharded scans and their
hierarchical merges are a later slice (ROADMAP.md queue 1 item 13)."""
from __future__ import annotations

import torch

from ..core.schema import Metric
from ..index.flat import stable_smallest_k


def merge_topk_level(metric: Metric, keys_a: torch.Tensor,
                     gids_a: torch.Tensor, keys_b: torch.Tensor,
                     gids_b: torch.Tensor, k: int):
    """One level of the per-query candidate merge: concatenate two (Q, k_a)
    and (Q, k_b) candidate sets column-wise and keep each row's best ``k``.

    ``keys_*`` are ascending order keys, +inf on empty lanes; ``gids_*``
    the matching global ids, -1 on empty lanes.  Equal keys keep the lower
    concatenated column (a stable sort, as ``lax.top_k`` keeps them), so
    with A = main and B = delta an empty delta leaves A's result bit for
    bit.  The output is exactly (Q, k), padded with empty lanes.  Returns
    (ids, raw sims, valid)."""
    keys = torch.cat([keys_a, keys_b], dim=1)
    gids = torch.cat([gids_a, gids_b], dim=1)
    vals, idx = stable_smallest_k(keys, k)
    valid = torch.isfinite(vals)
    ids = torch.take_along_dim(gids, idx.clamp_min(0).long(), dim=1)
    sims = torch.where(valid, -vals if metric.is_similarity() else vals, 0.0)
    return torch.where(valid, ids, -1), sims, valid
