"""Delta-segment scans of the live corpus (the port of
``src/repro/index/delta.py``).

Inserts land in a fixed-capacity append-only delta segment: a (delta_cap, d)
tensor whose empty slots are zero rows masked off by a validity lane.  The
helpers here scan it with the plain flat scan (:class:`FlatIndex`; the live
merges never run a kernel on it, in either package: the segment is a small
(Q, delta_cap) product) and emit candidates in the (keys, global ids) form
:func:`repro_torch.dist.collectives.merge_topk_level` consumes.

Delta slot ``s`` surfaces as global id ``offset + s``, ``offset`` being
the main segment's capacity, so a merged id names a row of either segment.
Keys are ascending with +inf on empty lanes.
"""
from __future__ import annotations

import torch

from ..core.expr import on_device, order_key
from ..core.schema import Metric
from .flat import FlatIndex, stable_smallest_k


def _merge_ready(metric: Metric, ids, sims, valid, offset: int):
    keys = torch.where(valid, order_key(metric, sims), float("inf"))
    return keys, torch.where(valid, ids + offset, -1)


def delta_topk_batch(metric: Metric, delta_vec: torch.Tensor,
                     qs: torch.Tensor, k: int, dmask, qvalid, offset: int):
    """Top-k over the (delta_cap, d) delta segment for a (Q, d) batch.

    ``dmask`` is the delta-row mask (validity ANDed with any predicate):
    None, shared (delta_cap,) or per-query (Q, delta_cap).  Returns
    merge-ready ``(keys, gids)``, each (Q, min(k, delta_cap))."""
    kd = min(int(k), delta_vec.shape[0])
    ids, sims, valid = FlatIndex(metric, delta_vec).topk(qs, kd, dmask)
    if qvalid is not None:
        valid = valid & qvalid[:, None]
    return _merge_ready(metric, ids, sims, valid, offset)


def delta_range_batch(metric: Metric, delta_vec: torch.Tensor,
                      qs: torch.Tensor, radius, dmask, qvalid, offset: int,
                      capacity: int):
    """Range scan over the delta segment for a (Q, d) batch, one query at a
    time (the reference's rowwise distance; a row's answer does not depend
    on the batch it rides in).

    Up to ``min(capacity, delta_cap)`` best-first hits per query and the
    exact per-query hit count (0 for ``qvalid``-invalid queries).  Returns
    ``(keys, gids, count)``, keys and gids merge-ready."""
    m, dn = qs.shape[0], delta_vec.shape[0]
    cap = min(int(capacity), dn)
    radius = on_device(radius, qs.device, torch.float32).expand(m)
    flat = FlatIndex(metric, delta_vec)
    rows = [flat.range_mask(qs[i], radius[i],
                            dmask if dmask is None or dmask.ndim == 1
                            else dmask[i]) for i in range(m)]
    hit = torch.stack([h for h, _ in rows])
    raw = torch.stack([r for _, r in rows])
    if qvalid is not None:
        hit = hit & qvalid[:, None]
    keys = torch.where(hit, order_key(metric, raw), float("inf"))
    vals, sel = stable_smallest_k(keys, cap)
    valid = torch.isfinite(vals)
    sel = sel.clamp_min(0).long()
    ids = torch.where(valid, sel.to(torch.int32), -1)
    sims = torch.where(valid, torch.take_along_dim(raw, sel, dim=1), 0.0)
    return (*_merge_ready(metric, ids, sims, valid, offset),
            hit.sum(1, dtype=torch.int32))
