"""IVF index and its probes (CHASE's ANN layer), in plain torch.

IVF keeps the property the paper's algorithms rely on, *monotone outward
expansion from the query's neighbourhood*, and turns each step into dense
tensor work on the card:

* probe order  = ascending centroid order key (the centroid distances and
  a stable argsort),
* cluster scan = a gather of the inverted lists' rows, their distances to
  the query and the predicate mask,
* Algorithm 1's per-tuple ``outRangeCounter`` becomes a per-*cluster*
  counter, and the top-k probe an adaptive queue that stops when the k-th
  key stops improving ('counter') or provably cannot ('bound': each cluster
  stores its radius, a sound lower bound on an unprobed member's key),
* Algorithm 2's record table (updateState) becomes dense per-query state
  over the static category universe: seen mask, hit counts and each
  category's best-K keys.

The reference runs each probe loop as a ``lax.while_loop``; here it is a
host loop over probe rounds whose body stays on the card.  ``Q`` queries
advance in lock-step, ``probe_batch`` clusters per round, and a per-query
``active`` mask freezes every query that is done: its buffers and counters
stop advancing in the round it terminates.  A round in which no query is
active changes nothing, so the host may read ``active.any()`` (one
synchronisation) only every :data:`ACTIVE_CHECK_EVERY` rounds and
otherwise stop at the round count; the answer is the same at any cadence.
The single-query probes are the batched ones at ``Q = 1, probe_batch =
1``: the sequential loop, one cluster per step, with the same counters.
The reference's single loops test their condition before each step and
its batched loops after each round; the two differ only before the first
cluster, where the single range probes test it too.

Every probe returns raw similarities beside the ids: the scan's values are
never recomputed downstream (the map operator, paper §5.1).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from ..core.expr import distance_values, full_fp32, on_device, order_key
from ..core.schema import Metric
from .flat import stable_smallest_k
from .kmeans import assign, kmeans

INF = float("inf")

# host reads of active.any() in the batched probes: every this many rounds.
# Every round: on an H100 a round of 100 queries costs more than a
# synchronisation, and rounds run after the last query is done are wasted
# (PERF.md §6)
ACTIVE_CHECK_EVERY = 1

# rounds run and host synchronisations made by the batched probes since the
# last reset (a caller sets both to 0 and reads them after an execute)
loop_stats = {"rounds": 0, "syncs": 0}


@dataclasses.dataclass
class IVFIndex:
    """Inverted-file index: k-means centroids with fixed-capacity member
    lists (-1 padded, rows ascending within a list) and per-list radii for
    the geometric probe-pruning bound.  Every tensor lives on the corpus's
    device."""
    metric: Metric
    centroids: torch.Tensor     # (nlist, d) fp32
    lists: torch.Tensor         # (nlist, cap) int32 row ids, -1 padded
    list_sizes: torch.Tensor    # (nlist,) int32
    radii: torch.Tensor         # (nlist,) max ||member - centroid||
    centroid_sq: torch.Tensor   # (nlist,) ||c||^2
    nlist: int
    cap: int


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """Static probe parameters (the engine's physical-operator knobs)."""
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
    # per-query cluster budget of the batched probes (0 = unlimited): the
    # straggler valve — a query that exhausts it freezes with its
    # best-so-far answer.  A runtime ``probe_budget`` argument (scalar or
    # (Q,)) overrides it per call.
    probe_budget: int = 0


def build_ivf(generator: torch.Generator | None, vectors: torch.Tensor,
              nlist: int, metric: Metric = Metric.INNER_PRODUCT,
              iters: int = 8, cap: int | None = None,
              centroids: torch.Tensor | None = None) -> IVFIndex:
    """Train centroids on ``vectors``' device and bucket the rows into
    padded inverted lists.

    ``cap`` pins the list capacity instead of deriving it from the largest
    cluster (rounded up to a multiple of 8); a pinned cap below the largest
    cluster raises ``ValueError``.  ``centroids`` skips training and buckets
    against the given ones.  The lists come from a stable sort of the
    assignments, so each list holds its rows in ascending order, entry for
    entry the reference's Python loop."""
    vectors = vectors.to(torch.float32)
    n = vectors.shape[0]
    dev = vectors.device
    if centroids is None:
        centroids = kmeans(generator, vectors, nlist, iters=iters)
    centroids = centroids.to(device=dev, dtype=torch.float32)
    a = assign(vectors, centroids).long()
    counts = torch.bincount(a, minlength=nlist)
    largest = int(counts.max())
    derived = max(8, -(-largest // 8) * 8)
    if cap is None:
        cap = derived
    elif cap < derived:
        raise ValueError(f"fixed cap {cap} < max cluster size {largest}")
    order = torch.argsort(a, stable=True)
    members = a[order]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[members]
    lists = torch.full((nlist, cap), -1, dtype=torch.int32, device=dev)
    lists[members, rank] = order.to(torch.int32)
    # cluster radii: max ||x - centroid|| per cluster, blocked over rows
    block = 16384
    norms = torch.cat([
        torch.linalg.vector_norm(vectors[i:i + block]
                                 - centroids[a[i:i + block]], dim=1)
        for i in range(0, n, block)])
    radii = torch.zeros(nlist, dtype=torch.float32, device=dev)
    radii.scatter_reduce_(0, a, norms, reduce="amax")
    return IVFIndex(metric=metric, centroids=centroids, lists=lists,
                    list_sizes=counts.to(torch.int32), radii=radii,
                    centroid_sq=torch.sum(centroids * centroids, dim=1),
                    nlist=nlist, cap=cap)


def ivf_from_numpy(fields: dict, metric: Metric, device) -> IVFIndex:
    """An index from numpy arrays (``centroids``, ``lists``,
    ``list_sizes``, ``radii``, ``centroid_sq``) and the ints ``nlist`` and
    ``cap``: the carry-over of an index built elsewhere, such as the
    reference's, so both packages probe the same lists."""
    def t(name, dtype):
        return torch.as_tensor(np.array(fields[name]), dtype=dtype,
                               device=device)

    return IVFIndex(metric=metric,
                    centroids=t("centroids", torch.float32),
                    lists=t("lists", torch.int32),
                    list_sizes=t("list_sizes", torch.int32),
                    radii=t("radii", torch.float32),
                    centroid_sq=t("centroid_sq", torch.float32),
                    nlist=int(fields["nlist"]), cap=int(fields["cap"]))


# ---------------------------------------------------------------------------
# shared probe plumbing
# ---------------------------------------------------------------------------

def _cluster_order(index: IVFIndex, qs: torch.Tensor):
    """Clusters of each (Q, d) query by ascending centroid order key.
    Returns (order, bound suffix minimum), each (Q, nlist):
    ``bounds[:, p]`` lower-bounds every member of every cluster from probe
    position p on (the per-cluster bounds are not monotone in probe order,
    so the exact termination test needs their suffix minimum)."""
    metric = index.metric
    with full_fp32():
        raw = distance_values(metric, index.centroids[None],
                              qs[:, None, :])                  # (Q, nlist)
    keys = order_key(metric, raw)
    if metric == Metric.L2:
        # members within radius r of c: sqdist >= max(0, ||q-c|| - r)^2
        dist = torch.sqrt(torch.clamp(keys, min=0.0))
        bound = torch.clamp(dist - index.radii, min=0.0) ** 2
    elif metric == Metric.INNER_PRODUCT:
        # x·q <= c·q + r||q||  =>  key = -x·q >= -(c·q) - r||q||
        qn = torch.linalg.vector_norm(qs, dim=-1, keepdim=True)
        bound = keys - index.radii * qn
    else:  # cosine: a conservative shift by the radius
        bound = keys - index.radii
    order = torch.argsort(keys, dim=-1, stable=True)
    sorted_bound = torch.take_along_dim(bound, order, dim=-1)
    sufmin = torch.flip(torch.cummin(torch.flip(sorted_bound, (-1,)),
                                     dim=-1).values, (-1,))
    return order, sufmin


def _scan_clusters_batch(index: IVFIndex, corpus: torch.Tensor,
                         qs: torch.Tensor, clusters: torch.Tensor,
                         row_mask: torch.Tensor | None):
    """Gather the B inverted lists of each query and their keys.

    ``clusters`` is (Q, B) with -1 sentinels.  Returns (ids (Q, B·cap),
    keys (+inf off the lists), pad, rm_hit (the row-mask lookup), n_evals
    (Q,) int32)."""
    qn, bsz = clusters.shape
    ids = index.lists[clusters.clamp_min(0).long()]              # (Q, B, cap)
    ids = torch.where(clusters[..., None] >= 0, ids, -1).reshape(
        qn, bsz * index.cap)
    pad = ids >= 0
    safe = ids.clamp_min(0).long()
    vecs = corpus[safe]                                          # (Q, M, d)
    with full_fp32():
        raw = distance_values(index.metric, vecs, qs[:, None, :])
    keys = order_key(index.metric, raw)
    if row_mask is None:
        rm_hit = pad
    elif row_mask.ndim == 1:
        rm_hit = row_mask[safe]
    else:
        rm_hit = torch.take_along_dim(row_mask, safe, dim=1)
    return (ids, torch.where(pad, keys, INF), pad, rm_hit,
            pad.sum(1, dtype=torch.int32))


def _merge_topk(best_keys, best_ids, cand_keys, cand_ids, cand_valid,
                k: int):
    """The k smallest of ``[best, candidates]`` along the last axis, equal
    keys in position order (``lax.top_k``'s order, not the lower id)."""
    keys = torch.cat([best_keys, torch.where(cand_valid, cand_keys, INF)],
                     dim=-1)
    ids = torch.cat([best_ids, cand_ids], dim=-1)
    vals, idx = stable_smallest_k(keys, k)
    return vals, torch.take_along_dim(ids, idx.long(), dim=-1)


def _sims(metric: Metric, keys: torch.Tensor, valid: torch.Tensor):
    return torch.where(valid, -keys if metric.is_similarity() else keys, 0.0)


# ---------------------------------------------------------------------------
# the round loop of the batched probes
# ---------------------------------------------------------------------------
#
# Q queries advance in lock-step; a finished query's state freezes (the
# ``active`` mask) while stragglers keep probing, so its ``probes`` and
# ``distance_evals`` report its OWN termination point.  Counters advance in
# CLUSTER units (a round adds ``n_probed``), so ``stop_after_no_improve``
# and ``out_range_stop`` keep their calibration for any probe_batch.  A
# per-query ``probe_budget`` caps heavy queries one by one.

def _apply_budget(active, probes, budget):
    """Freeze queries that exhausted their per-query cluster budget."""
    return active if budget is None else active & (probes < budget)


def _resolve_budget(probe_budget, cfg: ProbeConfig, qn: int, device):
    """The runtime budget (scalar or (Q,)) wins, else ``cfg.probe_budget``
    (0 = unlimited); returns a (Q,) int32 tensor or None."""
    if probe_budget is None:
        if cfg.probe_budget <= 0:
            return None
        probe_budget = cfg.probe_budget
    return on_device(probe_budget, device, torch.int32).expand(qn)


def _active_init(qvalid, qn: int, device) -> torch.Tensor:
    """Size-bucket pad queries (qvalid False) never probe."""
    if qvalid is None:
        return torch.ones((qn,), dtype=torch.bool, device=device)
    return on_device(qvalid, device, torch.bool).reshape(qn)


def _round_schedule(index: IVFIndex, cfg: ProbeConfig):
    """(B, n_rounds, max_probes) of the round loop."""
    max_probes = min(cfg.max_probes, index.nlist)
    B = max(1, min(cfg.probe_batch, max_probes))
    return B, -(-max_probes // B), max_probes


def _order_pad_batch(index: IVFIndex, qs: torch.Tensor, B: int,
                     n_rounds: int, max_probes: int):
    """Per-query probe order cut to ``max_probes`` and padded to
    n_rounds·B with -1 sentinels, and the bound suffix minima."""
    order, bounds = _cluster_order(index, qs)
    order = order[:, :max_probes]
    pad = n_rounds * B - max_probes
    if pad:
        order = torch.nn.functional.pad(order, (0, pad), value=-1)
    return order, bounds


def _run_rounds(n_rounds: int, active_of, body) -> None:
    """Run ``body(r)`` for r = 0, 1, ... up to ``n_rounds``; every
    :data:`ACTIVE_CHECK_EVERY` rounds stop once ``active_of()`` holds no
    active query (a round with none changes nothing)."""
    for r in range(n_rounds):
        if r and r % ACTIVE_CHECK_EVERY == 0:
            loop_stats["syncs"] += 1
            tracing.count("syncs")
            if not bool(active_of().any()):
                return
        body(r)
        loop_stats["rounds"] += 1


def ivf_topk_batch(index: IVFIndex, corpus: torch.Tensor, qs: torch.Tensor,
                   k: int, row_mask: torch.Tensor | None = None,
                   cfg: ProbeConfig = ProbeConfig(), probe_budget=None,
                   qvalid=None):
    """Batched filtered top-k with the adaptive probe queue: (Q, d)
    queries, ``probe_batch`` clusters per round.

    ``row_mask`` is None, a shared (N,) or a per-query (Q, N) bool mask.
    Returns (ids (Q, k), sims (Q, k), valid (Q, k), stats of (Q,) int32
    ``probes`` and ``distance_evals``).  At ``probe_batch == 1`` each row is
    :func:`ivf_topk`'s answer for its query; with B > 1 each query probes a
    superset of its sequential prefix, so its k-th key can only improve.
    ``probe_budget`` (scalar or (Q,)) caps each query's clusters, and
    ``qvalid`` (None | (Q,) bool) marks size-bucket pad queries, which
    never probe."""
    qn, dev = qs.shape[0], corpus.device
    qs = qs.to(device=dev, dtype=torch.float32)
    budget = _resolve_budget(probe_budget, cfg, qn, dev)
    B, n_rounds, max_probes = _round_schedule(index, cfg)
    order, bounds = _order_pad_batch(index, qs, B, n_rounds, max_probes)
    s = {"bk": torch.full((qn, k), INF, device=dev),
         "bi": torch.full((qn, k), -1, dtype=torch.int32, device=dev),
         "no_imp": torch.zeros((qn,), dtype=torch.int32, device=dev),
         "probes": torch.zeros((qn,), dtype=torch.int32, device=dev),
         "evals": torch.zeros((qn,), dtype=torch.int32, device=dev),
         "active": _active_init(qvalid, qn, dev)}

    def body(r: int) -> None:
        active = s["active"]
        ids, keys, valid, rm_hit, nev = _scan_clusters_batch(
            index, corpus, qs, order[:, r * B:(r + 1) * B], row_mask)
        old_kth = s["bk"][:, k - 1]
        merged_k, merged_i = _merge_topk(s["bk"], s["bi"], keys, ids,
                                         valid & rm_hit, k)
        bk = torch.where(active[:, None], merged_k, s["bk"])
        bi = torch.where(active[:, None], merged_i, s["bi"])
        kth = bk[:, k - 1]
        improved = (kth < old_kth) | (~torch.isfinite(old_kth)
                                      & torch.isfinite(kth))
        n_probed = min(B, max_probes - r * B)
        # the no-improvement counter advances per CLUSTER: a non-improving
        # round means all n_probed clusters failed to improve the k-th key
        no_imp = torch.where(active, torch.where(improved, 0,
                                                 s["no_imp"] + n_probed),
                             s["no_imp"])
        probes = s["probes"] + torch.where(active, n_probed, 0)
        evals = s["evals"] + torch.where(active, nev, 0)
        p_next = (r + 1) * B
        have_k = torch.isfinite(kth)
        if cfg.termination == "bound":
            done = have_k & (bounds[:, min(p_next, index.nlist - 1)] > kth)
        else:
            done = have_k & (no_imp >= cfg.stop_after_no_improve)
        done = done & (p_next >= cfg.min_probes)
        active = active & ~done & (p_next < max_probes)
        s.update(bk=bk, bi=bi, no_imp=no_imp.to(torch.int32),
                 probes=probes.to(torch.int32), evals=evals.to(torch.int32),
                 active=_apply_budget(active, probes, budget))

    _run_rounds(n_rounds, lambda: s["active"], body)
    valid = torch.isfinite(s["bk"])
    return (torch.where(valid, s["bi"], -1),
            _sims(index.metric, s["bk"], valid), valid,
            {"probes": s["probes"], "distance_evals": s["evals"]})


def ivf_range_batch(index: IVFIndex, corpus: torch.Tensor, qs: torch.Tensor,
                    radius, row_mask: torch.Tensor | None = None,
                    cfg: ProbeConfig = ProbeConfig(), probe_budget=None,
                    qvalid=None):
    """Batched DR-SF probe (paper Algorithm 1 over a query batch).

    Probes clusters by ascending centroid key; a round with in-range rows
    sets ``hasInRange``; after entering the range, ``out_range_stop``
    consecutive clusters without one end the scan ('counter'), or the
    radius-against-bound test ends it exactly ('bound').  The structured
    predicate filters the hits but not the termination signal.  ``radius``
    is a scalar or per-query (Q,) raw metric value.  Returns (ids
    (Q, capacity), sims, valid, count (Q,) int32, stats); hits are in probe
    discovery order, not key order, and ``count`` stops at the capacity.
    ``probe_budget`` and ``qvalid`` as in :func:`ivf_topk_batch`."""
    return _range_probe(index, corpus, None, qs, radius, row_mask, cfg,
                        probe_budget, qvalid)


def ivf_range_category_batch(index: IVFIndex, corpus: torch.Tensor,
                             categories: torch.Tensor, qs: torch.Tensor,
                             radius, row_mask: torch.Tensor | None = None,
                             cfg: ProbeConfig = ProbeConfig(num_categories=8),
                             probe_budget=None, qvalid=None):
    """Batched category probe (paper Algorithm 2, updateState, over a query
    batch): :func:`ivf_range_batch` plus the record table.

    The paper's hash table becomes dense per-query state over the static
    category universe (``cfg.num_categories`` C): a seen mask (Q, C), hit
    counts (Q, C) and each category's best-K keys (Q, C, K), K =
    ``cfg.k_per_category``.  A category converges once it holds K hits
    whose K-th key lies within the frontier (the next cluster's bound
    under 'bound', the radius under 'counter'); a query stops early when
    every category it has seen converged and ``no_new_category_stop``
    clusters brought no new one, or when the range test ends it.  Returns
    :func:`ivf_range_batch`'s tuple, with ``stats["categories_seen"]``
    (Q,) beside the probe counters."""
    if cfg.num_categories <= 0:
        raise ValueError("the category probe needs cfg.num_categories > 0")
    return _range_probe(index, corpus, categories, qs, radius, row_mask, cfg,
                        probe_budget, qvalid)


def _range_probe(index: IVFIndex, corpus: torch.Tensor, categories,
                 qs: torch.Tensor, radius, row_mask, cfg: ProbeConfig,
                 probe_budget, qvalid, check_first: bool = False):
    """The round loop of the range probes; with ``categories`` (N,) it
    keeps Algorithm 2's record table too.  ``check_first`` evaluates the
    stop condition before the first cluster, as the reference's
    single-query ``while_loop`` does (its batched loops run round 0
    whatever the condition says)."""
    qn, dev = qs.shape[0], corpus.device
    qs = qs.to(device=dev, dtype=torch.float32)
    budget = _resolve_budget(probe_budget, cfg, qn, dev)
    B, n_rounds, max_probes = _round_schedule(index, cfg)
    order, bounds = _order_pad_batch(index, qs, B, n_rounds, max_probes)
    radius_key = order_key(index.metric,
                           on_device(radius, dev, torch.float32).expand(qn))
    capacity = cfg.capacity
    zeros = torch.zeros((qn,), dtype=torch.int32, device=dev)
    active = _active_init(qvalid, qn, dev)
    if check_first and cfg.min_probes <= 0 and cfg.termination == "bound":
        # at p = 0 nothing is seen, so only the range test can hold
        active = active & ~(bounds[:, 0] > radius_key)
    # one scratch column past the capacity takes the writes that miss
    s = {"ids": torch.full((qn, capacity + 1), -1, dtype=torch.int32,
                           device=dev),
         "keys": torch.full((qn, capacity + 1), INF, device=dev),
         "count": zeros, "has_in": torch.zeros_like(zeros, dtype=torch.bool),
         "out_cnt": zeros, "probes": zeros, "evals": zeros, "active": active}
    if categories is not None:
        C, K = cfg.num_categories, cfg.k_per_category
        cat_ids = torch.arange(C, dtype=categories.dtype, device=dev)
        s.update(seen=torch.zeros((qn, C), dtype=torch.bool, device=dev),
                 counts=torch.zeros((qn, C), dtype=torch.int32, device=dev),
                 kth=torch.full((qn, C, K), INF, device=dev), no_new=zeros)

    def body(r: int) -> None:
        active = s["active"]
        ids, keys, pad, rm_hit, nev = _scan_clusters_batch(
            index, corpus, qs, order[:, r * B:(r + 1) * B], row_mask)
        in_range = pad & (keys <= radius_key[:, None])
        hit = in_range & rm_hit & active[:, None]
        n_range = in_range.sum(1, dtype=torch.int32)
        pos = s["count"][:, None] + torch.cumsum(hit, 1) - 1
        ok = hit & (pos < capacity)
        slot = torch.where(ok, pos, capacity)
        s["ids"].scatter_(1, slot, torch.where(ok, ids, -1))
        s["keys"].scatter_(1, slot, torch.where(ok, keys, INF))
        count = torch.where(active, torch.clamp(
            s["count"] + hit.sum(1, dtype=torch.int32), max=capacity),
            s["count"])
        has_in = torch.where(active, s["has_in"] | (n_range > 0),
                             s["has_in"])
        n_probed = min(B, max_probes - r * B)
        # out-of-range counter in CLUSTER units: an empty round is n_probed
        # consecutive empty cluster probes
        out_cnt = torch.where(active, torch.where(
            n_range > 0, 0, torch.where(s["has_in"], s["out_cnt"] + n_probed,
                                        0)), s["out_cnt"])
        probes = s["probes"] + torch.where(active, n_probed, 0)
        evals = s["evals"] + torch.where(active, nev, 0)
        p_next = (r + 1) * B
        next_bound = bounds[:, min(p_next, index.nlist - 1)]
        if cfg.termination == "bound":
            done = next_bound > radius_key
        else:
            done = has_in & (out_cnt >= cfg.out_range_stop)
        if categories is not None:
            frontier = (next_bound if cfg.termination == "bound"
                        else radius_key)
            done = done | _record_table(s, categories, cat_ids, ids, keys,
                                        hit, active, n_probed, frontier, cfg)
        done = done & (p_next >= cfg.min_probes)
        active = active & ~done & (p_next < max_probes)
        s.update(count=count.to(torch.int32), has_in=has_in,
                 out_cnt=out_cnt.to(torch.int32),
                 probes=probes.to(torch.int32), evals=evals.to(torch.int32),
                 active=_apply_budget(active, probes, budget))

    _run_rounds(n_rounds, lambda: s["active"], body)
    ids, keys = s["ids"][:, :capacity], s["keys"][:, :capacity]
    valid = ids >= 0
    stats = {"probes": s["probes"], "distance_evals": s["evals"]}
    if categories is not None:
        stats["categories_seen"] = s["seen"].sum(1, dtype=torch.int32)
    return ids, _sims(index.metric, keys, valid), valid, s["count"], stats


def _record_table(s: dict, categories, cat_ids, ids, keys, hit, active,
                  n_probed: int, frontier, cfg: ProbeConfig) -> torch.Tensor:
    """One round of Algorithm 2's updateState over the (Q, B·cap) hits:
    update ``s``'s seen mask, per-category counts and best-K keys and its
    no-new-category counter, and return the queries whose categories have
    all converged (T.restElements = 0) after enough rounds without a new
    one.  Hits of frozen queries are already masked out, so their record
    table stays as it was."""
    K = cfg.k_per_category
    cats = torch.where(hit, categories[ids.clamp_min(0).long()], -1)
    onehot = cats[..., None] == cat_ids                       # (Q, B·cap, C)
    cat_hits = onehot.sum(1, dtype=torch.int32)               # (Q, C)
    seen = s["seen"] | (cat_hits > 0)
    n_new = seen.sum(1) - s["seen"].sum(1)
    counts = s["counts"] + cat_hits
    # the per-category search queues: only keys ride along, so any smallest
    # K of [queue, candidates] gives the same values
    cand = torch.where(onehot, keys[..., None], INF).transpose(1, 2)
    kth = torch.topk(torch.cat([s["kth"], cand], dim=2), K, dim=2,
                     largest=False).values
    no_new = torch.where(active, torch.where(n_new > 0, 0,
                                             s["no_new"] + n_probed),
                         s["no_new"])
    converged = (counts >= K) & (kth[:, :, K - 1] <= frontier[:, None])
    rest = (seen & ~converged).sum(1)
    s.update(seen=seen, counts=counts, kth=kth,
             no_new=no_new.to(torch.int32))
    return ((rest == 0) & (no_new >= cfg.no_new_category_stop)
            & seen.any(1))


# ---------------------------------------------------------------------------
# the single-query probes: the batched loop at Q = 1, one cluster per step
# ---------------------------------------------------------------------------

def _single_cfg(cfg: ProbeConfig) -> ProbeConfig:
    """The sequential probes scan one cluster per step whatever
    ``probe_batch`` says.  The reference tightens their cluster cap by
    ``cfg.probe_budget``; the batched loop freezes a query at the same
    count."""
    return dataclasses.replace(cfg, probe_batch=1)


def _first(out):
    return tuple({key: v[0] for key, v in o.items()} if isinstance(o, dict)
                 else o[0] for o in out)


def ivf_topk(index: IVFIndex, corpus: torch.Tensor, q: torch.Tensor, k: int,
             row_mask: torch.Tensor | None = None,
             cfg: ProbeConfig = ProbeConfig()):
    """Filtered top-k for one (d,) query with the adaptive probe queue
    (VBASE's relaxed monotonicity, IVF-shaped): keep extending the probe
    frontier until k filtered results are held and the frontier stops
    improving them ('counter') or provably cannot ('bound').  Returns
    (ids (k,), sims (k,), valid (k,), stats of int32 scalars)."""
    return _first(ivf_topk_batch(
        index, corpus, q[None], k, None if row_mask is None else row_mask,
        _single_cfg(cfg)))


def ivf_range(index: IVFIndex, corpus: torch.Tensor, q: torch.Tensor, radius,
              row_mask: torch.Tensor | None = None,
              cfg: ProbeConfig = ProbeConfig()):
    """DR-SF for one (d,) query (paper Algorithm 1, cluster-granular).
    Returns (ids (capacity,), sims, valid, count, stats), hits in probe
    discovery order.  Unlike the batched probe it may stop before the
    first cluster (``min_probes`` 0 under 'bound')."""
    return _first(_range_probe(
        index, corpus, None, q[None], torch.as_tensor(radius).reshape(()),
        row_mask, _single_cfg(cfg), None, None, check_first=True))


def ivf_range_category(index: IVFIndex, corpus: torch.Tensor,
                       categories: torch.Tensor, q: torch.Tensor, radius,
                       row_mask: torch.Tensor | None = None,
                       cfg: ProbeConfig = ProbeConfig(num_categories=8)):
    """The category probe (paper Algorithm 2) for one (d,) query: the range
    scan with the updateState record table and its early stop.  Returns
    (ids (capacity,), sims, valid, count, stats with ``categories_seen``),
    hits in probe discovery order; it may stop before the first cluster
    as :func:`ivf_range` does."""
    if cfg.num_categories <= 0:
        raise ValueError("the category probe needs cfg.num_categories > 0")
    return _first(_range_probe(
        index, corpus, categories, q[None],
        torch.as_tensor(radius).reshape(()), row_mask, _single_cfg(cfg),
        None, None, check_first=True))
