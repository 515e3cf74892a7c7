"""Sharded-corpus hybrid-query collectives (the port of
``src/repro/dist/collectives.py``).

The corpus rows sit sharded over the devices of a mesh
(``dist/sharding.py``); each shard runs the *fused* local scan (distance +
filter + top-k or range) on its device, then only the K (id, key)
candidates of each shard and query move: the hierarchical merge gathers
the candidates of each mesh axis onto the first device of its group,
innermost axis first, and re-selects each query's best.  One process
drives every shard (the reference's single controller; ``shard_map``
becomes a loop over the shards), so a multi-shard plan runs on the CPU
with every shard on the CPU, and on the card with one CUDA device per
shard.

* **Single-query** (:func:`distributed_topk` / :func:`distributed_range`):
  one query vector per call, a plain masked scan per shard; kept as the
  simple reference (tests and examples call them).
* **Query-batched** (:func:`distributed_topk_batch`,
  :func:`distributed_range_batch` and their quantized ``_q`` twins): each
  shard scans its rows for ALL Q queries on the batched kernels
  (``kernels/ops.py``, ``kernels/quant.py``); the size-bucket ``qvalid``
  lane reaches every shard, so a pad query emits nothing and counts
  nothing anywhere.

Each factory returns a callable over per-shard sequences (shard order =
the mesh's C order), as the reference's ``shard_map``'d callables take
row-sharded arrays; outputs land on the device of the query batch.  A
gather of more than one shard's candidates records its bytes as an
all-gather into an active ``roofline.op_counter``; at one shard nothing
moves.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.expr import distance_values, full_fp32, in_range, order_key
from ..core.schema import Metric
from ..index.flat import masked_topk, stable_smallest_k
from ..roofline.op_counter import collective


def merge_topk_level(metric: Metric, keys_a: torch.Tensor,
                     gids_a: torch.Tensor, keys_b: torch.Tensor,
                     gids_b: torch.Tensor, k: int):
    """One level of the per-query candidate merge as a plain function:
    concatenate two (Q, k_a) and (Q, k_b) candidate sets column-wise and
    keep each row's best ``k`` (what :func:`_merge_topk` does per mesh
    axis; the live corpus merges its delta segment through it).

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


def _raw(metric: Metric, keys: torch.Tensor) -> torch.Tensor:
    return -keys if metric.is_similarity() else keys


def _merge_topk(metric: Metric, keys: list, gids: list, k: int,
                mesh_shape: tuple, device):
    """Hierarchical per-query candidate merge over per-shard winners.

    ``keys[s]`` / ``gids[s]`` are shard ``s``'s (Q, w) candidates on its
    device (ascending order keys, +inf on empty lanes; global ids, -1 on
    empty lanes).  Per mesh axis, innermost first: the shards of each group
    (consecutive in C order) move to the group's first device, their
    columns concatenate in shard order, and each row keeps its best
    ``min(k, width)`` by a stable sort — so a tie keeps the lowest global
    id, and at one shard the merge re-selects an already sorted list
    unchanged.  The width is clamped per level (an early level may keep
    fewer than ``k``; keeping everything is lossless).  Returns (ids, sims
    raw-metric, valid) on ``device``."""
    sizes = list(mesh_shape)
    while sizes:
        g = sizes.pop()
        merged_k, merged_g = [], []
        for i in range(0, len(keys), g):
            dev = keys[i].device
            ck, cg = keys[i], gids[i]
            if g > 1:
                ck = torch.cat([x.to(dev) for x in keys[i:i + g]], dim=1)
                cg = torch.cat([x.to(dev) for x in gids[i:i + g]], dim=1)
                collective("all-gather", ck.nbytes + cg.nbytes)
            vals, idx = stable_smallest_k(ck, min(k, ck.shape[1]))
            merged_k.append(vals)
            merged_g.append(torch.take_along_dim(cg, idx.long(), dim=1))
        keys, gids = merged_k, merged_g
    keys, gids = keys[0].to(device), gids[0].to(device)
    valid = torch.isfinite(keys)
    sims = torch.where(valid, _raw(metric, keys), 0.0)
    return torch.where(valid, gids, -1), sims, valid


def _local(lids, lsims, lvalid, row_ids, metric: Metric):
    """A shard's (ids, sims, valid) -> (order keys, global ids): local
    candidate ids map to global ids only here, after the shard's own
    scan (and, under quant, its replay) finished."""
    gids = torch.where(lvalid, row_ids[lids.clamp_min(0).long()], -1)
    keys = torch.where(lvalid, order_key(metric, lsims), float("inf"))
    return keys, gids


def _on(x, dev):
    return None if x is None else x.to(dev)


def _scan_shards(per_shard, sh_corpus: Sequence, qs, sh_mask: Sequence,
                 qvalid, *extra):
    """Run ``per_shard(s, corpus_s, qs_s, mask_s, qvalid_s, *extra_s)`` on
    every shard, its inputs moved to the shard's device."""
    out = []
    for s, corpus in enumerate(sh_corpus):
        dev = corpus.device
        out.append(per_shard(s, corpus, qs.to(dev), _on(sh_mask[s], dev),
                             _on(qvalid, dev), *(_on(e, dev) for e in extra)))
    return out


def _mesh_shape(mesh, axes) -> tuple:
    return tuple(mesh.shape[a] for a in axes)


def _merge_results(metric: Metric, width: int, shape: tuple,
                   sh_ids: Sequence, qs, results: list):
    """The shards' (ids, sims, valid[, count]) -> the merged (ids, sims,
    valid[, count]) on the query batch's device; counts sum exactly."""
    keys, gids = [], []
    for s, res in enumerate(results):
        kk, gg = _local(*res[:3], sh_ids[s].to(res[0].device), metric)
        keys.append(kk)
        gids.append(gg)
    out = _merge_topk(metric, keys, gids, width, shape, qs.device)
    if len(results[0]) == 4:
        counts = torch.stack([r[3].to(qs.device) for r in results])
        out += (counts.sum(0, dtype=torch.int32),)
    return out


def distributed_topk_batch(mesh, metric: Metric, k: int,
                           axes: tuple[str, ...] = ("data",)):
    """Batched filtered exact top-k over a row-sharded corpus.

    Each shard runs the query-tiled fused scan
    (``kernels.ops.fused_scan_topk_batch``) for ALL Q queries, then the
    hierarchical merge keeps K per query per mesh axis.  Returns
    ``fn(sh_corpus, sh_ids, qs, sh_mask, qvalid) -> (ids, sims, valid)``:

    * ``sh_corpus[s]`` (rows, d) and ``sh_ids[s]`` (rows,) — shard ``s``'s
      rows and global ids (-1 on pad rows), as laid out by
      :class:`~repro_torch.dist.sharding.ShardedCorpus`;
    * ``qs`` (Q, d) — the query batch, on the output device;
    * ``sh_mask[s]`` — shard ``s``'s fused predicate, pad rows False: a
      (Q, rows) per-query mask, a shared (rows,) mask, or None (no
      predicate and no pad row), so no (Q, N) mask is built for a
      predicate-free scan;
    * ``qvalid`` (Q,) bool or None — an invalid query emits nothing.

    Outputs are (Q, k).  At one shard the merge re-selects the kernel's
    sorted list unchanged: the answer is the flat batched path's bit for
    bit."""
    from ..kernels.ops import fused_scan_topk_batch
    shape = _mesh_shape(mesh, axes)

    def shard(s, corpus, q, m, qv):
        return fused_scan_topk_batch(corpus, q, k, m, metric, qvalid=qv)

    def fn(sh_corpus, sh_ids, qs, sh_mask, qvalid=None):
        return _merge_results(metric, k, shape, sh_ids, qs, _scan_shards(
            shard, sh_corpus, qs, sh_mask, qvalid))

    return fn


def distributed_topk_batch_q(mesh, metric: Metric, k: int,
                             axes: tuple[str, ...] = ("data",),
                             rescore_factor: int = 2):
    """Quantized twin of :func:`distributed_topk_batch`: each shard streams
    its int8 / bf16 rows through the quantized kernel and rescores its own
    top-(rescore_factor·k) candidates against its fp32 rows, so the keys
    entering the merge are exact fp32 keys — bitwise what the fp32 twin
    ships.  Returns ``fn(sh_corpus, sh_quant, sh_ids, qs, sh_mask, qvalid)
    -> (ids, sims, valid)`` with ``sh_quant[s]`` shard ``s``'s twin (the
    ``plan_arrays`` keys of a ``QuantizedCorpus``), its rows lined up with
    the shard's fp32 rows."""
    from ..kernels.quant import fused_scan_topk_batch_q
    shape = _mesh_shape(mesh, axes)

    def fn(sh_corpus, sh_quant, sh_ids, qs, sh_mask, qvalid=None):
        def shard(s, corpus, q, m, qv):
            t = sh_quant[s]
            return fused_scan_topk_batch_q(
                corpus, t["qvecs"], t["qscales"], q, k, m, metric,
                rescore_factor=rescore_factor, qvalid=qv)

        return _merge_results(metric, k, shape, sh_ids, qs, _scan_shards(
            shard, sh_corpus, qs, sh_mask, qvalid))

    return fn


def distributed_range_batch(mesh, metric: Metric, capacity: int,
                            axes: tuple[str, ...] = ("data",)):
    """Batched filtered range query over a row-sharded corpus.

    Each shard runs the query-tiled fused range scan and its compaction
    (``kernels.ops.fused_range_topk_batch``), keeping up to
    ``min(capacity, shard rows)`` best-first hits per query; the
    hierarchical merge re-truncates the concatenated buffers to the best
    ``capacity`` at every mesh axis.  Each shard's buffer holds its part of
    the global best ``capacity``, so the merged buffer IS the global
    best-first truncation (ascending key, lowest id first), and ``count``
    is the exact sum of the shards' hit counts.  Returns ``fn(sh_corpus,
    sh_ids, qs, radius, sh_mask, qvalid) -> (ids, sims, valid, count)``
    with ``radius`` (Q,) raw values and the rest as in
    :func:`distributed_topk_batch`."""
    from ..kernels.ops import fused_range_topk_batch
    shape = _mesh_shape(mesh, axes)

    def shard(s, corpus, q, m, qv, r):
        return fused_range_topk_batch(corpus, q, r, m, metric,
                                      min(capacity, corpus.shape[0]),
                                      qvalid=qv)

    def fn(sh_corpus, sh_ids, qs, radius, sh_mask, qvalid=None):
        return _merge_results(metric, capacity, shape, sh_ids, qs,
                              _scan_shards(shard, sh_corpus, qs, sh_mask,
                                           qvalid, radius))

    return fn


def distributed_range_batch_q(mesh, metric: Metric, capacity: int,
                              axes: tuple[str, ...] = ("data",),
                              rescore_factor: int = 2):
    """Quantized twin of :func:`distributed_range_batch`: per-shard slack
    bands and a local fp32 replay of the boundary rows
    (``kernels.quant.fused_range_topk_batch_q``), so the merged keys and
    the summed counts are exact.  Returns ``fn(sh_corpus, sh_quant, sh_ids,
    qs, radius, sh_mask, qvalid) -> (ids, sims, valid, count)``, the
    arguments as in :func:`distributed_topk_batch_q`."""
    from ..kernels.quant import fused_range_topk_batch_q
    shape = _mesh_shape(mesh, axes)

    def fn(sh_corpus, sh_quant, sh_ids, qs, radius, sh_mask, qvalid=None):
        def shard(s, corpus, q, m, qv, r):
            t = sh_quant[s]
            return fused_range_topk_batch_q(
                corpus, t["qvecs"], t["qscales"], t["qhalf"], t["ql1"],
                t["ql2"], q, r, m, metric, min(capacity, corpus.shape[0]),
                rescore_factor=rescore_factor, qvalid=qv)

        return _merge_results(metric, capacity, shape, sh_ids, qs,
                              _scan_shards(shard, sh_corpus, qs, sh_mask,
                                           qvalid, radius))

    return fn


# ---------------------------------------------------------------------------
# single-query primitives (tests and examples)
# ---------------------------------------------------------------------------

def shard_corpus(mesh, corpus: torch.Tensor,
                 axes: tuple[str, ...] = ("data",)):
    """Row-shard a corpus and its global row ids over ``axes``; the rows
    must divide the shard count (pad upstream otherwise).  Returns
    (per-shard rows, per-shard global ids), each on its shard's device."""
    from .sharding import ShardedCorpus
    shards = 1
    for a in axes:
        shards *= mesh.shape[a]
    if corpus.shape[0] % shards:
        raise ValueError(f"{corpus.shape[0]} rows do not divide into "
                         f"{shards} shards; pad upstream")
    sc = ShardedCorpus.build(mesh, corpus, axes)
    return list(sc.shards), list(sc.row_ids)


def distributed_topk(mesh, metric: Metric, k: int,
                     axes: tuple[str, ...] = ("data",)):
    """Filtered exact top-k of one query over a row-sharded corpus: a
    plain masked scan and top-k per shard, then the hierarchical merge (K
    pairs per shard per level).  Returns ``fn(sh_corpus, sh_ids, q,
    sh_mask) -> (ids (k,), sims, valid)`` with ``sh_mask[s]`` a (rows,)
    bool mask per shard."""
    shape = _mesh_shape(mesh, axes)

    def fn(sh_corpus, sh_ids, q, sh_mask):
        keys, gids = [], []
        for corpus, ids, mask in zip(sh_corpus, sh_ids, sh_mask):
            with full_fp32():
                raw = distance_values(metric, corpus, q.to(corpus.device))
            kk, gg, _ = masked_topk(order_key(metric, raw), ids,
                                    mask.to(corpus.device), k)
            keys.append(kk[None])
            gids.append(gg[None])
        ids, sims, valid = _merge_topk(metric, keys, gids, k, shape,
                                       q.device)
        return ids[0], sims[0], valid[0]

    return fn


def distributed_range(mesh, metric: Metric, capacity: int,
                      axes: tuple[str, ...] = ("data",)):
    """Filtered range query of one query over a row-sharded corpus: each
    shard keeps up to ``capacity`` best-first hits; the gather concatenates
    the shards' buffers (up to capacity·shards hits, best-first per shard)
    and sums their counts.  Returns ``fn(sh_corpus, sh_ids, q, radius,
    sh_mask) -> (ids, sims, valid, count)``."""

    def fn(sh_corpus, sh_ids, q, radius, sh_mask):
        keys, gids, count = [], [], 0
        for corpus, ids, mask in zip(sh_corpus, sh_ids, sh_mask):
            with full_fp32():
                raw = distance_values(metric, corpus, q.to(corpus.device))
            hit = mask.to(corpus.device) & in_range(metric, raw, radius)
            cap = min(capacity, corpus.shape[0])
            kk, gg, _ = masked_topk(order_key(metric, raw), ids, hit, cap)
            keys.append(kk.to(q.device))
            gids.append(gg.to(q.device))
            count = count + hit.sum(dtype=torch.int32).to(q.device)
        keys, gids = torch.cat(keys), torch.cat(gids)
        if len(sh_corpus) > 1:
            collective("all-gather", keys.nbytes + gids.nbytes)
        valid = torch.isfinite(keys)
        sims = torch.where(valid, _raw(metric, keys), 0.0)
        return torch.where(valid, gids, -1), sims, valid, count

    return fn
