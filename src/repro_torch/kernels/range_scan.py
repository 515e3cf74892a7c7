"""Fused distance + radius + predicate range scans: the two range kernels of
the Q2 and Q3 flat lowerings.

Each wrapper launches a hand-written CUDA kernel (``csrc/range_scan.cu``,
``csrc/range_scan_batch.cu``) on a CUDA tensor and runs its plain PyTorch
version beside it on a CPU tensor, and only then.  Both produce the
reference's outputs without its padding: the order keys with +inf off the
hits, the hits as int8, and the hit count (one per query).  Keys and hits are
query-major, (N,) or (Q, N).  ``range_topk_batch`` is the batched scan
compacted on the card (the same library): each query's best ``capacity``
hits, without the (Q, N) keys; ``ops.py`` holds the compaction of the dense
keys and the choice between the two.

A wrapper counts its kernel launches in a plain integer attribute
(``range_scan.launches``, ``range_scan_batch.launches``,
``range_topk_batch.launches``), so a run can show that a path went through
the kernels.  ``batch_plan`` is the batched kernel's launch plan, and
``range_scan_batch_replayed`` its bitwise reference on the card.
``range_scan_work``, ``range_scan_batch_work`` and
``range_topk_batch_work`` are a call's roofline work (as
``scan_topk.py``'s).
"""
from __future__ import annotations

import torch

from ..core.expr import pairwise_order_keys
from ..core.schema import Metric
from ..roofline.op_counter import Work, counted
from . import build
from .build import METRIC_CODES, I, P, check_tensor, ptr, stream
from .scan_topk import (BLOCK_RESERVED, BLOCK_SMEM, NARROW_QUERIES,
                        SM_SMEM, live_queries, mask_bytes, wave_splits)

# Block shapes of the batched kernel and of the quantized key kernel on the
# same tile (csrc/range_tile.cuh `Wide`, `Mid`, `Narrow`), by queries per
# block: (rows per tile, columns per staged chunk, blocks per SM its
# registers are sized for).  The wide shape takes buckets of 33 queries and
# more (64 and 128 in one query tile), the mid one 17..32, the narrow one
# small batches.  The plain versions need no plan: their outputs are whole
# (Q, N) matrices.
BATCH_SHAPES = {128: (128, 16, 1), 32: (256, 16, 2), 8: (512, 16, 2)}
MID_QUERIES = 32             # up to this many queries, the mid shape
# The widest buffer range_topk_batch compacts on the card: the largest
# power of two of 8-byte words that fits one block's shared memory (its
# sort kernel holds a query's words there; csrc/range_scan_batch.cu
# kMaxWidth).
APPEND_WIDTH = 1 << ((BLOCK_SMEM // 8).bit_length() - 1)
# an empty slot of the plain buffer: the all-ones word, top bit flipped
_EMPTY_WORD = (1 << 63) - 1


def batch_smem(qt: int) -> int:
    """Shared memory (bytes) of one block of shape ``qt``: two staging
    buffers, the tile's row norms and four per-query words (the kernel's
    ``Shape::kSmemBytes`` + static)."""
    rows, depth, _ = BATCH_SHAPES[qt]
    return 4 * (2 * depth * (rows + qt) + rows) + 16 * qt


def batch_plan(n: int, qn: int) -> tuple[int, int, int]:
    """(queries per block, splits, rows per split) of the batched kernel
    and of ``quant.quant_keys_batch``: the narrow shape up to 16 queries,
    the mid one up to 32, the wide one beyond, and splits of whole row
    tiles whose number fills whole waves of the card's SMs at the blocks
    per SM the shape allows (:func:`~.scan_topk.wave_splits`).  The splits
    stay within a wave's blocks, far under CUDA's grid limits."""
    if n < 1 or qn < 1:
        raise ValueError(f"batch_plan needs N, Q >= 1, got {n}, {qn}")
    qt = (8 if qn <= NARROW_QUERIES else 32 if qn <= MID_QUERIES
          else 128)
    tile, _, minb = BATCH_SHAPES[qt]
    per_sm = max(1, min(minb, SM_SMEM // (batch_smem(qt) + BLOCK_RESERVED)))
    return (qt,) + wave_splits(n, qn, qt, tile, per_sm)


def range_scan_work(corpus, query, radius_key, mask_i8, metric=None) -> Work:
    """A :func:`range_scan` launch's work: 2·N·D operations; the corpus,
    the query, the radius key and the mask in, the keys, hits and count
    out."""
    n, d = corpus.shape
    return Work(2 * n * d, n * d * 4 + d * 4 + 4 + mask_bytes(mask_i8, 1, n)
                + n * 5 + 4)


def range_scan_batch_work(corpus, queries, radius_keys, mask_i8, qvalid_i8,
                          metric=None) -> Work:
    """A :func:`range_scan_batch` launch's work for its live queries L:
    2·N·D·L operations; the corpus, L queries, the mask, the radius keys
    and valid lanes in, L rows of keys and hits and every query's count
    out."""
    n, d = corpus.shape
    qn = queries.shape[0]
    live = live_queries(qvalid_i8, qn)
    return Work(2 * n * d * live,
                n * d * 4 + live * d * 4 + mask_bytes(mask_i8, live, n)
                + live * n * 5 + qn * 8 + (0 if qvalid_i8 is None else qn))


def _hits(keys: torch.Tensor, radius_keys: torch.Tensor,
          live: torch.Tensor | None):
    """(masked keys, int8 hits, int32 counts) from (..., N) keys."""
    hit = keys <= radius_keys
    if live is not None:
        hit = hit & live
    return (keys.masked_fill(~hit, float("inf")), hit.to(torch.int8),
            hit.sum(-1, dtype=torch.int32))


def _live(mask_i8: torch.Tensor | None,
          qvalid_i8: torch.Tensor | None) -> torch.Tensor | None:
    """(Q, N), (1, N) or (Q, 1) bool: the row mask ANDed with the valid
    lane, None when neither is given."""
    live = None
    if mask_i8 is not None:
        live = mask_i8 != 0 if mask_i8.ndim == 2 else (mask_i8 != 0)[None]
    if qvalid_i8 is not None:
        qlive = (qvalid_i8 != 0)[:, None]
        live = qlive if live is None else live & qlive
    return live


# ---------------------------------------------------------------------------
# single query: replaces range_scan_pallas (src/repro/kernels/range_scan.py)
# ---------------------------------------------------------------------------

def range_scan_plain(corpus: torch.Tensor, query: torch.Tensor,
                     radius_key: torch.Tensor, mask_i8: torch.Tensor | None,
                     metric: Metric):
    """Plain PyTorch version of the single-query kernel."""
    keys = pairwise_order_keys(metric, corpus, query[None])[0]      # (N,)
    live = None if mask_i8 is None else mask_i8 != 0
    return _hits(keys, radius_key.reshape(()), live)


@counted(range_scan_work)
def range_scan(corpus: torch.Tensor, query: torch.Tensor,
               radius_key: torch.Tensor, mask_i8: torch.Tensor | None,
               metric: Metric):
    """Single-query fused range scan: corpus (N, D) fp32, query (D,) fp32,
    radius_key a one-element fp32 order key (it stays on the device: no
    host sync), mask None or (N,) int8.  Returns (keys (N,) fp32, +inf off
    the hits; hits (N,) int8; count, a 0-d int32)."""
    n, d = corpus.shape
    dev = corpus.device
    check_tensor(corpus, "corpus", (n, d), torch.float32, dev)
    check_tensor(query, "query", (d,), torch.float32, dev)
    check_tensor(radius_key.reshape(1), "radius_key", (1,), torch.float32,
                 dev)
    check_tensor(mask_i8, "mask", (n,), torch.int8, dev)
    if dev.type == "cpu":
        return range_scan_plain(corpus, query, radius_key, mask_i8, metric)
    if dev.type != "cuda":
        raise ValueError(f"range_scan runs on cuda (or cpu), not {dev}")
    keys = torch.empty(n, dtype=torch.float32, device=dev)
    hits = torch.empty(n, dtype=torch.int8, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    vec4 = d % 4 == 0 and corpus.data_ptr() % 16 == 0
    lib, launch = build.launcher("range_scan.cu", "range_scan_launch",
                                 [P] * 7 + [I] * 4 + [P])
    err = launch(
        ptr(corpus), ptr(query), ptr(radius_key), ptr(mask_i8), ptr(keys),
        ptr(hits), ptr(count), n, d, METRIC_CODES[metric], int(vec4),
        stream(dev))
    build.check(lib, "range_scan", err)
    range_scan.launches += 1
    return keys, hits, count.reshape(())


range_scan.launches = 0


# ---------------------------------------------------------------------------
# query batch: replaces range_scan_batch_pallas
# (src/repro/kernels/range_scan.py)
# ---------------------------------------------------------------------------

def range_scan_batch_plain(corpus: torch.Tensor, queries: torch.Tensor,
                           radius_keys: torch.Tensor,
                           mask_i8: torch.Tensor | None,
                           qvalid_i8: torch.Tensor | None, metric: Metric):
    """Plain PyTorch version of the batched kernel."""
    keys = pairwise_order_keys(metric, corpus, queries)              # (Q, N)
    return _hits(keys, radius_keys[:, None], _live(mask_i8, qvalid_i8))


def range_scan_batch_replayed(corpus: torch.Tensor, queries: torch.Tensor,
                              radius_keys: torch.Tensor,
                              mask_i8: torch.Tensor | None,
                              qvalid_i8: torch.Tensor | None,
                              metric: Metric):
    """The batched kernel's output rebuilt on its own arithmetic:
    ``quant.replay_keys`` of every (query, row) pair, then the mask, the
    valid lane and the radius test.  On the card the kernel must equal it
    bit for bit, keys, hits and counts (``chip_smoke.py``, phase
    range_bits); (Q, N) sized, for small checks."""
    from .quant import replay_keys      # quant imports this module

    n = corpus.shape[0]
    qn = queries.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=corpus.device)
    keys = replay_keys(corpus, queries, rows.expand(qn, n).contiguous(),
                       metric)
    return _hits(keys, radius_keys[:, None], _live(mask_i8, qvalid_i8))


@counted(range_scan_batch_work)
def range_scan_batch(corpus: torch.Tensor, queries: torch.Tensor,
                     radius_keys: torch.Tensor, mask_i8: torch.Tensor | None,
                     qvalid_i8: torch.Tensor | None, metric: Metric):
    """Batched fused range scan: corpus (N, D) fp32, queries (Q, D) fp32,
    radius_keys (Q,) fp32 order keys, mask None, shared (N,) or query-major
    (Q, N) int8, qvalid None or (Q,) int8 (a 0 lane is a size-bucket pad
    query: no hits, count 0).  Returns (keys (Q, N) fp32, +inf off the hits;
    hits (Q, N) int8; counts (Q,) int32)."""
    n, d = corpus.shape
    qn = queries.shape[0]
    dev = corpus.device
    check_tensor(corpus, "corpus", (n, d), torch.float32, dev)
    check_tensor(queries, "queries", (qn, d), torch.float32, dev)
    check_tensor(radius_keys, "radius_keys", (qn,), torch.float32, dev)
    if mask_i8 is not None:
        check_tensor(mask_i8, "mask", (qn, n) if mask_i8.ndim == 2 else (n,),
                     torch.int8, dev)
    check_tensor(qvalid_i8, "qvalid", (qn,), torch.int8, dev)
    if dev.type == "cpu":
        return range_scan_batch_plain(corpus, queries, radius_keys, mask_i8,
                                      qvalid_i8, metric)
    if dev.type != "cuda":
        raise ValueError(f"range_scan_batch runs on cuda (or cpu), not {dev}")
    qt, splits, rows = batch_plan(n, qn)
    keys = torch.empty((qn, n), dtype=torch.float32, device=dev)
    hits = torch.empty((qn, n), dtype=torch.int8, device=dev)
    counts = torch.zeros(qn, dtype=torch.int32, device=dev)
    mask_mode = 0 if mask_i8 is None else 1 if mask_i8.ndim == 1 else 2
    # 16-byte loads: whole 4-float units along D and aligned bases; 16-byte
    # key and 4-byte hit stores: whole 4-row runs along N
    vec4 = (d % 4 == 0 and corpus.data_ptr() % 16 == 0
            and queries.data_ptr() % 16 == 0)
    vec_out = (n % 4 == 0 and keys.data_ptr() % 16 == 0
               and hits.data_ptr() % 4 == 0)
    lib, launch = build.launcher("range_scan_batch.cu",
                                 "range_scan_batch_launch",
                                 [P] * 4 + [I] + [P] * 4 + [I] * 9 + [P])
    err = launch(
        ptr(corpus), ptr(queries), ptr(radius_keys), ptr(mask_i8), mask_mode,
        ptr(qvalid_i8), ptr(keys), ptr(hits), ptr(counts), n, d, qn,
        METRIC_CODES[metric], qt, rows, splits, int(vec4), int(vec_out),
        stream(dev))
    build.check(lib, "range_scan_batch", err)
    range_scan_batch.launches += 1
    return keys, hits, counts


range_scan_batch.launches = 0


# ---------------------------------------------------------------------------
# query batch compacted on the card: the range lists' stage 2, the
# compaction the reference runs in XLA after range_scan_batch_pallas
# ---------------------------------------------------------------------------

def range_topk_batch_work(corpus, queries, radius_keys, mask_i8, qvalid_i8,
                          metric=None, capacity: int = 1) -> Work:
    """A :func:`range_topk_batch` call's work for its live queries L:
    2·N·D·L operations; the corpus, L queries, the mask, the radius keys
    and valid lanes in, every query's count and ``capacity`` (id, sim,
    valid) slots out (the appended words, at most 16·capacity bytes a
    query written and read back, are left out)."""
    n, d = corpus.shape
    qn = queries.shape[0]
    live = live_queries(qvalid_i8, qn)
    return Work(2 * n * d * live,
                n * d * 4 + live * d * 4 + mask_bytes(mask_i8, live, n)
                + qn * 8 + (0 if qvalid_i8 is None else qn)
                + qn * capacity * 9)


def pack_hits(keys: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The card's 64-bit words of hits (``csrc/range_tile.cuh``
    ``pack_hit``) as int64 with the top bit flipped, so that a signed sort
    orders them as the card's unsigned compare: the high word the key's
    bits made monotone (−0.0 made +0.0 first), the low word row·2, plus 1
    where the key was −0.0.  ``keys`` fp32 and ``rows`` (< 2^31) of one
    shape."""
    bits = keys.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg0 = bits == 0x80000000
    bits = torch.where(neg0, 0, bits)
    hi = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF,
                     bits ^ 0x80000000)
    return (hi - (1 << 31)) * (1 << 32) + rows.to(torch.int64) * 2 + neg0


def unpack_hits(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(fp32 keys with their own bits, int32 rows) of :func:`pack_hits`'
    words (``unpack_key``, ``unpack_row`` on the card)."""
    lo = words & 0xFFFFFFFF
    hi = (words >> 32) + (1 << 31)            # the card's high word
    bits = torch.where(hi >= 0x80000000, hi ^ 0x80000000, hi ^ 0xFFFFFFFF)
    bits = torch.where(lo & 1 == 1, 0x80000000, bits)
    keys = (bits - (bits >= 0x80000000).to(torch.int64) * (1 << 32)).to(
        torch.int32).view(torch.float32)
    return keys, (lo >> 1).to(torch.int32)


def append_hits_plain(keys: torch.Tensor, hits: torch.Tensor, width: int,
                      order: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the append epilogue: the (Q, N) ``keys`` of the
    (Q, N) ``hits`` as :func:`pack_hits` words in the first ``min(count,
    width)`` slots of each query's row of a (Q, width) buffer, the rest
    empty.  Rows go in ascending order, or in the order of ``order``, a
    (Q, N) permutation of each query's rows (the card's atomics fill the
    slots in an order of their own)."""
    qn, n = keys.shape
    rows = torch.arange(n, device=keys.device).expand(qn, n)
    hit = hits != 0
    if order is not None:
        rows = order
        keys = torch.take_along_dim(keys, order, dim=1)
        hit = torch.take_along_dim(hit, order, dim=1)
    pos = torch.cumsum(hit, dim=1) - 1
    keep = hit & (pos < width)
    words = torch.full((qn, width), _EMPTY_WORD, dtype=torch.int64,
                       device=keys.device)
    qi = torch.arange(qn, device=keys.device)[:, None].expand(qn, n)
    words[qi[keep], pos[keep]] = pack_hits(keys[keep], rows[keep])
    return words


def sort_hits_plain(words: torch.Tensor, counts: torch.Tensor,
                    metric: Metric):
    """Plain version of the sort kernel over a (Q, W) buffer of
    :func:`pack_hits` words: for a query whose count is at most W, its
    words in ascending order, emitted as (ids, raw sims, valid), each
    (Q, W): the row, −key for a similarity metric (else the key) and True
    where a slot holds a hit with a finite key, else −1, 0 and False; a
    query whose count passes W gets empty slots only."""
    width = words.shape[1]
    kept = (torch.arange(width, device=words.device)[None]
            < torch.where(counts <= width, counts, 0)[:, None])
    words = torch.sort(torch.where(kept, words, _EMPTY_WORD), dim=1).values
    keys, rows = unpack_hits(words)
    valid = kept & torch.isfinite(keys)
    ids = torch.where(valid, rows, -1)
    sims = torch.where(valid, -keys if metric.is_similarity() else keys,
                       0.0)
    return ids, sims, valid


def range_topk_batch_plain(corpus: torch.Tensor, queries: torch.Tensor,
                           radius_keys: torch.Tensor,
                           mask_i8: torch.Tensor | None,
                           qvalid_i8: torch.Tensor | None, metric: Metric,
                           capacity: int):
    """Plain PyTorch version of :func:`range_topk_batch`: the batched
    scan's plain version, then the append and the sort above."""
    keys, hits, counts = range_scan_batch_plain(corpus, queries, radius_keys,
                                                mask_i8, qvalid_i8, metric)
    words = append_hits_plain(keys, hits, capacity)
    return sort_hits_plain(words, counts, metric) + (counts,)


@counted(range_topk_batch_work)
def range_topk_batch(corpus: torch.Tensor, queries: torch.Tensor,
                     radius_keys: torch.Tensor, mask_i8: torch.Tensor | None,
                     qvalid_i8: torch.Tensor | None, metric: Metric,
                     capacity: int):
    """Batched fused range scan compacted on the card: inputs as
    :func:`range_scan_batch`, and ``capacity`` in 1 .. ``APPEND_WIDTH``.
    Two launches of ``csrc/range_scan_batch.cu``: the range tile appends
    each hit's (key, row) to its query's row of a (Q, capacity) buffer and
    counts it, then one block per query sorts its row.  Returns (ids
    (Q, capacity) int32, raw sims fp32, valid bool, counts (Q,) int32):
    each query's best ``capacity`` hits ascending by order key, equal keys
    lowest id first, empty slots id -1 and sim 0, as ``index.flat.
    compact_range`` over :func:`range_scan_batch`'s keys, bit for bit, for
    every query whose count is at most ``capacity``; a query past it gets
    empty slots only and its full count (the caller's to recompute)."""
    n, d = corpus.shape
    qn = queries.shape[0]
    dev = corpus.device
    check_tensor(corpus, "corpus", (n, d), torch.float32, dev)
    check_tensor(queries, "queries", (qn, d), torch.float32, dev)
    check_tensor(radius_keys, "radius_keys", (qn,), torch.float32, dev)
    if mask_i8 is not None:
        check_tensor(mask_i8, "mask", (qn, n) if mask_i8.ndim == 2 else (n,),
                     torch.int8, dev)
    check_tensor(qvalid_i8, "qvalid", (qn,), torch.int8, dev)
    if not 1 <= capacity <= APPEND_WIDTH:
        raise ValueError(f"range_topk_batch: capacity {capacity} outside "
                         f"1..{APPEND_WIDTH}")
    if dev.type == "cpu":
        return range_topk_batch_plain(corpus, queries, radius_keys, mask_i8,
                                      qvalid_i8, metric, capacity)
    if dev.type != "cuda":
        raise ValueError(f"range_topk_batch runs on cuda (or cpu), not {dev}")
    qt, splits, rows = batch_plan(n, qn)
    words = torch.empty((qn, capacity), dtype=torch.int64, device=dev)
    counts = torch.zeros(qn, dtype=torch.int32, device=dev)
    mask_mode = 0 if mask_i8 is None else 1 if mask_i8.ndim == 1 else 2
    vec4 = (d % 4 == 0 and corpus.data_ptr() % 16 == 0
            and queries.data_ptr() % 16 == 0)
    lib, append = build.launcher("range_scan_batch.cu",
                                 "range_append_batch_launch",
                                 [P] * 4 + [I] + [P] * 2 + [I] + [P]
                                 + [I] * 8 + [P])
    err = append(
        ptr(corpus), ptr(queries), ptr(radius_keys), ptr(mask_i8), mask_mode,
        ptr(qvalid_i8), ptr(words), capacity, ptr(counts), n, d, qn,
        METRIC_CODES[metric], qt, rows, splits, int(vec4), stream(dev))
    build.check(lib, "range_topk_batch (append)", err)
    range_topk_batch.launches += 1
    return sort_hits(words, counts, metric) + (counts,)


range_topk_batch.launches = 0


def sort_hits(words: torch.Tensor, counts: torch.Tensor, metric: Metric):
    """The sort kernel of :func:`range_topk_batch` on a CUDA (Q, W) buffer
    of the card's words (:func:`pack_hits`' with the top bit flipped back,
    as int64) and (Q,) int32 counts: (ids, raw sims, valid) as
    :func:`sort_hits_plain`."""
    qn, width = words.shape
    dev = words.device
    check_tensor(words, "words", (qn, width), torch.int64, dev)
    check_tensor(counts, "counts", (qn,), torch.int32, dev)
    ids = torch.empty((qn, width), dtype=torch.int32, device=dev)
    sims = torch.empty((qn, width), dtype=torch.float32, device=dev)
    valid = torch.empty((qn, width), dtype=torch.int8, device=dev)
    lib, sort = build.launcher("range_scan_batch.cu", "range_sort_launch",
                               [P, P, I, I, I, P, P, P, P])
    err = sort(ptr(words), ptr(counts), width, qn,
               int(metric.is_similarity()), ptr(ids), ptr(sims), ptr(valid),
               stream(dev))
    build.check(lib, "range_topk_batch (sort)", err)
    return ids, sims, valid.view(torch.bool)

