"""Quantized corpus scans with an exact fp32 rescore: the kernels and the
stage 2 of ``EngineOptions(quant="int8" | "bf16")`` on the Q1–Q3 flat
lowerings.

The flat batched scan streams the whole corpus per launch.  These paths
stream its int8 (per-row symmetric scale) or bf16 twin instead — 4× or 2×
fewer bytes — and re-rank a small candidate set with the fp32 kernels' own
keys.  A range answer is exactly the fp32 path's, bit for bit.  A top-k
answer returns exact fp32 similarities, and every row of the fp32 top-k
that lies among the quantized top-(c·k) (c = ``rescore_factor``); it
equals the fp32 path's bit for bit whenever the quantized top-(c·k) covers
the fp32 top-k (below), which the twin's small error makes the usual case
but does not assure:

* **Segmented candidates** (Q1).  ``quant_scan_topk_batch`` reduces its
  quantized keys to per-8-row segment minima and keeps each query's best
  segments per split.  A row of quantized rank ≤ c·k has at most c·k − 1
  rows ahead of it, so at most c·k − 1 segments have a smaller minimum: the
  global top-(c·k) segments, expanded to their rows, hold every row of
  quantized rank ≤ c·k.  Splits hold at most 8·1024 rows (1,024 segments):
  a split that cannot hold c·k segments emits all of them.  Above
  ``MAX_K`` the quantized key kernel scores every row and the segments are
  ranked over all of the corpus at once: the same candidate set with no
  list cap.
* **Bitwise replay.**  ``replay_keys`` scores the candidate (row, query)
  pairs with the fp32 batched kernels' exact arithmetic (``csrc/
  replay_keys.cu``), and the candidates are sorted by row id before the
  stable final top-k, so ties keep the lowest id.  The result equals the
  fp32 path whenever the quantized top-(c·k) covers the fp32 top-k
  (c = ``rescore_factor``).
* **Slack bands** (Q2, Q3).  Per-row dequantization error bounds
  (``QuantizedCorpus.half_step``) bound |k̂ − k| by a slack, so rows with
  k̂ ≤ r − slack are certain hits, rows with k̂ > r + slack certain misses,
  and only the band between is replayed.  When a band is wider than the
  replay budget, the path runs the fp32 range kernel itself.

Each kernel wrapper launches a hand-written CUDA kernel on a CUDA tensor
and runs its plain PyTorch version beside it on a CPU tensor, and only then;
it counts its launches in a plain integer attribute (``.launches``), and
its ``*_work`` function is a launch's roofline work (as ``scan_topk.py``'s).
Stage 2 is plain torch, and every top-k in it is ``stable_smallest_k``;
each of its steps between kernels is the span ``repro_torch.stage2``
(:mod:`repro_torch.tracing`).  Around them, the twin's kernel with its
candidate selection (or the slack classification) is the span
``repro_torch.quant.scan`` and the replay with its re-rank
``repro_torch.quant.replay``, both timed on the card's stream; the
counters ``quant_replayed``, ``quant_band_rows`` and ``quant_fallbacks``
count the replayed slots, the range bands' rows and the fp32 fallbacks.
"""
from __future__ import annotations

import math

import torch

from .. import tracing
from ..core.expr import pairwise_order_keys
from ..core.schema import Metric
from ..index.flat import stable_smallest_k
from ..roofline.op_counter import Work, counted
from . import build
from .build import METRIC_CODES, I, P, check_tensor, ptr, stream
from .distance import MAX_GRID_Y
from .ops import (_check_limit, _mask_i8, _radius_keys, _stage2,
                  fused_range_topk_batch)
from .range_scan import batch_plan
from .scan_topk import (BLOCK_RESERVED, BLOCK_SMEM, MAX_K, SM_SMEM, _cdiv,
                        _check_k, _masked, _next_pow2, _split_topk,
                        live_queries, mask_bytes, pick_shape, wave_splits)

INF = float("inf")
I32_MAX = 2 ** 31 - 1
SEG = 8                        # rows per segment of the candidate extraction
MAX_SPLIT_ROWS = SEG * MAX_K   # a split holds at most 1,024 segments
MODE_CODES = {torch.int8: 0, torch.bfloat16: 1}


# Block shapes of the quantized top-k kernel (csrc/quant_scan_topk_batch.cu
# `Wide`, `Mid`, `Narrow`), by queries per block: (rows per tile, columns
# per staged chunk, blocks per SM its registers are sized for).  A block
# keeps one list of 2·kp (key, id) pairs per query, so the wide shape
# serves kp <= 128 and the mid one kp <= 256; the narrow one serves small
# batches and every larger kp.
QUANT_SHAPES = {64: (256, 16, 1), 32: (256, 16, 2), 8: (512, 16, 2)}


def quant_kp(qt: int, k: int) -> int:
    """List length of the kernel's shape ``qt`` for ``k`` segments kept: a
    power of two that holds k and one tile's segments."""
    return _next_pow2(max(k, QUANT_SHAPES[qt][0] // SEG))


def quant_smem(qt: int, kp: int) -> int:
    """Shared memory (bytes) of one block of shape ``qt`` at list length
    ``kp``: two staging buffers, the tile's row norms, the lists, and six
    per-query words (the kernel's ``Shape::smem_bytes`` + static)."""
    rows, depth, _ = QUANT_SHAPES[qt]
    return 4 * (2 * depth * (rows + qt) + rows) + qt * 2 * kp * 8 + 24 * qt


def quant_plan(n: int, qn: int, count: int) -> tuple[int, int, int, int]:
    """(queries per block, splits, rows per split, segments kept per split)
    of the quantized top-k kernel asked for ``count`` = c·k segments per
    query.

    The narrow shape up to 16 queries, the mid one up to 32, the wide one
    beyond; where a shape's lists would not fit (the wide one's past
    c·k = 128, the mid one's past 256), the next narrower.  Splits are
    whole tiles of the shape and at most 8·1024 rows (1,024 segments, so a
    split that cannot hold c·k segments emits all of them); their number
    fills whole waves of the card's 132 SMs at the blocks per SM the
    shape's shared memory allows, the fewest waves that keep that cap."""
    kc = min(count, MAX_K)
    qt = pick_shape(
        qn, lambda t: quant_smem(t, quant_kp(t, kc)) <= BLOCK_SMEM)
    tile, _, minb = QUANT_SHAPES[qt]
    per_sm = max(1, min(minb, SM_SMEM // (quant_smem(qt, quant_kp(qt, kc))
                                          + BLOCK_RESERVED)))
    splits, rows = wave_splits(n, qn, qt, tile, per_sm,
                               _cdiv(max(1, _cdiv(n, tile)),
                                     MAX_SPLIT_ROWS // tile))
    if splits > MAX_GRID_Y:
        raise ValueError(f"quant_scan_topk_batch takes at most "
                         f"{MAX_GRID_Y * MAX_SPLIT_ROWS} rows, got {n}")
    return qt, splits, rows, max(1, min(count, rows // SEG))


def _twin_bytes(qvecs: torch.Tensor) -> int:
    """The quantized rows and, for int8, their fp32 scales (a bf16 twin's
    kernel reads no scale)."""
    return (qvecs.numel() * qvecs.element_size()
            + (qvecs.shape[0] * 4 if qvecs.dtype == torch.int8 else 0))


def quant_scan_topk_batch_work(qvecs, scales, queries, mask_i8, qvalid_i8,
                               count: int, metric=None) -> Work:
    """A :func:`quant_scan_topk_batch` launch's work for its live queries
    L: 2·N·D·L operations; the twin, L queries, the mask and the valid
    lanes in, each live query's splits·s (key, segment) pairs out."""
    n, d = qvecs.shape
    qn = queries.shape[0]
    live = live_queries(qvalid_i8, qn)
    _, splits, _, s_count = quant_plan(n, qn, count)
    return Work(2 * n * d * live,
                _twin_bytes(qvecs) + live * d * 4
                + mask_bytes(mask_i8, live, n)
                + (0 if qvalid_i8 is None else qn)
                + live * splits * s_count * 8)


def quant_keys_batch_work(qvecs, scales, queries, mask_i8, qvalid_i8,
                          metric=None) -> Work:
    """A :func:`quant_keys_batch` launch's work for its live queries L:
    2·N·D·L operations; the twin, L queries, the mask and the valid lanes
    in, L rows of keys out."""
    n, d = qvecs.shape
    qn = queries.shape[0]
    live = live_queries(qvalid_i8, qn)
    return Work(2 * n * d * live,
                _twin_bytes(qvecs) + live * d * 4
                + mask_bytes(mask_i8, live, n)
                + (0 if qvalid_i8 is None else qn) + live * n * 4)


def replay_keys_work(corpus, queries, rows, metric=None) -> Work:
    """A :func:`replay_keys` launch's work: 2·D operations per (query, row)
    pair with a row in [0, N); those rows and the queries that have one
    in, the rows read and the keys written out."""
    n, d = corpus.shape
    ok = (rows >= 0) & (rows < n)
    pairs = int(ok.sum())
    live = int(ok.any(1).sum())
    return Work(2 * d * pairs,
                pairs * d * 4 + live * d * 4 + 2 * rows.numel() * 4)


def _check_quant(qvecs: torch.Tensor, scales: torch.Tensor,
                 queries: torch.Tensor, mask_i8, qvalid_i8) -> torch.Tensor:
    """Validate a quantized kernel's inputs; returns the scales as (N,)."""
    n, d = qvecs.shape
    qn = queries.shape[0]
    dev = qvecs.device
    if qvecs.dtype not in MODE_CODES:
        raise ValueError(f"qvecs must be int8 or bfloat16, got {qvecs.dtype}")
    check_tensor(qvecs, "qvecs", (n, d), qvecs.dtype, dev)
    scales = scales.reshape(-1)
    check_tensor(scales, "scales", (n,), torch.float32, dev)
    check_tensor(queries, "queries", (qn, d), torch.float32, dev)
    if mask_i8 is not None:
        check_tensor(mask_i8, "mask", (qn, n) if mask_i8.ndim == 2 else (n,),
                     torch.int8, dev)
    check_tensor(qvalid_i8, "qvalid", (qn,), torch.int8, dev)
    return scales


def _device_of(name: str, t: torch.Tensor) -> str:
    """'cpu' or 'cuda' for a wrapper's input; raises on any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda (or cpu), not {t.device}")
    return t.device.type


def _plain_keys(qvecs, scales, queries, mask_i8, qvalid_i8, metric: Metric):
    """(Q, N) order keys of the dequantized rows, +inf on dead lanes: the
    plain form of both quantized kernels' keys."""
    deq = qvecs.to(torch.float32) * scales.reshape(-1, 1)
    return _masked(pairwise_order_keys(metric, deq, queries), mask_i8,
                   qvalid_i8)


# ---------------------------------------------------------------------------
# stage 1 of Q1: replaces quant_scan_topk_batch_pallas
# (src/repro/kernels/quant.py)
# ---------------------------------------------------------------------------

def quant_scan_topk_batch_plain(qvecs, scales, queries, mask_i8, qvalid_i8,
                                count: int, metric: Metric):
    """Plain PyTorch version of the quantized top-k kernel."""
    keys = _plain_keys(qvecs, scales, queries, mask_i8, qvalid_i8, metric)
    return segment_topk(keys, count)


def segment_topk(keys: torch.Tensor, count: int):
    """(Q, N) masked row keys -> the kernel's output for ``count``: each
    8-row segment's minimum key, and each split's best segments (the plan
    of :func:`quant_plan`) ascending by (key, id), (+inf, -1) in empty
    slots."""
    qn, n = keys.shape
    _, splits, rows, s_count = quant_plan(n, qn, count)
    return _split_topk(segment_minima(keys), s_count, splits, rows // SEG)


def segment_minima(keys: torch.Tensor) -> torch.Tensor:
    """(Q, N) row keys -> (Q, ceil(N / 8)) each 8-row segment's minimum,
    the last segment padded with +inf: the segment key of the quantized
    top-k kernel."""
    qn, n = keys.shape
    pad = (-n) % SEG
    if pad:
        keys = torch.cat([keys, keys.new_full((qn, pad), INF)], 1)
    return keys.reshape(qn, -1, SEG).amin(dim=-1)


def quant_scan_topk_batch_replayed(qvecs, scales, queries, mask_i8,
                                   qvalid_i8, count: int, metric: Metric):
    """The quantized top-k kernel's output rebuilt on the fp32 kernels' own
    arithmetic: :func:`replay_keys` of every (query, row) pair over the
    dequantized corpus, masked, then :func:`segment_topk`.  On the card the
    kernel must equal it bit for bit, keys and ids (``chip_smoke.py``,
    phase quant_bits); (Q, N) sized, for small checks."""
    n = qvecs.shape[0]
    qn = queries.shape[0]
    deq = qvecs.to(torch.float32) * scales.reshape(-1, 1)
    rows = torch.arange(n, dtype=torch.int32, device=qvecs.device)
    keys = replay_keys(deq, queries, rows.expand(qn, n).contiguous(), metric)
    return segment_topk(_masked(keys, mask_i8, qvalid_i8), count)


@counted(quant_scan_topk_batch_work)
def quant_scan_topk_batch(qvecs: torch.Tensor, scales: torch.Tensor,
                          queries: torch.Tensor, mask_i8: torch.Tensor | None,
                          qvalid_i8: torch.Tensor | None, count: int,
                          metric: Metric):
    """Stage 1 of the quantized top-k: qvecs (N, D) int8 or bf16, scales
    (N, 1) or (N,) fp32 (ones for bf16), queries (Q, D) fp32, mask None,
    shared (N,) or query-major (Q, N) int8, qvalid None or (Q,) int8.
    Returns (Q, splits·s) keys and global segment ids (row // 8), each
    split's ``s`` best segments ascending by (key, id), (+inf, -1) in empty
    slots; (splits, s) come from :func:`quant_plan` for ``count``."""
    _check_k(min(count, MAX_K))
    n, d = qvecs.shape
    qn = queries.shape[0]
    scales = _check_quant(qvecs, scales, queries, mask_i8, qvalid_i8)
    if _device_of("quant_scan_topk_batch", qvecs) == "cpu":
        return quant_scan_topk_batch_plain(qvecs, scales, queries, mask_i8,
                                           qvalid_i8, count, metric)
    dev = qvecs.device
    qt, splits, rows, s_count = quant_plan(n, qn, count)
    keys = torch.empty((qn, splits * s_count), dtype=torch.float32,
                       device=dev)
    ids = torch.empty((qn, splits * s_count), dtype=torch.int32, device=dev)
    mask_mode = 0 if mask_i8 is None else 1 if mask_i8.ndim == 1 else 2
    # 16-byte loads: whole units along D (16 int8 or 8 bf16 columns) and
    # aligned bases
    vec = (d % (16 // qvecs.element_size()) == 0
           and qvecs.data_ptr() % 16 == 0 and queries.data_ptr() % 16 == 0)
    lib, launch = build.launcher(
        "quant_scan_topk_batch.cu", "quant_scan_topk_batch_launch",
        [P, P, I, P, P, I] + [P] * 3 + [I] * 9 + [P])
    err = launch(
        ptr(qvecs), ptr(scales), MODE_CODES[qvecs.dtype], ptr(queries),
        ptr(mask_i8), mask_mode, ptr(qvalid_i8), ptr(keys), ptr(ids), n, d,
        qn, s_count, METRIC_CODES[metric], qt, rows, splits, int(vec),
        stream(dev))
    build.check(lib, "quant_scan_topk_batch", err)
    quant_scan_topk_batch.launches += 1
    return keys, ids


quant_scan_topk_batch.launches = 0


# ---------------------------------------------------------------------------
# stage 1 of Q2/Q3: replaces quant_keys_batch_pallas
# (src/repro/kernels/quant.py)
# ---------------------------------------------------------------------------

def quant_keys_batch_plain(qvecs, scales, queries, mask_i8, qvalid_i8,
                           metric: Metric):
    """Plain PyTorch version of the quantized key kernel."""
    return _plain_keys(qvecs, scales, queries, mask_i8, qvalid_i8, metric)


def quant_keys_batch_replayed(qvecs, scales, queries, mask_i8, qvalid_i8,
                              metric: Metric):
    """The quantized key kernel's output rebuilt on the fp32 kernels' own
    arithmetic: :func:`replay_keys` of every (query, row) pair over the
    dequantized corpus, then the mask and the valid lane.  On the card the
    kernel must equal it bit for bit (``chip_smoke.py``, phase keys_bits);
    (Q, N) sized, for small checks."""
    n = qvecs.shape[0]
    qn = queries.shape[0]
    deq = qvecs.to(torch.float32) * scales.reshape(-1, 1)
    rows = torch.arange(n, dtype=torch.int32, device=qvecs.device)
    keys = replay_keys(deq, queries, rows.expand(qn, n).contiguous(), metric)
    return _masked(keys, mask_i8, qvalid_i8)


@counted(quant_keys_batch_work)
def quant_keys_batch(qvecs: torch.Tensor, scales: torch.Tensor,
                     queries: torch.Tensor, mask_i8: torch.Tensor | None,
                     qvalid_i8: torch.Tensor | None, metric: Metric):
    """Masked quantized order keys, query-major: inputs as
    :func:`quant_scan_topk_batch`.  Returns (Q, N) fp32 keys, +inf where
    the mask or the query's valid lane is 0 (no radius test).  The kernel
    is the fp32 batched range scan's tile with an int8 / bf16 row loader,
    launched on that kernel's plan (:func:`~.range_scan.batch_plan`)."""
    n, d = qvecs.shape
    qn = queries.shape[0]
    scales = _check_quant(qvecs, scales, queries, mask_i8, qvalid_i8)
    if _device_of("quant_keys_batch", qvecs) == "cpu":
        return quant_keys_batch_plain(qvecs, scales, queries, mask_i8,
                                      qvalid_i8, metric)
    dev = qvecs.device
    qt, splits, rows = batch_plan(n, qn)
    keys = torch.empty((qn, n), dtype=torch.float32, device=dev)
    mask_mode = 0 if mask_i8 is None else 1 if mask_i8.ndim == 1 else 2
    # 16-byte loads: whole units along D (16 int8 or 8 bf16 columns) and
    # aligned bases; 16-byte key stores: whole 4-row runs along N
    vec = (d % (16 // qvecs.element_size()) == 0
           and qvecs.data_ptr() % 16 == 0 and queries.data_ptr() % 16 == 0)
    vec_out = n % 4 == 0 and keys.data_ptr() % 16 == 0
    lib, launch = build.launcher(
        "quant_keys_batch.cu", "quant_keys_batch_launch",
        [P, P, I, P, P, I, P, P] + [I] * 9 + [P])
    err = launch(
        ptr(qvecs), ptr(scales), MODE_CODES[qvecs.dtype], ptr(queries),
        ptr(mask_i8), mask_mode, ptr(qvalid_i8), ptr(keys), n, d, qn,
        METRIC_CODES[metric], qt, rows, splits, int(vec), int(vec_out),
        stream(dev))
    build.check(lib, "quant_keys_batch", err)
    quant_keys_batch.launches += 1
    return keys


quant_keys_batch.launches = 0


# ---------------------------------------------------------------------------
# exact fp32 replay: the port's form of _replay_keys
# (src/repro/kernels/quant.py), plain XLA in the reference
# ---------------------------------------------------------------------------

def replay_keys_plain(corpus: torch.Tensor, queries: torch.Tensor,
                      rows: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Plain PyTorch version of the replay: the fp32 plain kernels' own
    (Q, N) keys, gathered.  The CPU fp32 path computes this same call on
    the same inputs, so on the CPU, too, the replayed keys are its keys."""
    n = corpus.shape[0]
    keys = pairwise_order_keys(metric, corpus, queries)
    ok = (rows >= 0) & (rows < n)
    got = torch.take_along_dim(keys, rows.clamp(0, n - 1).long(), dim=1)
    return torch.where(ok, got, INF)


@counted(replay_keys_work)
def replay_keys(corpus: torch.Tensor, queries: torch.Tensor,
                rows: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Exact fp32 order keys of the pairs (query q, row ``rows[q, j]``):
    corpus (N, D) fp32, queries (Q, D) fp32, rows (Q, C) int32.  Returns
    (Q, C) fp32 keys, bitwise the fp32 batched kernels' keys of the same
    pairs, +inf where a row id lies outside [0, N)."""
    n, d = corpus.shape
    qn, c = rows.shape
    dev = corpus.device
    check_tensor(corpus, "corpus", (n, d), torch.float32, dev)
    check_tensor(queries, "queries", (qn, d), torch.float32, dev)
    check_tensor(rows, "rows", (qn, c), torch.int32, dev)
    if _device_of("replay_keys", corpus) == "cpu":
        return replay_keys_plain(corpus, queries, rows, metric)
    out = torch.empty((qn, c), dtype=torch.float32, device=dev)
    vec4 = d % 4 == 0 and corpus.data_ptr() % 16 == 0
    lib, launch = build.launcher("replay_keys.cu", "replay_keys_launch",
                                 [P] * 4 + [I] * 6 + [P])
    err = launch(ptr(corpus), ptr(queries), ptr(rows), ptr(out), n, d, qn, c,
                 METRIC_CODES[metric], int(vec4), stream(dev))
    build.check(lib, "replay_keys", err)
    replay_keys.launches += 1
    return out


replay_keys.launches = 0


def _mask_at_rows(row_mask: torch.Tensor | None,
                  rows: torch.Tensor) -> torch.Tensor:
    """The row mask at gathered candidate positions ((Q, C) bool; ``rows``
    in [0, N)).  Segment expansion can bring back a masked row that shares
    a segment with a live one, so the rescore applies the mask again."""
    if row_mask is None:
        return torch.ones(rows.shape, dtype=torch.bool, device=rows.device)
    m = row_mask.to(torch.bool)
    if m.ndim == 1:
        return m[rows.long()]
    return torch.take_along_dim(m, rows.long(), dim=1)


def _rescored_topk(corpus, queries, rows, row_mask, k: int, metric: Metric):
    """The best ``k`` of each query's candidate rows (ascending ids) by
    exact fp32 key: (ids, sims, valid)."""
    n = corpus.shape[0]
    tracing.count("quant_replayed", rows.numel())
    with tracing.span(tracing.QUANT_REPLAY, corpus.device):
        exact = replay_keys(corpus, queries, rows, metric)
        with _stage2(exact.device):
            live = (rows < n) & _mask_at_rows(row_mask,
                                              rows.clamp(max=n - 1))
            exact = torch.where(live, exact, INF)
            out_keys, pos = stable_smallest_k(exact, k)
            valid = torch.isfinite(out_keys)
            ids = torch.where(
                valid,
                torch.take_along_dim(rows, pos.clamp_min(0).long(), dim=1),
                -1)
            sims = torch.where(valid, -out_keys if metric.is_similarity()
                               else out_keys, 0.0)
    return ids, sims, valid


def fused_scan_topk_batch_q(corpus: torch.Tensor, qvecs: torch.Tensor,
                            scales: torch.Tensor, queries: torch.Tensor,
                            k: int, row_mask: torch.Tensor | None,
                            metric: Metric, rescore_factor: int = 2,
                            qvalid: torch.Tensor | None = None):
    """Quantized twin of :func:`~repro_torch.kernels.ops.
    fused_scan_topk_batch`: the global top-(c·k) segments per query, their
    rows in ascending order, and the exact fp32 re-rank (c =
    ``rescore_factor``), any k >= 1.  Up to ``MAX_K`` the segmented
    quantized kernel gives the segments; above it the quantized key kernel
    gives every row's key, and the segments are ranked by their minima
    over all of the corpus, the candidate set the segmented kernel would
    give with no list cap.  Contract (masks, the valid lane, outputs)
    identical to the fp32 wrapper.  Returns (ids (Q, k), sims raw-metric
    (Q, k), valid (Q, k))."""
    _check_limit(k)
    corpus = corpus.to(torch.float32).contiguous()
    queries = queries.to(torch.float32).contiguous()
    count = max(1, int(rescore_factor)) * k
    qv = None if qvalid is None else _mask_i8(qvalid)
    mask = _mask_i8(row_mask)
    dev = corpus.device
    with tracing.span(tracing.QUANT_SCAN, dev):
        if k > MAX_K:
            keys = quant_keys_batch(qvecs, scales, queries, mask, qv, metric)
            with _stage2(dev):
                keys = segment_minima(keys)
                segs = torch.arange(keys.shape[1], dtype=torch.int32,
                                    device=dev).expand_as(keys)
                rows = candidate_rows(keys, segs, count)
        else:
            keys, segs = quant_scan_topk_batch(qvecs, scales, queries, mask,
                                               qv, count, metric)
            with _stage2(dev):
                rows = candidate_rows(keys, segs, count)
    return _rescored_topk(corpus, queries, rows, row_mask, k, metric)


def candidate_rows(keys: torch.Tensor, segs: torch.Tensor,
                   count: int) -> torch.Tensor:
    """Stage 2 of the quantized top-k: the global top-``count`` segments of
    each query from the kernel's per-split lists, expanded to their rows in
    ascending order ((Q, 8·count) int32, ``I32_MAX`` in empty slots)."""
    top, pos = stable_smallest_k(keys, min(count, keys.shape[1]))
    seg = torch.where(torch.isfinite(top),
                      torch.take_along_dim(segs, pos.long(), dim=1), -1)
    offs = torch.arange(SEG, dtype=torch.int32, device=seg.device)
    rows = torch.where(seg[..., None] >= 0, seg[..., None] * SEG + offs,
                       I32_MAX).reshape(keys.shape[0], -1)
    return torch.sort(rows, dim=1).values


# ---------------------------------------------------------------------------
# range: slack-band classification and boundary rescore
# ---------------------------------------------------------------------------

def _range_slack(metric: Metric, half: torch.Tensor, l1: torch.Tensor,
                 l2: torch.Tensor, queries: torch.Tensor,
                 d_true: int) -> torch.Tensor:
    """Per-(query, row) upper bound on |quantized key − exact key|.

    With h the per-row componentwise dequantization error bound
    (``QuantizedCorpus.half_step``), x̂ the dequantized row and q the query:

    * IP:  |Δ(−q·x)| ≤ h·‖q‖₁
    * L2:  |Δ‖x−q‖²| ≤ 2h(‖x̂‖₁ + ‖q‖₁) + D·h²
    * cos: |Δ| ≤ h·(‖q‖₁/‖q‖₂ + √D) / ‖x̂‖₂

    Returns (Q, N) fp32, widened by a small relative and absolute epsilon
    for the fp32 evaluation of the bound itself."""
    h = half.reshape(1, -1)
    q_l1 = queries.abs().sum(dim=1, keepdim=True)
    if metric == Metric.INNER_PRODUCT:
        slack = h * q_l1
    elif metric == Metric.L2:
        slack = 2.0 * h * (l1.reshape(1, -1) + q_l1) + d_true * h * h
    elif metric == Metric.COSINE:
        q_l2 = torch.sqrt((queries * queries).sum(dim=1, keepdim=True))
        num = q_l1 / q_l2.clamp_min(1e-12) + math.sqrt(float(d_true))
        slack = h * num / l2.reshape(1, -1).clamp_min(1e-12)
    else:
        raise ValueError(metric)
    return slack * 1.001 + 1e-6


def _ascending_rows(sel_keys: torch.Tensor, w: int) -> torch.Tensor:
    """Each query's rows with a finite ``sel_keys`` (at most ``w``), in
    ascending order, ``I32_MAX`` in empty slots: (Q, w) int32."""
    vals, sel = stable_smallest_k(sel_keys, w)
    rows = torch.where(torch.isfinite(vals), sel, I32_MAX)
    return torch.sort(rows, dim=1).values


def fused_range_topk_batch_q(corpus: torch.Tensor, qvecs: torch.Tensor,
                             scales: torch.Tensor, half: torch.Tensor,
                             l1: torch.Tensor, l2: torch.Tensor,
                             queries: torch.Tensor, radius,
                             row_mask: torch.Tensor | None, metric: Metric,
                             capacity: int, rescore_factor: int = 2,
                             qvalid: torch.Tensor | None = None):
    """Quantized twin of :func:`~repro_torch.kernels.ops.
    fused_range_topk_batch`.

    Quantized keys classify every row as a certain hit (k̂ ≤ r − slack), a
    certain miss (k̂ > r + slack) or a boundary row.  The best
    ``rescore_factor·capacity`` maybe rows (certain or boundary) of each
    query are replayed in exact fp32 for the emission, and its boundary
    rows for the count (certain hits + boundary rows that hit exactly).
    When any query has more maybe rows than that budget, the replay sets
    would be incomplete, and the call runs the fp32 range kernel on the
    fp32 corpus instead — the keys the replay reproduces — so the answer
    is exact either way.  Each query's count of maybe rows reaches the
    host in one copy (one sync), which picks the branch and feeds the
    counter ``quant_band_rows``; a fallback counts in ``quant_fallbacks``.
    Returns (ids (Q, P), sims, valid, count (Q,)) with P = min(capacity,
    N), as the fp32 wrapper."""
    corpus = corpus.to(torch.float32).contiguous()
    queries = queries.to(torch.float32).contiguous()
    n, d = corpus.shape
    qn = queries.shape[0]
    dev = corpus.device
    qv = None if qvalid is None else _mask_i8(qvalid)
    cap = min(int(capacity), n)
    w = min(max(1, int(rescore_factor)) * cap, n)
    with tracing.span(tracing.QUANT_SCAN, dev):
        qkeys = quant_keys_batch(qvecs, scales, queries, _mask_i8(row_mask),
                                 qv, metric)                       # (Q, N)
        with _stage2(dev):
            rk = _radius_keys(radius, metric, qn, dev)[:, None]
            slack = _range_slack(metric, half, l1, l2, queries, d)
            certain = qkeys <= rk - slack
            maybe = qkeys <= rk + slack             # +inf lanes: never maybe
            # the branch is chosen on the host from each query's count of
            # maybe rows, read in one copy: one device sync per call.
            # Boundary rows are maybe rows, so one test covers both replay
            # budgets.
            tracing.count("syncs")
            band = maybe.sum(dim=1).tolist()
        tracing.count("quant_band_rows", sum(band))
        over = max(band) > w
        if not over:
            with _stage2(dev):
                n_certain = certain.sum(dim=1, dtype=torch.int32)
                # emission: the maybe rows; count: the boundary rows,
                # nearest the radius first
                rows_e = _ascending_rows(torch.where(maybe, qkeys, INF), w)
                rows_b = _ascending_rows(
                    torch.where(maybe & ~certain, (qkeys - rk).abs(), INF),
                    w)
    del qkeys, certain, maybe
    if over:
        tracing.count("quant_fallbacks")
        return fused_range_topk_batch(corpus, queries, radius, row_mask,
                                      metric, cap, qvalid=qvalid)
    tracing.count("quant_replayed", rows_e.numel() + rows_b.numel())
    with tracing.span(tracing.QUANT_REPLAY, dev):
        exact_e = replay_keys(corpus, queries, rows_e, metric)
        exact_b = replay_keys(corpus, queries, rows_b, metric)
        with _stage2(dev):
            # emission: the best ``cap`` exact hits among the maybe rows
            hit_e = (rows_e < n) & (exact_e <= rk)
            out_keys, pos = stable_smallest_k(
                torch.where(hit_e, exact_e, INF), cap)
            valid = torch.isfinite(out_keys)
            ids = torch.where(
                valid,
                torch.take_along_dim(rows_e, pos.clamp_min(0).long(), dim=1),
                -1)
            sims = torch.where(valid, -out_keys if metric.is_similarity()
                               else out_keys, 0.0)
            # count: certain hits + the boundary rows that hit exactly
            count = n_certain + ((rows_b < n) & (exact_b <= rk)).sum(
                dim=1, dtype=torch.int32)
    return ids, sims, valid, count
