"""Fused scan + filter + top-k: the two kernels of the Q1 main path.

Each wrapper launches a hand-written CUDA kernel (``csrc/scan_topk.cu``,
``csrc/scan_topk_batch.cu``) on a CUDA tensor and runs its plain PyTorch
version beside it on a CPU tensor, and only then.  Both produce the same
stage-1 layout: the corpus is cut into contiguous row splits, and each split
yields its ``k`` best (key, global row id) pairs, ascending by key and then
by id, with (+inf, -1) in empty slots.  The stage-2 merge is in ``ops.py``.

A wrapper counts its kernel launches in a plain integer attribute
(``scan_topk.launches``, ``scan_topk_batch.launches``), so a run can show
that the main path went through the kernels.  ``scan_topk_work`` and
``scan_topk_batch_work`` are a launch's roofline work (the operations, and
the bytes each input read once and each output written once, live queries
only): an active ``roofline.op_counter`` records them per launch, and
``chip_smoke.py``'s bounds read them.  ``single_plan`` and
``batch_plan`` are their launch plans; the batched plan's shape choice and
wave sizing (``pick_shape``, ``wave_splits``) serve the quantized top-k's
plan (``quant.quant_plan``) too.
"""
from __future__ import annotations

import torch

from ..core.expr import pairwise_order_keys
from ..core.schema import Metric
from ..index.flat import stable_smallest_k
from ..roofline.op_counter import Work, counted
from . import build
from .build import METRIC_CODES, I, P, check_tensor, ptr, stream

# The longest list the top-k kernels keep per query: each block holds 2·kp
# (key, id) pairs per query in shared memory (see ``batch_smem``).  Not a
# limit of the reference's: the ops-level wrappers (``ops.py``,
# ``quant.fused_scan_topk_batch_q``) serve a larger k through the range
# kernels.
MAX_K = 1024

# Launch geometry (H100 SXM).  The plain versions cut the corpus the same
# way, so kernel and plain outputs compare entry by entry.
SINGLE_TILE = 256            # rows a single-query block scores per step
SINGLE_BLOCKS = 528          # 4 blocks per SM
# Block shapes of the batched kernel (csrc/scan_topk_batch.cu `Wide`,
# `Mid`, `Narrow`), by queries per block: (rows per tile, columns per staged
# chunk, blocks per SM its registers are sized for).  A block keeps one
# list of 2·kp (key, id) pairs per query, kp = next power of two >=
# max(k, ROUND_ROWS), so the wide shape serves kp = 128 and the mid one
# kp <= 256; the narrow one serves small batches and every larger kp.
BATCH_SHAPES = {64: (256, 16, 1), 32: (256, 16, 2), 8: (512, 16, 2)}
ROUND_ROWS = 128             # rows of a tile that enter the lists at once
NARROW_QUERIES = 16          # up to this many queries, the narrow shape
SM_COUNT = 132               # H100 SXM
SM_SMEM = 233_472            # shared memory of one SM (228 KB)
BLOCK_SMEM = 232_448         # the most one block may use (227 KB)
BLOCK_RESERVED = 1_024       # shared memory the card keeps per block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def single_plan(n: int) -> tuple[int, int]:
    """(blocks, rows per block) of the single-query kernel for N rows."""
    tiles = _cdiv(n, SINGLE_TILE)
    rows = _cdiv(tiles, min(tiles, SINGLE_BLOCKS)) * SINGLE_TILE
    return _cdiv(n, rows), rows


def batch_kp(k: int) -> int:
    """List length of the batched kernel for ``k``: a power of two that
    holds k and one insertion round's rows."""
    return _next_pow2(max(k, ROUND_ROWS))


def batch_smem(qt: int, kp: int) -> int:
    """Shared memory (bytes) of one block of shape ``qt`` at list length
    ``kp``: two staging buffers, the tile's row norms, the lists, and seven
    per-query words (the kernel's ``Shape::smem_bytes`` + static)."""
    rows, depth, _ = BATCH_SHAPES[qt]
    return 4 * (2 * depth * (rows + qt) + rows) + qt * 2 * kp * 8 + 28 * qt


def wave_splits(n: int, qn: int, qt: int, tile: int, per_sm: int,
                least: int = 1) -> tuple[int, int]:
    """(splits, rows per split) of a block shape with ``qt`` queries and
    ``tile``-row tiles, ``per_sm`` blocks resident per SM: splits that are
    whole tiles, at least ``least`` of them, whose number fills whole waves
    of the card's SMs, the fewest waves that keep that floor."""
    slots, qtiles = SM_COUNT * per_sm, _cdiv(qn, qt)
    tiles = max(1, _cdiv(n, tile))
    waves = _cdiv(least * qtiles, slots)
    want = min(tiles, max(least, waves * slots // qtiles))
    rows = _cdiv(tiles, want) * tile
    return _cdiv(n, rows), rows


def pick_shape(qn: int, fits) -> int:
    """Queries per block of a batched top-k kernel with the wide / mid /
    narrow shapes (64, 32 and 8 queries): the narrow one up to 16 queries,
    the mid one up to 32, the wide one beyond; where a shape's lists would
    not fit (``fits(qt)`` false), the next narrower."""
    if qn <= NARROW_QUERIES:
        return 8
    shapes = (64, 32) if qn > 32 else (32,)
    return next((t for t in shapes if fits(t)), 8)


def batch_plan(n: int, qn: int, k: int) -> tuple[int, int, int]:
    """(queries per block, splits, rows per split) of the batched kernel
    (:func:`pick_shape` by the lists' shared memory at kp =
    :func:`batch_kp`, then :func:`wave_splits` at the blocks per SM that
    shape's shared memory and registers allow)."""
    kp = batch_kp(min(k, MAX_K))
    qt = pick_shape(qn, lambda t: batch_smem(t, kp) <= BLOCK_SMEM)
    tile, _, minb = BATCH_SHAPES[qt]
    per_sm = max(1, min(minb, SM_SMEM // (batch_smem(qt, kp)
                                          + BLOCK_RESERVED)))
    return (qt,) + wave_splits(n, qn, qt, tile, per_sm)


def live_queries(qvalid_i8: torch.Tensor | None, qn: int) -> int:
    """The queries a launch serves: its valid lanes (a host read), or all
    ``qn``."""
    return qn if qvalid_i8 is None else int((qvalid_i8 != 0).sum())


def mask_bytes(mask_i8: torch.Tensor | None, live: int, n: int) -> int:
    """The row-mask bytes a launch reads: a shared (N,) mask once, a
    query-major one for the ``live`` queries."""
    if mask_i8 is None:
        return 0
    return n if mask_i8.ndim == 1 else live * n


def scan_topk_work(corpus, query, mask_i8, k: int, metric=None) -> Work:
    """A :func:`scan_topk` launch's work: 2·N·D operations; the corpus,
    the query and the mask in, each block's k (key, id) pairs out."""
    n, d = corpus.shape
    blocks, _ = single_plan(n)
    return Work(2 * n * d, n * d * 4 + d * 4 + mask_bytes(mask_i8, 1, n)
                + blocks * k * 8)


def scan_topk_batch_work(corpus, queries, mask_i8, qvalid_i8, k: int,
                         metric=None) -> Work:
    """A :func:`scan_topk_batch` launch's work for its live queries L:
    2·N·D·L operations; the corpus, L queries, the mask and the valid lanes
    in, each live query's splits·k (key, id) pairs out."""
    n, d = corpus.shape
    qn = queries.shape[0]
    live = live_queries(qvalid_i8, qn)
    _, splits, _ = batch_plan(n, qn, k)
    return Work(2 * n * d * live,
                n * d * 4 + live * d * 4 + mask_bytes(mask_i8, live, n)
                + (0 if qvalid_i8 is None else qn) + live * splits * k * 8)


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}] for the fused scan "
                         f"kernels, got {k}")


def _masked(keys: torch.Tensor, mask_i8: torch.Tensor | None,
            qvalid_i8: torch.Tensor | None) -> torch.Tensor:
    """(Q, N) keys with +inf where the row mask or the valid lane is 0."""
    if mask_i8 is not None:
        m = mask_i8 if mask_i8.ndim == 2 else mask_i8[None]
        keys = keys.masked_fill(m == 0, float("inf"))
    if qvalid_i8 is not None:
        keys = keys.masked_fill((qvalid_i8 == 0)[:, None], float("inf"))
    return keys


def _split_topk(keys: torch.Tensor, k: int, splits: int,
                rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, N) masked keys -> (Q, splits·k) per-split best keys and global
    ids: the plain form of both kernels' selection."""
    qn, n = keys.shape
    pad = splits * rows - n
    if pad:
        keys = torch.cat([keys, keys.new_full((qn, pad), float("inf"))], 1)
    vals, local = stable_smallest_k(keys.reshape(qn, splits, rows), k)
    base = (torch.arange(splits, dtype=torch.int32,
                         device=keys.device) * rows)[None, :, None]
    ids = torch.where(torch.isfinite(vals), local + base, -1)
    return vals.reshape(qn, splits * k), ids.reshape(qn, splits * k)


# ---------------------------------------------------------------------------
# single query: replaces scan_topk_pallas (src/repro/kernels/scan_topk.py)
# ---------------------------------------------------------------------------

def scan_topk_plain(corpus: torch.Tensor, query: torch.Tensor,
                    mask_i8: torch.Tensor | None, k: int, metric: Metric):
    """Plain PyTorch version of the single-query kernel."""
    n = corpus.shape[0]
    keys = pairwise_order_keys(metric, corpus, query[None])     # (1, N)
    if mask_i8 is not None:
        keys = keys.masked_fill(mask_i8[None] == 0, float("inf"))
    blocks, rows = single_plan(n)
    vals, ids = _split_topk(keys, k, blocks, rows)
    return vals.reshape(blocks, k), ids.reshape(blocks, k)


@counted(scan_topk_work)
def scan_topk(corpus: torch.Tensor, query: torch.Tensor,
              mask_i8: torch.Tensor | None, k: int, metric: Metric):
    """Stage 1 of the single-query fused scan: corpus (N, D) fp32, query
    (D,) fp32, mask None or (N,) int8.  Returns (blocks, k) keys and global
    ids (see :func:`single_plan`)."""
    _check_k(k)
    n, d = corpus.shape
    dev = corpus.device
    check_tensor(corpus, "corpus", (n, d), torch.float32, dev)
    check_tensor(query, "query", (d,), torch.float32, dev)
    check_tensor(mask_i8, "mask", (n,), torch.int8, dev)
    if dev.type == "cpu":
        return scan_topk_plain(corpus, query, mask_i8, k, metric)
    if dev.type != "cuda":
        raise ValueError(f"scan_topk runs on cuda (or cpu), not {dev}")
    blocks, rows = single_plan(n)
    keys = torch.empty((blocks, k), dtype=torch.float32, device=dev)
    ids = torch.empty((blocks, k), dtype=torch.int32, device=dev)
    vec4 = d % 4 == 0 and corpus.data_ptr() % 16 == 0
    lib, launch = build.launcher("scan_topk.cu", "scan_topk_launch",
                                 [P] * 5 + [I] * 7 + [P])
    err = launch(
        ptr(corpus), ptr(query), ptr(mask_i8), ptr(keys), ptr(ids),
        n, d, k, METRIC_CODES[metric], int(vec4), rows, blocks,
        stream(dev))
    build.check(lib, "scan_topk", err)
    scan_topk.launches += 1
    return keys, ids


scan_topk.launches = 0


# ---------------------------------------------------------------------------
# query batch: replaces scan_topk_batch_pallas (src/repro/kernels/scan_topk.py)
# ---------------------------------------------------------------------------

def _batch_select(keys: torch.Tensor, mask_i8: torch.Tensor | None,
                  qvalid_i8: torch.Tensor | None, k: int):
    """(Q, N) order keys -> the batched kernel's output: +inf where the row
    mask or the query's valid lane is 0, then each split's best k (the
    splits of :func:`batch_plan`)."""
    qn, n = keys.shape
    _, splits, rows = batch_plan(n, qn, k)
    return _split_topk(_masked(keys, mask_i8, qvalid_i8), k, splits, rows)


def scan_topk_batch_plain(corpus: torch.Tensor, queries: torch.Tensor,
                          mask_i8: torch.Tensor | None,
                          qvalid_i8: torch.Tensor | None, k: int,
                          metric: Metric):
    """Plain PyTorch version of the batched kernel."""
    return _batch_select(pairwise_order_keys(metric, corpus, queries),
                         mask_i8, qvalid_i8, k)


def scan_topk_batch_replayed(corpus: torch.Tensor, queries: torch.Tensor,
                             mask_i8: torch.Tensor | None,
                             qvalid_i8: torch.Tensor | None, k: int,
                             metric: Metric):
    """The batched kernel's output rebuilt on its own arithmetic:
    ``quant.replay_keys`` of every (query, row) pair, masked, then each
    split's best k.  On the card the kernel must equal it bit for bit,
    keys and ids (``chip_smoke.py``, phase topk_bits); (Q, N) sized, for
    small checks."""
    from .quant import replay_keys      # quant imports this module

    n = corpus.shape[0]
    qn = queries.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=corpus.device)
    keys = replay_keys(corpus, queries, rows.expand(qn, n).contiguous(),
                       metric)
    return _batch_select(keys, mask_i8, qvalid_i8, k)


@counted(scan_topk_batch_work)
def scan_topk_batch(corpus: torch.Tensor, queries: torch.Tensor,
                    mask_i8: torch.Tensor | None,
                    qvalid_i8: torch.Tensor | None, k: int, metric: Metric):
    """Stage 1 of the batched fused scan: corpus (N, D) fp32, queries
    (Q, D) fp32, mask None, shared (N,) or query-major (Q, N) int8, qvalid
    None or (Q,) int8 (a 0 lane is a size-bucket pad query: no candidates).
    Returns (Q, splits·k) keys and global ids (see :func:`batch_plan`)."""
    _check_k(k)
    n, d = corpus.shape
    qn = queries.shape[0]
    dev = corpus.device
    check_tensor(corpus, "corpus", (n, d), torch.float32, dev)
    check_tensor(queries, "queries", (qn, d), torch.float32, dev)
    if mask_i8 is not None:
        check_tensor(mask_i8, "mask", (qn, n) if mask_i8.ndim == 2 else (n,),
               torch.int8, dev)
    check_tensor(qvalid_i8, "qvalid", (qn,), torch.int8, dev)
    if dev.type == "cpu":
        return scan_topk_batch_plain(corpus, queries, mask_i8, qvalid_i8, k,
                                     metric)
    if dev.type != "cuda":
        raise ValueError(f"scan_topk_batch runs on cuda (or cpu), not {dev}")
    qt, splits, rows = batch_plan(n, qn, k)
    keys = torch.empty((qn, splits * k), dtype=torch.float32, device=dev)
    ids = torch.empty((qn, splits * k), dtype=torch.int32, device=dev)
    mask_mode = 0 if mask_i8 is None else 1 if mask_i8.ndim == 1 else 2
    # 16-byte loads: whole 4-float units along D and aligned bases
    vec4 = (d % 4 == 0 and corpus.data_ptr() % 16 == 0
            and queries.data_ptr() % 16 == 0)
    lib, launch = build.launcher("scan_topk_batch.cu",
                                 "scan_topk_batch_launch",
                                 [P] * 3 + [I] + [P] * 3 + [I] * 9 + [P])
    err = launch(
        ptr(corpus), ptr(queries), ptr(mask_i8), mask_mode,
        ptr(qvalid_i8), ptr(keys), ptr(ids), n, d, qn, k,
        METRIC_CODES[metric], qt, rows, splits, int(vec4), stream(dev))
    build.check(lib, "scan_topk_batch", err)
    scan_topk_batch.launches += 1
    return keys, ids


scan_topk_batch.launches = 0
