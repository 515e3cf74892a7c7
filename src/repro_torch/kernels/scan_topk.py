"""Fused scan + filter + top-k: the two kernels of the Q1 main path.

Each wrapper launches a hand-written CUDA kernel (``csrc/scan_topk.cu``,
``csrc/scan_topk_batch.cu``) on a CUDA tensor and runs its plain PyTorch
version beside it on a CPU tensor, and only then.  Both produce the same
stage-1 layout: the corpus is cut into contiguous row splits, and each split
yields its ``k`` best (key, global row id) pairs, ascending by key and then
by id, with (+inf, -1) in empty slots.  The stage-2 merge is in ``ops.py``.

A wrapper counts its kernel launches in a plain integer attribute
(``scan_topk.launches``, ``scan_topk_batch.launches``), so a run can show
that the main path went through the kernels.
"""
from __future__ import annotations

import torch

from ..core.expr import pairwise_order_keys
from ..core.schema import Metric
from ..index.flat import stable_smallest_k
from . import build
from .build import METRIC_CODES, I, P, check_tensor, ptr, stream

MAX_K = 1024                 # the reference's BLOCK_N cap on k

# Launch geometry (H100: 132 SMs).  The plain versions cut the corpus the
# same way, so kernel and plain outputs compare entry by entry.
SINGLE_TILE = 256            # rows a single-query block scores per step
SINGLE_BLOCKS = 528          # 4 blocks per SM
BATCH_TILE = 64              # rows a batched block scores per step
BATCH_BLOCKS = 264           # 2 blocks per SM
BATCH_QTILES = (4, 16, 64)   # queries per batched block (kernel templates)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def single_plan(n: int) -> tuple[int, int]:
    """(blocks, rows per block) of the single-query kernel for N rows."""
    tiles = _cdiv(n, SINGLE_TILE)
    rows = _cdiv(tiles, min(tiles, SINGLE_BLOCKS)) * SINGLE_TILE
    return _cdiv(n, rows), rows


def batch_plan(n: int, qn: int, k: int) -> tuple[int, int, int]:
    """(queries per block, splits, rows per split) of the batched kernel.

    A block keeps 2·kp (key, id) pairs per query in shared memory
    (kp = next power of two >= max(k, 64)), which caps its queries at 64,
    16 or 4 as k grows; it takes the smallest tile that holds all Q."""
    kp = _next_pow2(max(k, BATCH_TILE))
    cap = 64 if kp <= 64 else 16 if kp <= 256 else 4
    qt = next((t for t in BATCH_QTILES if t >= qn and t <= cap), cap)
    return (qt,) + split_plan(n, qn, qt)


def split_plan(n: int, qn: int, qt: int) -> tuple[int, int]:
    """(splits, rows per split) of a query-batched kernel whose blocks take
    ``qt`` queries each: about BATCH_BLOCKS blocks in all, each split a
    whole number of BATCH_TILE-row tiles."""
    tiles = max(1, _cdiv(n, BATCH_TILE))
    want = max(1, _cdiv(BATCH_BLOCKS, _cdiv(qn, qt)))
    rows = _cdiv(tiles, min(tiles, want)) * BATCH_TILE
    return _cdiv(n, rows), rows


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}] for the fused scan "
                         f"kernels, got {k}")


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

def scan_topk_batch_plain(corpus: torch.Tensor, queries: torch.Tensor,
                          mask_i8: torch.Tensor | None,
                          qvalid_i8: torch.Tensor | None, k: int,
                          metric: Metric):
    """Plain PyTorch version of the batched kernel."""
    n = corpus.shape[0]
    qn = queries.shape[0]
    keys = pairwise_order_keys(metric, corpus, queries)          # (Q, N)
    if mask_i8 is not None:
        m = mask_i8 if mask_i8.ndim == 2 else mask_i8[None]
        keys = keys.masked_fill(m == 0, float("inf"))
    if qvalid_i8 is not None:
        keys = keys.masked_fill((qvalid_i8 == 0)[:, None], float("inf"))
    _, splits, rows = batch_plan(n, qn, k)
    return _split_topk(keys, k, splits, rows)


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
    lib, launch = build.launcher("scan_topk_batch.cu",
                                 "scan_topk_batch_launch",
                                 [P] * 3 + [I] + [P] * 3 + [I] * 8 + [P])
    err = launch(
        ptr(corpus), ptr(queries), ptr(mask_i8), mask_mode,
        ptr(qvalid_i8), ptr(keys), ptr(ids), n, d, qn, k,
        METRIC_CODES[metric], qt, rows, splits,
        stream(dev))
    build.check(lib, "scan_topk_batch", err)
    scan_topk_batch.launches += 1
    return keys, ids


scan_topk_batch.launches = 0
