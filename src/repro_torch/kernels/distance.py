"""The pairwise order-key matrix: a GEMM with a metric epilogue.

``pairwise_keys`` launches a hand-written CUDA kernel
(``csrc/pairwise_keys.cu``) on CUDA tensors and runs its plain PyTorch
version beside it on CPU tensors, and only then.  Both give the (Q, N) fp32
order keys (smaller = better) of every (query, corpus row) pair in the
reference kernel's float order: −ip, ‖q‖² − 2·ip + ‖c‖², or
−ip / (‖q‖·‖c‖ + 1e-12).  Q, N and D are ragged: nothing is padded.  The
public op that casts its inputs to fp32 is ``ops.pairwise_keys``.

The wrapper counts its kernel launches in a plain integer attribute
(``pairwise_keys.launches``), so a run can show that a path went through
the kernel.  ``pairwise_plan`` is its launch plan: which block shape of the
kernel, and the grid.
"""
from __future__ import annotations

import torch

from ..core.expr import full_fp32
from ..core.schema import Metric
from ..roofline.op_counter import Work, counted
from . import build
from .build import METRIC_CODES, I, P, check_tensor, ptr, stream


def pairwise_keys_plain(queries: torch.Tensor, corpus: torch.Tensor,
                        metric: Metric) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one fp32 ``torch.matmul`` (in
    full fp32 whatever the caller's matmul precision) plus the kernel's
    epilogue."""
    with full_fp32():
        ip = torch.matmul(queries, corpus.T)                     # (Q, N)
    if metric == Metric.INNER_PRODUCT:
        return -ip
    qq = torch.sum(queries * queries, dim=1, keepdim=True)
    cc = torch.sum(corpus * corpus, dim=1)[None, :]
    if metric == Metric.L2:
        return (qq - 2.0 * ip) + cc
    if metric == Metric.COSINE:
        return -(ip / (torch.sqrt(qq) * torch.sqrt(cc) + 1e-12))
    raise ValueError(metric)


# (queries, rows) per block of the kernel's shapes, narrowest first: the
# narrow one for small batches, where the corpus bytes bound the kernel,
# and the wide 128 x 128 one that takes 100 queries in one query tile
PAIRWISE_SHAPES = ((16, 256), (128, 128))
MAX_GRID_Y = 65535                     # CUDA's limit on gridDim.y


def pairwise_plan(n: int, qn: int) -> tuple[int, int, int, int]:
    """(queries per block, rows per block, row blocks, query blocks) of the
    kernel for ``qn`` queries over ``n`` rows: the narrow shape up to 16
    queries, the wide one past it, one output tile per block.  Every
    value fits the launcher's 32-bit ints; the kernel forms each key's
    offset q·N + row in 64 bits."""
    if n < 1 or qn < 1:
        raise ValueError(f"pairwise_plan needs N, Q >= 1, got {n}, {qn}")
    qt, rt = next((s for s in PAIRWISE_SHAPES if qn <= s[0]),
                  PAIRWISE_SHAPES[-1])
    row_blocks, query_blocks = -(-n // rt), -(-qn // qt)
    if query_blocks > MAX_GRID_Y or n >= 2**31 or qn >= 2**31:
        raise ValueError(f"pairwise_keys takes at most {MAX_GRID_Y * qt} "
                         f"queries and 2^31 - 1 rows, got {qn} x {n}")
    return qt, rt, row_blocks, query_blocks


def pairwise_keys_work(queries, corpus, metric=None) -> Work:
    """A :func:`pairwise_keys` launch's work: 2·Q·N·D operations; the
    corpus and the queries in, the (Q, N) keys out."""
    n, d = corpus.shape
    qn = queries.shape[0]
    return Work(2 * qn * n * d, n * d * 4 + qn * d * 4 + qn * n * 4)


# replaces pairwise_keys_pallas (src/repro/kernels/distance.py)
@counted(pairwise_keys_work)
def pairwise_keys(queries: torch.Tensor, corpus: torch.Tensor,
                  metric: Metric) -> torch.Tensor:
    """(Q, N) fp32 order keys of queries (Q, D) fp32 against corpus (N, D)
    fp32, both contiguous on one device, D >= 1."""
    n, d = corpus.shape
    qn = queries.shape[0]
    dev = corpus.device
    if d < 1:
        raise ValueError("pairwise_keys needs D >= 1")
    check_tensor(corpus, "corpus", (n, d), torch.float32, dev)
    check_tensor(queries, "queries", (qn, d), torch.float32, dev)
    if dev.type == "cpu":
        return pairwise_keys_plain(queries, corpus, metric)
    if dev.type != "cuda":
        raise ValueError(f"pairwise_keys runs on cuda (or cpu), not {dev}")
    out = torch.empty((qn, n), dtype=torch.float32, device=dev)
    if qn == 0 or n == 0:
        return out
    qt, rt, row_blocks, query_blocks = pairwise_plan(n, qn)
    vec4 = (d % 4 == 0 and corpus.data_ptr() % 16 == 0
            and queries.data_ptr() % 16 == 0)
    # the squared query norms of the L2 and cosine epilogues (a prepass)
    qq = (None if metric == Metric.INNER_PRODUCT else
          torch.empty(query_blocks * qt, dtype=torch.float32, device=dev))
    lib, launch = build.launcher("pairwise_keys.cu", "pairwise_keys_launch",
                                 [P] * 4 + [I] * 9 + [P])
    err = launch(ptr(corpus), ptr(queries), ptr(qq), ptr(out), n, d, qn,
                 METRIC_CODES[metric], qt, rt, row_blocks, query_blocks,
                 int(vec4), stream(dev))
    build.check(lib, "pairwise_keys", err)
    pairwise_keys.launches += 1
    return out


pairwise_keys.launches = 0
