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
the kernel.
"""
from __future__ import annotations

import torch

from ..core.schema import Metric
from . import build
from .build import METRIC_CODES, I, P, check_tensor, ptr, stream
from .range_scan import batch_plan


def pairwise_keys_plain(queries: torch.Tensor, corpus: torch.Tensor,
                        metric: Metric) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one fp32 ``torch.matmul`` plus
    the kernel's epilogue."""
    ip = torch.matmul(queries, corpus.T)                         # (Q, N)
    if metric == Metric.INNER_PRODUCT:
        return -ip
    qq = torch.sum(queries * queries, dim=1, keepdim=True)
    cc = torch.sum(corpus * corpus, dim=1)[None, :]
    if metric == Metric.L2:
        return (qq - 2.0 * ip) + cc
    if metric == Metric.COSINE:
        return -(ip / (torch.sqrt(qq) * torch.sqrt(cc) + 1e-12))
    raise ValueError(metric)


# replaces pairwise_keys_pallas (src/repro/kernels/distance.py)
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
    qt, splits, rows = batch_plan(n, qn)
    lib, launch = build.launcher("pairwise_keys.cu", "pairwise_keys_launch",
                                 [P] * 3 + [I] * 7 + [P])
    err = launch(ptr(corpus), ptr(queries), ptr(out), n, d, qn,
                 METRIC_CODES[metric], qt, rows, splits, stream(dev))
    build.check(lib, "pairwise_keys", err)
    pairwise_keys.launches += 1
    return out


pairwise_keys.launches = 0
