"""Blocked Lloyd k-means in torch (the IVF coarse quantizer's training).

The assignment step is a dense (chunk x nlist) fp32 matmul, chunked so the
distance matrix stays small.  Training subsamples the corpus (about 256
points per centroid, standard IVF practice) and the final full assignment
is one blocked pass.  Everything runs on the tensors' device; randomness
comes from an explicit ``torch.Generator``, so a seed gives the same
centroids on every run (the reference seeds with ``jax.random.key``, whose
draws torch cannot reproduce).
"""
from __future__ import annotations

import torch

from ..core.expr import full_fp32


def _pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, d), (k, d) -> (n, k) squared L2 in the matmul form
    ‖x‖² − 2x·c + ‖c‖², in full fp32."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(c * c, dim=1)
    with full_fp32():
        ip = x @ c.T
    return x2 - 2.0 * ip + c2[None, :]


def assign(x: torch.Tensor, centroids: torch.Tensor,
           chunk: int = 16384) -> torch.Tensor:
    """Nearest-centroid assignment, blocked over rows: (n,) int32, the
    first centroid on ties."""
    x = x.to(torch.float32)
    centroids = centroids.to(torch.float32)
    out = [torch.argmin(_pairwise_sqdist(x[i:i + chunk], centroids), dim=1)
           for i in range(0, x.shape[0], chunk)]
    return torch.cat(out).to(torch.int32)


def _lloyd(x: torch.Tensor, init: torch.Tensor, nlist: int, iters: int,
           chunk: int) -> torch.Tensor:
    """``iters`` Lloyd steps from ``init``.  Cluster sums are a one-hot
    matmul (deterministic on the card, where ``index_add_`` is not); a
    centroid that loses every point stays where it was."""
    centroids = init
    lanes = torch.arange(nlist, device=x.device)
    for _ in range(iters):
        a = assign(x, centroids, chunk=chunk)
        onehot = (a[:, None] == lanes[None, :]).to(torch.float32)  # (n, k)
        with full_fp32():
            sums = onehot.T @ x
        counts = onehot.sum(0)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        centroids = torch.where((counts > 0)[:, None], new, centroids)
    return centroids


def _choice(n: int, size: int, generator: torch.Generator,
            replace: bool) -> torch.Tensor:
    """``size`` draws from range(n) on the generator's device."""
    if replace:
        return torch.randint(n, (size,), generator=generator,
                             device=generator.device)
    return torch.randperm(n, generator=generator,
                          device=generator.device)[:size]


def kmeans(generator: torch.Generator, x: torch.Tensor, nlist: int,
           iters: int = 8, train_points_per_centroid: int = 256,
           chunk: int = 16384) -> torch.Tensor:
    """Train ``nlist`` centroids on (a subsample of) ``x``; returns
    (nlist, d) fp32 on ``x``'s device.  The draws come from ``generator``
    (the training subsample first, then the initial centroids), so one
    generator state gives one answer."""
    x = x.to(torch.float32)
    n = x.shape[0]
    max_train = min(n, nlist * train_points_per_centroid)
    if max_train < n:
        idx = _choice(n, max_train, generator, replace=False)
        xt = x[idx.to(x.device)]
    else:
        xt = x
    init_idx = _choice(xt.shape[0], nlist, generator,
                       replace=xt.shape[0] < nlist)
    init = xt[init_idx.to(x.device)]
    return _lloyd(xt, init, nlist, iters, min(chunk, xt.shape[0]))
