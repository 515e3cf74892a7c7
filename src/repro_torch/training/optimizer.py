"""AdamW from scratch (the port of ``src/repro/training/optimizer.py``):
dtype-configurable moments, decoupled weight decay, global-norm clipping,
warmup + cosine schedule.

``adamw_update`` returns new trees and metrics, as the reference does (no
in-place ``torch.optim`` step), so a step can be held against the
reference leaf for leaf.  Every leaf is updated in fp32 and cast back to
its dtype.  A leaf whose gradient is None (no path from it to the loss,
such as the token table of an embeddings-mode model) is updated as if its
gradient were zeros, as the reference's AD would give it: the moments
decay and the weight decay still applies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..models.transformer import tree_leaves, tree_unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    m_dtype: str = "float32"      # bf16 for >= 100B archs
    v_dtype: str = "float32"


def warmup_cosine(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor; fp32 arithmetic): linear
    warmup, then a cosine to 0 at ``total_steps``."""
    step = torch.as_tensor(step).to(F32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr_peak * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(cfg: AdamWConfig, params: Any) -> dict:
    """Zero moments of ``params``' shapes in ``m_dtype`` / ``v_dtype`` on
    each leaf's device, and an int32 step counter."""
    def zeros(dtype):
        return lambda p: torch.zeros(p.shape, dtype=getattr(torch, dtype),
                                     device=p.device)

    leaves = tree_leaves(params)
    return {"m": tree_unflatten(params, map(zeros(cfg.m_dtype), leaves)),
            "v": tree_unflatten(params, map(zeros(cfg.v_dtype), leaves)),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the fp32 sum of squares over the leaves, added up leaf by
    leaf in tree order (None leaves, zero gradients, add nothing)."""
    sq = sum(torch.sum(torch.square(x.to(F32))) for x in tree_leaves(tree))
    return torch.sqrt(torch.as_tensor(sq, dtype=F32))


def _grad_leaves(params: Any, grads: Any) -> list:
    """``grads``' leaves aligned with ``tree_leaves(params)``, None where a
    gradient (or a whole subtree of them) is None."""
    if grads is None:
        return [None] * len(tree_leaves(params))
    if isinstance(params, dict):
        return [g for k in sorted(params)
                for g in _grad_leaves(params[k], grads[k])]
    if isinstance(params, (list, tuple)):
        return [g for p, gs in zip(params, grads)
                for g in _grad_leaves(p, gs)]
    return [grads]


def _update_leaf(cfg: AdamWConfig, p, g, m, v, scale, lr, b1c, b2c):
    """One leaf's AdamW update in fp32, in the reference's order of
    operations; each fp32 temporary is reused once its value is spent
    (the arithmetic is the same).  The new leaf is written into a buffer
    laid out like ``p``: a gradient's layout (autograd hands the tied
    embedding's back transposed) must not become the parameter's, or the
    next step's products would take other kernels than a restored state's
    (another summation order on the card)."""
    g32 = torch.empty_like(p, dtype=F32)
    if g is None:
        g32.zero_()
    else:
        torch.mul(g.to(F32), scale, out=g32)
    m32 = m.to(F32) * cfg.b1
    tmp = g32 * (1 - cfg.b1)
    m32 += tmp                                   # b1 m + (1 - b1) g
    v32 = v.to(F32) * cfg.b2
    torch.mul(g32, 1 - cfg.b2, out=tmp).mul_(g32)
    v32 += tmp                                   # b2 v + (1 - b2) g g
    delta = m32 / b1c                            # mhat
    torch.div(v32, b2c, out=tmp).sqrt_().add_(cfg.eps)
    delta.div_(tmp)                              # mhat / (sqrt(vhat) + eps)
    p32 = p.to(F32)
    torch.mul(p32, cfg.weight_decay, out=tmp)
    delta.add_(tmp).mul_(lr)                     # lr (delta + wd p)
    torch.sub(p32, delta, out=g32)
    return g32.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: dict) -> tuple[Any, dict, dict]:
    """Returns (new_params, new_state, metrics): the clipped AdamW step
    of every leaf, the moments and step counter advanced; ``metrics``
    holds the pre-clip ``grad_norm`` and the step's ``lr`` (0-d
    tensors)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = warmup_cosine(cfg, step)
    stepf = step.to(F32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)

    flat_p = tree_leaves(params)
    flat_g = _grad_leaves(params, grads)
    flat_m = tree_leaves(state["m"])
    flat_v = tree_leaves(state["v"])
    out = [_update_leaf(cfg, p, g, m, v, scale, lr, b1c, b2c)
           for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics
