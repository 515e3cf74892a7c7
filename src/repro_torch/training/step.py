"""Train-step builders (the port of ``src/repro/training/step.py``): the
plain step with microbatch gradient accumulation, and the data-parallel
step with int8 error-feedback gradient compression.

* Gradients come from ``torch.autograd`` over the parameter leaves.  The
  forward, the backward and remat's recompute all run inside
  ``core.expr.full_fp32``, so an fp32 model's products are full fp32 on
  the card (no TF32) whatever the caller's matmul precision.
* Microbatches are a loop over ``microbatches`` equal slices of the batch:
  the gradients are added in ``accum_dtype`` in slice order, then scaled
  by 1 / microbatches, as the reference's ``lax.scan`` does.
* The compressed step does in one process what the reference's
  ``shard_map`` does over its ``dp_axis``: the batch is split over the
  axis's devices, each replica computes its loss and gradients on its own
  device, adds its error memory and quantizes per tensor to int8 with one
  scale; the payloads times their scales are summed in replica order on
  the first replica's device and divided by the replica count, and each
  replica keeps its new quantization error on its device.  The update is
  computed once, so it is the same for every replica.  On the CPU every
  replica is the CPU; on one card the mesh is that card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..core.expr import full_fp32
from ..models import lm_loss
from ..models.config import ModelConfig
from ..models.transformer import tree_leaves, tree_map, tree_unflatten
from ..roofline.op_counter import collective
from .optimizer import AdamWConfig, _grad_leaves, adamw_update
from .train_state import TrainState

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    accum_dtype: str = "float32"        # bf16 halves the accumulator memory
                                        # for 100B+ archs (a trade-off)
    compress_grads: bool = False        # int8 error-feedback DP all-reduce
    dp_axis: str = "data"               # mesh axis of the compressed step


def _loss_fn(params, cfg: ModelConfig, batch):
    if cfg.input_mode == "tokens":
        return lm_loss(params, cfg, tokens=batch["tokens"],
                       labels=batch.get("labels"))
    return lm_loss(params, cfg, embeds=batch["embeds"],
                   labels=batch["labels"])


def value_and_grad(params, cfg: ModelConfig, batch) -> tuple:
    """(loss, grads): the loss of ``batch`` and its gradient with respect
    to every leaf of ``params``, a tree of ``params``' structure with None
    where a leaf does not reach the loss.  The forward and the backward
    run under ``full_fp32``."""
    leaves = tree_leaves(params)
    with torch.enable_grad(), full_fp32():
        live = [p.detach().requires_grad_() for p in leaves]
        loss = _loss_fn(tree_unflatten(params, live), cfg, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), tree_unflatten(params, grads)


def _split(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) -> (n, B / n, ...): slice i holds rows i·B/n onward."""
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def build_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     step_cfg: TrainStepConfig = TrainStepConfig()
                     ) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    hold the loss, the pre-clip grad norm and the lr (0-d tensors)."""

    def grads_of(params, batch):
        n = step_cfg.microbatches
        if n <= 1:
            return value_and_grad(params, cfg, batch)
        adt = getattr(torch, step_cfg.accum_dtype)
        leaves = tree_leaves(params)
        # like each leaf (a DTensor's accumulator is one, as its gradient)
        acc = [torch.zeros_like(p, dtype=adt,
                                memory_format=torch.contiguous_format)
               for p in leaves]
        loss_acc = torch.zeros((), dtype=F32, device=leaves[0].device)
        slices = {k: _split(v, n) for k, v in batch.items()}
        for i in range(n):
            loss, grads = value_and_grad(
                params, cfg, {k: v[i] for k, v in slices.items()})
            for a, g in zip(acc, _grad_leaves(params, grads)):
                if g is not None:
                    a += g.to(adt)
            loss_acc = loss_acc + loss
        inv = 1.0 / n
        return loss_acc * inv, tree_unflatten(params, [a * inv for a in acc])

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, grads = grads_of(state.params, batch)
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, state.params, grads, state.opt)
        metrics["loss"] = loss
        new_state = TrainState(
            params=new_params, opt=new_opt, step=state.step + 1,
            data_cursor=state.data_cursor + 1, rng=state.rng)
        return new_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Compressed-gradient DP
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: (q, scale) with x ~ q · scale."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compressed_psum(grads: Sequence[Any], errors: Sequence[Any]):
    """int8 error-feedback all-reduce over replicas, in one process.

    ``grads`` and ``errors`` hold one tree per replica (each on its
    replica's device; a None gradient counts as zeros).  Each replica adds
    its residual error, quantizes per tensor to int8 and keeps the new
    quantization error; the dequantized payloads are summed in replica
    order on the first replica's device and divided by the replica count;
    with more than one replica each summed leaf's bytes are recorded as an
    all-reduce into an active ``roofline.op_counter``.  Returns (the mean
    tree on the first replica's device, the new error trees, one per
    replica on its device)."""
    n = len(grads)
    like = errors[0]
    dev0 = tree_leaves(like)[0].device
    flat_g = [_grad_leaves(like, g) for g in grads]
    flat_e = [tree_leaves(e) for e in errors]
    means, new_err = [], [[] for _ in range(n)]
    for i in range(len(flat_e[0])):
        summed = None
        for r in range(n):
            e = flat_e[r][i]
            g = flat_g[r][i]
            g32 = e if g is None else g.to(F32) + e
            q, scale = quantize_int8(g32)
            new_err[r].append(g32 - dequantize_int8(q, scale))
            part = (q.to(F32) * scale).to(dev0)
            summed = part if summed is None else summed + part
        if n > 1:
            collective("all-reduce", summed.nbytes)
        means.append(summed / n)
    return (tree_unflatten(like, means),
            [tree_unflatten(like, e) for e in new_err])


def dp_devices(mesh, dp_axis: str = "data") -> list:
    """The replicas of ``mesh``'s ``dp_axis``: its devices along that axis
    (index 0 on every other axis, whose devices hold the same replica)."""
    axis = mesh.axis_names.index(dp_axis)
    devs = np.moveaxis(mesh.devices, axis, 0)
    return list(devs.reshape(devs.shape[0], -1)[:, 0])


def build_compressed_dp_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                             mesh, dp_axis: str = "data") -> Callable:
    """Returns ``step(params, opt, err, batch) -> (params, opt, err,
    metrics)``: the batch split over ``mesh``'s ``dp_axis``, params
    replicated (they live on the first replica's device), the gradient
    mean int8-compressed with error feedback (:func:`compressed_psum`).
    ``err`` holds one error tree per replica, each on its replica's
    device (zeros at the start, as the reference's replicated zeros)."""
    devs = dp_devices(mesh, dp_axis)
    n = len(devs)

    def step(params, opt, err, batch):
        if len(err) != n:
            raise ValueError(f"err holds {len(err)} replicas' memories; "
                             f"the {dp_axis!r} axis has {n}")
        slices = {k: _split(v, n) for k, v in batch.items()}
        losses, grads = [], []
        for r, dev in enumerate(devs):
            local = tree_map(lambda p, d=dev: p.to(d), params)
            loss, g = value_and_grad(
                local, cfg, {k: v[r].to(dev) for k, v in slices.items()})
            losses.append(loss.to(devs[0]))
            grads.append(g)
        mean, err = compressed_psum(grads, err)
        loss = losses[0]
        for x in losses[1:]:
            loss = loss + x
        new_params, new_opt, metrics = adamw_update(opt_cfg, params, mean,
                                                    opt)
        metrics["loss"] = loss / n
        return new_params, new_opt, err, metrics

    return step
