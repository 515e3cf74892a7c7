"""Shared neural layers (plain torch functions on dicts of tensors; the port
of ``src/repro/models/layers.py``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dist.sharding import constrain


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the reference accumulates ``dtype`` in: fp32, or fp64 for
    an fp64 model (a higher-precision yardstick of the fp32 one)."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMS norm in fp32 (fp64 for fp64 inputs) with the weight applied as
    ``1 + w``."""
    dt = x.dtype
    acc = acc_dtype(dt)
    x32 = x.to(acc)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.to(acc))).to(dt)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rotary(x: torch.Tensor, positions: torch.Tensor,
           theta: float) -> torch.Tensor:
    """RoPE over the last dim in the half-split layout (the first half of
    the head rotates against the second). x: (..., S, H, hd); positions:
    (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    # the reference takes the log in fp32 (a weakly typed jnp.log)
    step = torch.log(torch.tensor(theta, dtype=torch.float32)) / half
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32) * step)
    ang = positions.to(torch.float32)[..., None] * freqs.to(positions.device)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def normal(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """Standard normal fp32 draws from ``generator`` on its device, moved to
    ``device``; on ``meta`` (the dry-run) an fp32 tensor of the shape and
    no draw."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device="meta")
    out = torch.randn(tuple(shape), generator=generator,
                      device=generator.device, dtype=torch.float32)
    return out if device is None else out.to(device)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, dtype,
               lead: tuple = (), device=None) -> torch.Tensor:
    """A (*lead, in_dim, out_dim) weight drawn N(0, 1/in_dim)."""
    scale = 1.0 / math.sqrt(in_dim)
    return (normal(generator, (*lead, in_dim, out_dim), device)
            * scale).to(dtype)


def mlp_init(generator: torch.Generator, cfg, d_ff: int | None = None,
             lead: tuple = (), device=None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.pdtype()
    p = {"wi": dense_init(generator, d, f, dt, lead, device)}
    if cfg.mlp_type == "glu":
        p["wg"] = dense_init(generator, d, f, dt, lead, device)
    p["wo"] = dense_init(generator, f, d, dt, lead, device)
    return p


def mlp_apply(params: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    h = x @ params["wi"]
    if mlp_type == "glu":
        g = x @ params["wg"]
        h = F.silu(g) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    h = constrain(h, ("batch", "seq", "ff"))
    return h @ params["wo"]
