"""Mamba2 (SSD — state-space duality) block, chunked scan + recurrent decode
(the port of ``src/repro/models/ssm.py``).

Scalar-per-head decay A, per-token dt via softplus, B/C shared across head
channels.  The chunked algorithm computes the intra-chunk term as a masked
quasi-attention product and carries the inter-chunk states in a loop that
keeps the state before each chunk.  Decode is the recurrent dual: a
constant-size state (B, H, N, P) updated per token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dist.sharding import constrain
from .config import ModelConfig
from .layers import acc_dtype, dense_init, normal, rms_norm


def ssm_init(generator: torch.Generator, cfg: ModelConfig, lead: tuple = (),
             device=None) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nheads = d_in // s.head_dim
    dt = cfg.pdtype()

    def const(v):
        return v.to(device=device, dtype=dt).expand(*lead, -1).clone()

    # in_proj emits [z (gate), x, B, C, dt]
    p = {
        "in_z": dense_init(generator, d, d_in, dt, lead, device),
        "in_x": dense_init(generator, d, d_in, dt, lead, device),
        "in_B": dense_init(generator, d, s.d_state, dt, lead, device),
        "in_C": dense_init(generator, d, s.d_state, dt, lead, device),
        "in_dt": dense_init(generator, d, nheads, dt, lead, device),
        "dt_bias": const(torch.zeros(nheads)),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, nheads))),
        "D": const(torch.ones(nheads)),
        "conv_w": (normal(generator, (*lead, s.d_conv, d_in), device)
                   * (1.0 / math.sqrt(s.d_conv))).to(dt),
        "conv_b": const(torch.zeros(d_in)),
        "norm": const(torch.zeros(d_in)),
        "out": dense_init(generator, d_in, d, dt, lead, device),
    }
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv over seq as a sum of shifted products (no
    cuDNN conv, whose TF32 default would round the products).
    x: (B, S, C); w: (K, C)."""
    k, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:S, :] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + S, :] * w[i]
    return F.silu(out + b)


def ssm_forward(p: dict, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    """Training/prefill path. u: (B, S, d_model)."""
    s = cfg.ssm
    bsz, S, d = u.shape
    d_in = s.expand * d
    H = d_in // s.head_dim
    P, N = s.head_dim, s.d_state
    acc = acc_dtype(cfg.cdtype())

    z = u @ p["in_z"]
    x = _causal_conv(u @ p["in_x"], p["conv_w"], p["conv_b"])
    Bm = (u @ p["in_B"]).to(acc)                                 # (B,S,N)
    Cm = (u @ p["in_C"]).to(acc)                                 # (B,S,N)
    dt = F.softplus((u @ p["in_dt"]).to(acc)
                    + p["dt_bias"].to(acc))                      # (B,S,H)
    A = -torch.exp(p["A_log"].to(acc))                           # (H,)
    xh = x.reshape(bsz, S, H, P).to(acc)
    x = constrain(x, ("batch", "seq", "ff"))

    # the reference's rule: chunks of L only when they tile S exactly and
    # there are two or more, else one chunk of S (it sets the sum order)
    L = s.chunk if (S % s.chunk == 0 and S > s.chunk) else S
    nc = S // L
    xc = xh.reshape(bsz, nc, L, H, P)
    Bc = Bm.reshape(bsz, nc, L, N)
    Cc = Cm.reshape(bsz, nc, L, N)
    dtc = dt.reshape(bsz, nc, L, H)

    dA = dtc * A                                                  # (B,nc,L,H)
    # the prefix sums accumulate in fp64 on every device, as the CPU's fp32
    # cumsum does: exp(cum_t - cum_r) cancels large sums, so the card's
    # fp32 scan order would move the decays by an ulp of |cum|
    cum = torch.cumsum(dA.to(torch.float64), dim=2).to(acc)      # (B,nc,L,H)

    # intra-chunk: Y[t] = sum_{r<=t} C_t·B_r * exp(cum_t - cum_r) dt_r x_r
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B,nc,L,L,H)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=u.device))
    # mask BEFORE exp: non-causal entries have seg > 0
    seg = torch.where(causal[None, None, :, :, None], seg, -torch.inf)
    wdt = cfg.cdtype()
    decay = torch.exp(seg).to(wdt)
    cb = torch.einsum("bctn,bcrn->bctr", Cc, Bc).to(wdt)
    w = cb[..., None] * decay                                    # (B,nc,L,L,H)
    y_intra = torch.einsum("bctrh,bcrh,bcrhp->bcthp", w.to(acc),
                           dtc.to(wdt).to(acc), xc.to(wdt).to(acc))

    # chunk-final states: S_c = sum_r exp(cum_L - cum_r) dt_r B_r x_r^T
    decay_tail = torch.exp(cum[:, :, -1:, :] - cum)               # (B,nc,L,H)
    state_c = torch.einsum("bcrh,bcrh,bcrn,bcrhp->bchnp",
                           decay_tail, dtc, Bc, xc)               # per chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])                     # (B,nc,H)

    state = torch.zeros((bsz, H, N, P), dtype=acc, device=u.device)
    prev = []                                  # the state BEFORE each chunk
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + state_c[:, c]
    prev_states = torch.stack(prev, dim=1)                       # (B,nc,H,N,P)

    # inter-chunk: Y[t] = C_t · (exp(cum_t) * prev_state)
    y_inter = torch.einsum("bctn,bcth,bchnp->bcthp",
                           Cc, torch.exp(cum), prev_states)

    y = (y_intra + y_inter).reshape(bsz, S, H, P)
    y = y + xh * p["D"].to(acc)[None, None, :, None]
    y = y.reshape(bsz, S, d_in).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.rms_eps)
    return y @ p["out"]


def ssm_decode(p: dict, cfg: ModelConfig, u: torch.Tensor, conv_buf, state):
    """Recurrent one-token step.

    u: (B, 1, d); conv_buf: (B, d_conv-1, d_in) trailing inputs;
    state: (B, H, N, P).  Returns (y, conv_buf', state')."""
    s = cfg.ssm
    bsz, _, d = u.shape
    d_in = s.expand * d
    H = d_in // s.head_dim
    P = s.head_dim
    acc = acc_dtype(cfg.cdtype())

    u0 = u[:, 0]
    z = u0 @ p["in_z"]
    x_lin = u0 @ p["in_x"]                                       # (B,d_in)
    window = torch.cat([conv_buf, x_lin[:, None, :]], dim=1)
    xconv = torch.einsum("bkc,kc->bc", window.to(acc), p["conv_w"].to(acc))
    x = F.silu(xconv + p["conv_b"].to(acc))
    new_buf = window[:, 1:, :]

    Bm = (u0 @ p["in_B"]).to(acc)                                # (B,N)
    Cm = (u0 @ p["in_C"]).to(acc)
    dt = F.softplus((u0 @ p["in_dt"]).to(acc)
                    + p["dt_bias"].to(acc))                      # (B,H)
    A = -torch.exp(p["A_log"].to(acc))
    xh = x.reshape(bsz, H, P)
    dA = torch.exp(dt * A)                                       # (B,H)
    upd = torch.einsum("bh,bn,bhp->bhnp", dt, Bm, xh)
    state = state * dA[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cm, state)
    y = y + xh * p["D"].to(acc)[None, :, None]
    y = y.reshape(bsz, d_in).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.rms_eps)
    return (y @ p["out"])[:, None, :], new_buf, state


def ssm_cache_init(cfg: ModelConfig, batch: int, n_ssm_layers: int,
                   device=None):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    return {
        "conv": torch.zeros((n_ssm_layers, batch, s.d_conv - 1, d_in),
                            dtype=cfg.cdtype(), device=device),
        "state": torch.zeros((n_ssm_layers, batch, H, s.d_state, s.head_dim),
                             dtype=acc_dtype(cfg.cdtype()), device=device),
    }
