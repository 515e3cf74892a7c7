"""GQA attention: full / sliding-window / alternating patterns, logit
softcap, QK-norm, QKV bias, RoPE; memory-bounded chunked prefill and
single-token cached decode (the port of ``src/repro/models/attention.py``).

Scores are never materialized (B, H, S, S): the query axis is chunked so
the live intermediate is (B, H, cq, S_kv).  Where the reference contracts
with ``preferred_element_type=float32``, the port casts the operands to
fp32 first (``torch.einsum`` on bf16 returns bf16); softmax runs in fp32
and its weights are cast back to the value dtype before the PV product.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..dist.sharding import constrain
from .config import ModelConfig
from .layers import dense_init, rms_norm, rotary, softcap

NEG = -2.3819763e38  # large negative for masked logits (bf16-safe)


def attn_init(generator: torch.Generator, cfg: ModelConfig, lead: tuple = (),
              device=None) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd()
    dt = cfg.pdtype()
    p = {
        "wq": dense_init(generator, d, h * hd, dt, lead, device),
        "wk": dense_init(generator, d, kv * hd, dt, lead, device),
        "wv": dense_init(generator, d, kv * hd, dt, lead, device),
        "wo": dense_init(generator, h * hd, d, dt, lead, device),
    }

    def zeros(n):
        return torch.zeros((*lead, n), dtype=dt, device=device)

    if cfg.qkv_bias:
        p["bq"] = zeros(h * hd)
        p["bk"], p["bv"] = zeros(kv * hd), zeros(kv * hd)
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = zeros(hd), zeros(hd)
    return p


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd()
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    q = rotary(q, positions, cfg.rope_theta)
    k = rotary(k, positions, cfg.rope_theta)
    q = constrain(q, ("batch", "seq", "heads", None))
    k = constrain(k, ("batch", "seq", "kv_heads", None))
    v = constrain(v, ("batch", "seq", "kv_heads", None))
    return q, k, v


def _expand_kv(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by group repetition (exact)."""
    kv = x.shape[2]
    if kv == h:
        return x
    return torch.repeat_interleave(x, h // kv, dim=2)


def _masked_attend(q, k, v, q_pos, k_pos, cfg: ModelConfig,
                   window: Optional[int]):
    """q: (B, cq, H, hd); k/v: (B, S, H, hd); positions 1-D per axis.
    Returns (B, cq, H, hd)."""
    scale = cfg.hd() ** -0.5
    f32 = torch.float32
    scores = torch.einsum("bqhe,bshe->bhqs", q.to(f32), k.to(f32)) * scale
    scores = constrain(scores, ("batch", "heads", None, None))
    scores = softcap(scores, cfg.attn_logit_softcap)
    mask = k_pos[None, :] <= q_pos[:, None]                 # causal
    if window is not None:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    scores = torch.where(mask[None, None], scores, NEG)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshe->bqhe", w.to(v.dtype).to(f32), v.to(f32))
    return out.to(v.dtype)


def attn_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, pattern: str) -> torch.Tensor:
    """Full-sequence (training / prefill) path with q-chunking."""
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.hd()
    window = cfg.sliding_window if pattern == "local" else None
    q, k, v = _project_qkv(p, cfg, x, positions)
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)

    # positions: (S,) shared across the batch
    cq = cfg.q_chunk if (s % cfg.q_chunk == 0 and s > cfg.q_chunk) else s
    outs = [_masked_attend(q[:, i:i + cq], k, v, positions[i:i + cq],
                           positions, cfg, window)
            for i in range(0, s, cq)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    out = out.reshape(b, s, h * hd)
    out = constrain(out, ("batch", "seq", "heads"))
    return out @ p["wo"]


# ---------------------------------------------------------------------------
# Cached decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCacheSpec:
    max_seq: int

    def init(self, cfg: ModelConfig, batch: int, n_attn_layers: int,
             dtype=None, device=None) -> dict:
        kv, hd = cfg.num_kv_heads, cfg.hd()
        dt = dtype or cfg.cdtype()
        shape = (n_attn_layers, batch, self.max_seq, kv, hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device),
                "pos": 0}


def attn_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache_k, cache_v,
                cache_kpos, pos: int, pattern: str):
    """One-token decode with a ring-buffer KV cache.

    x: (B, 1, d); cache_k/v: (B, S_cap, KV, hd); cache_kpos: (S_cap,)
    absolute position of each cache entry (-1 = empty); pos: tokens already
    decoded (a host int).  Sliding-window layers allocate S_cap = window and
    wrap.  Keys are stored post-RoPE at their absolute position.  The new
    entry is written into ``cache_k``, ``cache_v`` and ``cache_kpos`` in
    place at ``pos % S_cap``; returns (out, cache_k, cache_v, cache_kpos)."""
    b, one, d = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd()
    g = h // kv
    window = cfg.sliding_window if pattern == "local" else None
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    s_cap = cache_k.shape[1]
    widx = pos % s_cap
    cache_k[:, widx] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, widx] = v_new[:, 0].to(cache_v.dtype)
    cache_kpos[widx] = pos
    # decode is bandwidth-bound: keep KV grouped (no head expansion)
    qg = q.reshape(b, 1, kv, g, hd)
    scale = hd ** -0.5
    f32 = torch.float32
    scores = torch.einsum("bqnge,bsne->bngqs", qg.to(f32),
                          cache_k.to(q.dtype).to(f32)) * scale
    scores = softcap(scores, cfg.attn_logit_softcap)
    mask = (cache_kpos >= 0) & (cache_kpos <= pos)
    if window is not None:
        mask = mask & (pos - cache_kpos < window)
    scores = torch.where(mask[None, None, None, None], scores, NEG)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngqs,bsne->bqnge", w.to(cache_v.dtype),
                       cache_v).to(x.dtype)
    out = out.reshape(b, 1, h * hd)
    return out @ p["wo"], cache_k, cache_v, cache_kpos
