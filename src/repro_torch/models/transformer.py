"""Generic decoder-only LM assembled from :class:`ModelConfig` (the port of
``src/repro/models/transformer.py``).

Covers all ten assigned architectures through composition: attention
patterns per layer ("full" / "local"), MoE MLPs, Mamba2 SSD blocks and the
Zamba2 hybrid (SSM backbone + a weight-shared attention block every
period), token or precomputed-embedding inputs.

The parameter tree is the reference's: parameters are stacked per
period slot (``params["period"]["s<j>"]`` leaves carry a leading axis of
``num_layers // len(layer_pattern)``), the remainder layers sit in
``params["tail"]``.  Where the reference scans over periods, the port
loops over them.  ``forward`` and ``decode_step`` run their fp32 products
in full fp32 (``core.expr.full_fp32``: no TF32 on the card).

Decode caches are updated in place: ``decode_step`` writes the new KV
entry, SSM state and conv window into the cache it is given and returns
that cache with ``pos`` advanced (the reference returns a new tree).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
from torch.overrides import _get_current_function_mode_stack
from torch.utils.checkpoint import checkpoint

from ..core.expr import full_fp32
from ..dist.sharding import constrain
from .attention import attn_decode, attn_forward, attn_init
from .config import ModelConfig
from .layers import (acc_dtype, mlp_apply, mlp_init, normal, rms_norm,
                     softcap)
from .moe import moe_apply, moe_init
from .ssm import ssm_decode, ssm_forward, ssm_init


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensor leaves of a tree of dicts and lists in the reference's
    order (``jax.tree.leaves``: dict keys sorted, list entries in order);
    None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves) -> Any:
    """A tree of ``tree``'s structure whose leaves are ``leaves``, given in
    :func:`tree_leaves` order (None stays None)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(tree)


# ---------------------------------------------------------------------------
# Block specs
# ---------------------------------------------------------------------------

def block_kinds(cfg: ModelConfig) -> list[str]:
    """Per-layer kind sequence ('full' | 'local' | 'ssm'), len num_layers."""
    return [cfg.pattern_for_layer(i) for i in range(cfg.num_layers)]


def _num_periods(cfg: ModelConfig) -> tuple[int, int]:
    p = len(cfg.layer_pattern)
    return cfg.num_layers // p, cfg.num_layers % p


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(gen, cfg: ModelConfig, kind: str, lead: tuple,
                device) -> dict:
    dt = cfg.pdtype()
    d = cfg.d_model

    def zeros():
        return torch.zeros((*lead, d), dtype=dt, device=device)

    if kind == "ssm":
        return {"norm": zeros(), "ssm": ssm_init(gen, cfg, lead, device)}
    p = {"norm1": zeros(), "attn": attn_init(gen, cfg, lead, device),
         "norm2": zeros()}
    if cfg.moe is not None:
        p["moe"] = moe_init(gen, cfg, lead, device)
    elif cfg.d_ff:
        p["mlp"] = mlp_init(gen, cfg, lead=lead, device=device)
    return p


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> dict:
    """Random parameters in the reference's tree layout, every draw from
    ``generator`` (on its device), placed on ``device`` (default: the
    generator's)."""
    device = torch.device(device) if device is not None else generator.device
    nper, ntail = _num_periods(cfg)
    pat = cfg.layer_pattern
    dt = cfg.pdtype()
    d = cfg.d_model
    params: dict[str, Any] = {
        "embed": (normal(generator, (cfg.vocab_size, d), device)
                  * 0.02).to(dt)}
    if not cfg.tie_embeddings:
        params["unembed"] = (normal(generator, (cfg.vocab_size, d), device)
                             * 0.02).to(dt)
    params["final_norm"] = torch.zeros((d,), dtype=dt, device=device)
    if nper > 0:
        params["period"] = {
            f"s{j}": _block_init(generator, cfg, pat[j], (nper,), device)
            for j in range(len(pat))}
    params["tail"] = [_block_init(generator, cfg, pat[i % len(pat)], (),
                                  device) for i in range(ntail)]
    if cfg.shared_attn_every:
        # Zamba2: one weight-shared attention+MLP block
        params["shared"] = {
            "norm1": torch.zeros((d,), dtype=dt, device=device),
            "attn": attn_init(generator, cfg, (), device),
            "norm2": torch.zeros((d,), dtype=dt, device=device),
            "mlp": mlp_init(generator, cfg, device=device),
        }
    return params


# ---------------------------------------------------------------------------
# Forward (training / prefill)
# ---------------------------------------------------------------------------

def _remat_contexts():
    """``checkpoint``'s ``context_fn``: the recompute in the backward runs
    under the torch function modes the forward ran under (the dry-run's
    per-device partitioner is one); ``checkpoint`` itself carries only a
    device context over.  With no mode active both are empty."""
    modes = _get_current_function_mode_stack()

    @contextlib.contextmanager
    def recompute():
        with contextlib.ExitStack() as stack:
            for mode in modes:
                stack.enter_context(mode)
            yield

    return contextlib.nullcontext(), recompute()


def _embed(params: dict, cfg: ModelConfig, tokens, embeds) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        x = params["embed"][tokens.long()].to(cfg.cdtype())
    else:
        x = embeds.to(cfg.cdtype())
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(float(cfg.d_model)),
                             dtype=torch.float32).to(x.dtype)
    return x


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = torch.einsum("bsd,vd->bsv", x, head.to(x.dtype))
    return softcap(logits, cfg.final_logit_softcap)


def _mlp_part(p: dict, cfg: ModelConfig, x):
    """The block's second half: (x + MoE / MLP, aux)."""
    if cfg.moe is not None:
        m, aux = moe_apply(p["moe"], cfg, rms_norm(x, p["norm2"], cfg.rms_eps),
                           capacity_factor=cfg.moe.capacity_factor)
        return x + m, aux
    if cfg.d_ff:
        x = x + mlp_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.rms_eps),
                          cfg.mlp_type)
    return x, 0.0


def _apply_block(p: dict, cfg: ModelConfig, kind: str, x, positions):
    if kind == "ssm":
        return x + ssm_forward(p["ssm"], cfg, rms_norm(x, p["norm"],
                                                       cfg.rms_eps)), 0.0
    x = x + attn_forward(p["attn"], cfg, rms_norm(x, p["norm1"], cfg.rms_eps),
                         positions, kind)
    return _mlp_part(p, cfg, x)


def _apply_shared(params: dict, cfg: ModelConfig, x, positions):
    sp = params["shared"]
    x = x + attn_forward(sp["attn"], cfg,
                         rms_norm(x, sp["norm1"], cfg.rms_eps), positions,
                         "full")
    return x + mlp_apply(sp["mlp"], rms_norm(x, sp["norm2"], cfg.rms_eps),
                         cfg.mlp_type)


def _stacked_slices(params: dict, cfg: ModelConfig) -> list:
    """Per period, its slots' parameter trees: views of the stacked
    leaves, cut by one ``unbind`` per leaf (under autograd its backward
    stacks the periods' gradients once)."""
    nper, _ = _num_periods(cfg)
    out = [{} for _ in range(nper)]
    for j in range(len(cfg.layer_pattern)):
        slot = params["period"][f"s{j}"]
        leaves = [v.unbind(0) for v in tree_leaves(slot)]
        for t in range(nper):
            out[t][f"s{j}"] = tree_unflatten(slot, [v[t] for v in leaves])
    return out


def forward(params: dict, cfg: ModelConfig, tokens=None, embeds=None):
    """Returns (logits (B,S,V), aux_loss).  With gradients on and
    ``cfg.remat == "block"``, each pattern period runs under
    ``torch.utils.checkpoint`` (its activations are recomputed in the
    backward, as the reference's ``jax.checkpoint`` of the period body);
    with gradients off the ops are the same either way."""
    with full_fp32():
        x = _embed(params, cfg, tokens, embeds)
        s = x.shape[1]
        x = constrain(x, ("batch", "seq", "embed"))
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        pat = cfg.layer_pattern
        nper, ntail = _num_periods(cfg)

        def carry(x):
            # the period-boundary residual; the reference scans the
            # periods, so its carry has this one sharding from the first
            # period on
            return constrain(x, ("batch", "seq_act", "embed"))

        def period(x, aux, pp):
            x = carry(x)
            for j, kind in enumerate(pat):
                x, a = _apply_block(pp[f"s{j}"], cfg, kind, x, positions)
                aux = aux + a
            if cfg.shared_attn_every:
                x = _apply_shared(params, cfg, x, positions)
            return carry(x), aux

        remat = cfg.remat == "block" and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for pp in (_stacked_slices(params, cfg) if nper else []):
            if remat:
                # the blocks draw no random numbers: no RNG state to keep
                x, aux = checkpoint(period, x, aux, pp, use_reentrant=False,
                                    preserve_rng_state=False,
                                    context_fn=_remat_contexts)
            else:
                x, aux = period(x, aux, pp)
        for i in range(ntail):
            x, a = _apply_block(params["tail"][i], cfg, pat[i % len(pat)], x,
                                positions)
            aux = aux + a

        logits = constrain(_head(params, cfg, x), ("batch", "seq", "vocab"))
    return logits, aux


def lm_loss(params: dict, cfg: ModelConfig, tokens=None, embeds=None,
            labels=None, loss_chunk: int = 512):
    """Next-token cross-entropy, summed per seq chunk in fp32. Returns a
    scalar loss."""
    logits, aux = forward(params, cfg, tokens=tokens, embeds=embeds)
    b, s, v = logits.shape
    if labels is None:
        labels = torch.roll(tokens, -1, dims=1)
    c = loss_chunk if (s % loss_chunk == 0 and s > loss_chunk) else s
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for i in range(0, s, c):
        lg = logits[:, i:i + c].to(torch.float32)
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels[:, i:i + c, None].long())[..., 0]
        total = total + torch.sum(lse - gold)
    return total / (b * s) + aux


# ---------------------------------------------------------------------------
# Cached decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> dict:
    """Per-slot caches, stacked over periods (the parameter layout); ``pos``
    is a host int."""
    kinds = cfg.layer_pattern
    nper, ntail = _num_periods(cfg)
    kv, hd = cfg.num_kv_heads, cfg.hd()
    dt = cfg.cdtype()

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv_cache(n, seq):
        return {"k": zeros((n, batch, seq, kv, hd)),
                "v": zeros((n, batch, seq, kv, hd)),
                "kpos": torch.full((n, seq), -1, dtype=torch.int32,
                                   device=device)}

    def slot_cache(kind, n):
        if kind == "ssm":
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            H = d_in // s.head_dim
            return {"conv": zeros((n, batch, s.d_conv - 1, d_in)),
                    "state": zeros((n, batch, H, s.d_state, s.head_dim),
                                   acc_dtype(dt))}
        # local layers only need window-sized ring KV; global layers need full
        seq = max_seq if kind == "full" else min(
            max_seq, (cfg.sliding_window or max_seq))
        return kv_cache(n, seq)

    cache: dict[str, Any] = {"pos": 0}
    if nper > 0:
        cache["period"] = {f"s{j}": slot_cache(kinds[j], nper)
                           for j in range(len(kinds))}
    cache["tail"] = [slot_cache(kinds[i % len(kinds)], 1)
                     for i in range(ntail)]
    if cfg.shared_attn_every:
        cache["shared"] = kv_cache(nper, max_seq)
    return cache


def _decode_block(p, cfg: ModelConfig, kind: str, x, slot: dict, pos: int):
    """One block's decode step against the cache views ``slot``, which it
    updates in place."""
    if kind == "ssm":
        h, conv, state = ssm_decode(p["ssm"], cfg,
                                    rms_norm(x, p["norm"], cfg.rms_eps),
                                    slot["conv"], slot["state"])
        slot["conv"].copy_(conv)
        slot["state"].copy_(state)
        return x + h
    h, _, _, _ = attn_decode(p["attn"], cfg,
                             rms_norm(x, p["norm1"], cfg.rms_eps),
                             slot["k"], slot["v"], slot["kpos"], pos, kind)
    return _mlp_part(p, cfg, x + h)[0]


def decode_step(params: dict, cfg: ModelConfig, cache: dict, tokens=None,
                embeds=None):
    """One-token decode. tokens: (B, 1) int / embeds: (B, 1, d).
    Returns (logits (B, 1, V), cache), the cache updated in place."""
    pos = cache["pos"]
    pat = cfg.layer_pattern
    nper, ntail = _num_periods(cfg)
    with full_fp32():
        x = _embed(params, cfg, tokens, embeds)
        for t in range(nper):
            for j, kind in enumerate(pat):
                pp = tree_map(lambda v, t=t: v[t], params["period"][f"s{j}"])
                pc = tree_map(lambda v, t=t: v[t], cache["period"][f"s{j}"])
                x = _decode_block(pp, cfg, kind, x, pc, pos)
            if cfg.shared_attn_every:
                # zamba2: the shared block after every period, each
                # invocation with a KV cache of its own
                sp, sc = params["shared"], cache["shared"]
                h, _, _, _ = attn_decode(
                    sp["attn"], cfg, rms_norm(x, sp["norm1"], cfg.rms_eps),
                    sc["k"][t], sc["v"][t], sc["kpos"][t], pos, "full")
                x = x + h
                x = x + mlp_apply(sp["mlp"],
                                  rms_norm(x, sp["norm2"], cfg.rms_eps),
                                  cfg.mlp_type)
        for i in range(ntail):
            tc = tree_map(lambda v: v[0], cache["tail"][i])
            x = _decode_block(params["tail"][i], cfg, pat[i % len(pat)], x,
                              tc, pos)
        logits = _head(params, cfg, x)
    cache["pos"] = pos + 1
    return logits, cache
