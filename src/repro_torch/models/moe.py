"""Top-k routed mixture-of-experts MLP with capacity-based dispatch (the port
of ``src/repro/models/moe.py``).

The local path: token->expert assignments ranked per expert (a stable sort,
a count per expert and exclusive offsets), scattered into a dense (E, cap, d) buffer,
grouped GEMMs, gathered back and summed per token with ``index_add_``.
Tokens overflowing an expert's capacity are dropped (GShard semantics).
The router's top-k breaks ties by the lowest expert id, as ``lax.top_k``
does.

The shard_map path runs under a mesh of more than one device with a
``"model"`` axis, as the reference's does: every model shard holds all of
its data shard's tokens and dispatches only to the experts it owns
('expert' mode: E / model experts; 'ff' mode: the d_ff / model slice of
every expert); one ``psum`` over ``model`` combines the partial outputs,
FSDP-split expert weights are all-gathered over ``mlp_embed`` first, and
the aux loss ``pmean`` s its per-expert density and router probability over
the data axes before their product.  One body (``_moe_body``) runs under
``dist/shard_map.py``'s two drivers: every shard in lock step on plain
tensors, or this rank's shard under ``local_map`` on DTensors (the
dry-run).  At one device the reference's path computes what the local
path computes (expert offset 0; ``psum`` and ``pmean`` over axes of size
1), so the port takes the local path there.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..dist import shard_map as sm
from ..dist.sharding import current_mesh, current_rules
from .config import ModelConfig
from .layers import dense_init, normal


def moe_init(generator: torch.Generator, cfg: ModelConfig, lead: tuple = (),
             device=None) -> dict:
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert
    dt = cfg.pdtype()
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(f)

    def experts(a, b, scale):
        return (normal(generator, (*lead, e.num_experts, a, b), device)
                * scale).to(dt)

    p = {"router": dense_init(generator, d, e.num_experts, dt, lead, device),
         "wi": experts(d, f, scale_in),
         "wg": experts(d, f, scale_in),
         "wo": experts(f, d, scale_out)}
    if e.num_shared_experts:
        fs = f * e.num_shared_experts
        p["shared_wi"] = dense_init(generator, d, fs, dt, lead, device)
        p["shared_wg"] = dense_init(generator, d, fs, dt, lead, device)
        p["shared_wo"] = dense_init(generator, fs, d, dt, lead, device)
    return p


# ---------------------------------------------------------------------------
# Local capacity dispatch
# ---------------------------------------------------------------------------

def _count(ids: torch.Tensor, length: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=length)`` for ids in [0, length):
    a count of fixed length that also runs on ``meta`` tensors (the
    dry-run), where ``bincount``'s data-dependent length cannot."""
    return torch.zeros(length, dtype=torch.int64,
                       device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _dispatch_compute(x_flat, top_w, top_idx, wi, wg, wo, num_experts: int,
                      expert_offset: int, cap: int, compute_dtype):
    """Capacity-dispatch x_flat (T, d) for experts [offset, offset+E_local).

    top_idx are GLOBAL expert ids; assignments outside this range are
    dropped.  Returns the (T, d) fp32 partial output."""
    T, d = x_flat.shape
    K = top_w.shape[-1]
    e_local = wi.shape[0]
    dev = x_flat.device
    f32 = torch.float32

    expert_flat = top_idx.reshape(T * K) - expert_offset
    weight_flat = top_w.reshape(T * K)
    mine = (expert_flat >= 0) & (expert_flat < e_local)
    expert_key = torch.where(mine, expert_flat, e_local)  # strangers last
    token_flat = torch.arange(T * K, device=dev) // K

    order = torch.sort(expert_key, stable=True).indices
    sorted_e = expert_key[order]
    counts = _count(expert_key, e_local + 1)
    offsets = torch.cumsum(counts, 0) - counts           # exclusive
    rank_sorted = torch.arange(T * K, device=dev) - offsets[sorted_e]

    x_gathered = x_flat[token_flat[order]].to(compute_dtype)
    ok = sorted_e < e_local
    # the reference's .set(mode="drop"): a stranger or an assignment past
    # the capacity lands in a pad slot (row e_local or column cap) that is
    # cut off below
    se = torch.where(ok, sorted_e, e_local)
    slot = torch.clamp(rank_sorted, max=cap)
    buf = torch.zeros((e_local + 1, cap + 1, d), dtype=compute_dtype,
                      device=dev)
    buf = torch.index_put(buf, (se, slot),
                          torch.where(ok[:, None], x_gathered, 0))
    buf = buf[:e_local, :cap]

    h = torch.einsum("ecd,edf->ecf", buf.to(f32), wi.to(f32))
    g = torch.einsum("ecd,edf->ecf", buf.to(f32), wg.to(f32))
    h = (F.silu(g) * h).to(compute_dtype)
    y_e = torch.einsum("ecf,efd->ecd", h.to(f32),
                       wo.to(f32)).to(compute_dtype)

    in_cap = ok & (rank_sorted < cap)
    y_sorted = torch.where(in_cap[:, None],
                           y_e[torch.clamp(se, max=e_local - 1),
                               torch.clamp(rank_sorted, max=cap - 1)], 0.0)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=dev)
    y_assign = y_sorted[inv]
    contrib = y_assign.to(f32) * weight_flat[:, None]
    return torch.zeros((T, d), dtype=f32, device=dev).index_add_(
        0, token_flat, contrib)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, ties broken by the lowest index."""
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    return srt.values[..., :k], srt.indices[..., :k]


def _route(x_flat, router, K: int):
    logits = (x_flat @ router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = _top_k(probs, K)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_idx


def _aux_terms(e, probs, top_idx):
    """The Switch aux loss's per-expert density and mean router
    probability."""
    T = probs.shape[0]
    density = _count(top_idx.reshape(-1), e.num_experts
                     ).to(torch.float32) / (T * e.top_k)
    return density, torch.mean(probs, dim=0)


def _aux_loss(e, probs, top_idx):
    """Switch aux loss."""
    density, mean_prob = _aux_terms(e, probs, top_idx)
    return e.num_experts * torch.sum(density * mean_prob) \
        * e.router_aux_coef


def _moe_local(p, cfg: ModelConfig, x, capacity_factor: float):
    e = cfg.moe
    b, s, d = x.shape
    T = b * s
    cap = max(8, int(capacity_factor * T * e.top_k / e.num_experts))
    x_flat = x.reshape(T, d)
    probs, top_w, top_idx = _route(x_flat, p["router"], e.top_k)
    out_flat = _dispatch_compute(x_flat, top_w, top_idx, p["wi"], p["wg"],
                                 p["wo"], e.num_experts, 0, cap, cfg.cdtype())
    out = out_flat.reshape(b, s, d)
    if e.num_shared_experts:
        xe = x_flat.to(cfg.cdtype())
        hs = F.silu(xe @ p["shared_wg"]) * (xe @ p["shared_wi"])
        out = out + (hs @ p["shared_wo"]).reshape(b, s, d).to(out.dtype)
    return out.to(x.dtype), _aux_loss(e, probs, top_idx)


# ---------------------------------------------------------------------------
# shard_map path (meshes of more than one device)
# ---------------------------------------------------------------------------

def _weight_specs(e, rules):
    """Spec tuples of the expert weights under the active rules."""
    ax = rules.get
    if e.shard_mode == "expert" and ax("experts"):
        wi = (ax("experts"), ax("expert_ff_in"), ax("moe_ff"))
        wo = (ax("experts"), ax("moe_ff"), ax("expert_ff_in"))
    else:
        wi = (None, ax("expert_ff_in"), ax("moe_ff"))
        wo = (None, ax("moe_ff"), ax("expert_ff_in"))
    return wi, wo


def _moe_body(cfg: ModelConfig, capacity_factor: float, e_local: int,
              expert_mode: bool, fsdp_axes: tuple, dp_axes: tuple,
              x_l, router, wi, wg, wo, *shared):
    """One shard's MoE (the reference's ``shard_map`` body), as a
    ``dist.shard_map`` generator: yields its collectives, returns (out,
    aux)."""
    e = cfg.moe
    bl, sl, d = x_l.shape
    T = bl * sl
    cap = max(8, int(capacity_factor * T * e.top_k / max(e.num_experts, 1)))
    # ZeRO-3: reassemble the weight blocks held on the DP axes
    for a in fsdp_axes:
        router = yield sm.all_gather(router, a, 0)
        wi = yield sm.all_gather(wi, a, 1)
        wg = yield sm.all_gather(wg, a, 1)
        wo = yield sm.all_gather(wo, a, 2)
    x_flat = x_l.reshape(T, d)
    probs, top_w, top_idx = _route(x_flat, router, e.top_k)
    offset = (yield sm.axis_index("model")) * e_local if expert_mode else 0
    out_flat = _dispatch_compute(x_flat, top_w, top_idx, wi, wg, wo,
                                 e.num_experts, offset, cap, cfg.cdtype())
    # expert mode sums the shards' disjoint expert sets, ff mode the
    # d_ff slices: one psum either way
    out_flat = yield sm.psum(out_flat, "model")
    out = out_flat.reshape(bl, sl, d).to(x_l.dtype)
    if e.num_shared_experts:
        swi, swg, swo = shared
        for a in fsdp_axes:
            swi = yield sm.all_gather(swi, a, 0)
            swg = yield sm.all_gather(swg, a, 0)
            swo = yield sm.all_gather(swo, a, 1)
        xe = x_flat.to(cfg.cdtype())
        hs = (F.silu(xe @ swg) * (xe @ swi)) @ swo
        if swo.shape[0] != e.d_ff_expert * e.num_shared_experts:
            hs = yield sm.psum(hs, "model")     # d_ff split over model
        out = out + hs.reshape(bl, sl, d).to(out.dtype)
    density, mean_prob = _aux_terms(e, probs, top_idx)
    if dp_axes:
        # pmean BEFORE the (nonlinear) product: the mean of the shards'
        # aux losses is not the global one
        density = yield sm.pmean(density, dp_axes)
        mean_prob = yield sm.pmean(mean_prob, dp_axes)
    aux = e.num_experts * torch.sum(density * mean_prob) * e.router_aux_coef
    return out, aux


def _moe_shard_map(p, cfg: ModelConfig, x, capacity_factor: float):
    e = cfg.moe
    mesh = current_mesh()
    rules = current_rules()
    dp = rules.get("batch")
    dp_axes = tuple(dp) if isinstance(dp, (tuple, list)) else (
        (dp,) if dp else ())
    fsdp = rules.get("mlp_embed")
    fsdp_axes = () if fsdp is None else (
        (fsdp,) if isinstance(fsdp, str) else tuple(fsdp))
    expert_mode = bool(e.shard_mode == "expert" and rules.get("experts"))
    e_local = e.num_experts // mesh.shape["model"] if expert_mode \
        else e.num_experts
    wi_spec, wo_spec = _weight_specs(e, rules)
    x_spec = (dp if dp else None, None, None)
    in_specs = [x_spec, (rules.get("embed"), None), wi_spec, wi_spec,
                wo_spec]
    args = [x, p["router"], p["wi"], p["wg"], p["wo"]]
    if e.num_shared_experts:
        mlp = (rules.get("mlp_embed"), rules.get("ff"))
        in_specs += [mlp, mlp, mlp[::-1]]
        args += [p["shared_wi"], p["shared_wg"], p["shared_wo"]]
    body = functools.partial(_moe_body, cfg, capacity_factor, e_local,
                             expert_mode, fsdp_axes, dp_axes)
    out, aux = sm.shard_map(body, mesh, in_specs, (x_spec, ()), args)
    return out.to(x.device), aux.to(x.device)


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: float = 1.25):
    """x: (B, S, d) -> (out, aux_loss)."""
    mesh = current_mesh()
    rules = current_rules()
    if (mesh is not None and rules is not None and "model" in mesh.axis_names
            and mesh.devices.size > 1):
        return _moe_shard_map(p, cfg, x, capacity_factor)
    return _moe_local(p, cfg, x, capacity_factor)


def moe_apply_dense(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Dense-dispatch oracle (every expert computes every token): O(E)
    FLOPs, used only by tests to validate the capacity dispatch above."""
    e = cfg.moe
    f32 = torch.float32
    logits = (x @ p["router"]).to(f32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = _top_k(probs, e.top_k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(top_idx, e.num_experts).to(f32)
    combine = torch.einsum("bske,bsk->bse", onehot, top_w)
    xe = x.to(f32)
    h = torch.einsum("bsd,edf->bsef", xe, p["wi"].to(f32))
    g = torch.einsum("bsd,edf->bsef", xe, p["wg"].to(f32))
    h = F.silu(g) * h
    y = torch.einsum("bsef,efd->bsed", h, p["wo"].to(f32))
    out = torch.einsum("bsed,bse->bsd", y, combine)
    if e.num_shared_experts:
        hs = F.silu(xe @ p["shared_wg"].to(f32)) \
            * (xe @ p["shared_wi"].to(f32))
        out = out + hs @ p["shared_wo"].to(f32)
    return out.to(x.dtype)
