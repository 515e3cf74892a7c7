"""The port's models in bf16, as the production configs run (``param_dtype``
and ``compute_dtype`` ``bfloat16``), against the reference's, on the CPU,
with the reference's bf16 parameters carried over by ``params_from_numpy``.

Where the reference contracts bf16 operands into fp32
(``preferred_element_type``) and runs the softmax and the norms in fp32, the
port casts to fp32 itself (``torch.einsum`` on bf16 returns bf16).  Two
kinds of checks hold those casts:

* bit for bit, up to one bf16 unit in the last place: ``rms_norm``,
  attention (``attn_forward`` and the ring-buffer ``attn_decode``, with
  and without a logit softcap) and the routed MoE dispatch.  Rounding the
  attention scores, the norm or an expert's product to bf16 breaks it.
* the SSD block, the whole forward, the decode replay and greedy
  generation, whose bf16 elementwise chains (``exp``, ``silu``, the causal
  conv) round differently in XLA and in torch: each package's bf16 output
  is measured against the fp32 answer on the same parameters (the
  reference's fp32 forward on the bf16 values), and the port's mean error
  may not exceed the reference's by more than a quarter, nor its largest by
  more than 2.5x.  Keeping the SSD state or its intra-chunk sum in bf16
  breaks it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attention
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.serving.decode import generate as ref_generate
from repro.serving.decode import prefill as ref_prefill
from repro_torch import configs
from repro_torch.models import (attention, forward, layers, moe,
                                params_from_numpy, ssm)
from repro_torch.serving import generate, prefill

BF16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
MEAN_RATIO, MAX_RATIO = 1.25, 2.5


def _cfgs(arch):
    return (dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                                **BF16),
            dataclasses.replace(configs.get_config(arch, smoke=True),
                                **BF16))


def _bf16(shape, seed, scale=0.5):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * scale
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _f32(tree):
    return jax.tree.map(lambda v: v.astype(jnp.float32)
                        if v.dtype == jnp.bfloat16 else v, tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def assert_within_ulp(got, want, what):
    """``got`` and ``want`` (both bf16) equal but for rare single-ulp
    flips: no element more than one bf16 ulp apart at the scale of its row
    (the larger of its magnitude and its last axis' rms, so that a flip in
    a sum that cancels counts at the scale of its terms), and at most 1% of
    the elements apart at all."""
    g, w = _np(got), _np(want)
    assert got.dtype == torch.bfloat16, what
    scale = np.maximum(np.abs(w), np.sqrt((w * w).mean(-1, keepdims=True)))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(scale, 2.0 ** -126))) - 7)
    worst = float((np.abs(g - w) / ulp).max())
    apart = float((g != w).mean())
    assert worst <= 1.0 and apart <= 0.01, \
        f"{what}: {worst} bf16 ulps apart at most, {apart:.2%} of them apart"


def assert_as_close_to_fp32(got, want, truth, what):
    """The port's bf16 ``got`` is about as close to the fp32 answer
    ``truth`` as the reference's bf16 ``want``."""
    t = _np(truth)
    mine, theirs = np.abs(_np(got) - t), np.abs(_np(want) - t)
    assert np.isfinite(mine).all(), what
    assert mine.mean() <= MEAN_RATIO * theirs.mean(), \
        f"{what}: mean error {mine.mean()} against {theirs.mean()}"
    assert mine.max() <= MAX_RATIO * theirs.max(), \
        f"{what}: max error {mine.max()} against {theirs.max()}"


def test_bf16_rms_norm_matches_reference_to_the_ulp():
    xj, xt = _bf16((2, 16, 64), 0)
    wj, wt = _bf16((64,), 1, 0.1)
    assert_within_ulp(layers.rms_norm(xt, wt, 1e-6),
                      ref_layers.rms_norm(xj, wj, 1e-6), "rms_norm")


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-27b"])
def test_bf16_attention_matches_reference_to_the_ulp(arch):
    """The q-chunked forward and eight ring-buffer decode steps (gemma2:
    the logit softcap)."""
    rcfg, cfg = _cfgs(arch)
    rp = ref_attention.attn_init(jax.random.key(0), rcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, rp), cfg)
    xj, xt = _bf16((2, 32, rcfg.d_model), 2)
    pos = np.arange(32, dtype=np.int32)
    assert_within_ulp(
        attention.attn_forward(p, cfg, xt, torch.from_numpy(pos), "full"),
        ref_attention.attn_forward(rp, rcfg, xj, jnp.asarray(pos), "full"),
        f"{arch} attn_forward")
    # decode: each step from the reference's cache, so that one step's
    # flip does not carry into the next
    steps, kv, hd = 8, rcfg.num_kv_heads, rcfg.hd()
    rk = rv = jnp.zeros((2, steps, kv, hd), jnp.bfloat16)
    rkp = jnp.full((steps,), -1, jnp.int32)
    gots, wants = [], []
    for t in range(steps):
        k, v = (torch.from_numpy(np.asarray(a.astype(jnp.float32)))
                .to(torch.bfloat16) for a in (rk, rv))
        kp = torch.from_numpy(np.array(rkp))
        want, rk, rv, rkp = ref_attention.attn_decode(
            rp, rcfg, xj[:, t:t + 1], rk, rv, rkp, t, "full")
        got, k, v, kp = attention.attn_decode(p, cfg, xt[:, t:t + 1], k, v,
                                              kp, t, "full")
        assert kp.tolist() == np.asarray(rkp).tolist()
        gots.append(torch.cat([got[:, 0], k[:, t].flatten(1),
                               v[:, t].flatten(1)], dim=1))
        wants.append(jnp.concatenate([want[:, 0], rk[:, t].reshape(2, -1),
                                      rv[:, t].reshape(2, -1)], axis=1))
    # the outputs and the new K and V entries of all steps
    assert_within_ulp(torch.stack(gots), jnp.stack(wants),
                      f"{arch} attn_decode")


def test_bf16_moe_dispatch_matches_reference_to_the_ulp():
    rcfg, cfg = _cfgs("grok-1-314b")
    rp = ref_moe.moe_init(jax.random.key(0), rcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, rp), cfg)
    xj, xt = _bf16((2, 16, rcfg.d_model), 4, 0.3)
    want, want_aux = ref_moe._moe_local(rp, rcfg, xj, 1.25)
    got, aux = moe._moe_local(p, cfg, xt, 1.25)
    assert_within_ulp(got, want, "grok _moe_local")
    assert abs(float(aux) - float(want_aux)) <= 1e-6


def test_bf16_ssd_is_as_close_to_fp32_as_the_reference():
    """``ssm_forward`` over two chunks and six ``ssm_decode`` steps."""
    rcfg, cfg = _cfgs("mamba2-370m")
    rcfg32 = ref_configs.get_config("mamba2-370m", smoke=True)
    rp = ref_ssm.ssm_init(jax.random.key(0), rcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, rp), cfg)
    xj, xt = _bf16((2, 32, rcfg.d_model), 3)
    assert_as_close_to_fp32(
        ssm.ssm_forward(p, cfg, xt), ref_ssm.ssm_forward(rp, rcfg, xj),
        ref_ssm.ssm_forward(_f32(rp), rcfg32, xj.astype(jnp.float32)),
        "ssm_forward")
    rc, rc32, pc = (ref_ssm.ssm_cache_init(rcfg, 2, 1),
                    ref_ssm.ssm_cache_init(rcfg32, 2, 1),
                    ssm.ssm_cache_init(cfg, 2, 1))
    assert pc["state"].dtype == torch.float32
    (rconv, rst), (tconv, tst) = ((rc["conv"][0], rc["state"][0]),
                                  (rc32["conv"][0], rc32["state"][0]))
    conv, st = pc["conv"][0], pc["state"][0]
    for t in range(6):
        want, rconv, rst = ref_ssm.ssm_decode(rp, rcfg, xj[:, t:t + 1],
                                              rconv, rst)
        truth, tconv, tst = ref_ssm.ssm_decode(
            _f32(rp), rcfg32, xj[:, t:t + 1].astype(jnp.float32), tconv, tst)
        got, conv, st = ssm.ssm_decode(p, cfg, xt[:, t:t + 1], conv, st)
        assert_as_close_to_fp32(got, want, truth, f"ssm_decode step {t}")
    assert_as_close_to_fp32(st, rst, tst, "the SSD state")


@pytest.fixture(scope="module")
def ref_bf16():
    """Per arch, computed once: the reference's bf16 params, tokens, its
    bf16 forward and prefill logits, the fp32 forward on the same values,
    and greedy generations."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg, _cfg = _cfgs(arch)
            rcfg32 = ref_configs.get_config(arch, smoke=True)
            rp = ref_init(jax.random.key(0), rcfg)
            rng = np.random.default_rng(0)
            toks = rng.integers(0, rcfg.vocab_size, (2, 32)).astype(np.int32)
            prompts = rng.integers(0, rcfg.vocab_size, (2, 8)).astype(
                np.int32)
            logits, _ = ref_forward(rp, rcfg, tokens=jnp.asarray(toks))
            truth, _ = ref_forward(_f32(rp), rcfg32, tokens=jnp.asarray(toks))
            _, dec = ref_prefill(rp, rcfg, tokens=jnp.asarray(toks),
                                 max_seq=32)
            gen = ref_generate(rp, rcfg, jnp.asarray(prompts), 6)
            cache[arch] = {"tree": jax.tree.map(np.asarray, rp),
                           "params": rp, "cfg": rcfg, "tokens": toks,
                           "prompts": prompts, "logits": logits,
                           "truth": truth, "prefill": dec,
                           "generate": np.asarray(gen)}
        return cache[arch]
    return get


ARCHS = ["qwen2-1.5b", "mamba2-370m"]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_is_as_close_to_fp32_as_the_reference(arch, ref_bf16):
    ref = ref_bf16(arch)
    _rcfg, cfg = _cfgs(arch)
    p = params_from_numpy(ref["tree"], cfg)
    with torch.inference_mode():
        logits, _ = forward(p, cfg, tokens=torch.from_numpy(ref["tokens"]))
    assert logits.dtype == torch.bfloat16
    assert_as_close_to_fp32(logits, ref["logits"], ref["truth"],
                            f"{arch} forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_is_as_close_to_fp32_as_the_reference(arch, ref_bf16):
    ref = ref_bf16(arch)
    _rcfg, cfg = _cfgs(arch)
    p = params_from_numpy(ref["tree"], cfg)
    cache, dec = prefill(p, cfg, tokens=torch.from_numpy(ref["tokens"]),
                         max_seq=32)
    assert cache["pos"] == 32 and dec.dtype == torch.bfloat16
    assert_as_close_to_fp32(dec, ref["prefill"], ref["truth"],
                            f"{arch} prefill")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_greedy_tokens_are_the_references_argmax(arch, ref_bf16):
    """Every token the port's greedy ``generate`` picks is, under the
    reference's own bf16 forward over the same sequence, within the two
    packages' logit gap on the prompt of that step's maximum.  qwen2's
    tokens equal the reference's; mamba2's part where two candidates lie
    inside that gap."""
    ref = ref_bf16(arch)
    _rcfg, cfg = _cfgs(arch)
    p = params_from_numpy(ref["tree"], cfg)
    prompts = torch.from_numpy(ref["prompts"])
    got = generate(p, cfg, prompts, 6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    assert torch.equal(got, generate(p, cfg, prompts, 6))
    _cache, lg = prefill(p, cfg, tokens=prompts, max_seq=14)
    first = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
    seq = np.concatenate([ref["prompts"], first[:, None].numpy(),
                          got.numpy()], axis=1)
    want, _ = ref_forward(ref["params"], ref["cfg"],
                          tokens=jnp.asarray(seq[:, :-1]))
    want = _np(want)
    gap = float(np.abs(_np(lg) - want[:, :8]).max())
    s = ref["prompts"].shape[1]
    for t in range(s - 1, seq.shape[1] - 1):
        chosen = want[np.arange(2), t, seq[:, t + 1]]
        assert (chosen >= want[:, t].max(-1) - gap).all(), \
            f"{arch}: step {t} picked a token outside the gap {gap}"
    if arch == "qwen2-1.5b":
        np.testing.assert_array_equal(got.numpy(), ref["generate"])
