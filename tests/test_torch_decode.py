"""The port's decode path (``repro_torch.serving.decode``) on the CPU:
``prefill`` (the decode replay) reproduces ``forward``'s logits for every
family of ``tests/test_decode.py`` (KV caches, SWA ring buffers beyond the
window, SSM states, zamba2's shared block, MoE at T = B, embeddings mode)
to its 2e-3; greedy ``generate`` gives the reference's tokens on the
reference's parameters carried over by ``params_from_numpy``; a fresh
``generate`` starts from a fresh cache, so two calls agree; temperature
sampling follows its ``torch.Generator``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init
from repro.serving.decode import generate as ref_generate
from repro.serving.decode import prefill as ref_prefill
from repro_torch import configs
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, params_from_numpy, tree_map)
from repro_torch.serving import build_serve_step, generate, prefill

DECODE_ARCHS = ["qwen2-1.5b", "gemma3-12b", "gemma2-27b", "mamba2-370m",
                "zamba2-1.2b", "grok-1-314b", "musicgen-medium"]
TOL = 2e-3


def _params(arch, seed=0):
    cfg = configs.get_config(arch, smoke=True)
    return cfg, init_params(torch.Generator().manual_seed(seed), cfg)


def _check_prefill(cfg, params, b, s, seed):
    g = torch.Generator().manual_seed(seed)
    if cfg.input_mode == "tokens":
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                             dtype=torch.int32)
        full, _ = forward(params, cfg, tokens=toks)
        cache, dec = prefill(params, cfg, tokens=toks, max_seq=s)
    else:
        emb = torch.randn((b, s, cfg.d_model), generator=g)
        full, _ = forward(params, cfg, embeds=emb)
        cache, dec = prefill(params, cfg, embeds=emb, max_seq=s)
    assert cache["pos"] == s
    np.testing.assert_allclose(dec.numpy(), full.detach().numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_forward(arch):
    cfg, params = _params(arch)
    _check_prefill(cfg, params, 2, 24, seed=1)


@pytest.mark.parametrize("arch", ["gemma3-12b", "h2o-danube-3-4b"])
def test_sliding_window_ring_buffer_beyond_window(arch):
    """Decode past the window (16) with a ring cache == forward with the
    SWA mask; the local layers' caches hold the window only."""
    cfg, params = _params(arch)
    cache = init_cache(cfg, 1, 40)
    assert cache["period"]["s0"]["k"].shape[2] == cfg.sliding_window
    _check_prefill(cfg, params, 1, 40, seed=2)


def test_serve_step_is_the_last_decode_logits():
    cfg, params = _params("gemma2-27b")
    toks = torch.randint(0, cfg.vocab_size, (2, 5),
                         generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32)
    cache, logits = prefill(params, cfg, tokens=toks[:, :4], max_seq=8)
    step = build_serve_step(cfg)
    with torch.inference_mode():
        nxt, cache = step(params, cache, tokens=toks[:, 4:])
    assert cache["pos"] == 5
    full, _ = forward(params, cfg, tokens=toks)
    np.testing.assert_allclose(nxt.numpy(), full[:, -1].detach().numpy(),
                               rtol=TOL, atol=TOL)


def test_decode_step_updates_the_cache_in_place():
    cfg, params = _params("qwen2-1.5b")
    cache = init_cache(cfg, 2, 4)
    k = cache["period"]["s0"]["k"]
    _, out = decode_step(params, cfg, cache,
                         tokens=torch.zeros((2, 1), dtype=torch.int32))
    assert out is cache and cache["pos"] == 1
    assert out["period"]["s0"]["k"] is k and k[:, :, 0].abs().sum() > 0
    assert cache["period"]["s0"]["kpos"][0].tolist() == [0, -1, -1, -1]


@pytest.fixture(scope="module")
def ref_generations():
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg = ref_configs.get_config(arch, smoke=True)
            rp = ref_init(jax.random.key(0), rcfg)
            prompts = np.random.default_rng(3).integers(
                0, rcfg.vocab_size, (2, 8)).astype(np.int32)
            toks = ref_generate(rp, rcfg, jnp.asarray(prompts), 6)
            cache[arch] = (jax.tree.map(np.asarray, rp), prompts,
                           np.asarray(toks))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m",
                                  "grok-1-314b"])
def test_greedy_tokens_match_reference(arch, ref_generations):
    tree, prompts, want = ref_generations(arch)
    cfg = configs.get_config(arch, smoke=True)
    p = params_from_numpy(tree, cfg)
    got = generate(p, cfg, torch.from_numpy(prompts), 6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_shapes_and_determinism():
    cfg, params = _params("qwen2-1.5b")
    prompts = torch.randint(0, cfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(3),
                            dtype=torch.int32)
    out1 = generate(params, cfg, prompts, 6)
    out2 = generate(params, cfg, prompts, 6)
    assert out1.shape == (2, 6)
    assert torch.equal(out1, out2)                 # greedy, fresh caches
    assert ((out1 >= 0) & (out1 < cfg.vocab_size)).all()
    assert generate(params, cfg, prompts, 0).shape == (2, 0)


def test_generate_reports_its_prefill_and_decode_time():
    cfg, params = _params("qwen2-1.5b")
    prompts = torch.zeros((2, 4), dtype=torch.int32)
    timings = {}
    out = generate(params, cfg, prompts, 3, timings=timings)
    assert torch.equal(out, generate(params, cfg, prompts, 3))
    assert sorted(timings) == ["decode_s", "prefill_s"]
    assert all(v > 0 for v in timings.values())


def test_temperature_sampling_follows_its_generator():
    cfg, params = _params("qwen2-1.5b")
    prompts = torch.zeros((2, 4), dtype=torch.int32)

    def draw(seed):
        return generate(params, cfg, prompts, 12, temperature=1.0,
                        generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(5), draw(5), draw(6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    # the default generator is seeded with 0
    assert torch.equal(generate(params, cfg, prompts, 12, temperature=1.0),
                       draw(0))


def test_mamba2_decode_matches_forward_at_full_depth():
    """mamba2-370m's 48 layers at smoke widths, S = 64 (four SSD chunks):
    in fp64 the decode replay equals the chunked forward to 1e-9, so the
    state carried between chunks and between layers is right at full
    depth.  In fp32 both packages' forward and replay drift from that
    answer as the random model deepens (its rounding grows from layer to
    layer): the reference's own pair parts beyond this file's 2e-3, and
    the port's drift stays within 3x of the reference's."""
    rcfg = dataclasses.replace(ref_configs.get_config("mamba2-370m",
                                                      smoke=True),
                               num_layers=48)
    cfg = dataclasses.replace(configs.get_config("mamba2-370m", smoke=True),
                              num_layers=48)
    cfg64 = dataclasses.replace(cfg, param_dtype="float64",
                                compute_dtype="float64")
    rp = ref_init(jax.random.key(0), rcfg)
    p32 = params_from_numpy(jax.tree.map(np.asarray, rp), cfg)
    p64 = tree_map(lambda v: v.to(torch.float64) if v.is_floating_point()
                   else v, p32)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (2, 64)).astype(np.int32)
    t = torch.from_numpy(toks)
    with torch.inference_mode():
        exact, _ = forward(p64, cfg64, tokens=t)
        f32, _ = forward(p32, cfg, tokens=t)
    _c, dec64 = prefill(p64, cfg64, tokens=t, max_seq=64)
    _c, dec32 = prefill(p32, cfg, tokens=t, max_seq=64)
    assert dec64.dtype == torch.float64
    np.testing.assert_allclose(dec64.numpy(), exact.numpy(), rtol=0,
                               atol=1e-9)
    ref_f32 = np.asarray(ref_forward(rp, rcfg, tokens=jnp.asarray(toks))[0])
    ref_dec = np.asarray(ref_prefill(rp, rcfg, tokens=jnp.asarray(toks),
                                     max_seq=64)[1])
    x = exact.numpy()
    ref_gap = np.abs(ref_dec - ref_f32) - TOL * np.abs(ref_f32)
    assert ref_gap.max() > TOL
    ref_drift = max(np.abs(ref_f32 - x).max(), np.abs(ref_dec - x).max())
    drift = max(np.abs(f32.numpy() - x).max(), np.abs(dec32.numpy() - x).max())
    assert drift <= 3 * ref_drift, (drift, ref_drift)
