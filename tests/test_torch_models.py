"""The port's model side (``repro_torch.configs``, ``repro_torch.models``,
the logical-axis rules of ``repro_torch.dist.sharding``) against the
reference's, on the CPU.

The reference's ``init_params`` tree is carried over with
``params_from_numpy``, so both packages compute the same function: the
logits and aux losses of all ten smoke configs at B = 2, S = 32 agree to
1e-4, as do ``lm_loss`` and the layers.  Every config is field-equal to
the reference's, the port's parameter tree has the reference's paths and
shapes, and ``num_params_estimate`` is within 12% of the tree's size
(``tests/test_models.py``'s rule).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.dist import sharding as ref_sharding
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init
from repro.models import layers as ref_layers
from repro.models import lm_loss as ref_lm_loss
from repro_torch import configs
from repro_torch.dist import sharding
from repro_torch.dist.sharding import DistSpec, resolve_mesh
from repro_torch.models import (forward, init_params, layers, lm_loss,
                                params_from_numpy, tree_leaves)

TOL = 1e-4
B, S = 2, 32


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        return {"tokens": toks}
    return {"embeds": rng.standard_normal((B, S, cfg.d_model))
            .astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S))
            .astype(np.int32)}


@pytest.fixture(scope="module")
def ref_runs():
    """Per arch, computed once: the reference's params (numpy tree), the
    inputs and its forward's logits and aux."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = ref_configs.get_config(arch, smoke=True)
            params = ref_init(jax.random.key(0), cfg)
            inp = _inputs(cfg)
            logits, aux = ref_forward(
                params, cfg, tokens=jnp.asarray(inp["tokens"])
                if "tokens" in inp else None,
                embeds=jnp.asarray(inp["embeds"]) if "embeds" in inp
                else None)
            cache[arch] = (params, jax.tree.map(np.asarray, params), inp,
                           np.asarray(logits), float(aux))
        return cache[arch]
    return get


def _torch_inputs(inp):
    return {k: torch.from_numpy(v) for k, v in inp.items() if k != "labels"}


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_forward_matches_reference(arch, ref_runs):
    _params, tree, inp, want_logits, want_aux = ref_runs(arch)
    cfg = configs.get_config(arch, smoke=True)
    p = params_from_numpy(tree, cfg)
    logits, aux = forward(p, cfg, **_torch_inputs(inp))
    assert logits.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0, atol=TOL)
    assert abs(float(aux) - want_aux) <= TOL


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "grok-1-314b",
                                  "musicgen-medium"])
def test_lm_loss_matches_reference(arch, ref_runs):
    params, tree, inp, _logits, _aux = ref_runs(arch)
    rcfg = ref_configs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    want = float(ref_lm_loss(params, rcfg, **jin))
    got = lm_loss(params_from_numpy(tree, cfg), cfg,
                  **{k: torch.from_numpy(v) for k, v in inp.items()})
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= TOL


def test_layers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
        .numpy(), np.asarray(ref_layers.rms_norm(x, w, 1e-6)), atol=1e-6)
    for cap in (None, 5.0):
        np.testing.assert_allclose(
            layers.softcap(torch.from_numpy(x * 10), cap).numpy(),
            np.asarray(ref_layers.softcap(jnp.asarray(x * 10), cap)),
            atol=1e-5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = layers.rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(w), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(ref_layers.rms_norm(xb, w, 1e-6).astype(jnp.float32)),
        atol=2e-2)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rotary_half_split_matches_reference(theta):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(100, 107, dtype=np.int32)
    got = layers.rotary(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = np.asarray(ref_layers.rotary(jnp.asarray(x), jnp.asarray(pos),
                                        theta))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the layout: the first half rotates against the second
    got0 = layers.rotary(torch.from_numpy(x),
                         torch.zeros(7, dtype=torch.int32), theta)
    np.testing.assert_array_equal(got0.numpy(), x)


@pytest.mark.parametrize("mlp_type", ["glu", "gelu"])
def test_mlp_matches_reference(mlp_type):
    cfg = dataclasses.replace(configs.get_config("qwen2-1.5b", smoke=True),
                              mlp_type=mlp_type)
    rcfg = dataclasses.replace(ref_configs.get_config("qwen2-1.5b",
                                                      smoke=True),
                               mlp_type=mlp_type)
    rp = jax.tree.map(np.asarray, ref_layers.mlp_init(jax.random.key(1),
                                                      rcfg))
    x = np.random.default_rng(5).standard_normal((2, 3, 64)).astype(
        np.float32)
    got = layers.mlp_apply(params_from_numpy(rp, cfg), torch.from_numpy(x),
                           mlp_type)
    want = np.asarray(ref_layers.mlp_apply(rp, jnp.asarray(x), mlp_type))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert sorted(rp) == sorted(layers.mlp_init(torch.Generator(), cfg))


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_field_equal_to_reference(arch, smoke):
    got = configs.get_config(arch, smoke=smoke)
    want = ref_configs.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hd() == want.hd()
    assert got.num_params_estimate() == want.num_params_estimate()
    assert got.active_params_estimate() == want.active_params_estimate()
    assert got.pdtype() == getattr(torch, want.param_dtype)
    assert got.cdtype() == getattr(torch, want.compute_dtype)


def test_registry_matches_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.cells() == ref_configs.cells()
    assert configs.cells(False) == ref_configs.cells(False)
    for smoke in (False, True):
        for name in ref_configs.SHAPES:
            assert dataclasses.asdict(configs.get_shape(name, smoke)) == \
                dataclasses.asdict(ref_configs.get_shape(name, smoke))
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-9")
    assert configs.chase_laion.bench_config().dim == 512


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items()
                for p, s in _paths(v, prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: s for i, v in enumerate(tree)
                for p, s in _paths(v, prefix + (i,)).items()}
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_param_tree_equals_reference(arch, ref_runs):
    _params, tree, _inp, _l, _a = ref_runs(arch)
    cfg = configs.get_config(arch, smoke=True)
    mine = init_params(torch.Generator().manual_seed(0), cfg)
    assert _paths(mine) == _paths(tree)
    assert all(x.dtype == cfg.pdtype() for x in tree_leaves(mine))
    actual = sum(x.numel() for x in tree_leaves(mine))
    assert actual == sum(x.size for x in jax.tree.leaves(tree))
    if arch in ("qwen2-1.5b", "mamba2-370m", "moonshot-v1-16b-a3b"):
        assert abs(cfg.num_params_estimate() - actual) / actual < 0.12


def test_init_params_is_seeded():
    cfg = configs.get_config("zamba2-1.2b", smoke=True)
    a = init_params(torch.Generator().manual_seed(7), cfg)
    b = init_params(torch.Generator().manual_seed(7), cfg)
    c = init_params(torch.Generator().manual_seed(8), cfg)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])


def test_bf16_leaves_carry_bit_for_bit():
    rcfg = dataclasses.replace(ref_configs.get_config("qwen2-1.5b",
                                                      smoke=True),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_config("qwen2-1.5b", smoke=True),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, ref_init(jax.random.key(2), rcfg))
    p = params_from_numpy(tree, cfg)
    assert p["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["embed"].view(torch.int16).numpy(),
                                  tree["embed"].view(np.int16))
    logits, _ = forward(p, cfg, tokens=torch.zeros((1, 4), dtype=torch.int32))
    assert logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()
    with pytest.raises(ValueError, match="float32"):
        params_from_numpy(tree, configs.get_config("qwen2-1.5b", smoke=True))


RULES = {"batch": ("data",), "heads": "model", "ff": "model", "embed": None,
         "empty": ()}


@pytest.mark.parametrize("axes", [("batch", "seq", "heads", None),
                                  ("embed", "ff"), ("empty", "batch"), ()])
def test_logical_to_spec_matches_reference(axes):
    assert sharding.logical_to_spec(axes, RULES) == \
        tuple(ref_sharding.logical_to_spec(axes, RULES))


def test_rules_stack_and_constrain():
    x = torch.ones(4, 6)
    assert sharding.current_rules() is None
    assert sharding.current_mesh() is None
    assert sharding.constrain(x, ("batch", "heads")) is x
    one = resolve_mesh(DistSpec((1,), ("data",)), "cpu")
    two = resolve_mesh(DistSpec((1, 2), ("data", "model")), "cpu")
    with sharding.logical_axis_rules(RULES):
        assert sharding.current_rules() == RULES
        assert sharding.current_mesh() is None
        assert sharding.constrain(x, ("batch", "heads")) is x
        with sharding.logical_axis_rules({"batch": "data"}, one):
            assert sharding.current_rules() == {"batch": "data"}
            assert sharding.current_mesh() is one
            assert sharding.constrain(x, ("batch", None)) is x
            with sharding.logical_axis_rules(RULES, two):
                # a plain tensor under a mesh of two devices: one process
                # holds the whole value, so the constraint changes nothing
                assert sharding.constrain(x, ("batch", "heads")) is x
            assert sharding.current_mesh() is one
        assert sharding.current_rules() == RULES
    assert sharding.current_rules() is None
