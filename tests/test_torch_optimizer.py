"""The port's AdamW (``repro_torch.training.optimizer``) against the
reference's, on the CPU.

Inputs are made with numpy from a seed and given to both packages: the
reference's qwen2 smoke params, gradients and moments of a step in
progress (step 6, v = g'^2 of another draw, so no denominator is near
eps).  Every leaf is updated in fp32 in both, so params and moments agree
to fp32 rounding: rtol 1e-6, and atol 1e-9 on the moments and 1e-8 on the
params (a few fp32 ulps of the largest update, lr · mhat / sqrt(vhat) of
about 0.02); bf16 moments to one bf16 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import init_params as ref_init
from repro.training import optimizer as ref_opt
from repro_torch import configs
from repro_torch.models import params_from_numpy, tree_leaves, tree_map
from repro_torch.training import optimizer as opt
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, global_norm,
                                            warmup_cosine)

RTOL, ATOL, P_ATOL = 1e-6, 1e-9, 1e-8


def test_warmup_cosine_matches_reference():
    """The reference test's points (tests/test_training.py) and more."""
    cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    rcfg = ref_opt.AdamWConfig(lr_peak=1e-3, warmup_steps=10,
                               total_steps=100)
    for step in (0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 150):
        got = float(warmup_cosine(cfg, torch.tensor(step, dtype=torch.int32)))
        want = float(ref_opt.warmup_cosine(rcfg, jnp.asarray(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step
    lr0 = float(warmup_cosine(cfg, torch.tensor(0)))
    lr_peak = float(warmup_cosine(cfg, torch.tensor(10)))
    lr_end = float(warmup_cosine(cfg, torch.tensor(100)))
    assert lr0 < lr_peak and abs(lr_peak - 1e-3) < 1e-9 and lr_end < 1e-5


def _inputs(m_dtype: str):
    rcfg = ref_configs.get_config("qwen2-1.5b", smoke=True)
    rp = jax.tree.map(np.asarray, ref_init(jax.random.key(0), rcfg))
    rng = np.random.default_rng(0)

    def draw(x, scale):
        return (rng.standard_normal(x.shape) * scale).astype(np.float32)

    grads = jax.tree.map(lambda x: draw(x, 0.05), rp)
    m = jax.tree.map(lambda x: draw(x, 0.01), rp)
    v = jax.tree.map(lambda x: np.square(draw(x, 0.05)) + 1e-6, rp)
    if m_dtype == "bfloat16":
        m = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                         m)
        v = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                         v)
    return rp, grads, m, v


@pytest.mark.parametrize("m_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_reference(m_dtype, clip):
    rp, grads, m, v = _inputs(m_dtype)
    kw = dict(lr_peak=2e-3, warmup_steps=3, total_steps=20, clip_norm=clip,
              m_dtype=m_dtype, v_dtype=m_dtype)
    rcfg, cfg = ref_opt.AdamWConfig(**kw), AdamWConfig(**kw)
    ref_state = {"m": jax.tree.map(jnp.asarray, m),
                 "v": jax.tree.map(jnp.asarray, v),
                 "step": jnp.asarray(6, jnp.int32)}
    want_p, want_s, want_m = ref_opt.adamw_update(
        rcfg, jax.tree.map(jnp.asarray, rp), jax.tree.map(jnp.asarray, grads),
        ref_state)

    tcfg = configs.get_config("qwen2-1.5b", smoke=True)
    as_t = lambda t: tree_map(lambda x: torch.from_numpy(  # noqa: E731
        np.asarray(x, np.float32)).to(getattr(torch, m_dtype)), t)
    state = {"m": as_t(m), "v": as_t(v),
             "step": torch.tensor(6, dtype=torch.int32)}
    got_p, got_s, got_m = adamw_update(
        cfg, params_from_numpy(rp, tcfg), params_from_numpy(grads, tcfg),
        state)
    assert int(got_s["step"]) == 7
    assert float(got_m["grad_norm"]) == pytest.approx(
        float(want_m["grad_norm"]), rel=1e-6)
    assert float(got_m["lr"]) == pytest.approx(float(want_m["lr"]),
                                               rel=1e-6)
    for a, b in zip(tree_leaves(got_p), jax.tree.leaves(want_p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=P_ATOL)
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(got_s[key]),
                        jax.tree.leaves(want_s[key])):
            assert a.dtype == getattr(torch, m_dtype)
            a = a.to(torch.float32).numpy()
            b = np.asarray(b, np.float32)
            if m_dtype == "float32":
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
            else:   # one bf16 ulp (2**-7 relative) where the fp32 differs
                np.testing.assert_allclose(a, b, rtol=2.0**-7, atol=0)


def test_none_gradient_updates_as_zeros():
    """A None gradient (an embeddings-mode model's token table) moves like
    a zero one: the moments decay and the weight decay applies, as the
    reference's zero gradient does."""
    rng = np.random.default_rng(1)
    p = {"embed": rng.standard_normal((8, 4)).astype(np.float32),
         "w": rng.standard_normal((4, 4)).astype(np.float32)}
    g = {"embed": np.zeros((8, 4), np.float32),
         "w": rng.standard_normal((4, 4)).astype(np.float32)}
    m = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.01
         for k, v in p.items()}
    vv = {k: np.square(rng.standard_normal(v.shape)).astype(np.float32)
          * 1e-3 for k, v in p.items()}
    cfg = AdamWConfig(lr_peak=1e-2, warmup_steps=1, total_steps=10)
    want = ref_opt.adamw_update(
        ref_opt.AdamWConfig(lr_peak=1e-2, warmup_steps=1, total_steps=10),
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray,
                                                             vv),
         "step": jnp.asarray(2, jnp.int32)})
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa
    got = adamw_update(cfg, t(p), {"embed": None,
                                   "w": torch.from_numpy(g["w"])},
                       {"m": t(m), "v": t(vv),
                        "step": torch.tensor(2, dtype=torch.int32)})
    for k in p:
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(want[0][k]),
                                   rtol=RTOL, atol=P_ATOL)
        for mk in ("m", "v"):
            np.testing.assert_allclose(got[1][mk][k].numpy(),
                                       np.asarray(want[1][mk][k]),
                                       rtol=RTOL, atol=ATOL)
    assert not np.array_equal(got[0]["embed"].numpy(), p["embed"])
    assert float(got[2]["grad_norm"]) == pytest.approx(
        float(want[2]["grad_norm"]), rel=1e-6)
    # a tree whose whole subtree is None counts as zeros too
    assert opt._grad_leaves({"a": {"b": p["w"]}}, {"a": None}) == [None]


def test_adamw_init_and_global_norm():
    cfg = configs.get_config("zamba2-1.2b", smoke=True)
    from repro_torch.models import init_params

    p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    st = adamw_init(AdamWConfig(m_dtype="bfloat16"), p)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert isinstance(st["m"]["tail"], list)
    for x, y, z in zip(tree_leaves(p), tree_leaves(st["m"]),
                       tree_leaves(st["v"])):
        assert x.shape == y.shape == z.shape
        assert y.dtype == torch.bfloat16 and z.dtype == torch.float32
        assert not y.any() and not z.any()
    leaves = tree_leaves(p)
    want = np.sqrt(sum(np.sum(np.square(x.numpy().astype(np.float64)))
                       for x in leaves))
    assert float(global_norm(p)) == pytest.approx(want, rel=1e-5)
    ref = float(ref_opt.global_norm([jnp.asarray(x.numpy()) for x in leaves]))
    assert float(global_norm(p)) == pytest.approx(ref, rel=1e-6)
