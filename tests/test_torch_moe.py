"""The port's MoE (``repro_torch.models.moe``) against the reference's, on
the CPU: the capacity dispatch with the reference's parameters carried over
(outputs and aux to 1e-5, with and without drops), against both dense
oracles, grok-style ``ff`` experts, decode-shaped inputs (capacity taken at
T = B), lowest-index ties in the router, and gradients through the dispatch
(plain autograd) against ``jax.grad``.  Mirrors ``tests/test_moe.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import moe as ref_moe
from repro_torch import configs
from repro_torch.dist.sharding import (DistSpec, logical_axis_rules,
                                       resolve_mesh)
from repro_torch.models import moe, params_from_numpy

TOL = 1e-5


def _setup(arch="moonshot-v1-16b-a3b", seed=0, shape=(2, 16)):
    rcfg = ref_configs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    rp = ref_moe.moe_init(jax.random.key(seed), rcfg)
    x = np.array(jax.random.normal(jax.random.key(seed + 1),
                                   (*shape, rcfg.d_model),
                                   jnp.float32) * 0.3)
    p = params_from_numpy(jax.tree.map(np.asarray, rp), cfg)
    return rcfg, cfg, rp, p, x


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "grok-1-314b"])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.1])
def test_moe_local_matches_reference(arch, cf):
    rcfg, cfg, rp, p, x = _setup(arch, seed=3)
    want, want_aux = ref_moe._moe_local(rp, rcfg, jnp.asarray(x), cf)
    got, aux = moe._moe_local(p, cfg, torch.from_numpy(x), cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    assert abs(float(aux) - float(want_aux)) <= TOL
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "grok-1-314b"])
def test_capacity_dispatch_matches_dense_oracles(arch):
    rcfg, cfg, rp, p, x = _setup(arch, seed=5)
    got, aux = moe.moe_apply(p, cfg, torch.from_numpy(x),
                             capacity_factor=8.0)     # no drops
    dense = moe.moe_apply_dense(p, cfg, torch.from_numpy(x))
    want = np.asarray(ref_moe.moe_apply_dense(rp, rcfg, jnp.asarray(x)))
    np.testing.assert_allclose(dense.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-3,
                               atol=2e-3)
    assert float(aux) > 0


def test_tiny_capacity_drops_tokens_not_nan():
    _rcfg, cfg, _rp, p, x = _setup(seed=5)
    out, aux = moe.moe_apply(p, cfg, torch.from_numpy(x),
                             capacity_factor=0.1)
    assert torch.isfinite(out).all() and torch.isfinite(aux)
    assert out.shape == x.shape
    full, _ = moe.moe_apply(p, cfg, torch.from_numpy(x), capacity_factor=8.0)
    assert not torch.allclose(out, full)       # tokens were dropped


def test_decode_shaped_input_matches_reference():
    """T = B in decode: the capacity is max(8, int(cf·B·K/E))."""
    rcfg, cfg, rp, p, x = _setup(seed=9, shape=(3, 1))
    want, _ = ref_moe._moe_local(rp, rcfg, jnp.asarray(x),
                                 rcfg.moe.capacity_factor)
    got, _ = moe._moe_local(p, cfg, torch.from_numpy(x),
                            cfg.moe.capacity_factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_router_ties_break_by_lowest_index():
    probs = np.array([[0.25, 0.25, 0.1, 0.25, 0.15],
                      [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    w, idx = moe._top_k(torch.from_numpy(probs), 3)
    rw, ridx = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(rw))


def test_grads_through_dispatch_match_jax_grad():
    rcfg, cfg, rp, p, x = _setup(seed=7)

    def ref_loss(params):
        out, aux = ref_moe._moe_local(params, rcfg, jnp.asarray(x), 4.0)
        return jnp.sum(out ** 2) + aux

    want = jax.tree.map(np.asarray, jax.grad(ref_loss)(rp))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    out, aux = moe._moe_local(leaves, cfg, torch.from_numpy(x), 4.0)
    (torch.sum(out ** 2) + aux).backward()
    assert sorted(leaves) == sorted(want)
    for name, leaf in leaves.items():
        g = leaf.grad.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, want[name], rtol=1e-3, atol=1e-5,
                                   err_msg=name)
    assert sum(float(v.grad.norm()) for v in leaves.values()) > 0


def test_moe_init_layout_matches_reference():
    rcfg, cfg, rp, _p, _x = _setup()
    mine = moe.moe_init(torch.Generator().manual_seed(0), cfg, lead=(3,))
    assert {k: tuple(v.shape[1:]) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in rp.items()}
    assert all(v.shape[0] == 3 for v in mine.values())


def test_shard_map_path_is_deferred_to_14c():
    """Once deferred; now a (1, 2) model mesh takes the shard_map path (each
    model shard dispatches to its 4 experts, one psum), which equals the
    reference's local path at the same capacity: one data shard holds all
    the tokens, so the drops are the same."""
    rcfg, cfg, rp, p, x = _setup()
    mesh = resolve_mesh(DistSpec((1, 2), ("data", "model")), "cpu")
    with logical_axis_rules({"batch": "data", "experts": "model"}, mesh):
        got, aux = moe.moe_apply(p, cfg, torch.from_numpy(x))
    want, want_aux = ref_moe._moe_local(rp, rcfg, jnp.asarray(x), 1.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    assert abs(float(aux) - float(want_aux)) <= TOL
    # a mesh without a model axis keeps the local path
    one = resolve_mesh(DistSpec((1,), ("data",)), "cpu")
    with logical_axis_rules({"batch": "data"}, one):
        out, _ = moe.moe_apply(p, cfg, torch.from_numpy(x))
    assert out.shape == x.shape
