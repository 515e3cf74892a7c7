"""The port's Mamba2 SSD block (``repro_torch.models.ssm``) against the
reference's, on the CPU: ``ssm_forward`` (two chunks, one chunk because
S <= chunk, one chunk because the chunk does not tile S) and
``ssm_decode`` with the reference's parameters carried over, to 1e-5;
chunked = the recurrent decode oracle (2e-3, ``tests/test_ssm.py``'s
tolerance); causality.  Mirrors ``tests/test_ssm.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.models import params_from_numpy, ssm

TOL = 1e-5


def _setup(seed=0, shape=(2, 32), scale=0.5):
    rcfg = ref_configs.get_config("mamba2-370m", smoke=True)
    cfg = configs.get_config("mamba2-370m", smoke=True)
    rp = ref_ssm.ssm_init(jax.random.key(seed), rcfg)
    u = np.array(jax.random.normal(jax.random.key(seed + 1),
                                   (*shape, rcfg.d_model),
                                   jnp.float32) * scale)
    return rcfg, cfg, rp, params_from_numpy(jax.tree.map(np.asarray, rp),
                                            cfg), u


def _naive(p, cfg, u):
    """Token-at-a-time oracle using the port's decode step."""
    s = cfg.ssm
    bsz, S, d = u.shape
    d_in = s.expand * d
    cache = ssm.ssm_cache_init(cfg, bsz, 1)
    conv, state = cache["conv"][0], cache["state"][0]
    outs = []
    for t in range(S):
        y, conv, state = ssm.ssm_decode(p, cfg, u[:, t:t + 1], conv, state)
        outs.append(y)
    assert conv.shape == (bsz, s.d_conv - 1, d_in)
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("seq", [32, 16, 8, 24])
def test_ssm_forward_matches_reference(seq):
    """32: two chunks of 16; 16 and 8: one chunk (S <= chunk); 24: one
    chunk of 24 (16 does not tile it)."""
    rcfg, cfg, rp, p, u = _setup(seed=seq, shape=(2, seq))
    want = np.asarray(ref_ssm.ssm_forward(rp, rcfg, jnp.asarray(u)))
    got = ssm.ssm_forward(p, cfg, torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_ssm_decode_matches_reference():
    rcfg, cfg, rp, p, u = _setup(seed=2, shape=(2, 6))
    rc = ref_ssm.ssm_cache_init(rcfg, 2, 1)
    pc = ssm.ssm_cache_init(cfg, 2, 1)
    assert {k: tuple(v.shape) for k, v in pc.items()} == \
        {k: tuple(v.shape) for k, v in rc.items()}
    rconv, rstate = rc["conv"][0], rc["state"][0]
    conv, state = pc["conv"][0], pc["state"][0]
    for t in range(u.shape[1]):
        ry, rconv, rstate = ref_ssm.ssm_decode(rp, rcfg,
                                               jnp.asarray(u[:, t:t + 1]),
                                               rconv, rstate)
        y, conv, state = ssm.ssm_decode(p, cfg, torch.from_numpy(
            u[:, t:t + 1]), conv, state)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(rstate),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(conv.numpy(), np.asarray(rconv), rtol=0,
                                   atol=TOL)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    got = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b))
    want = np.asarray(ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_ssd_chunked_equals_recurrent():
    _rcfg, cfg, _rp, p, u = _setup(seed=0)
    y = ssm.ssm_forward(p, cfg, torch.from_numpy(u))   # 2 chunks of 16
    np.testing.assert_allclose(y.numpy(), _naive(p, cfg, torch.from_numpy(u))
                               .numpy(), rtol=2e-3, atol=2e-3)


def test_ssd_single_chunk_path():
    _rcfg, cfg, _rp, p, u = _setup(seed=2, shape=(1, 8))
    y = ssm.ssm_forward(p, cfg, torch.from_numpy(u))   # 8 < chunk
    np.testing.assert_allclose(y.numpy(), _naive(p, cfg, torch.from_numpy(u))
                               .numpy(), rtol=2e-3, atol=2e-3)


def test_ssd_state_decay_causality():
    """Changing a future token must not affect past outputs."""
    _rcfg, cfg, _rp, p, u = _setup(seed=4, shape=(1, 32), scale=1.0)
    u = torch.from_numpy(u)
    y1 = ssm.ssm_forward(p, cfg, u)
    u2 = u.clone()
    u2[:, 20] = 123.0
    y2 = ssm.ssm_forward(p, cfg, u2)
    np.testing.assert_allclose(y1[:, :20].numpy(), y2[:, :20].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert not np.allclose(y1[:, 20:].numpy(), y2[:, 20:].numpy())
