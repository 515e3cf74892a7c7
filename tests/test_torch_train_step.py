"""The port's train step (``repro_torch.training.step``) against the
reference's, on the CPU, for every smoke config.

The reference's params (``init_params(jax.random.key(0))``) are carried
over with ``params_from_numpy``; batches come from the synthetic pipeline,
equal in both packages (B = 2, S = 32).

**One step, default AdamW (eps 1e-8), all ten configs.**  The loss and the
lr agree to fp32 rounding.  The gradient is held through the moments: after
one step ``m = (1 - b1) ĝ`` and ``v = (1 - b2) ĝ²`` (ĝ the clipped
gradient), so per leaf ``|m - m_ref| <= TOL_G · max |m_ref|`` (and v at
twice that) holds ĝ to ``TOL_G`` of the leaf's largest entry.  ``TOL_G``
is 2e-5 (the attention, MoE and audio families measure 0.8–3e-6), 1e-4 for
mamba2 (3.4e-5) and 2e-3 for zamba2 (6.3e-4): fp32 rounding through the
SSM layers' depth, as the fp64 witness below shows for this seed.  The
params are held to the bound that follows: the step-1 update is
``lr (ĝ / (|ĝ| + eps) + wd p)``, and a gradient error δ moves
``ĝ / (|ĝ| + eps)`` by at most ``min(2, 2δ / (|ĝ| + eps))``, so each entry
may differ by ``lr · min(2, 2δ / (|ĝ_ref| + eps))`` (δ = ``TOL_G`` · max
|ĝ_ref| of its leaf) plus fp32 rounding (2e-7 |p| + 1e-8).  Near ĝ = 0 the
sign of an update is a coin toss for any two implementations; where |ĝ| is
well above δ the bound is tight.

**Three steps** of qwen2, moonshot, mamba2, zamba2 and musicgen, and
microbatches 2, run at eps 1e-4: at eps 1e-8 the coin-toss entries' moves
(up to 2 lr) feed the next steps' gradients (qwen2: the moments part by
3.5e-4 of their largest after three steps, 1.4e-6 after one), while at
eps 1e-4 every update is a smooth function of the gradient.  After each
step the loss holds to 1e-5, the moments to 10 · TOL_G and the params to
the tolerance the reference holds two of its own steps to when only the
summation order differs (rtol 2e-4, atol 2e-5; ``tests/test_models.py``'s
microbatch test).  The smoke zamba2 starts at a grad norm of 122 and its
trajectory is chaotic: the two packages' grad norms part by 3% within two
steps at lr 1e-3 (0.9% at lr 3e-4) from a 4e-6 start, as any two fp32
implementations would.  So each of its steps starts from the reference's
state, carried over, and is held one step at a time.

Router ties: the MoE config breaks ties at the lowest index in both
packages; at these seeds no routing decision in the compared steps sits on
a tie (a tie would part the expert choice, and the loss, beyond the
tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import init_params as ref_init
from repro.training import AdamWConfig as RefAdamWConfig
from repro.training import TrainState as RefTrainState
from repro.training import TrainStepConfig as RefTrainStepConfig
from repro.training import adamw_init as ref_adamw_init
from repro.training import build_train_step as ref_build
from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import params_from_numpy, tree_leaves, tree_map
from repro_torch.training import (AdamWConfig, TrainState, TrainStepConfig,
                                  adamw_init, build_train_step)
from repro_torch.training.step import value_and_grad
from repro_torch.training.train_state import prng_key

B, S = 2, 32
OPT = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10)
TOL_G = {"mamba2-370m": 1e-4, "zamba2-1.2b": 2e-3}
TOL_G_DEFAULT = 2e-5
# each package's fp32 SSM gradient from the fp64 one (the witness below)
FP64_WITNESS = {"zamba2-1.2b": 1e-3, "mamba2-370m": 5e-4}
B1, B2 = 0.9, 0.95


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's small tensors: the test workers
    share the cores, and many threads on tiny ops spin against each other
    (the module restores the count it found)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(arch: str) -> float:
    return TOL_G.get(arch, TOL_G_DEFAULT)


def _setup(arch: str, opt: dict, step_cfg=None, cfg_fn=None):
    """(reference state, its jitted step, the port's state, its step, the
    two pipelines)."""
    rcfg = ref_configs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    if cfg_fn is not None:
        rcfg, cfg = cfg_fn(rcfg), cfg_fn(cfg)
    rp = ref_init(jax.random.key(0), rcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, rp), cfg)
    rstate = RefTrainState.create(rp, ref_adamw_init(RefAdamWConfig(**opt),
                                                     rp), jax.random.key(1))
    state = TrainState.create(p, adamw_init(AdamWConfig(**opt), p),
                              prng_key(1))
    rstep = jax.jit(ref_build(rcfg, RefAdamWConfig(**opt),
                              RefTrainStepConfig(**(step_cfg or {}))))
    step = build_train_step(cfg, AdamWConfig(**opt),
                            TrainStepConfig(**(step_cfg or {})))
    dc = dict(global_batch=B * 2 if step_cfg else B, seq_len=S,
              vocab_size=cfg.vocab_size, input_mode=cfg.input_mode,
              d_model=cfg.d_model)
    return (rstate, rstep, state, step, RefSyntheticLM(RefDataConfig(**dc)),
            SyntheticLM(DataConfig(**dc)))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _check_moments(state, rstate, tol: float, what: str) -> None:
    """Per leaf, m within tol and v within 2 tol of the leaf's largest
    reference entry."""
    for key, k in (("m", 1.0), ("v", 2.0)):
        for a, b in zip(tree_leaves(state.opt[key]),
                        jax.tree.leaves(rstate.opt[key])):
            a, b = _np(a), np.asarray(b, np.float32)
            scale = float(np.abs(b).max())
            err = float(np.abs(a - b).max()) / scale if scale else \
                float(np.abs(a).max())
            assert err <= k * tol, (what, key, err)


def _check_step1_params(state, rstate, p0, lr: float, tol: float,
                        what: str) -> None:
    """The step-1 params within the bound the module doc derives."""
    for a, b, m, p in zip(tree_leaves(state.params),
                          jax.tree.leaves(rstate.params),
                          jax.tree.leaves(rstate.opt["m"]), tree_leaves(p0)):
        a, b = _np(a), np.asarray(b, np.float32)
        ghat = np.abs(np.asarray(m, np.float32)) / (1 - B1)
        delta = tol * float(ghat.max())
        allowed = (2e-7 * np.abs(b) + 1e-8
                   + lr * np.minimum(2.0, 2 * delta / (ghat + 1e-8)))
        bad = np.abs(a - b) > allowed
        assert not bad.any(), (what, int(bad.sum()),
                               float(np.abs(a - b).max()))
        # the update happened: the params moved off their start
        assert not np.array_equal(b, _np(p)) or not ghat.any()


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_one_step_matches_reference(arch):
    rstate, rstep, state, step, rdata, data = _setup(arch, OPT)
    p0 = state.params
    rstate, rm = rstep(rstate, rdata.batch_at(0))
    state, m = step(state, data.batch_at(0, device="cpu"))
    tol = _tol(arch)
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert np.isfinite(float(m["loss"]))
    assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-7)
    assert float(m["grad_norm"]) > 0
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=tol)
    assert int(state.step) == 1 and int(state.data_cursor) == 1
    assert torch.equal(state.rng, prng_key(1))
    _check_moments(state, rstate, tol, arch)
    _check_step1_params(state, rstate, p0, float(rm["lr"]), tol, arch)


def _carried(rstate, cfg) -> TrainState:
    """The reference's state as the port's."""
    def tree(t):
        return params_from_numpy(jax.tree.map(np.asarray, t), cfg)

    def scalar(x):
        return torch.from_numpy(np.array(x))

    return TrainState(tree(rstate.params),
                      {"m": tree(rstate.opt["m"]), "v": tree(rstate.opt["v"]),
                       "step": scalar(rstate.opt["step"])},
                      scalar(rstate.step), scalar(rstate.data_cursor),
                      torch.from_numpy(np.array(
                          jax.random.key_data(rstate.rng)).copy()))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "moonshot-v1-16b-a3b",
                                  "mamba2-370m", "zamba2-1.2b",
                                  "musicgen-medium"])
def test_three_steps_match_reference(arch):
    opt = dict(OPT, eps=1e-4)
    rstate, rstep, state, step, rdata, data = _setup(arch, opt)
    cfg = configs.get_config(arch, smoke=True)
    tol = 10 * _tol(arch)
    for i in range(3):
        if arch == "zamba2-1.2b":
            state = _carried(rstate, cfg)
        rstate, rm = rstep(rstate, rdata.batch_at(i))
        state, m = step(state, data.batch_at(i, device="cpu"))
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                                 rel=1e-5), i
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=tol), i
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert int(state.step) == i + 1 and int(state.opt["step"]) == i + 1
        _check_moments(state, rstate, tol, f"{arch} step {i}")
        for a, b in zip(tree_leaves(state.params),
                        jax.tree.leaves(rstate.params)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2e-4,
                                       atol=2e-5)


def test_microbatches_2_match_reference():
    """Microbatches 2 against the reference's microbatches 2 (B = 4), and
    against the port's own single batch."""
    opt = dict(OPT, eps=1e-4)
    rstate, rstep, state, step, rdata, data = _setup(
        "qwen2-1.5b", opt, step_cfg={"microbatches": 2})
    start = state
    batch = data.batch_at(0, device="cpu")
    rstate, rm = rstep(rstate, rdata.batch_at(0))
    state, m = step(state, batch)
    tol = _tol("qwen2-1.5b")
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=tol)
    _check_moments(state, rstate, tol, "microbatches 2")
    for a, b in zip(tree_leaves(state.params),
                    jax.tree.leaves(rstate.params)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    # the port's two microbatches = its one batch of 4, to accumulation
    # order (tests/test_models.py's rule)
    one = build_train_step(configs.get_config("qwen2-1.5b", smoke=True),
                           AdamWConfig(**opt))
    s1, m1 = one(start, batch)
    assert float(m1["loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(state.params)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=2e-5)


def _fp64_witness(arch: str, seq: int = S):
    """Per leaf, relative to the fp64 gradient's largest entry: (the
    reference's fp32 gradient from the fp64 one, the port's fp32 from the
    fp64 one, the two fp32 ones from each other), the port's fp64 model
    holding the same params (its SSD sums and norms in fp64)."""
    from repro.training.step import _loss_fn as ref_loss_fn

    rcfg = ref_configs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    rp = ref_init(jax.random.key(0), rcfg)
    tree = jax.tree.map(np.asarray, rp)
    batch = SyntheticLM(DataConfig(global_batch=B, seq_len=seq,
                                   vocab_size=cfg.vocab_size)).batch_at(
        0, device="cpu")
    _l, rg = jax.jit(jax.value_and_grad(ref_loss_fn), static_argnums=1)(
        rp, rcfg, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    _l, g32 = value_and_grad(params_from_numpy(tree, cfg), cfg, batch)
    cfg64 = dataclasses.replace(cfg, param_dtype="float64",
                                compute_dtype="float64")
    p64 = tree_map(lambda x: x.to(torch.float64),
                   params_from_numpy(tree, cfg))
    _l, g64 = value_and_grad(p64, cfg64, batch)
    out = []
    for r, a, b in zip(jax.tree.leaves(rg), tree_leaves(g32),
                       tree_leaves(g64)):
        r = np.asarray(r, np.float64)
        a, b = a.to(torch.float64).numpy(), b.numpy()
        scale = np.abs(b).max()
        out.append((np.abs(r - b).max() / scale,
                    np.abs(a - b).max() / scale,
                    np.abs(r - a).max() / scale))
    return np.array(out)


def test_ssm_gradient_gap_is_fp32_rounding():
    """The fp64 witness of the SSM configs' TOL_G: each package's fp32
    gradient lies within ``FP64_WITNESS`` of the port's fp64 one, so the
    distance between the two, which TOL_G bounds, is fp32 rounding of
    each.

    Measured at this seed: zamba2's fp32 gradients lie 1.0e-4 (the
    reference's) and 5.4e-4 (the port's) from fp64, 6.3e-4 from each
    other; its bound is half its TOL_G, so the two distances add up to
    TOL_G at most.  mamba2's lie 2.7e-4 and 3.1e-4 from fp64, five times
    its TOL_G of 1e-4, yet only 3.4e-5 from each other: the two packages
    round alike there, so its TOL_G rests on their measured distance, and
    the witness shows only that each is within fp32 rounding (5e-4) of
    fp64.  Which package lands nearer fp64 changes with the seed (the
    port in 13 of 24 seeds for zamba2): any fp32 rounding in the first
    SSM blocks is amplified about 1e3-fold at this random init (ROADMAP.md
    queue 3, Q1)."""
    for arch in ("zamba2-1.2b", "mamba2-370m"):
        w = _fp64_witness(arch)
        ref_vs_64, port_vs_64, ref_vs_port = w.max(axis=0)
        bound = FP64_WITNESS[arch]
        assert ref_vs_64 <= bound and port_vs_64 <= bound, (arch, w.max(0))
        assert ref_vs_port <= _tol(arch), (arch, ref_vs_port)


def test_bf16_gradients_as_close_to_fp32_as_the_references():
    """qwen2's smoke shape in bf16 params and compute (the published
    dtypes).  Both packages' AD gives bf16 gradients; neither equals the
    other bit for bit (XLA and torch round bf16 chains differently), so
    each is held against the fp32 gradient at the same (bf16) parameter
    values: per leaf, the port's distance from it (relative to the leaf's
    largest entry) is at most 1.2 times the reference's, or one bf16 ulp
    (2**-8) where the reference's is smaller.  Both measure 1–5e-2 and the
    worst leaf's ratio is 1.09.  Mutation-checked: the attention's two
    products returned in bf16 (the fp32 output the reference asks XLA for
    lost) reach 1.30, and the norms in bf16 fail as well.  The loss is
    within 2**-8 of the fp32 loss; one train step keeps bf16 params and
    fp32 moments."""
    from repro.training.step import _loss_fn as ref_loss_fn

    def bf16(c):
        return dataclasses.replace(c, param_dtype="bfloat16",
                                   compute_dtype="bfloat16")

    rcfg = ref_configs.get_config("qwen2-1.5b", smoke=True)
    cfg = bf16(configs.get_config("qwen2-1.5b", smoke=True))
    rpb = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                       ref_init(jax.random.key(0), rcfg))
    batch = SyntheticLM(DataConfig(global_batch=B, seq_len=S,
                                   vocab_size=cfg.vocab_size)).batch_at(
        0, device="cpu")
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    l32, g32 = jax.value_and_grad(ref_loss_fn)(
        jax.tree.map(lambda x: x.astype(jnp.float32), rpb), rcfg, jb)
    _lb, gb = jax.value_and_grad(ref_loss_fn)(rpb, bf16(rcfg), jb)
    p = params_from_numpy(jax.tree.map(np.asarray, rpb), cfg)
    loss, g = value_and_grad(p, cfg, batch)
    assert abs(float(loss) - float(l32)) <= 2.0**-8 * abs(float(l32))
    for want, ref, got in zip(jax.tree.leaves(g32), jax.tree.leaves(gb),
                              tree_leaves(g)):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float64)
        scale = np.abs(want).max()
        ref_err = np.abs(np.asarray(ref.astype(jnp.float32)) - want).max()
        err = np.abs(got.to(torch.float64).numpy() - want).max()
        assert err / scale <= 1.2 * max(ref_err / scale, 2.0**-8), (
            err / scale, ref_err / scale)

    state = TrainState.create(p, adamw_init(AdamWConfig(**OPT), p),
                              prng_key(1))
    state, m = build_train_step(cfg, AdamWConfig(**OPT))(state, batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(state.params))
    assert all(x.dtype == torch.float32 for x in tree_leaves(state.opt["m"]))
