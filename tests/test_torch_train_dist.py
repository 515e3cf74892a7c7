"""The port's compressed data-parallel step (int8 error feedback,
``repro_torch.training.step``) and its meshes (``repro_torch.launch.mesh``)
against the reference's, on the CPU.

The reference runs ``shard_map`` over a one-device mesh here (no
subprocess).  The port runs every replica in one process: on the CPU every
replica of a mesh is the CPU, so the reference's 8-device slow test runs
in process, unmarked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh as RefMesh
from jax.sharding import PartitionSpec as P

from repro import configs as ref_configs
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import init_params as ref_init
from repro.training import AdamWConfig as RefAdamWConfig
from repro.training import adamw_init as ref_adamw_init
from repro.training import step as ref_step
from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist.sharding import DeviceCountError
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import (init_params, params_from_numpy, tree_leaves,
                                tree_map)
from repro_torch.training import AdamWConfig, adamw_init
from repro_torch.training.step import (build_compressed_dp_step,
                                       compressed_psum, dp_devices,
                                       quantize_int8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's small tensors: the test workers
    share the cores, and many threads on tiny ops spin against each other
    (the module restores the count it found)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_mesh():
    return RefMesh(np.array(jax.devices()[:1]), ("data",))


def test_compressed_psum_equals_reference_on_one_device():
    """Same grads and error memory in: the same mean and new error out, to
    fp32 rounding (one ulp of the leaf's largest entry: XLA may divide by
    the scale as a product with its reciprocal), so the same int8 payload
    (one replica: the psum is the payload)."""
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal((64, 33)).astype(np.float32),
         "b": [rng.standard_normal(7).astype(np.float32) * 1e-3]}
    e = {"a": rng.standard_normal((64, 33)).astype(np.float32) * 0.01,
         "b": [np.zeros(7, np.float32)]}
    fn = shard_map(lambda g_, e_: ref_step.compressed_psum(g_, e_, "data"),
                   mesh=_ref_mesh(), in_specs=(P(), P()),
                   out_specs=(P(), P()), check_rep=False)
    want_mean, want_err = jax.jit(fn)(jax.tree.map(jnp.asarray, g),
                                      jax.tree.map(jnp.asarray, e))
    t = lambda x: tree_map(torch.from_numpy, x)  # noqa: E731
    mean, errs = compressed_psum([t(g)], [t(e)])
    assert len(errs) == 1
    ulp = [2.0**-23 * np.abs(x + y).max() for x, y in
           zip(jax.tree.leaves(g), jax.tree.leaves(e))]
    for a, b, u in zip(tree_leaves(mean), jax.tree.leaves(want_mean), ulp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=u)
    for a, b, u in zip(tree_leaves(errs[0]), jax.tree.leaves(want_err),
                       ulp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=u)


def test_compressed_psum_8_replicas_against_numpy():
    """Eight replicas (a CPU mesh): the mean of the dequantized payloads,
    summed in replica order, and each replica's new error, against a
    numpy oracle of the same arithmetic (fp32 throughout)."""
    rng = np.random.default_rng(1)
    n = 8
    gs = [{"w": rng.standard_normal((16, 5)).astype(np.float32)}
          for _ in range(n)]
    es = [{"w": rng.standard_normal((16, 5)).astype(np.float32) * 0.02}
          for _ in range(n)]
    mean, errs = compressed_psum(
        [{"w": torch.from_numpy(g["w"])} for g in gs],
        [{"w": torch.from_numpy(e["w"])} for e in es])
    total = np.zeros((16, 5), np.float32)
    for r in range(n):
        x = gs[r]["w"] + es[r]["w"]
        scale = np.float32(np.abs(x).max() / np.float32(127.0)
                           + np.float32(1e-12))
        q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        deq = q.astype(np.float32) * scale
        np.testing.assert_array_equal(errs[r]["w"].numpy(), x - deq)
        total = total + deq
    np.testing.assert_array_equal(mean["w"].numpy(), total / np.float32(n))
    q, scale = quantize_int8(torch.tensor([0.0, 1.0, -2.54]))
    assert q.dtype == torch.int8 and q.tolist() == [0, 50, -127]


def _smoke_setup(global_batch: int):
    cfg = configs.get_config("qwen2-1.5b", smoke=True)
    rcfg = ref_configs.get_config("qwen2-1.5b", smoke=True)
    dc = dict(global_batch=global_batch, seq_len=32,
              vocab_size=cfg.vocab_size)
    return cfg, rcfg, SyntheticLM(DataConfig(**dc)), RefSyntheticLM(
        RefDataConfig(**dc))


def test_compressed_dp_step_matches_reference_on_one_device():
    """Two steps of the compressed DP step on a one-device mesh from the
    reference's params.  The loss agrees to 1e-5 and the grad norm to 2e-5
    (test_torch_train_step's TOL_G).  An error memory (g minus its
    dequantized payload: at most half a scale, max |g| / 254) moves with
    the gradient, by up to 2e-5 of max |g|, i.e. 254 · 2e-5 of its own
    largest entry; except where g / scale sits within that noise of a half
    step, and the two packages round it to neighbouring int8 values: there
    the payload differs by one scale and the memory by one scale the other
    way (up to 2.2 of its largest entry).  Such flips must be rare (at most
    1e-3 of a leaf's entries); the params agree to rtol 2e-4, atol 2e-5
    (``tests/test_models.py``'s rule) outside them and to 2 lr per step on
    them."""
    opt = dict(lr_peak=3e-3, warmup_steps=2, total_steps=30)
    cfg, rcfg, data, rdata = _smoke_setup(8)
    rp = ref_init(jax.random.key(0), rcfg)
    ropt = ref_adamw_init(RefAdamWConfig(**opt), rp)
    rerr = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), rp)
    rstep = ref_step.build_compressed_dp_step(rcfg, RefAdamWConfig(**opt),
                                              _ref_mesh())
    p = params_from_numpy(jax.tree.map(np.asarray, rp), cfg)
    popt = adamw_init(AdamWConfig(**opt), p)
    perr = [tree_map(torch.zeros_like, p)]
    pstep = build_compressed_dp_step(cfg, AdamWConfig(**opt),
                                     make_mesh((1,), ("data",),
                                               device="cpu"))
    for i in range(2):
        rp, ropt, rerr, rm = rstep(rp, ropt, rerr, rdata.batch_at(i))
        p, popt, perr, m = pstep(p, popt, perr,
                                 data.batch_at(i, device="cpu"))
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                                 rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=2e-5)
    flips = 0
    for a, b, pa, pb in zip(tree_leaves(perr[0]), jax.tree.leaves(rerr),
                            tree_leaves(p), jax.tree.leaves(rp)):
        b, pb = np.asarray(b), np.asarray(pb)
        top = np.abs(b).max()
        d = np.abs(a.numpy() - b)
        flip = d > 254 * 2e-5 * top
        assert flip.sum() <= 1e-3 * flip.size, int(flip.sum())
        assert (d <= 2.2 * top).all()
        flips += int(flip.sum())
        dp = np.abs(pa.numpy() - pb)
        loose = 2 * 2 * opt["lr_peak"]
        assert (dp <= np.where(flip, loose, 2e-5 + 2e-4 * np.abs(pb))).all()
    assert flips <= 16, flips


def test_compressed_dp_step_trains_on_8_replicas():
    """The reference's slow test (``tests/test_distributed.py``), in
    process: 8 replicas of a CPU mesh, batch 8 (one row each), 30 steps;
    the mean of the last 5 losses is 0.3 below the first 5.  Each
    replica's error memory is its own."""
    cfg, _rcfg, data, _ = _smoke_setup(8)
    opt = AdamWConfig(lr_peak=3e-3, warmup_steps=2, total_steps=30)
    mesh = make_mesh((8,), ("data",), device="cpu")
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    state = adamw_init(opt, params)
    err = [tree_map(torch.zeros_like, params) for _ in range(8)]
    step = build_compressed_dp_step(cfg, opt, mesh)
    losses = []
    for i in range(30):
        params, state, err, m = step(params, state, err,
                                     data.batch_at(i, device="cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses
    assert len(err) == 8
    assert not torch.equal(err[0]["embed"], err[1]["embed"])


def test_meshes_and_their_errors():
    assert make_mesh((2, 4), ("data", "model"), device="cpu").shape == {
        "data": 2, "model": 4}
    prod = make_production_mesh(device="cpu")
    assert prod.shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True, device="cpu").shape == {
        "pod": 2, "data": 16, "model": 16}
    mesh = make_mesh((2, 3), ("model", "data"), device="cpu")
    assert len(dp_devices(mesh, "data")) == 3
    if torch.cuda.device_count() < 512:
        with pytest.raises(DeviceCountError, match="512 CUDA devices"):
            make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="same length"):
        make_mesh((2,), ("data", "model"), device="cpu")
    cfg = configs.get_config("qwen2-1.5b", smoke=True)
    step = build_compressed_dp_step(cfg, AdamWConfig(),
                                    make_mesh((2,), ("data",),
                                              device="cpu"))
    p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="2"):
        step(p, adamw_init(AdamWConfig(), p), [p], {})


def test_importing_the_mesh_module_touches_no_device():
    import importlib
    import sys

    sys.modules.pop("repro_torch.launch.mesh", None)
    calls = []
    real = torch.cuda.device_count
    torch.cuda.device_count = lambda: calls.append(1) or real()
    try:
        importlib.import_module("repro_torch.launch.mesh")
    finally:
        torch.cuda.device_count = real
    assert not calls
