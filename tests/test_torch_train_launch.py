"""The port's training launcher and its input stand-ins
(``repro_torch.launch.train``, ``repro_torch.launch.inputs``) on the CPU,
and the reference's own training gates (``tests/test_training.py``,
``tests/test_checkpoint.py``'s resume test) run on the port."""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import SMOKE_SHAPES as REF_SMOKE_SHAPES
from repro.launch import inputs as ref_inputs
from repro_torch import configs
from repro_torch.checkpoint import checkpointer
from repro_torch.configs.shapes import SHAPES, SMOKE_SHAPES
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist.sharding import DeviceCountError
from repro_torch.launch import inputs
from repro_torch.launch import train as launch
from repro_torch.models import init_params, tree_leaves
from repro_torch.training import (AdamWConfig, TrainState, adamw_init,
                                  build_train_step, warmup_cosine)
from repro_torch.training.train_state import prng_key

JAX_TO_TORCH = {"int32": torch.int32, "float32": torch.float32,
                "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's small tensors: the test workers
    share the cores, and many threads on tiny ops spin against each other
    (the module restores the count it found)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_input_specs_match_reference(arch, smoke):
    """Every arch x shape: the reference's ShapeDtypeStructs as meta
    tensors (nothing allocated)."""
    cfg = configs.get_config(arch, smoke=smoke)
    rcfg = ref_configs.get_config(arch, smoke=smoke)
    shapes, ref_shapes = ((SMOKE_SHAPES, REF_SMOKE_SHAPES) if smoke
                          else (SHAPES, REF_SHAPES))
    for name, shape in shapes.items():
        got = inputs.input_specs(cfg, shape)
        want = ref_inputs.input_specs(rcfg, ref_shapes[name])
        assert sorted(got) == sorted(want), (arch, name)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (arch, name, k)
            assert v.dtype == JAX_TO_TORCH[want[k].dtype.name]


def _final(ckpt_dir: str, step: int) -> dict:
    with np.load(os.path.join(ckpt_dir, f"step_{step}", "host_0.npz")) as f:
        return {k: f[k] for k in f.files}


def test_main_resume_equals_straight_through(tmp_path, capsys):
    """A crash and a relaunch with the same flags: ``main --steps 6
    --ckpt-every 3`` into A, A's step-3 checkpoint copied into a fresh B
    (the state a job killed after step 3 leaves), then the same command on
    B resumes from step 3; its step-6 checkpoint equals A's
    (``tests/test_checkpoint.py``'s tolerance, rtol 1e-5, atol 1e-6)."""
    args = ["--arch", "qwen2-1.5b", "--smoke", "--global-batch", "2",
            "--seq-len", "16", "--lr", "1e-3", "--device", "cpu",
            "--log-every", "1", "--steps", "6", "--ckpt-every", "3"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert launch.main(args + ["--ckpt-dir", a]) == 0
    assert checkpointer.latest_steps(a) == [3, 6]
    shutil.copytree(os.path.join(a, "step_3"), os.path.join(b, "step_3"))
    capsys.readouterr()
    assert launch.main(args + ["--ckpt-dir", b]) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out
    assert "[train] step=3 " in out and "[train] step=0 " not in out
    want, got = _final(a, 6), _final(b, 6)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)
    assert got[".step"] == 6 and got[".data_cursor"] == 6
    assert got[".rng__prngkey"].tolist() == [0, 0]


def test_train_function_history_and_hook():
    seen = []
    run = launch.train("musicgen-medium", smoke=True, steps=2,
                       global_batch=2, seq_len=16, device="cpu",
                       on_step=lambda s, st, m: seen.append(
                           (s, int(st.step), float(m["loss"]))))
    assert [r["step"] for r in run.history] == [0, 1]
    assert [s[:2] for s in seen] == [(0, 1), (1, 2)]
    for r, s in zip(run.history, seen):
        assert r["loss"] == s[2] and np.isfinite(r["loss"])
        assert r["grad_norm"] > 0 and r["step_s"] > 0 and r["data_s"] >= 0
    assert run.resumed_from is None and int(run.state.step) == 2


@pytest.mark.parametrize("mesh", ["tiny", "single", "multi"])
def test_meshes_of_more_than_one_device_are_not_ported(mesh, tmp_path):
    """Once not ported; now each mesh trains on the CPU (the dense smoke
    qwen2 has no MoE layer, so its losses are the ``--mesh none`` run's bit
    for bit), and on ``cuda`` with too few cards it raises
    ``DeviceCountError`` naming the count before any work."""
    kw = dict(smoke=True, steps=2, global_batch=4, seq_len=16, device="cpu")
    run = launch.train("qwen2-1.5b", mesh=mesh, **kw)
    plain = launch.train("qwen2-1.5b", **kw)
    assert [r["loss"] for r in run.history] == \
        [r["loss"] for r in plain.history]
    ck = str(tmp_path / "ck")
    with pytest.raises(DeviceCountError,
                       match=f"have {torch.cuda.device_count()}"):
        launch.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cuda",
                     "--mesh", mesh, "--ckpt-dir", ck])
    assert not os.path.exists(ck)       # before any work


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        launch.train("qwen2-1.5b", smoke=True, steps=1)


# -- the reference's gates (tests/test_training.py), on the port -------------

def _fresh(cfg, opt_cfg, seed=0):
    params = init_params(torch.Generator().manual_seed(seed), cfg, "cpu")
    return TrainState.create(params, adamw_init(opt_cfg, params),
                             prng_key(seed))


def test_loss_decreases_on_bigram_data():
    cfg = configs.get_config("qwen2-1.5b", smoke=True)
    opt_cfg = AdamWConfig(lr_peak=3e-3, warmup_steps=3, total_steps=40,
                          weight_decay=0.0)
    data = SyntheticLM(DataConfig(global_batch=4, seq_len=32,
                                  vocab_size=cfg.vocab_size))
    state = _fresh(cfg, opt_cfg)
    step = build_train_step(cfg, opt_cfg)
    losses = []
    for i in range(40):
        state, m = step(state, data.batch_at(i, device="cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_warmup_cosine_schedule():
    cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    lr0 = float(warmup_cosine(cfg, torch.tensor(0)))
    lr_peak = float(warmup_cosine(cfg, torch.tensor(10)))
    lr_end = float(warmup_cosine(cfg, torch.tensor(100)))
    assert lr0 < lr_peak
    assert abs(lr_peak - 1e-3) < 1e-9
    assert lr_end < 1e-5


def test_gradient_clipping_activates():
    cfg = configs.get_config("qwen2-1.5b", smoke=True)
    opt_cfg = AdamWConfig(lr_peak=1e-3, clip_norm=1e-6, warmup_steps=1,
                          total_steps=5)
    data = SyntheticLM(DataConfig(global_batch=2, seq_len=16,
                                  vocab_size=cfg.vocab_size))
    state = _fresh(cfg, opt_cfg)
    s1, _m = build_train_step(cfg, opt_cfg)(state, data.batch_at(
        0, device="cpu"))
    delta = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(state.params),
                                tree_leaves(s1.params)))
    assert delta < 1e-2


def test_resume_after_restart_reproduces_training(tmp_path):
    """tests/test_checkpoint.py's contract: 6 steps straight = 3 steps,
    save, restore, 3 more."""
    cfg = configs.get_config("qwen2-1.5b", smoke=True)
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=6)
    data = SyntheticLM(DataConfig(global_batch=2, seq_len=16,
                                  vocab_size=cfg.vocab_size))
    step_fn = build_train_step(cfg, opt_cfg)
    sa = _fresh(cfg, opt_cfg)
    for i in range(6):
        sa, _ = step_fn(sa, data.batch_at(i, device="cpu"))
    sb = _fresh(cfg, opt_cfg)
    for i in range(3):
        sb, _ = step_fn(sb, data.batch_at(i, device="cpu"))
    checkpointer.save(str(tmp_path), 3, sb)
    sb2 = checkpointer.restore(str(tmp_path), 3, _fresh(cfg, opt_cfg))
    assert isinstance(sb2, TrainState) and int(sb2.step) == 3
    for i in range(3, 6):
        sb2, _ = step_fn(sb2, data.batch_at(i, device="cpu"))
    for a, b in zip(tree_leaves(sa.params), tree_leaves(sb2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_remat_block_equals_none_bit_for_bit():
    """``remat="block"`` (torch.utils.checkpoint per period) gives the
    loss and every gradient of ``remat="none"`` bit for bit, and without
    gradients the forward is the same ops."""
    import dataclasses

    from repro_torch.models import forward
    from repro_torch.training.step import value_and_grad

    for arch in ("qwen2-1.5b", "zamba2-1.2b"):
        cfg = configs.get_config(arch, smoke=True)
        p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        batch = SyntheticLM(DataConfig(global_batch=2, seq_len=32,
                                       vocab_size=cfg.vocab_size)).batch_at(
            0, device="cpu")
        out = [value_and_grad(p, dataclasses.replace(cfg, remat=r), batch)
               for r in ("none", "block")]
        assert torch.equal(out[0][0], out[1][0])
        for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
            assert torch.equal(a, b)
        with torch.no_grad():
            la, _ = forward(p, dataclasses.replace(cfg, remat="block"),
                            tokens=batch["tokens"])
            lb, _ = forward(p, cfg, tokens=batch["tokens"])
        assert torch.equal(la, lb)


def test_prng_key_matches_reference_key_data():
    for seed in (0, 5, -1, 2**31, 2**32 + 5, 2**40 + 3):
        assert prng_key(seed).tolist() == np.asarray(
            jax.random.key_data(jax.random.key(seed))).tolist(), seed


def test_updated_params_keep_their_layout():
    """The tied embedding's gradient comes back from autograd transposed;
    the updated parameter keeps the parameter's (contiguous) layout, as a
    restored state has it, so a resumed run's products take the same
    kernels as a straight one's."""
    from repro_torch.training.step import value_and_grad

    cfg = configs.get_config("qwen2-1.5b", smoke=True)
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=6)
    state = _fresh(cfg, opt_cfg)
    batch = SyntheticLM(DataConfig(global_batch=2, seq_len=16,
                                   vocab_size=cfg.vocab_size)).batch_at(
        0, device="cpu")
    _loss, grads = value_and_grad(state.params, cfg, batch)
    assert not grads["embed"].is_contiguous()
    new, _m = build_train_step(cfg, opt_cfg)(state, batch)
    for tree in (new.params, new.opt["m"], new.opt["v"]):
        assert all(x.is_contiguous() for x in tree_leaves(tree))
