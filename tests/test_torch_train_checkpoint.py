"""The port's checkpointer on model trees and train states, against the
reference's (``repro.checkpoint``), on the CPU.

Leaves are named by the reference's ``tree_flatten_with_path`` walk: dict
keys sorted, ``[i]`` for list entries (an empty ``tail`` list writes no
key), ``.field`` for the ``TrainState`` fields, the key data of the
reference's PRNG key under ``.rng__prngkey``.  So the parameters of all ten
smoke configs (zamba2's ``tail`` and ``shared`` included) and a whole
``TrainState`` written by either package restore in the other, bit for
bit.  The reference's params come from ``init_params(jax.random.key(0))``
and are carried over with ``params_from_numpy``.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import checkpointer as ref_ckpt
from repro.models import init_params as ref_init
from repro.training import AdamWConfig as RefAdamWConfig
from repro.training import TrainState as RefTrainState
from repro.training import adamw_init as ref_adamw_init
from repro_torch import configs
from repro_torch.checkpoint import Checkpointer, checkpointer
from repro_torch.models import params_from_numpy, tree_leaves
from repro_torch.training import AdamWConfig, TrainState, adamw_init
from repro_torch.training.train_state import prng_key


def _ref_leaf(x) -> np.ndarray:
    try:
        if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
            return np.asarray(jax.random.key_data(x))
    except (AttributeError, TypeError):
        pass
    return np.asarray(x)


def _keys(ckpt_dir: str, step: int) -> list:
    with np.load(os.path.join(ckpt_dir, f"step_{step}", "host_0.npz")) as f:
        return sorted(f.files)


def _port_leaves(state: TrainState) -> list:
    """The state's leaves in the reference's flatten order."""
    return (tree_leaves(state.params) + tree_leaves(state.opt)
            + [state.step, state.data_cursor, state.rng])


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_params_round_trip_both_ways(arch, tmp_path):
    cfg = configs.get_config(arch, smoke=True)
    ref = ref_init(jax.random.key(0), ref_configs.get_config(arch,
                                                             smoke=True))
    tree = jax.tree.map(np.asarray, ref)
    mine = params_from_numpy(tree, cfg)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.save(ref_dir, 1, ref)
    checkpointer.save(port_dir, 1, mine)
    keys = _keys(ref_dir, 1)
    assert keys == _keys(port_dir, 1)
    assert not any(k.endswith("['tail']") for k in keys)   # empty list: no key
    if len(mine["tail"]):
        assert any(k.startswith("['tail']/[0]/") for k in keys)

    # reference -> port: the port's target structure, lists included
    got = checkpointer.restore(ref_dir, 1, mine)
    assert isinstance(got["tail"], list) and len(got["tail"]) == len(
        mine["tail"])
    for a, b in zip(tree_leaves(got), tree_leaves(mine)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # port -> reference
    back = ref_ckpt.restore(port_dir, 1, jax.eval_shape(lambda: ref))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-1.2b"])
def test_train_state_round_trip_both_ways(arch, tmp_path):
    """A whole TrainState (params, moments, counters, the PRNG key data)."""
    cfg = configs.get_config(arch, smoke=True)
    rcfg = ref_configs.get_config(arch, smoke=True)
    rp = ref_init(jax.random.key(5), rcfg)
    ref_state = RefTrainState.create(rp, ref_adamw_init(RefAdamWConfig(),
                                                        rp),
                                     jax.random.key(5))
    p = params_from_numpy(jax.tree.map(np.asarray, rp), cfg)
    mine = TrainState.create(p, adamw_init(AdamWConfig(), p), prng_key(5))
    assert mine.rng.tolist() == [0, 5]
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.save(ref_dir, 3, ref_state)
    checkpointer.save(port_dir, 3, mine)
    keys = _keys(ref_dir, 3)
    assert keys == _keys(port_dir, 3)
    for k in (".step", ".data_cursor", ".rng__prngkey", ".opt/['step']",
              ".params/['embed']"):
        assert k in keys
    if arch == "zamba2-1.2b":
        assert ".opt/['m']/['tail']/[0]/['norm']" in keys
        assert ".params/['shared']/['attn']/['wq']" in keys

    got = checkpointer.restore(ref_dir, 3, mine)
    assert isinstance(got, TrainState)
    assert got.rng.dtype == torch.uint32 and got.rng.tolist() == [0, 5]
    want = [torch.from_numpy(_ref_leaf(x).copy())
            for x in jax.tree.leaves(ref_state)]
    got_leaves = _port_leaves(got)
    assert len(got_leaves) == len(want)
    for a, b in zip(got_leaves, want):
        assert a.dtype == b.dtype and torch.equal(a, b)

    back = ref_ckpt.restore(port_dir, 3, jax.eval_shape(lambda: ref_state))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
        np.testing.assert_array_equal(_ref_leaf(a), _ref_leaf(b))


def test_bf16_meta_targets_and_async_state(tmp_path):
    """bf16 leaves round-trip through their bit patterns (``|V2``, as the
    reference writes them; the port also reads the reference's); a target
    of meta tensors restores as CPU tensors; the async checkpointer saves a
    TrainState; a wrong shape raises."""
    import dataclasses

    cfg = dataclasses.replace(configs.get_config("qwen2-1.5b", smoke=True),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    from repro_torch.models import init_params, tree_map

    p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    state = TrainState.create(p, adamw_init(AdamWConfig(), p), prng_key(7))
    ck = Checkpointer(str(tmp_path / "a"), keep_last_k=1)
    ck.save_async(2, state)
    ck.wait()
    with np.load(tmp_path / "a" / "step_2" / "host_0.npz") as f:
        assert f[".params/['embed']"].dtype == np.dtype("V2")
    meta = TrainState(tree_map(lambda x: x.to("meta"), state.params),
                      tree_map(lambda x: x.to("meta"), state.opt),
                      state.step.to("meta"), state.data_cursor.to("meta"),
                      state.rng.to("meta"))
    got = checkpointer.restore(ck.ckpt_dir, 2, meta)
    for a, b in zip(_port_leaves(got), _port_leaves(state)):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b)

    ref_dir = str(tmp_path / "ref")
    ref_ckpt.save(ref_dir, 1, {"w": jax.numpy.asarray([1.5, -2.0, 3.25],
                                                      jax.numpy.bfloat16)})
    w = checkpointer.restore(ref_dir, 1, {"w": torch.zeros(
        3, dtype=torch.bfloat16)})["w"]
    assert torch.equal(w, torch.tensor([1.5, -2.0, 3.25],
                                       dtype=torch.bfloat16))
    bad = TrainState(dict(state.params, embed=torch.zeros(3, 4)), state.opt,
                     state.step, state.data_cursor, state.rng)
    with pytest.raises(ValueError, match="shape"):
        checkpointer.restore(ck.ckpt_dir, 2, bad)
