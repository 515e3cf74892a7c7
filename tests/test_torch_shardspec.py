"""The port's sharding policy (``repro_torch.launch.shardspec``) against the
reference's (``repro.launch.shardspec``), on the CPU.

* ``rules_for`` and ``moe_rules_patch`` equal for all ten archs x four
  shapes on duck-typed 16 x 16 and 2 x 16 x 16 meshes.
* The logical axes of every parameter, decode-cache and batch leaf of all
  ten configs equal, leaf by leaf under the reference's key strings (the
  port walks its trees on ``meta`` tensors, the reference its
  ``eval_shape`` trees).
* ``safe_named_sharding``'s spec equals on a 1 x 1 mesh in process, and on
  a 2 x 4 mesh against the reference in a subprocess with 8 fake CPU
  devices (as ``tests/test_distributed.py``'s ``_run``); ``tree_shardings``
  over a ``TrainState`` equals the reference's spec for spec.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import shardspec as ref_ss
from repro.launch.inputs import input_specs as ref_input_specs
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init
from repro.training import AdamWConfig as RefAdamWConfig
from repro.training import TrainState as RefTrainState
from repro.training import adamw_init as ref_adamw_init
from repro_torch import configs
from repro_torch.dist.sharding import DistSpec, NamedSharding, resolve_mesh
from repro_torch.launch import shardspec as ss
from repro_torch.launch.inputs import input_specs
from repro_torch.models import init_cache, init_params
from repro_torch.training import AdamWConfig, TrainState, adamw_init
from repro_torch.training.train_state import prng_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Mesh16:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class _Mesh2x16:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("mesh", [_Mesh16, _Mesh2x16],
                         ids=["16x16", "2x16x16"])
def test_rules_match_reference(arch, mesh):
    for shape_name in configs.SHAPES:
        cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
        shape = configs.get_shape(shape_name)
        rshape = ref_configs.get_shape(shape_name)
        got = ss.rules_for(cfg, shape, mesh())
        want = ref_ss.rules_for(rcfg, rshape, mesh())
        assert got == want, shape_name
        assert ss.moe_rules_patch(cfg, got) == \
            ref_ss.moe_rules_patch(rcfg, want), shape_name


def _port_axes(tree, fn) -> dict:
    return {ss.keystr(path): fn(path, leaf)
            for path, leaf in ss.tree_flatten_with_path(tree)}


def _ref_axes(tree, fn) -> dict:
    return {jax.tree_util.keystr(path): fn(path, leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_logical_axes_match_reference(arch):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    params = init_params(torch.Generator(), cfg, device="meta")
    rparams = jax.eval_shape(lambda k: ref_init(k, rcfg), jax.random.key(0))
    got = _port_axes(params, ss.param_logical_axes)
    assert got == _ref_axes(rparams, ref_ss.param_logical_axes)
    assert len(got) > 3
    shape = configs.get_shape("decode_32k")
    cache = init_cache(cfg, shape.global_batch, 64, device="meta")
    rcache = jax.eval_shape(lambda: ref_init_cache(rcfg, shape.global_batch,
                                                   64))
    assert _port_axes(cache, ss.cache_logical_axes) == \
        _ref_axes(rcache, ref_ss.cache_logical_axes)
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = configs.get_shape(shape_name, smoke=True)
        got = _port_axes(input_specs(cfg, shape), ss.batch_logical_axes)
        want = _ref_axes(ref_input_specs(rcfg, ref_configs.get_shape(
            shape_name, smoke=True)), ref_ss.batch_logical_axes)
        assert got == want, shape_name


# (rules, logical axes, shape) cases for safe_named_sharding
CASES = [
    ({"heads": "model"}, ("heads", None), (48, 128)),
    ({"batch": "data", "embed": "model"}, ("batch", None, "embed"),
     (8, 16, 512)),
    ({"batch": ("data", "model")}, ("batch", None), (16, 3)),
    ({"batch": ("data", "model")}, ("batch", None), (12, 3)),
    ({"vocab": "model", "embed": "data"}, ("vocab", "embed"), (151936, 1536)),
    ({"kv_seq": ("data", "model")}, (None, "batch", "kv_seq", "kv_heads",
                                     "head_dim"), (2, 4, 40, 2, 120)),
    ({}, (None,), (7,)),
    ({"ff": "model"}, ("ff",), (6,)),
]


def _port_specs(mesh) -> list:
    return [list(ss.safe_named_sharding(mesh, r, a, s).spec)
            for r, a, s in CASES]


def _json(specs) -> list:
    return json.loads(json.dumps(specs))


def test_safe_named_sharding_one_device():
    mesh = resolve_mesh(DistSpec((1, 1), ("data", "model")), "cpu")
    rmesh = ref_make_mesh((1, 1), ("data", "model"))
    want = [list(ref_ss.safe_named_sharding(rmesh, r, a, s).spec)
            for r, a, s in CASES]
    assert _json(_port_specs(mesh)) == _json(want)
    sh = ss.safe_named_sharding(mesh, {"heads": "model"}, ("heads", None),
                                (48, 128))
    assert isinstance(sh, NamedSharding) and sh.mesh is mesh


def test_safe_named_sharding_2x4_matches_reference_on_8_devices():
    code = textwrap.dedent(f"""
        import json
        from repro.launch.mesh import make_mesh
        from repro.launch.shardspec import safe_named_sharding
        mesh = make_mesh((2, 4), ("data", "model"))
        cases = {CASES!r}
        shs = [safe_named_sharding(mesh, r, a, s) for r, a, s in cases]
        print(json.dumps([[list(sh.spec) for sh in shs],
                          [list(sh.shard_shape(s))
                           for sh, (_r, _a, s) in zip(shs, cases)]]))
    """)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    want, want_blocks = json.loads(r.stdout.strip().splitlines()[-1])
    mesh = resolve_mesh(DistSpec((2, 4), ("data", "model")), "cpu")
    got = _json(_port_specs(mesh))
    assert got == want
    # one device's block of each case, as jax's NamedSharding.shard_shape
    assert [list(ss.safe_named_sharding(mesh, r, a, s).shard_shape(s))
            for r, a, s in CASES] == want_blocks
    # the guard drops what does not divide: 12 rows over 8 devices
    assert got[3] == [None, None] and got[2] == [["data", "model"], None]


def test_device_bytes_follow_the_placements():
    """The bytes one device holds: each tensor leaf's block under its
    placement; a non-tensor leaf (a cache's host ``pos``) holds none."""
    mesh = resolve_mesh(DistSpec((2, 4), ("data", "model")), "cpu")
    rules = {"heads": "model", "batch": "data"}
    tree = {"wq": torch.empty(48, 128, device="meta"),
            "x": torch.empty(6, 5, dtype=torch.bfloat16, device="meta"),
            "tail": [torch.empty(7, device="meta")], "pos": 3}

    def axes(path, leaf):
        name = path[-1].key if isinstance(path[-1], ss.DictKey) else None
        return {"wq": ("heads", None), "x": ("batch", None)}.get(
            name, (None,) * getattr(leaf, "ndim", 0))

    sh = ss.tree_shardings(tree, mesh, rules, axes)
    assert sh["wq"].shard_shape((48, 128)) == (12, 128)
    assert ss.device_bytes(tree, sh) == 12 * 128 * 4 + 3 * 5 * 2 + 7 * 4
    one = resolve_mesh(DistSpec((1, 1), ("data", "model")), "cpu")
    assert ss.device_bytes(tree, ss.tree_shardings(tree, one, rules, axes)) \
        == 48 * 128 * 4 + 6 * 5 * 2 + 7 * 4


def _at(tree, path):
    """The node of ``tree`` at a port key path."""
    for k in path:
        tree = (getattr(tree, k.name) if isinstance(k, ss.GetAttrKey)
                else tree[k.key] if isinstance(k, ss.DictKey) else
                tree[k.idx])
    return tree


def test_tree_shardings_over_train_state_match_reference():
    arch = "qwen2-1.5b"
    cfg, rcfg = (configs.get_config(arch, smoke=True),
                 ref_configs.get_config(arch, smoke=True))
    shape = configs.get_shape("train_4k", smoke=True)
    mesh = resolve_mesh(DistSpec((1, 1), ("data", "model")), "cpu")
    rules = ss.moe_rules_patch(cfg, ss.rules_for(cfg, shape, mesh))
    p = init_params(torch.Generator(), cfg, device="meta")
    state = TrainState.create(p, adamw_init(AdamWConfig(), p),
                              prng_key(0, "meta"))
    tree = ss.tree_shardings(state, mesh, rules, ss.param_logical_axes)
    assert isinstance(tree, TrainState)
    assert set(tree.params) == set(state.params)
    assert isinstance(tree.params["tail"], list)

    rmesh = ref_make_mesh((1, 1), ("data", "model"))
    rrules = ref_ss.moe_rules_patch(rcfg, ref_ss.rules_for(
        rcfg, ref_configs.get_shape("train_4k", smoke=True), rmesh))
    assert rules == rrules

    def make(k):
        rp = ref_init(k, rcfg)
        return RefTrainState.create(rp, ref_adamw_init(RefAdamWConfig(), rp),
                                    k)

    rstate = jax.eval_shape(make, jax.random.key(0))
    rtree = ref_ss.tree_shardings(rstate, rmesh, rrules,
                                  ref_ss.param_logical_axes)
    got = {ss.keystr(path): list(_at(tree, path).spec)
           for path, _leaf in ss.tree_flatten_with_path(state)}
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        rtree, is_leaf=lambda x: hasattr(x, "spec"))
    want = {jax.tree_util.keystr(path): list(sh.spec)
            for path, sh in leaves}
    # the rng key: the reference's typed key is 0-d, the port holds its
    # uint32[2] key data
    assert want.pop(".rng") == [] and got.pop(".rng") == [None]
    assert _json(got) == _json(want)
