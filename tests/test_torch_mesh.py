"""Meshes of more than one device in the port, against the reference on a
(2, 4) mesh of fake CPU devices, on the CPU.

The reference runs once per module in a subprocess with
``--xla_force_host_platform_device_count=8`` (its meshes need the devices);
the port runs every shard of its CPU meshes in this process.

* ``constrain``: the guarded spec (``dist.sharding.guarded_spec``) of each
  of the ten call sites in ``models/`` equals the spec the reference's
  ``constrain`` hands ``with_sharding_constraint``, at the smoke configs'
  shapes under ``rules_for``'s train rules; a plain tensor comes back as it
  is, a DTensor is redistributed to that placement.
* MoE's shard_map path (``dist/shard_map.py`` over ``models/moe.py``'s
  body) against the reference's ``_moe_shard_map``: moonshot in expert mode
  and grok in ff mode, each also with ``mlp_embed`` set (FSDP), at a
  capacity that drops tokens: outputs to 1e-5 of their largest entry, the
  aux loss to 1e-6 relative.  Its gradients equal the local path's where no
  token drops (1e-5 of each leaf's largest entry), and it passes the
  reference's own check against ``_moe_local`` (rtol 3e-3).
* The elastic reshard: a checkpoint saved under a (4, 2) mesh (by the port,
  and by the reference) restores under (2, 2) as four blocks of
  ``shard_shape``, each the reference's device block, ``full()`` bit for
  bit.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import restore, save
from repro_torch.dist import shard_map as sm
from repro_torch.dist import sharding
from repro_torch.dist.sharding import (DistSpec, NamedSharding, ShardedLeaf,
                                       logical_axis_rules, resolve_mesh)
from repro_torch.launch import dryrun
from repro_torch.launch.shardspec import rules_for
from repro_torch.models import (attention, forward, init_params, layers, moe,
                                params_from_numpy, ssm, transformer)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SITES = (attention, layers, ssm, transformer)

# MoE cases: (arch, capacity factor, rules over the (2, 4) mesh)
_EXPERT = {"batch": "data", "embed": None, "mlp_embed": None, "ff": "model",
           "experts": "model", "expert_ff_in": None, "moe_ff": None,
           "moe_cap": "data"}
_FF = dict(_EXPERT, experts=None, moe_ff="model")
MOE_CASES = {
    "moonshot-expert": ("moonshot-v1-16b-a3b", 1.25, _EXPERT),
    "moonshot-expert-fsdp": ("moonshot-v1-16b-a3b", 1.25, dict(
        _EXPERT, embed="data", mlp_embed="data", expert_ff_in="data")),
    "grok-ff": ("grok-1-314b", 1.25, _FF),
    "grok-ff-fsdp": ("grok-1-314b", 1.25, dict(
        _FF, embed="data", mlp_embed="data", expert_ff_in="data")),
}
X_SHAPE = (4, 16)


def _mesh(shape):
    return resolve_mesh(DistSpec(shape, ("data", "model")), "cpu")


def _call_sites() -> list:
    """(shape, logical axes) at each ``constrain`` call site (file and
    line) in the forwards of the smoke qwen2 (attention, MLP, residual,
    logits) and mamba2 (SSM), recorded from the port's own calls."""
    seen = {}
    saved = [m.constrain for m in SITES]

    def record(x, axes):
        caller = sys._getframe(1)
        site = (os.path.basename(caller.f_code.co_filename), caller.f_lineno)
        seen.setdefault(site, (tuple(x.shape), tuple(axes)))
        return x

    try:
        for m in SITES:
            m.constrain = record
        for arch in ("qwen2-1.5b", "mamba2-370m"):
            cfg = configs.get_config(arch, smoke=True)
            params = init_params(torch.Generator().manual_seed(0), cfg)
            forward(params, cfg, tokens=torch.zeros(2, 32, dtype=torch.long))
    finally:
        for m, c in zip(SITES, saved):
            m.constrain = c
    return [seen[site] for site in sorted(seen)]


REF_CODE = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro import configs
from repro.checkpoint import restore, save
from repro.dist import sharding as S
from repro.launch.mesh import make_mesh
from repro.models import moe
from jax.sharding import NamedSharding, PartitionSpec as P

job = json.load(open(sys.argv[1]))
out_dir = sys.argv[2]
mesh = make_mesh((2, 4), ("data", "model"))
res = {}

# constrain: the spec handed to with_sharding_constraint
specs = []
orig = jax.lax.with_sharding_constraint
jax.lax.with_sharding_constraint = lambda x, s: (specs.append(
    [list(e) if isinstance(e, tuple) else e for e in s.spec]), x)[1]
with S.logical_axis_rules(job["rules"], mesh):
    for shape, axes in job["sites"]:
        S.constrain(jnp.zeros(shape), tuple(axes))
jax.lax.with_sharding_constraint = orig
res["specs"] = specs

# MoE's shard_map path
arrays = {}
for name, (arch, cf, rules) in job["moe"].items():
    cfg = configs.get_config(arch, smoke=True)
    p = moe.moe_init(jax.random.key(0), cfg)
    x = jax.random.normal(jax.random.key(1), (*job["x_shape"], cfg.d_model),
                          jnp.float32) * 0.3
    with mesh, S.logical_axis_rules(rules, mesh):
        y, aux = jax.jit(lambda p, x: moe.moe_apply(p, cfg, x, cf))(p, x)
    arrays[name + "/x"] = np.asarray(x)
    arrays[name + "/out"] = np.asarray(y)
    arrays[name + "/aux"] = np.asarray(aux)
    for k, v in p.items():
        arrays[name + "/p/" + k] = np.asarray(v)
np.savez(out_dir + "/moe.npz", **arrays)

# the elastic reshard: save under (4, 2), restore under (2, 2)
m42 = make_mesh((4, 2), ("data", "model"))
x = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
save(out_dir + "/ckpt", 1, {"w": jax.device_put(
    x, NamedSharding(m42, P("data", "model")))})
m22 = make_mesh((2, 2), ("data", "model"))
got = restore(out_dir + "/ckpt", 1,
              {"w": jax.ShapeDtypeStruct((8, 8), jnp.float32)},
              {"w": NamedSharding(m22, P("data", "model"))})
ids = [d.id for d in m22.devices.reshape(-1)]
by_dev = {s.device.id: np.asarray(s.data).tolist()
          for s in got["w"].addressable_shards}
res["reshard_blocks"] = [by_dev[i] for i in ids]
json.dump(res, open(out_dir + "/res.json", "w"))
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's answers, from one subprocess on 8 fake devices."""
    d = tmp_path_factory.mktemp("ref_mesh")
    cfg = configs.get_config("qwen2-1.5b", smoke=True)
    rules = rules_for(cfg, configs.get_shape("train_4k", smoke=True),
                      _mesh((2, 4)))
    sites = _call_sites()
    job = {"rules": rules, "sites": sites, "x_shape": X_SHAPE,
           "moe": MOE_CASES}
    (d / "job.json").write_text(json.dumps(job))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    r = subprocess.run([sys.executable, "-c", REF_CODE, str(d / "job.json"),
                        str(d)], capture_output=True, text=True, timeout=600,
                       env=env)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stderr[-4000:]
    res = json.loads((d / "res.json").read_text())
    with np.load(d / "moe.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return {"rules": rules, "sites": sites, "dir": str(d), "arrays": arrays,
            **res}


def _json(spec) -> list:
    """A spec as JSON, a one-axis tuple as the axis (``PartitionSpec``
    prints ``("data",)`` as ``"data"``: the same placement)."""
    return [e[0] if isinstance(e, list) and len(e) == 1 else e
            for e in json.loads(json.dumps(spec))]


# -- constrain ----------------------------------------------------------------

def test_the_ten_call_sites_are_recorded(ref):
    assert len(ref["sites"]) == 10
    assert {tuple(a) for _s, a in ref["sites"]} >= {
        ("batch", "seq", "heads", None), ("batch", "heads", None, None),
        ("batch", "seq", "ff"), ("batch", "seq_act", "embed"),
        ("batch", "seq", "vocab")}


@pytest.mark.parametrize("site", range(10))
def test_constrain_spec_matches_reference(ref, site):
    shape, axes = ref["sites"][site]
    mesh = _mesh((2, 4))
    got = sharding.guarded_spec(shape, axes, ref["rules"], mesh)
    assert _json(got) == _json(ref["specs"][site]), (shape, axes)
    # a plain tensor under the rules comes back as it is
    x = torch.zeros(shape)
    with logical_axis_rules(ref["rules"], mesh):
        assert sharding.constrain(x, axes) is x


def test_constrain_redistributes_a_dtensor():
    """On a DTensor the constraint is a redistribution to the guarded
    spec's placement (under the dry-run's fake group)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = _mesh((2, 4))
    rules = {"batch": "data", "heads": "model", "ff": ("data", "model")}
    with dryrun.per_device(mesh) as dmesh:
        x = DTensor.from_local(torch.zeros(4, 8, 6, device="meta"), dmesh,
                               [Replicate(), Replicate()], run_check=False)
        with logical_axis_rules(rules, mesh):
            y = sharding.constrain(x, ("batch", None, "heads"))
            # 6 heads over 4 devices: the guard leaves the dim whole
            assert tuple(y.placements) == (Shard(0), Replicate())
            assert tuple(y._local_tensor.shape) == (2, 8, 6)
            z = sharding.constrain(x, (None, "ff"))
            assert tuple(z.placements) == (Shard(1), Shard(1))
            assert tuple(z._local_tensor.shape) == (4, 1, 6)
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_placements_follow_the_spec_tuple_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = resolve_mesh(DistSpec((2, 2, 2), ("pod", "data", "model")), "cpu")
    pl = sharding.placements(NamedSharding(mesh, (("pod", "data"), None,
                                                  "model")))
    assert pl == [Shard(0), Shard(0), Shard(2)]
    assert sharding.placements(NamedSharding(mesh, (None,))) == \
        [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        sharding.placements(NamedSharding(mesh, (("data", "pod"),)))
    with pytest.raises(ValueError, match="order"):
        sharding.placements(NamedSharding(mesh, ("data", "data")))


def test_guarded_spec_drops_an_axis_already_used():
    """FSDP's ``embed`` on the batch's ``data`` axis: the reference raises
    ``DuplicateSpecError`` (its full-width FSDP cells under ``single``);
    the port leaves the later dimension whole."""
    mesh = _mesh((2, 4))
    rules = {"batch": ("data",), "embed": "data", "seq": "model"}
    assert sharding.guarded_spec((4, 8, 16), ("batch", "seq", "embed"),
                                 rules, mesh) == (("data",), "model", None)


def test_block_slices_cut_tuples_major_to_minor():
    mesh = resolve_mesh(DistSpec((2, 2, 2), ("pod", "data", "model")), "cpu")
    sh = NamedSharding(mesh, (("pod", "data"), "model"))
    # device 3 is pod 0, data 1, model 1: rows 2..4 of 8, columns 2..4
    assert sh.block_slices((8, 4), 3) == (slice(2, 4), slice(2, 4))
    assert sh.block_slices((8, 4), 4) == (slice(4, 6), slice(0, 2))
    x = torch.arange(32.0).reshape(8, 4)
    leaf = ShardedLeaf.place(x, sh)
    assert leaf.device_count == 8
    assert all(tuple(b.shape) == (2, 2) for b in leaf.blocks)
    assert torch.equal(leaf.full(), x)


# -- shard_map ----------------------------------------------------------------

def test_lock_step_driver_collectives():
    """psum adds a group's partials, all_gather concatenates them in shard
    order, axis_index is the shard's coordinate."""
    mesh = _mesh((2, 3))

    def body(x):
        i = yield sm.axis_index("model")
        j = yield sm.axis_index("data")
        s = yield sm.psum(x * 0 + i, "model")
        g = yield sm.all_gather(x, "model", 1)
        m = yield sm.pmean(torch.tensor(float(j)), ("data", "model"))
        return s, g, m

    x = torch.arange(12.0).reshape(2, 6)
    s, g, m = sm.shard_map(body, mesh, [("data", "model")],
                           [("data", "model"), ("data", None), ()], [x])
    assert torch.equal(s, torch.full((2, 6), 3.0))     # 0 + 1 + 2
    assert torch.equal(g, x)
    assert float(m) == 0.5


def _moe_case(ref, name):
    arch, cf, rules = MOE_CASES[name]
    cfg = configs.get_config(arch, smoke=True)
    a = ref["arrays"]
    p = params_from_numpy({k.split("/p/")[1]: v for k, v in a.items()
                           if k.startswith(name + "/p/")}, cfg)
    return cfg, cf, rules, p, torch.from_numpy(a[name + "/x"])


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_shard_map_matches_reference(ref, name):
    cfg, cf, rules, p, x = _moe_case(ref, name)
    want = ref["arrays"][name + "/out"]
    want_aux = float(ref["arrays"][name + "/aux"])
    mesh = _mesh((2, 4))
    with logical_axis_rules(rules, mesh):
        got, aux = moe.moe_apply(p, cfg, x, cf)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert abs(float(aux) - want_aux) <= 1e-6 * abs(want_aux)
    # the per-shard capacity drops tokens the local path keeps
    local, _ = moe._moe_local(p, cfg, x, cf)
    assert not torch.allclose(local, got, atol=1e-5)


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_shard_map_gradients_match_local_path(ref, name):
    """No token drops (capacity factor 8): the shard_map path and the
    local path are one function, and so are their gradients."""
    cfg, _cf, rules, p, x = _moe_case(ref, name)
    r = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))

    def local(leaves, xx):
        return moe._moe_local(leaves, cfg, xx, 8.0)

    def sharded(leaves, xx):
        with logical_axis_rules(rules, _mesh((2, 4))):
            return moe.moe_apply(leaves, cfg, xx, 8.0)

    def grad_list(run):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        xx = x.detach().requires_grad_()
        out, aux = run(leaves, xx)
        return torch.autograd.grad((out * r).sum() + aux,
                                   [xx, *leaves.values()])

    for want, got in zip(grad_list(local), grad_list(sharded)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_moe_shard_map_matches_local_as_the_reference_checks(ref):
    """The reference's ``test_moe_shard_map_matches_local``: moonshot in
    expert mode on a (2, 4) mesh at capacity factor 8 against
    ``_moe_local``, rtol 3e-3 (aux 1e-3)."""
    cfg, _cf, rules, p, x = _moe_case(ref, "moonshot-expert")
    want, aux_w = moe._moe_local(p, cfg, x, 8.0)
    with logical_axis_rules(rules, _mesh((2, 4))):
        got, aux_g = moe.moe_apply(p, cfg, x, 8.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-3,
                               atol=3e-3)
    np.testing.assert_allclose(float(aux_g), float(aux_w), rtol=1e-3)


def test_one_device_model_mesh_keeps_the_local_path(monkeypatch):
    cfg = configs.get_config("moonshot-v1-16b-a3b", smoke=True)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 8, cfg.d_model)
    monkeypatch.setattr(moe, "_moe_shard_map", None)    # not reached
    with logical_axis_rules(_EXPERT, _mesh((1, 1))):
        out, _ = moe.moe_apply(p, cfg, x)
    assert out.shape == x.shape


# -- the elastic reshard ------------------------------------------------------

def _check_reshard(got, want_blocks):
    leaf = got["w"]
    assert isinstance(leaf, ShardedLeaf) and leaf.device_count == 4
    assert [tuple(b.shape) for b in leaf.blocks] == \
        [leaf.sharding.shard_shape((8, 8))] * 4 == [(4, 4)] * 4
    assert [b.tolist() for b in leaf.blocks] == want_blocks
    assert torch.equal(leaf.full(),
                       torch.arange(64, dtype=torch.float32).reshape(8, 8))


def test_elastic_reshard_restore(ref, tmp_path):
    """The port saves under a (4, 2) mesh and restores under (2, 2)."""
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    placed = ShardedLeaf.place(x, NamedSharding(_mesh((4, 2)),
                                                ("data", "model")))
    assert placed.device_count == 8
    save(str(tmp_path), 1, {"w": placed})
    got = restore(str(tmp_path), 1,
                  {"w": torch.empty(8, 8, device="meta")},
                  {"w": NamedSharding(_mesh((2, 2)), ("data", "model"))})
    _check_reshard(got, ref["reshard_blocks"])


def test_reference_checkpoint_reshards_in_the_port(ref):
    """A step the reference wrote under its (4, 2) mesh restores under the
    port's (2, 2) as the reference restores it."""
    got = restore(os.path.join(ref["dir"], "ckpt"), 1,
                  {"w": torch.empty(8, 8, device="meta")},
                  {"w": NamedSharding(_mesh((2, 2)), ("data", "model"))})
    _check_reshard(got, ref["reshard_blocks"])


def test_restore_on_a_one_device_mesh_is_a_tensor(tmp_path):
    tree = {"w": torch.randn(4, 6), "b": torch.randn(3).to(torch.bfloat16)}
    save(str(tmp_path), 2, tree)
    target = {k: torch.empty_like(v, device="meta") for k, v in tree.items()}
    one = _mesh((1, 1))
    got = restore(str(tmp_path), 2, target, {
        "w": NamedSharding(one, ("data", "model")),
        "b": NamedSharding(one, (None,))})
    plain = restore(str(tmp_path), 2, target)
    for k, v in tree.items():
        assert type(got[k]) is torch.Tensor and got[k].device.type == "cpu"
        assert torch.equal(got[k], v) and torch.equal(plain[k], v)
