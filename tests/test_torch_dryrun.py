"""The port's dry-run (``repro_torch.launch.dryrun``) on ``meta`` tensors,
against the reference's where both compute the same thing, on the CPU.

* ``model_flops_for`` equals the reference's for all 40 cells.
* The CLI at ``--mesh one --smoke-config`` for qwen2-1.5b and mamba2-370m
  x train_4k and decode_32k exits 0 with 4 ``ok`` lines (the reference's
  ``tests/test_distributed.py`` dry-run smoke), and a meta cell counts
  what the same step counts on CPU tensors.
* The CLI under each mesh of more than one device (``single``, ``multi``,
  ``tiny``, ``tiny_multi``, ``both``) exits 0 with one ``ok`` line per
  cell, its records per device (``tests/test_torch_dryrun_mesh.py`` holds
  them against the reference's), and ``long_500k`` is skipped for
  full-attention archs, as in the reference.
* The MoE cells run on ``meta`` (the fixed-length count that replaced
  ``bincount``), and ``moe_apply`` under a 1 x 1 ``("data", "model")``
  mesh equals the reference's ``shard_map`` path under its 1 x 1 mesh.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.dist.sharding import logical_axis_rules as ref_rules_scope
from repro.launch import shardspec as ref_ss
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.models import moe as ref_moe
from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist.sharding import logical_axis_rules
from repro_torch.launch import dryrun
from repro_torch.launch import shardspec as ss
from repro_torch.models import init_params, moe, params_from_numpy
from repro_torch.roofline import H100_SXM, analyze
from repro_torch.training import TrainState, adamw_init, build_train_step
from repro_torch.training.train_state import prng_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_model_flops_for():
    """The reference's ``model_flops_for``.  Importing its dry-run module
    sets ``XLA_FLAGS`` from ``REPRO_DRYRUN_XLA_FLAGS``: point that at the
    current value, so this process's device count stays as it is."""
    old = os.environ.get("REPRO_DRYRUN_XLA_FLAGS")
    os.environ["REPRO_DRYRUN_XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "")
    try:
        from repro.launch.dryrun import model_flops_for
    finally:
        if old is None:
            del os.environ["REPRO_DRYRUN_XLA_FLAGS"]
        else:
            os.environ["REPRO_DRYRUN_XLA_FLAGS"] = old
    return model_flops_for


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_for_matches_reference(arch):
    ref = _ref_model_flops_for()
    for shape in configs.SHAPES:
        assert dryrun.model_flops_for(configs.get_config(arch),
                                      configs.get_shape(shape)) == \
            ref(ref_configs.get_config(arch), ref_configs.get_shape(shape))


def test_cli_smoke_mesh_one():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-1.5b,mamba2-370m", "--shape", "train_4k,decode_32k",
         "--mesh", "one", "--smoke-config"],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count(" ok") >= 4, r.stdout
    assert "jax" not in r.stderr


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m"])
def test_meta_cell_counts_what_a_cpu_step_counts(arch):
    cfg = configs.get_config(arch, smoke=True)
    shape = configs.get_shape("train_4k", smoke=True)
    rec = dryrun.run_cell(arch, "train_4k", smoke_config=True)
    assert rec["status"] == "ok" and rec["compile_s"] == 0.0
    opt = dryrun._opt_config(cfg)
    p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    state = TrainState.create(p, adamw_init(opt, p), prng_key(0))
    batch = SyntheticLM(DataConfig(seed=0, global_batch=shape.global_batch,
                                   seq_len=shape.seq_len,
                                   vocab_size=cfg.vocab_size)).batch_at(
        0, device="cpu")
    cost = analyze(build_train_step(cfg, opt, dryrun.train_step_config(
        cfg, shape)), state, batch)
    assert rec["cost"]["flops_by_dtype"] == cost.flops
    assert rec["memory"] == cost.memory()
    assert rec["peak_bytes"] == cost.peak_bytes
    # the bytes differ only by the rotary tables a CPU step need not copy
    # to its device: on any other device (meta, the card) each attention
    # layer copies its (hd / 2,) fp32 frequencies for q and for k, in the
    # forward and in remat's recompute
    copies = [e for e in cost.events if e[0] == "aten._to_copy.default"
              and e[1] == (((cfg.hd() // 2,), torch.float32),)]
    assert copies == []
    layers = sum(k != "ssm" for k in map(cfg.pattern_for_layer,
                                         range(cfg.num_layers)))
    per_layer = 2 * (2 if cfg.remat == "block" else 1)  # q, k; recompute
    # each copy reads and writes (hd / 2) fp32 values
    assert rec["cost"]["bytes_per_device"] - cost.bytes == \
        layers * per_layer * 2 * (cfg.hd() // 2) * 4 * (cfg.ssm is None)
    assert rec["fits_hbm"] and rec["roofline"]["dominant"] in (
        "compute", "memory")
    # the memory term reads the bytes the step must move, the same on meta
    # and on the CPU; the eager bytes' time is reported beside it
    assert rec["cost"]["moved_bytes_per_device"] == cost.moved_bytes
    # one device of mesh one holds every argument under the policy
    assert rec["argument_bytes_per_device"] == cost.argument_bytes
    assert rec["roofline"]["memory_s"] == cost.moved_bytes / H100_SXM.hbm_bw
    assert rec["roofline"]["eager_bytes_s"] == \
        rec["cost"]["bytes_per_device"] / H100_SXM.hbm_bw


def test_global_batch_cut_and_records():
    rec = dryrun.run_cell("qwen2-1.5b", "train_4k", "one",
                          smoke_config=True, global_batch=1)
    assert rec["global_batch"] == 1 and rec["chips"] == 1
    full = dryrun.run_cell("qwen2-1.5b", "train_4k", "one",
                           smoke_config=True)
    assert rec["cost"]["flops_per_device"] < full["cost"]["flops_per_device"]
    assert rec["memory"]["argument_bytes"] < full["memory"]["argument_bytes"]
    assert set(full) >= {"lower_s", "compile_s", "memory", "cost",
                         "collective_bytes", "roofline", "peak_bytes",
                         "fits_hbm"}
    assert sum(full["collective_bytes"].values()) == 0


@pytest.mark.parametrize("mesh", ["single", "multi", "tiny", "tiny_multi",
                                  "both"])
def test_meshes_of_more_than_one_device_are_not_ported(mesh, tmp_path,
                                                       capsys):
    """Once not ported; now each mesh runs: the CLI exits 0 with an ``ok``
    line per cell, and each record is one device's of a mesh of that
    many devices (its arguments' blocks under the policy)."""
    import torch.distributed as dist
    out = tmp_path / "recs.json"
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "prefill_32k",
                        "--mesh", mesh, "--smoke-config", "--out",
                        str(out)]) == 0
    assert not dist.is_initialized()
    recs = json.loads(out.read_text())
    chips = {"single": [256], "multi": [512], "tiny": [4],
             "tiny_multi": [8], "both": [256, 512]}[mesh]
    assert [r["chips"] for r in recs] == chips
    assert capsys.readouterr().out.count(" ok ") == len(chips)
    one = dryrun.run_cell("qwen2-1.5b", "prefill_32k", "one",
                          smoke_config=True)
    for r in recs:
        assert r["status"] == "ok" and r["fits_hbm"]
        assert r["memory"]["argument_bytes"] == \
            r["argument_bytes_per_device"] < one["argument_bytes_per_device"]
        assert r["cost"]["flops_per_device"] * r["chips"] >= \
            one["cost"]["flops_per_device"]
        assert sum(r["collective_bytes"].values()) > 0


def test_long_500k_is_skipped_for_full_attention():
    rec = dryrun.run_cell("qwen2-1.5b", "long_500k")
    assert rec["status"] == "skipped"
    rec = dryrun.run_cell("mamba2-370m", "long_500k", smoke_config=True)
    assert rec["status"] == "ok"


@pytest.mark.parametrize("cell", [("moonshot-v1-16b-a3b", "train_4k"),
                                  ("grok-1-314b", "decode_32k")])
def test_moe_cells_run_on_meta(cell):
    rec = dryrun.run_cell(*cell, smoke_config=True)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["cost"]["flops_per_device"] > 0


def test_fixed_length_count_is_bincount():
    ids = torch.randint(0, 9, (300,), generator=torch.Generator()
                        .manual_seed(0))
    assert torch.equal(moe._count(ids, 9), torch.bincount(ids, minlength=9))
    assert torch.equal(moe._count(ids[ids < 5], 9),
                       torch.bincount(ids[ids < 5], minlength=9))


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "grok-1-314b"])
def test_moe_apply_under_one_device_mesh_matches_reference(arch):
    rcfg = ref_configs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    rp = ref_moe.moe_init(jax.random.key(2), rcfg)
    x = np.array(jax.random.normal(jax.random.key(3), (2, 16, rcfg.d_model),
                                   jnp.float32) * 0.3)
    p = params_from_numpy(jax.tree.map(np.asarray, rp), cfg)
    shape = configs.get_shape("train_4k", smoke=True)
    rmesh = ref_make_mesh((1, 1), ("data", "model"))
    rrules = ref_ss.moe_rules_patch(rcfg, ref_ss.rules_for(
        rcfg, ref_configs.get_shape("train_4k", smoke=True), rmesh))
    with rmesh, ref_rules_scope(rrules, rmesh):
        want, want_aux = jax.jit(lambda p, x: ref_moe.moe_apply(
            p, rcfg, x))(rp, jnp.asarray(x))
    mesh = dryrun._mesh_for("one")
    rules = ss.moe_rules_patch(cfg, ss.rules_for(cfg, shape, mesh))
    assert rules == rrules
    with logical_axis_rules(rules, mesh):
        got, aux = moe.moe_apply(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
