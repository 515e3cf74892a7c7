"""``launch.train --mesh tiny`` on the CPU against the reference's
``repro.launch.train --mesh tiny`` on 4 of 8 fake CPU devices.

The reference's initial ``TrainState`` (moonshot smoke, random init from
seed 0) is written as step 0 of a checkpoint, so the port's ``train``
resumes from the reference's own parameters; both then take 3 steps of the
synthetic pipeline's batches under the 2 x 2 mesh's rules (the MoE layers
on their shard_map paths).  The reference's losses are read at full
precision from its step function (its CLI prints four decimals).  The
port's losses under ``tiny`` are within 1e-4 relative of the reference's
and of its own ``--mesh none`` run.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.launch import train as launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, STEPS, BATCH, SEQ = "moonshot-v1-16b-a3b", 3, 8, 32
TOL = 1e-4

REF_CODE = r"""
import json, sys
import jax
from repro.checkpoint import save
from repro.configs import get_config
from repro.configs.shapes import ShapeConfig
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.dist.sharding import logical_axis_rules
from repro.launch.mesh import make_mesh
from repro.launch.shardspec import moe_rules_patch, rules_for
from repro.models import init_params
from repro.training import (AdamWConfig, TrainState, TrainStepConfig,
                            adamw_init, build_train_step)

arch, steps, batch, seq, ckpt = sys.argv[1], *map(int, sys.argv[2:5]), \
    sys.argv[5]
# repro.launch.train.main's set-up, its losses kept at full precision
cfg = get_config(arch, smoke=True)
opt_cfg = AdamWConfig(lr_peak=3e-4, warmup_steps=max(steps // 10, 1),
                      total_steps=steps)
data = SyntheticLM(DataConfig(seed=0, global_batch=batch, seq_len=seq,
                              vocab_size=cfg.vocab_size,
                              input_mode=cfg.input_mode,
                              d_model=cfg.d_model))
mesh = make_mesh((2, 2), ("data", "model"))
rules = moe_rules_patch(cfg, rules_for(
    cfg, ShapeConfig("cli", "train", seq, batch), mesh))
losses = []
with mesh, logical_axis_rules(rules, mesh):
    train_step = build_train_step(cfg, opt_cfg, TrainStepConfig())
    key = jax.random.key(0)
    params = init_params(key, cfg)
    state = TrainState.create(params, adamw_init(opt_cfg, params), key)
    save(ckpt, 0, state)
    jstep = jax.jit(train_step, donate_argnums=(0,))
    for step in range(steps):
        state, metrics = jstep(state, data.batch_at(step))
        losses.append(float(metrics["loss"]))
print(json.dumps({"losses": losses, "devices": len(mesh.devices.flat)}))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_mesh")
    ckpt = str(d / "ref_step0")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    r = subprocess.run([sys.executable, "-c", REF_CODE, ARCH, str(STEPS),
                        str(BATCH), str(SEQ), ckpt], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["devices"] == 4
    return ckpt, out["losses"], d


@pytest.fixture(scope="module")
def port(reference):
    """The port's losses under ``tiny`` and ``none``, each resumed from a
    copy of the reference's step 0."""
    ckpt, _, d = reference
    out = {}
    for mesh in ("tiny", "none"):
        run_dir = str(d / f"port_{mesh}")
        shutil.copytree(ckpt, run_dir)
        run = launch.train(ARCH, smoke=True, steps=STEPS, global_batch=BATCH,
                           seq_len=SEQ, ckpt_dir=run_dir, device="cpu",
                           mesh=mesh)
        assert run.resumed_from == 0
        out[mesh] = [r["loss"] for r in run.history]
    return out


def test_train_mesh_tiny_matches_reference(reference, port):
    got = port["tiny"]
    assert len(got) == STEPS and np.isfinite(got).all()
    np.testing.assert_allclose(got, reference[1], rtol=TOL, atol=0)


def test_train_mesh_tiny_matches_no_mesh(port):
    np.testing.assert_allclose(port["tiny"], port["none"], rtol=TOL, atol=0)
