"""Training launcher of the port (the port of ``src/repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --smoke --steps 50 --ckpt-dir /tmp/ckpt [--device cpu]

The parameters are drawn on ``--device`` (default ``cuda``) from a
``torch.Generator`` seeded with ``--seed``; the batches are the synthetic
pipeline's (a pure function of the seed and the step).  With
``--ckpt-dir`` the run resumes from the newest committed step there (its
host arrays moved back to the device) and saves asynchronously every
``--ckpt-every`` steps and at the end; a job relaunched with the same
flags after a crash follows the same lr schedule from the step it resumes.

``train`` is the loop as a function: it returns the final state and a
per-step history (loss, grad norm, lr, step and data seconds, each read
after the device finished); ``main`` prints the reference's log lines from
it.  ``--mesh single | multi | tiny`` builds the reference's mesh (16 x 16,
2 x 16 x 16 or 2 x 2) on ``--device`` and runs the loop under its
logical-axis rules (``shardspec.rules_for`` of a ``train`` shape of the
run's sequence length and batch, patched for MoE): one process drives every
shard, so the state stays whole on ``--device`` and MoE layers take the
shard_map path, each shard's blocks on its mesh device.  On ``cuda`` a
mesh needs that many cards and raises ``DeviceCountError`` naming the
count before any work; on ``cpu`` every mesh device is the CPU.  ``none``
(the default) runs with no mesh.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch

from ..checkpoint import Checkpointer, latest_step, restore
from ..configs import get_config
from ..configs.shapes import ShapeConfig
from ..data.pipeline import DataConfig, SyntheticLM
from ..dist.sharding import logical_axis_rules
from ..models import init_params
from ..models.config import ModelConfig
from ..training import (AdamWConfig, TrainState, TrainStepConfig, adamw_init,
                        build_train_step)
from ..training.train_state import prng_key
from .mesh import make_mesh, make_production_mesh
from .shardspec import moe_rules_patch, rules_for

MESHES = ("none", "single", "multi", "tiny")


def build_mesh(kind: str, device="cuda"):
    """The reference's ``--mesh`` on ``device``'s type, or None for
    ``none``."""
    if kind == "none":
        return None
    if kind == "single":
        return make_production_mesh(device=device)
    if kind == "multi":
        return make_production_mesh(multi_pod=True, device=device)
    if kind == "tiny":
        return make_mesh((2, 2), ("data", "model"), device=device)
    raise ValueError(f"--mesh {kind}: one of {MESHES}")


@dataclasses.dataclass
class TrainRun:
    """What one ``train`` call made: the config, the final state, and one
    history record per step it ran (``step``, ``loss``, ``grad_norm``,
    ``lr``, ``step_s``: the train step until the device finished,
    ``data_s``: the batch's host time and upload); ``resumed_from`` is the
    checkpoint step it started from, or None."""
    cfg: ModelConfig
    state: TrainState
    history: list
    resumed_from: int | None = None


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(arch: str, *, smoke: bool = False, steps: int = 100,
          global_batch: int = 8, seq_len: int = 128, lr: float = 3e-4, microbatches: int = 1,
          ckpt_dir: str | None = None, ckpt_every: int = 25, seed: int = 0,
          device="cuda", mesh: str = "none",
          on_step: Callable[[int, TrainState, dict], Any] | None = None
          ) -> TrainRun:
    """Train ``arch`` (random init from ``seed``) on the synthetic bigram
    stream up to step ``steps`` on ``device``, resuming from ``ckpt_dir``'s
    newest step, under ``mesh`` (see the module doc); ``on_step(step,
    state, metrics)`` sees each step's new state."""
    cfg = get_config(arch, smoke=smoke)
    mesh_obj = build_mesh(mesh, device)         # raises before any work
    scope = contextlib.nullcontext()
    if mesh_obj is not None:
        shape = ShapeConfig("cli", "train", seq_len, global_batch)
        scope = logical_axis_rules(
            moe_rules_patch(cfg, rules_for(cfg, shape, mesh_obj)), mesh_obj)
    with scope:
        return _train_loop(cfg, steps=steps, global_batch=global_batch,
                           seq_len=seq_len, lr=lr, microbatches=microbatches,
                           ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                           seed=seed, device=device, on_step=on_step)


def _train_loop(cfg: ModelConfig, *, steps, global_batch, seq_len, lr,
                microbatches, ckpt_dir, ckpt_every, seed, device,
                on_step) -> TrainRun:
    opt_cfg = AdamWConfig(lr_peak=lr, warmup_steps=max(steps // 10, 1),
                          total_steps=steps)
    data = SyntheticLM(DataConfig(seed=seed, global_batch=global_batch,
                                  seq_len=seq_len, vocab_size=cfg.vocab_size,
                                  input_mode=cfg.input_mode,
                                  d_model=cfg.d_model))
    dev = torch.device(device)
    train_step = build_train_step(cfg, opt_cfg,
                                  TrainStepConfig(microbatches=microbatches))
    params = init_params(torch.Generator(dev).manual_seed(seed), cfg, dev)
    run = TrainRun(cfg, TrainState.create(
        params, adamw_init(opt_cfg, params), prng_key(seed, dev)), [])
    del params          # the state holds them (a resume frees them first)

    start, ckpt = 0, None
    if ckpt_dir:
        ckpt = Checkpointer(ckpt_dir)
        last = latest_step(ckpt_dir)
        if last is not None:
            host = restore(ckpt_dir, last, run.state)
            run.state = None
            run.state = host.to(dev)
            start = run.resumed_from = last

    for step in range(start, steps):
        t0 = time.perf_counter()
        batch = data.batch_at(step, device=dev)
        t1 = time.perf_counter()
        run.state, metrics = train_step(run.state, batch)
        _synchronize(dev)
        rec = {"step": step, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"]),
               "step_s": time.perf_counter() - t1, "data_s": t1 - t0}
        run.history.append(rec)
        if on_step is not None:
            on_step(step, run.state, metrics)
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save_async(step + 1, run.state)
    if ckpt:
        ckpt.wait()
        ckpt.save_async(steps, run.state)
        ckpt.wait()
    return run


def main(argv=None) -> int:
    """CLI: the reference's flags plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", default="none", choices=list(MESHES))
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the parameters and the state live and the "
                    "step runs")
    args = ap.parse_args(argv)
    run = train(args.arch, smoke=args.smoke, steps=args.steps,
                global_batch=args.global_batch, seq_len=args.seq_len,
                lr=args.lr, microbatches=args.microbatches,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                seed=args.seed, device=args.device, mesh=args.mesh)
    if run.resumed_from is not None:
        print(f"[train] resumed from step {run.resumed_from}")
    elapsed = 0.0
    for rec in run.history:
        elapsed += rec["data_s"] + rec["step_s"]
        step = rec["step"]
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step={step} loss={rec['loss']:.4f} "
                  f"gnorm={rec['grad_norm']:.3f} lr={rec['lr']:.2e} "
                  f"({elapsed:.1f}s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
