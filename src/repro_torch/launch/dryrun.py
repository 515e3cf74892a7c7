"""Dry-run: count every (arch × shape × mesh) cell on ``meta`` tensors (the
port of ``src/repro/launch/dryrun.py``).

For each cell this produces, with zero device allocation:
  * the memory a step holds: argument, temporary, output and aliased
    bytes and their peak (``roofline.op_counter``'s live-storage count in
    place of ``compiled.memory_analysis()``) — does the cell fit one card?
  * FLOPs of the matrix products by dtype and bytes touched (the counter
    in place of the HLO analyzer), collective bytes,
  * the arguments' bytes on one device under the sharding policy
    (``shardspec.tree_shardings``, the reference's ``in_shardings``;
    all of them at mesh ``one``),
  * the three roofline terms against one H100 SXM, the dominant one and
    the MODEL_FLOPS ratio.  The memory term reads the bytes the step must
    move (``OpCost.moved_bytes``: arguments read, new outputs written),
    not the eager ops' bytes, which exceed XLA's fused bytes and move
    with the implementation; their time is beside it as ``eager_bytes_s``.

The state, the inputs (``launch/inputs.py``) and the decode cache are
built on ``meta``, and the train step, the prefill or the decode step runs
once under the counter: eager torch has no trace without a run, so
``lower_s`` is the seconds of that meta run and ``compile_s`` is 0.

Meshes: ``one`` (the default) is the 1 × 1 ``("data", "model")`` mesh, the
one mesh a single card holds.  ``single`` (16 × 16), ``multi`` (2 × 16 ×
16), ``tiny`` (2 × 2) and ``tiny_multi`` (2 × 2 × 2) are the reference's
meshes of more than one device (``both`` runs ``single`` and ``multi``).
Under them a record is one device's: where the reference reads XLA's
SPMD-partitioned HLO, the port runs the step on DTensors (``per_device``):
this process is rank 0 of a fake process group as large as the mesh, each
argument is a DTensor of ``meta`` blocks placed as
``shardspec.tree_shardings`` says, and DTensor propagates the placements
through the step (under ``implicit_replication``: a tensor the model makes,
such as positions, is replicated) while the counter counts device 0's
local ops and the collectives that redistribution issues.  Where DTensor
cannot, or would not, split as GSPMD does, ``_Reshard`` reshards first
and the counter counts it: a view over an unevenly split dimension (such
as qwen2's 12 heads over a 16-way ``model`` axis) gathers its input over
the offending mesh axes; masked partials and a matrix product's partial
operands are reduced; a failed propagation runs on whole inputs.  The
counts follow the installed torch's DTensor (PERF.md §6).  The group is
set up and torn down around each cell.

Usage:
  python -m repro_torch.launch.dryrun --arch all --shape all \
      --out experiments/dryrun/one.json
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k \
      --mesh tiny --smoke-config
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b,mamba2-370m \
      --shape train_4k,decode_32k --smoke-config
"""
import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_IDS, SHAPES, get_config, get_shape
from ..configs.shapes import ShapeConfig
from ..dist.sharding import is_dtensor, logical_axis_rules, placements
from ..models import forward, init_cache, init_params
from ..models.config import ModelConfig
from ..roofline.analysis import roofline_terms
from ..roofline.hw import H100_SXM
from ..roofline.op_counter import analyze
from ..serving.decode import build_serve_step
from ..training import (AdamWConfig, TrainState, TrainStepConfig,
                        adamw_init, build_train_step)
from ..training.train_state import prng_key
from .inputs import input_specs
from .mesh import make_mesh, make_production_mesh
from .shardspec import (_map_with_path, batch_logical_axes,
                        cache_logical_axes, device_bytes, keystr,
                        moe_rules_patch, param_logical_axes, rules_for,
                        tree_flatten_with_path, tree_shardings)

BIG_PARAM_THRESHOLD = 50e9    # bf16 optimizer moments above this
MESHES = ("one", "single", "multi", "tiny", "tiny_multi")


def _mesh_for(kind: str):
    """The mesh of ``--mesh kind``, of CPU devices: the dry-run counts on
    ``meta`` and moves nothing."""
    if kind == "one":
        return make_mesh((1, 1), ("data", "model"), device="cpu")
    if kind == "single":
        return make_production_mesh(device="cpu")
    if kind == "multi":
        return make_production_mesh(multi_pod=True, device="cpu")
    if kind == "tiny":
        return make_mesh((2, 2), ("data", "model"), device="cpu")
    if kind == "tiny_multi":
        return make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    raise ValueError(kind)


@contextlib.contextmanager
def per_device(mesh):
    """This process as rank 0 of a fake process group as large as
    ``mesh`` (its collectives move nothing), for the enclosed region;
    yields the DTensor ``DeviceMesh`` over it.  Torn down on exit, so no
    group outlives the region."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry-run's per-device count needs its own")
    n = int(mesh.devices.size)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield DeviceMesh("cpu", torch.arange(n).reshape(mesh.devices.shape),
                         mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()


def as_dtensors(tree, shardings, dmesh):
    """``tree`` with each tensor leaf a DTensor of ``meta`` blocks, placed
    as its ``shardings`` entry says (``dist.sharding.placements``)."""
    from torch.distributed.tensor import DTensor
    by_path = {keystr(p): sh for p, sh in tree_flatten_with_path(shardings)}

    def leaf(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        sh = by_path[keystr(path)]
        block = torch.empty(sh.shard_shape(x.shape), dtype=x.dtype,
                            device="meta")
        return DTensor.from_local(block, dmesh, placements(sh),
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())

    return _map_with_path(leaf, tree)


def _kept_dims(in_shape, out_shape) -> set:
    """The input dimensions a view leaves whole: same size at the same
    offset in both shapes."""
    starts = {math.prod(out_shape[:j]): out_shape[j]
              for j in range(len(out_shape))}
    return {d for d, n in enumerate(in_shape)
            if starts.get(math.prod(in_shape[:d])) == n}


class _Reshard(TorchDispatchMode):
    """GSPMD's resharding where DTensor's propagation cannot go on:

    * a view of a DTensor that raises (a dimension unevenly sharded for
      the split it asks for) is retried after gathering its input over
      the mesh axes that split a dimension the view does not keep whole,
      then over all;
    * a masked partial output (a gather or an embedding lookup over a
      split vocabulary) is reduced at once: DTensor loses its mask through
      a later view (``gather(...)[..., 0]``) and fails where it reduces;
    * any other op whose sharding DTensor cannot propagate (torch 2.11's
      ``index_put`` strategy, an embedding's backward, fails on its own
      negative dimension) runs on its inputs gathered whole;
    * a matrix product takes no partial operand: it is reduced first.
      DTensor keeps a residual partial through ``rms_norm``'s (linear)
      scaling and then multiplies it by the whole gathered weight, where
      GSPMD reduces it and splits the product.

    All are redistributions, so the counter below counts their
    collectives."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket in flop_registry:
            args = tuple(_reduced(a) for a in args)
        try:
            out = func(*args, **kwargs)
        except RuntimeError as e:
            if func in _view_ops() and is_dtensor(args[0]):
                out = self._gathered_view(func, args, kwargs)
            elif ("Sharding propagation failed" in str(e)
                  and not func._schema.is_mutable):
                out = func(*tree_map(_replicated, args),
                           **tree_map(_replicated, kwargs))
            else:
                raise
        if is_dtensor(out) and any(type(p).__name__.endswith("MaskPartial")
                                   for p in out.placements):
            from torch.distributed.tensor import Replicate
            out = out.redistribute(out.device_mesh, [
                Replicate() if type(p).__name__.endswith("MaskPartial")
                else p for p in out.placements])
        return out

    @staticmethod
    def _gathered_view(func, args, kwargs):
        from torch.distributed.tensor import Replicate, Shard
        x = args[0]
        out = list(args[1])
        if -1 in out:
            out[out.index(-1)] = x.numel() // -math.prod(out)
        kept = _kept_dims(tuple(x.shape), tuple(out))
        for keep in (kept, set()):
            want = [Replicate() if isinstance(p, Shard) and p.dim not in keep
                    else p for p in x.placements]
            x = x.redistribute(x.device_mesh, want)
            try:
                return func(x, *args[1:], **kwargs)
            except RuntimeError:
                if not keep:
                    raise
        raise AssertionError("unreachable")


def _replicated(x):
    """``x`` whole on every device, if it is a DTensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _reduced(x):
    """``x`` with its partial mesh axes reduced, if it is such a DTensor."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def _view_ops() -> frozenset:
    aten = torch.ops.aten
    return frozenset({aten.view.default, aten._unsafe_view.default,
                      aten.reshape.default})


def _on_dtensors(fn):
    """``fn`` under ``implicit_replication`` and :class:`_Reshard`."""
    def run(*args):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication(), _Reshard():
            return fn(*args)
    return run


def _opt_config(cfg: ModelConfig) -> AdamWConfig:
    big = cfg.num_params_estimate() > BIG_PARAM_THRESHOLD
    return AdamWConfig(m_dtype="bfloat16" if big else "float32",
                       v_dtype="bfloat16" if big else "float32")


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_active = cfg.active_params_estimate()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # decode: one token


def train_step_config(cfg: ModelConfig, shape: ShapeConfig
                      ) -> TrainStepConfig:
    """The microbatch policy (validated against per-cell peak HBM in the
    reference): >100B: 8; >3B or SSM/hybrid (SSD chunk tensors ∝ tokens):
    4; else 1 — and 1 where the batch does not divide; bf16 accumulators
    past 100B."""
    nparams = cfg.num_params_estimate()
    if nparams > 100e9:
        mb = 8
    elif nparams > 3e9 or cfg.ssm is not None:
        mb = 4
    else:
        mb = 1
    if shape.global_batch % mb:
        mb = 1
    accum = "bfloat16" if nparams > 100e9 else "float32"
    return TrainStepConfig(microbatches=mb, accum_dtype=accum)


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: dict):
    """The cell's step function, its ``meta`` arguments and their
    placements under the policy (the reference's ``in_shardings``): (fn,
    args, shardings, chips); ``fn(*args)`` runs the step."""
    specs = input_specs(cfg, shape)
    chips = int(mesh.devices.size)
    params = init_params(torch.Generator(), cfg, device="meta")

    if shape.kind == "train":
        opt_cfg = _opt_config(cfg)
        train_step = build_train_step(cfg, opt_cfg,
                                      train_step_config(cfg, shape))
        state = TrainState.create(params, adamw_init(opt_cfg, params),
                                  prng_key(0, "meta"))
        shardings = (tree_shardings(state, mesh, rules, param_logical_axes),
                     tree_shardings(specs, mesh, rules, batch_logical_axes))
        return train_step, (state, specs), shardings, chips

    in_key = "tokens" if cfg.input_mode == "tokens" else "embeds"
    x = specs[in_key]
    params_sh = tree_shardings(params, mesh, rules, param_logical_axes)
    x_sh = tree_shardings({in_key: x}, mesh, rules,
                          batch_logical_axes)[in_key]
    if shape.kind == "prefill":
        def prefill_step(params, x):
            with torch.no_grad():
                logits, _ = forward(params, cfg, **{in_key: x})
            return logits[:, -1, :].clone()

        return prefill_step, (params, x), (params_sh, x_sh), chips

    # decode: the cache is updated in place (aliased to the output)
    serve_step = build_serve_step(cfg)

    def decode_fn(params, cache, x):
        with torch.no_grad():
            return serve_step(params, cache, **{in_key: x})

    cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    cache_sh = tree_shardings(cache, mesh, rules, cache_logical_axes)
    return decode_fn, (params, cache, x), (params_sh, cache_sh, x_sh), chips


def run_cell(arch: str, shape_name: str, mesh_kind: str = "one",
             smoke_config: bool = False,
             global_batch: int | None = None) -> dict:
    """One cell's record; ``global_batch`` cuts the shape's batch (one
    card's cell of a shape)."""
    cfg = get_config(arch, smoke=smoke_config)
    shape = get_shape(shape_name, smoke=smoke_config)
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=global_batch)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "kind": shape.kind, "global_batch": shape.global_batch}
    if shape_name == "long_500k" and not cfg.supports_long_context:
        rec["status"] = "skipped"
        rec["reason"] = ("pure full-attention arch: long_500k requires "
                         "sub-quadratic attention (DESIGN.md "
                         "§Arch-applicability)")
        return rec
    t0 = time.time()
    try:
        mesh = _mesh_for(mesh_kind)
        rules = moe_rules_patch(cfg, rules_for(cfg, shape, mesh))
        with logical_axis_rules(rules, mesh):
            fn, args, shardings, chips = lower_cell(cfg, shape, mesh, rules)
            arg_bytes = device_bytes(args, shardings)
            if chips == 1:
                cost = analyze(fn, *args)
            else:
                with per_device(mesh) as dmesh:
                    cost = analyze(_on_dtensors(fn), *as_dtensors(
                        args, shardings, dmesh))
        t_lower = time.time() - t0
        del fn, args
        mf = model_flops_for(cfg, shape)
        terms = roofline_terms({"flops": cost.flops_total,
                                "bytes accessed": cost.moved_bytes,
                                "flops_by_dtype": cost.flops},
                               cost.collective_bytes, chips, mf)
        rec.update({
            "status": "ok",
            "chips": chips,
            "lower_s": round(t_lower, 2),
            "compile_s": 0.0,
            "memory": cost.memory(),
            "cost": {"flops_per_device": cost.flops_total,
                     "bytes_per_device": cost.bytes,
                     "moved_bytes_per_device": cost.moved_bytes,
                     "flops_by_dtype": dict(cost.flops)},
            "collective_bytes": dict(cost.collective_bytes),
            "roofline": {
                "compute_s": terms.compute_s,
                "memory_s": terms.memory_s,
                "eager_bytes_s": cost.bytes / H100_SXM.hbm_bw,
                "collective_s": terms.collective_s,
                "dominant": terms.dominant,
                "model_flops": terms.model_flops,
                "hlo_flops_total": terms.hlo_flops_total,
                "useful_flops_fraction": terms.useful_flops_fraction,
                "roofline_fraction": terms.roofline_fraction,
                "step_lower_bound_s": terms.step_time_lower_bound_s,
            },
        })
        rec["peak_bytes"] = cost.peak_bytes
        rec["argument_bytes_per_device"] = arg_bytes
        rec["fits_hbm"] = bool(cost.peak_bytes <= H100_SXM.hbm_bytes)
    except Exception as e:    # noqa: BLE001 — sweep must survive cell bugs
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="one",
                    choices=["one", "single", "multi", "both", "tiny",
                             "tiny_multi"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--smoke-config", action="store_true",
                    help="reduced model configs (CI)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = (["single", "multi"] if args.mesh == "both"
              else [args.mesh])
    for mesh_kind in meshes:
        _mesh_for(mesh_kind)            # raises before any work

    records = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                rec = run_cell(arch, shape, mesh_kind, args.smoke_config)
                records.append(rec)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" dominant={r['dominant']}"
                             f" frac={r['roofline_fraction']:.3f}"
                             f" lower={rec['lower_s']:.1f}s")
                elif status == "error":
                    extra = " " + rec["error"][:160]
                print(f"[dryrun] {arch:24s} {shape:12s} {mesh_kind:6s} "
                      f"{status}{extra}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"[dryrun] wrote {len(records)} records to {args.out}")
    bad = [r for r in records if r["status"] == "error"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
