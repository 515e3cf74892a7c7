"""Per-arch / per-shape sharding policy for the production meshes (the port
of ``src/repro/launch/shardspec.py``, over the port's trees and
``dist.sharding.Mesh``).

This encodes the real placement decisions (DESIGN.md §5):
* DP over ('pod','data'); TP over 'model'; FSDP (weights' embed axis over
  'data') for ≥10B archs;
* MoE: experts→model when divisible (moonshot 64/16), else per-expert d_ff
  TP (grok 8 experts);
* decode KV cache: kv_heads→model when divisible, else head_dim→model when
  divisible, else kv_seq→model (danube's 8 kv × 120 hd);
* long_500k (batch=1): batch unsharded, KV seq sharded over the DP axes —
  distributed-softmax decode;
* every explicit sharding passes a divisibility guard (non-divisible axes
  drop to replicated rather than relying on GSPMD padding).

The port walks its trees as the reference's ``tree_flatten_with_path``
does: dict keys in sorted order (:class:`DictKey`), list and tuple entries
(:class:`SequenceKey`, the ``tail`` list) and dataclass fields
(:class:`GetAttrKey`, ``TrainState``); a leaf that is not a tensor (a
decode cache's host ``pos``) has no dimension.  The placements are
those the launchers run under: ``launch/train.py --mesh`` binds the rules,
``launch/dryrun.py`` places each argument's DTensor blocks by
``tree_shardings``, and ``checkpoint.restore(..., shardings)`` places each
restored leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..configs.shapes import ShapeConfig
from ..dist.sharding import Mesh, NamedSharding, logical_to_spec
from ..models.config import ModelConfig

FSDP_PARAM_THRESHOLD = 10e9


@dataclasses.dataclass(frozen=True)
class DictKey:
    key: Any

    def __str__(self) -> str:
        return f"[{self.key!r}]"


@dataclasses.dataclass(frozen=True)
class SequenceKey:
    idx: int

    def __str__(self) -> str:
        return f"[{self.idx}]"


@dataclasses.dataclass(frozen=True)
class GetAttrKey:
    name: str

    def __str__(self) -> str:
        return f".{self.name}"


def keystr(path: Sequence) -> str:
    """``jax.tree_util.keystr`` of a path: ``['period']['s0']['wq']``."""
    return "".join(map(str, path))


def _children(node):
    """(key, child) pairs of a dict (keys sorted), list, tuple or
    dataclass node, or None for a leaf (a :class:`NamedSharding` is one,
    as jax's is)."""
    if isinstance(node, NamedSharding):
        return None
    if isinstance(node, dict):
        return [(DictKey(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(SequenceKey(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(GetAttrKey(f.name), getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def tree_flatten_with_path(tree, path: tuple = ()) -> list:
    """(path, leaf) pairs in the reference's leaf order; None is an empty
    subtree."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    return [pl for k, v in kids for pl in tree_flatten_with_path(v, path
                                                                 + (k,))]


def _map_with_path(fn, tree, path: tuple = ()):
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    new = [_map_with_path(fn, v, path + (k,)) for k, v in kids]
    if isinstance(tree, dict):
        return {k.key: v for (k, _), v in zip(kids, new)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(new)
    return type(tree)(**{k.name: v for (k, _), v in zip(kids, new)})


def _ndim(leaf) -> int:
    return getattr(leaf, "ndim", 0)


def mesh_axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return int(np.prod([mesh.shape[a] for a in axis]))
    return mesh.shape[axis]


def rules_for(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> dict:
    multi = "pod" in mesh.axis_names
    model = mesh.shape["model"]
    dp_axes = ("pod", "data") if multi else ("data",)
    dp_total = mesh_axis_size(mesh, dp_axes)
    # FSDP for ≥10B archs in training AND inference.  §Perf HC3 measured the
    # TP-only-inference alternative and REFUTED it: replicating weights over
    # the data axis grows the per-token weight-read memory term (gemma2
    # decode 94→264 ms) and overflows HBM for MoE archs — sharded weights +
    # gathers is the better decode layout once the q/cache alignment fix
    # removed the spurious cache gathers.
    fsdp = cfg.num_params_estimate() >= FSDP_PARAM_THRESHOLD

    r: dict[str, Any] = {
        "batch": dp_axes if shape.global_batch % dp_total == 0 else None,
        "seq": None,
        # Megatron-SP: the period-boundary residual carry shards its seq dim
        # over the model axis during training/prefill (remat stack / 16)
        "seq_act": "model" if (shape.kind in ("train", "prefill")
                               and shape.seq_len % model == 0) else None,
        "heads": "model",
        "kv_heads": None,
        "head_dim": None,
        "kv_seq": None,
        "embed": "data" if fsdp else None,
        "mlp_embed": "data" if fsdp else None,
        "ff": "model",
        "vocab": "model" if cfg.vocab_size % model == 0 else None,
        "experts": None,
        "expert_ff": None,
        "moe_cap": dp_axes,
        "d_state": None,
        "ff_heads": None,
    }
    if cfg.ssm is not None:
        ssm_heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        if ssm_heads % model == 0:
            r["ff_heads"] = "model"
    if multi and fsdp:
        r["embed"] = ("pod", "data")
        r["mlp_embed"] = ("pod", "data")

    # decode cache placement priority
    if cfg.num_kv_heads % model == 0:
        r["kv_heads"] = "model"
    elif cfg.hd() % model == 0:
        r["head_dim"] = "model"
    else:
        r["kv_seq"] = "model"
    if shape.kind == "decode" and r["batch"] is None:
        # long-context decode: shard the KV sequence over the idle DP axes
        kv = r["kv_seq"]
        extra = dp_axes
        r["kv_seq"] = (extra + (kv,)) if isinstance(kv, str) else extra

    if cfg.moe is not None:
        if cfg.moe.shard_mode == "expert" and cfg.moe.num_experts % model == 0:
            r["experts"] = "model"
            r["expert_ff"] = "data" if fsdp else None
        else:
            r["experts"] = None
            r["expert_ff"] = "model"
            # grok: per-expert tensor parallelism; 'ff' already model for
            # the shared-expert MLPs
    return r


# ---------------------------------------------------------------------------
# Parameter / state / batch logical-axis maps
# ---------------------------------------------------------------------------

_ATTN_AXES = {
    "wq": ("embed", "heads"), "wk": ("embed", "heads"),
    "wv": ("embed", "heads"), "wo": ("heads", "embed"),
    "bq": ("heads",), "bk": ("heads",), "bv": ("heads",),
    "q_norm": (None,), "k_norm": (None,),
}
_MLP_AXES = {
    "wi": ("mlp_embed", "ff"), "wg": ("mlp_embed", "ff"),
    "wo": ("ff", "mlp_embed"),
}
_MOE_AXES = {
    "router": ("embed", None),
    "wi": ("experts", "expert_ff_in", "moe_ff"),
    "wg": ("experts", "expert_ff_in", "moe_ff"),
    "wo": ("experts", "moe_ff", "expert_ff_in"),
    "shared_wi": ("mlp_embed", "ff"), "shared_wg": ("mlp_embed", "ff"),
    "shared_wo": ("ff", "mlp_embed"),
}
_SSM_AXES = {
    "in_z": ("mlp_embed", "ff"), "in_x": ("mlp_embed", "ff"),
    "in_B": ("embed", None), "in_C": ("embed", None),
    "in_dt": ("embed", None), "dt_bias": (None,), "A_log": (None,),
    "D": (None,), "conv_w": (None, "ff"), "conv_b": ("ff",),
    "norm": ("ff",), "out": ("ff", "mlp_embed"),
}


def param_logical_axes(path: Sequence, leaf) -> tuple:
    """Logical axes for a model parameter leaf, inferred from its path."""
    keys = [getattr(p, "key", getattr(p, "name", str(p))) for p in path]
    name = keys[-1]
    parents = set(keys[:-1])
    if name in ("embed", "unembed"):
        return ("vocab", "embed")
    if name == "final_norm":
        return (None,)
    if "attn" in parents and name in _ATTN_AXES:
        axes = _ATTN_AXES[name]
    elif "moe" in parents and name in _MOE_AXES:
        axes = _MOE_AXES[name]
    elif "ssm" in parents and name in _SSM_AXES:
        axes = _SSM_AXES[name]
    elif name in _MLP_AXES and ("mlp" in parents or "shared" in parents):
        axes = _MLP_AXES[name]
    elif name in ("norm", "norm1", "norm2"):
        axes = (None,)
    else:
        axes = (None,) * _ndim(leaf)
    # stacked period slots have a leading layer axis
    pad = _ndim(leaf) - len(axes)
    return (None,) * pad + tuple(axes)


def moe_rules_patch(cfg: ModelConfig, rules: dict) -> dict:
    """Resolve the MoE weight logical names against the shard mode."""
    r = dict(rules)
    if cfg.moe is None:
        return r
    fsdp_axes = r.get("mlp_embed")     # 'data' (or (pod,data)) when FSDP on
    if cfg.moe.shard_mode == "expert" and r.get("experts"):
        r["expert_ff_in"] = fsdp_axes
        r["moe_ff"] = None
    else:
        # per-expert TP (grok): d_ff over model; FSDP shards the expert
        # input dim over the DP axes so 3×(E·d·f) state spreads 256-way
        r["expert_ff_in"] = fsdp_axes
        r["moe_ff"] = "model"
    return r


def cache_logical_axes(path: Sequence, leaf) -> tuple:
    keys = [getattr(p, "key", getattr(p, "name", str(p))) for p in path]
    name = keys[-1]
    if name in ("k", "v"):
        return (None, "batch", "kv_seq", "kv_heads", "head_dim")
    if name == "kpos":
        return (None, "kv_seq")
    if name == "conv":
        return (None, "batch", None, "ff")
    if name == "state":
        return (None, "batch", "ff_heads", None, None)
    return (None,) * _ndim(leaf)


def batch_logical_axes(path: Sequence, leaf) -> tuple:
    keys = [getattr(p, "key", getattr(p, "name", str(p))) for p in path]
    name = keys[-1]
    if name in ("tokens", "labels"):
        return ("batch", None)
    if name == "embeds":
        return ("batch", None, None)
    return (None,) * _ndim(leaf)


def _axis_size_in(mesh: Mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return int(np.prod([mesh.shape[a] for a in entry]))
    return mesh.shape[entry]


def safe_named_sharding(mesh: Mesh, rules: Mapping, logical_axes: tuple,
                        shape: tuple) -> NamedSharding:
    """logical axes -> NamedSharding with a divisibility guard: any axis whose
    mesh factor doesn't divide the dim drops to replicated (the spec is a
    tuple, the reference's ``PartitionSpec`` entries)."""
    spec = list(logical_to_spec(logical_axes, rules))
    while len(spec) < len(shape):
        spec.append(None)
    fixed = []
    for dim, entry in zip(shape, spec[:len(shape)]):
        size = _axis_size_in(mesh, entry)
        fixed.append(entry if (size > 1 and dim % size == 0)
                     or size == 1 else None)
    return NamedSharding(mesh, tuple(fixed))


def tree_shardings(tree, mesh: Mesh, rules: Mapping, axes_fn):
    """``tree``'s structure with a :class:`NamedSharding` per leaf."""
    def leaf_sharding(path, leaf):
        axes = axes_fn(path, leaf)
        shp = getattr(leaf, "shape", ())
        return safe_named_sharding(mesh, rules, axes, tuple(shp))

    return _map_with_path(leaf_sharding, tree)


def device_bytes(tree, shardings, skip=frozenset()) -> int:
    """The bytes of ``tree``'s tensors that one device holds when each leaf
    is placed as ``shardings`` (:func:`tree_shardings` of the tree) says;
    leaves whose ``keystr`` path is in ``skip`` are left out."""
    pairs = zip(tree_flatten_with_path(tree),
                tree_flatten_with_path(shardings), strict=True)
    return sum(math.prod(sh.shard_shape(leaf.shape)) * leaf.element_size()
               for (path, leaf), (_, sh) in pairs
               if isinstance(leaf, torch.Tensor)
               and keystr(path) not in skip)
