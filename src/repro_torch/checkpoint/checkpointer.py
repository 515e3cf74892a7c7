"""Atomic, keep-last-k checkpoints of a tree of host arrays (the port of
``src/repro/checkpoint/checkpointer.py``).

* A step is one ``host_0.npz`` plus a ``manifest.json`` written into a
  ``.tmp_step_<n>`` directory and committed by renaming it to
  ``step_<n>``: readers only trust manifested steps, so a crash mid-save
  is invisible.
* Leaves are named by their key path in the reference's form (its
  ``tree_flatten_with_path`` walk): ``['k']`` for a dict key (keys in
  sorted order), ``[0]`` for a list or tuple entry (an empty list has no
  leaf), ``.name`` for a dataclass field (fields in declaration order; the
  port's ``TrainState``), joined by ``/``; None is an empty subtree.  A
  dataclass field marked ``metadata={"prngkey": True}`` holds the uint32[2]
  key data of the reference's typed PRNG key and is stored, as the
  reference stores a key, under ``<path>__prngkey``.  So a directory
  written by either package restores in the other: the engine's
  dict-of-columns snapshots, model parameters (``tail`` lists included)
  and a whole ``TrainState``.
* A bf16 tensor is stored as its 2-byte patterns (numpy's ``|V2``, the
  dtype the reference's bfloat16 arrays take in an ``.npz``).
* ``restore`` takes a *target tree* and returns a tree of its structure
  (lists and dataclasses included) whose leaves have their target's shape
  (checked) and dtype: a CPU tensor where the target leaf is a tensor (any
  device, ``meta`` included), a numpy array elsewhere.  With a matching
  tree of ``NamedSharding`` s it is the reference's elastic reshard: a
  step was saved host-complete, so any mesh can take it, each leaf placed
  as its sharding says (a tensor on the device of a one-device mesh, a
  ``dist.sharding.ShardedLeaf`` of per-device blocks on a larger one).
* ``keep_last_k`` garbage collection after every commit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from ..dist.sharding import NamedSharding, ShardedLeaf


def _children(node: Any):
    """The (key-path segment, child) pairs of a dict (keys sorted), list,
    tuple or dataclass node, or None for a leaf (a :class:`NamedSharding`
    and a :class:`ShardedLeaf` are leaves)."""
    if isinstance(node, (NamedSharding, ShardedLeaf)):
        return None
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}" + ("__prngkey" if f.metadata.get("prngkey")
                                 else ""), getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _rebuild(target: Any, leaf_fn, path: tuple = ()) -> Any:
    """``target``'s structure with each leaf replaced by ``leaf_fn(key,
    leaf)``, ``key`` its key-path string (see the module doc)."""
    if target is None:
        return None
    kids = _children(target)
    if kids is None:
        return leaf_fn("/".join(path), target)
    new = [_rebuild(v, leaf_fn, path + (seg,)) for seg, v in kids]
    if isinstance(target, dict):
        return {k: new[i] for i, k in enumerate(sorted(target))}
    if isinstance(target, (list, tuple)):
        return type(target)(new)
    return type(target)(**{f.name: v for f, v in
                           zip(dataclasses.fields(target), new)})


def _to_host(leaf, copy: bool = True) -> np.ndarray:
    """A leaf as a host numpy array (bf16 as ``|V2`` bit patterns); a
    tensor is always copied, a numpy leaf where ``copy``; a
    :class:`ShardedLeaf` is saved whole (host-complete, so any mesh can
    restore it)."""
    if isinstance(leaf, ShardedLeaf):
        leaf = leaf.full()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy().view(np.dtype("V2"))
        return t.numpy().copy()
    return np.array(leaf) if copy else np.asarray(leaf)


def _from_host(arr: np.ndarray, leaf, key: str):
    """``arr`` (read back from a step) as ``leaf``'s kind, shape and dtype."""
    if tuple(arr.shape) != tuple(np.shape(leaf)):
        raise ValueError(f"{key}: shape {arr.shape} != "
                         f"{tuple(np.shape(leaf))}")
    if isinstance(leaf, torch.Tensor):
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(leaf.dtype)
    return arr.astype(np.asarray(leaf).dtype, copy=False)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    flat = {}
    _rebuild(tree, lambda key, leaf: flat.__setitem__(
        key, _to_host(leaf, copy=False)))
    return flat


def save(ckpt_dir: str, step: int, tree: Any, keep_last_k: int = 3) -> str:
    """Write ``tree`` as step ``step`` and commit it by an atomic rename;
    returns the committed directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp, "host_0.npz"), **flat)
    manifest = {"step": step, "time": time.time(),
                "keys": sorted(flat.keys()), "hosts": 1}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic commit
    _gc(ckpt_dir, keep_last_k)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def latest_steps(ckpt_dir: str) -> list[int]:
    """Every committed (manifested) step under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            manifest = os.path.join(ckpt_dir, name, "manifest.json")
            if os.path.exists(manifest):
                out.append(int(name.split("_", 1)[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    """The newest committed step, or None."""
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, target_tree: Any,
            shardings: Any = None) -> Any:
    """Restore step ``step`` into the structure of ``target_tree``: each
    leaf of its target leaf's shape and dtype, a CPU tensor for a tensor
    target and a numpy array otherwise.  ``shardings``, a tree of
    ``NamedSharding`` s of the target's structure (``launch.shardspec.
    tree_shardings``), places every leaf on its mesh instead: on a mesh of
    one device a tensor on that device, on a larger one a
    :class:`~repro_torch.dist.sharding.ShardedLeaf` holding each device's
    block on that device."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        json.load(f)
    placed = {}
    if shardings is not None:
        _rebuild(shardings, placed.__setitem__)
    with np.load(os.path.join(path, "host_0.npz")) as data:
        def read(key, leaf):
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            value = _from_host(data[key], leaf, key)
            if shardings is None:
                return value
            return _place(torch.as_tensor(value), placed[key])

        return _rebuild(target_tree, read)


def _place(t: torch.Tensor, sharding: NamedSharding):
    """``t`` placed as ``sharding`` says (``jax.device_put``)."""
    if sharding.mesh.devices.size == 1:
        return t.to(sharding.mesh.flat[0])
    return ShardedLeaf.place(t, sharding)


class Checkpointer:
    """Async wrapper: the tree is copied to the host on the caller's thread
    and serialised on a background one; an error surfaces on the next
    ``wait()``."""

    def __init__(self, ckpt_dir: str, keep_last_k: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep_last_k
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save_async(self, step: int, tree: Any) -> None:
        """Start saving ``tree`` as ``step`` (after any save in flight)."""
        self.wait()
        host_tree = _rebuild(tree, lambda _key, leaf: _to_host(leaf))

        def _run():
            try:
                save(self.ckpt_dir, step, host_tree, self.keep)
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the save in flight; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

