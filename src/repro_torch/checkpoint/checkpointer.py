"""Atomic, keep-last-k checkpoints of a tree of host arrays (the port of
``src/repro/checkpoint/checkpointer.py``).

* A step is one ``host_0.npz`` plus a ``manifest.json`` written into a
  ``.tmp_step_<n>`` directory and committed by renaming it to
  ``step_<n>``: readers only trust manifested steps, so a crash mid-save
  is invisible.
* The leaves of a nested dict are named by their key path in the
  reference's form (``['cols']/['price']``, dict keys in sorted order), so
  a directory written by either package restores in the other.
* ``restore`` takes a *target tree* and returns host numpy arrays of its
  structure, shapes checked and dtypes cast to the target's.
* ``keep_last_k`` garbage collection after every commit.

The reference's typed PRNG-key leaves have no counterpart here: no tree the
port saves holds a key.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np


def _leaves(tree: Any, path: tuple = ()):
    """(key-path string, leaf) pairs of a nested dict, keys sorted at every
    level (the reference's ``tree_flatten_with_path`` order and names)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
        return
    yield "/".join(f"[{k!r}]" for k in path), tree


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: np.asarray(leaf) for key, leaf in _leaves(tree)}


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


def _unflatten(target: Any, values: dict, path: tuple = ()) -> Any:
    if isinstance(target, dict):
        return {k: _unflatten(target[k], values, path + (k,))
                for k in target}
    return values["/".join(f"[{k!r}]" for k in path)]


def restore(ckpt_dir: str, step: int, target_tree: Any) -> Any:
    """Restore step ``step`` into the structure of ``target_tree``: host
    numpy arrays, each of its target leaf's shape, cast to its dtype."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        json.load(f)
    with np.load(os.path.join(path, "host_0.npz")) as data:
        out = {}
        for key, leaf in _leaves(target_tree):
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            leaf = np.asarray(leaf)
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != {leaf.shape}")
            out[key] = arr.astype(leaf.dtype, copy=False)
    return _unflatten(target_tree, out)


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
        host_tree = _unflatten(tree, _host_copies(tree))

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


def _host_copies(tree: Any) -> dict[str, np.ndarray]:
    """Leaf copies on the host (a tensor is copied off its device)."""
    def host(leaf):
        if hasattr(leaf, "detach"):
            return leaf.detach().cpu().numpy().copy()
        return np.array(leaf)

    return {key: host(leaf) for key, leaf in _leaves(tree)}
