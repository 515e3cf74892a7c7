"""Persistent plan cache — warm restarts for the port.

The reference persists a traced XLA executable per (plan, bucket, argument
signature).  Eager torch has no trace to export; what a cold start pays
here is the front end (``analyze`` and ``rewrite``) at prepare and, on a
machine whose ``build/kernels/`` is empty, ``nvcc`` at the first execute
that launches each kernel.  An entry therefore carries two parts, in the
reference's framing:

* the **portable part** — what ``compile_plan`` needs to rebuild the plan
  without ``analyze`` and ``rewrite``: the rewritten plan, the
  :class:`~repro_torch.core.semantics.Analysis`, the options and the
  static binds, pickled (no closure, no tensor: the corpus and index
  tensors ride the ``arrays`` argument and re-bind on load, as in the
  reference).  ``Database.prepare`` restores it from any entry of the plan,
  so a restarted process parses, fingerprints and builds, and skips the
  rest of the front end;
* the **kernel annex** — the compiled kernel libraries the bucket loaded
  at its cold first execute (``kernels/build.py`` records them).  Each
  library is stored once, content-addressed, under
  ``<cache>/kernels/<target name>`` (the target name is a digest of the
  sources and flags); the entry lists the target names with the sha256 of
  each.  A hit whose ``build/kernels/`` lacks a library writes it back
  under its target name after the sha256 check, so no ``nvcc`` runs.  A
  bad library (sha256 mismatch) is counted ``corrupt``, warned about and
  removed, and the kernel builds normally — the reference's fallback from
  its annex to the portable artifact.

**Key contract.**  An entry's file name is a digest over everything that
shapes the plan: the normalized plan fingerprint, the ``EngineOptions``
fingerprint, the canonical static binds, the bucket Q, the full argument
signature (structure, shapes and dtypes of ``(arrays, binds, qvalid,
probe_budget)``), the torch and CUDA versions, the device (type, name,
compute capability), a digest of the kernels' ``nvcc`` flags, and the
entry-format version.  The same fields are echoed in the header and
re-validated on load.  The name is ``<plan digest>-<entry digest>.aot``,
so a prepare can find the plan's entries before it knows a bucket.

**Invalidation.**  Entries carry the reference's cross-process **catalog
token** (:func:`catalog_token`, the same hash of the same state, so it
equals the reference's token for a catalog carried across).  A mismatch
removes the disk entry itself; the next cold execute re-saves it.

**Corruption semantics.**  Truncation, garbage bytes, header/key skew, a
stale catalog token or an unserializable plan all degrade to a clean cold
miss: an :class:`AOTCacheWarning` is emitted, the matching ``corrupt`` /
``stale`` / ``errors`` counter bumps, the bad file is removed, and
compilation proceeds as if no cache existed.  No exception escapes
``prepare`` or ``execute``.  :data:`MAGIC` differs from the reference's,
so a reference entry reads as a ``corrupt`` miss.
"""
from __future__ import annotations

import dataclasses
import enum
import glob
import hashlib
import io
import json
import os
import pickle
import struct
import tempfile
import threading
import time
import warnings
from typing import Any

import numpy as np
import torch

from .schema import ColumnKind

MAGIC = b"CHASEAOT-TORCH1\n"
FORMAT_VERSION = 1


class AOTCacheWarning(UserWarning):
    """A persistent-plan-cache entry could not be used (corrupt bytes,
    version/key skew, catalog drift, or an unserializable plan).  Always a
    degradation signal, never an error: the engine falls back to a cold
    compile and keeps serving."""


def _sha(*parts: bytes) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
    return h.hexdigest()


def _sig_parts(x: Any, path: str, out: list) -> None:
    if isinstance(x, torch.Tensor):
        out.append(f"{path}={x.dtype}:{tuple(x.shape)}")
    elif isinstance(x, (np.ndarray, np.generic)):
        out.append(f"{path}={x.dtype}:{tuple(np.shape(x))}")
    elif isinstance(x, dict):
        out.append(f"{path}=dict")
        for k in sorted(x, key=str):
            _sig_parts(x[k], f"{path}.{k}", out)
    elif isinstance(x, (list, tuple)):
        out.append(f"{path}={type(x).__name__}[{len(x)}]")
        for i, v in enumerate(x):
            _sig_parts(v, f"{path}[{i}]", out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        out.append(f"{path}={type(x).__name__}")
        for f in dataclasses.fields(x):
            _sig_parts(getattr(x, f.name), f"{path}.{f.name}", out)
    else:
        out.append(f"{path}={type(x).__name__}")


def args_signature(args: Any) -> str:
    """Digest of an argument tuple's structure + leaf shapes and dtypes.

    Two argument tuples share a signature iff one entry can serve both:
    same structure (bind names, index presence, probe-budget lane
    presence) and same leaf shapes and dtypes (bucket Q, corpus capacity,
    vector dim).  Reads shapes only: no tensor leaves its device."""
    parts: list[str] = []
    _sig_parts(args, "", parts)
    return _sha("\x1f".join(parts).encode())[:32]


def _np_dtype(t: torch.Tensor) -> str:
    """A tensor dtype under its numpy name ("float32", "int32", "bool")."""
    return str(t.dtype).removeprefix("torch.")


def catalog_token(catalog: Any, dep_keys: tuple) -> str:
    """Cross-process content token of the catalog state a plan bakes in —
    the reference's hash of the same state, field for field:

    * ``("table", name)`` — schema layout, every non-vector column's raw
      bytes (the builders close over predicate columns), the validity
      mask, and vector columns' shape and dtype (their content rides the
      ``arrays`` argument and re-binds in place on load; it never leaves
      the device here);
    * ``("index", t, c)`` — presence and type only;
    * ``("live", t, c)`` — presence only; ``"sharded"`` / ``"quantized"``
      — nothing (their content rides ``arrays``).
    """
    h = hashlib.sha256()
    for key in dep_keys:
        h.update(repr(key).encode())
        kind = key[0]
        if kind == "table":
            name = key[1]
            if not catalog.has_table(name):
                h.update(b"<absent>")
                continue
            tab = catalog.table(name)
            for cname in tab.schema.names():
                ctype = tab.schema[cname]
                col = tab[cname]
                h.update(f"{cname}:{ctype.kind.value}:"
                         f"{_np_dtype(col)}:{tuple(col.shape)}".encode())
                if ctype.kind != ColumnKind.VECTOR:
                    h.update(np.ascontiguousarray(
                        col.detach().cpu().numpy()).tobytes())
            h.update(np.ascontiguousarray(
                tab.valid.detach().cpu().numpy()).tobytes())
        elif kind == "index":
            idx = catalog.index_for(key[1], key[2])
            h.update(b"<none>" if idx is None
                     else type(idx).__name__.encode())
        elif kind == "live":
            h.update(b"live" if catalog.live_for(key[1], key[2]) is not None
                     else b"<none>")
    return h.hexdigest()


def device_identity(device: torch.device) -> str:
    """The device an entry was made for: ``"cpu"``, or the card's type,
    name and compute capability."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    major, minor = torch.cuda.get_device_capability(device)
    return f"cuda:{torch.cuda.get_device_name(device)}:sm_{major}{minor}"


def _flags_digest() -> str:
    from ..kernels import build
    return _sha(" ".join(build.FLAGS).encode())[:16]


@dataclasses.dataclass
class AOTBinding:
    """One compiled plan's hook into the persistent cache: the cache, the
    plan-level key components, the catalog it must watch for structural
    drift, and the device its tensors live on.  Attached to a
    :class:`~repro_torch.core.compiler.BucketedExecutor` by
    ``Database.prepare`` when the session has ``aot_cache_path`` set."""
    cache: "AOTPlanCache"
    plan_key: tuple           # (plan fingerprint, options fp, static key)
    catalog: Any
    dep_keys: tuple
    device: torch.device
    _token: tuple | None = None

    def token(self) -> str:
        """The catalog content token, cached per version snapshot (the
        snapshot is a few dict lookups; the hash walks column bytes)."""
        snap = self.catalog.version_snapshot(self.dep_keys)
        if self._token is None or self._token[0] != snap:
            self._token = (snap, catalog_token(self.catalog, self.dep_keys))
        return self._token[1]


def plan_binding(cache: "AOTPlanCache", plan_key: tuple, catalog: Any,
                 analysis: Any, options: Any) -> AOTBinding:
    """The binding of a plan given its analysis: the registration keys the
    compiled plan watches, and the scanned table's device."""
    from .compiler import _catalog_dep_keys, _scan_of
    return AOTBinding(cache, plan_key, catalog,
                      _catalog_dep_keys(analysis, catalog, options),
                      catalog.table(_scan_of(analysis)[0]).device)


# ---------------------------------------------------------------------------
# the portable part
# ---------------------------------------------------------------------------

# the modules whose dataclasses and enums make up a plan's portable part
_PLAN_MODULES = ("repro_torch.core.expr", "repro_torch.core.plan",
                 "repro_torch.core.semantics", "repro_torch.core.physical",
                 "repro_torch.core.schema", "repro_torch.core.sql",
                 "repro_torch.index.ivf", "repro_torch.dist.sharding")
_BUILTINS = ("tuple", "list", "dict", "set", "frozenset", "complex", "slice")
_NUMPY = {("numpy", "dtype"), ("numpy", "ndarray"),
          ("numpy.core.multiarray", "scalar"),
          ("numpy._core.multiarray", "scalar"),
          ("numpy.core.multiarray", "_reconstruct"),
          ("numpy._core.multiarray", "_reconstruct")}


class _PlanUnpickler(pickle.Unpickler):
    """Unpickles the portable part and nothing else: the port's plan
    dataclasses and enums, builtin containers, numpy scalars and arrays."""

    def find_class(self, module, name):
        if module in _PLAN_MODULES and "." not in name:
            obj = super().find_class(module, name)
            if isinstance(obj, type) and (dataclasses.is_dataclass(obj)
                                          or issubclass(obj, enum.Enum)):
                return obj
        elif ((module == "builtins" and name in _BUILTINS)
              or (module, name) in _NUMPY
              or (module == "numpy.dtypes" and name.endswith("DType"))):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not a plan class")


def export_plan(plan: Any) -> bytes:
    """Serialize a :class:`~repro_torch.core.compiler.CompiledPlan`'s
    portable part: rewritten plan, analysis, options, static binds.  Raises
    when the plan holds something that does not pickle."""
    return pickle.dumps({"analysis": plan.analysis,
                         "rewritten_plan": plan.rewritten_plan,
                         "options": plan.options,
                         "static_binds": dict(plan.static_binds)},
                        protocol=4)


def load_plan(portable: bytes) -> dict:
    """The portable part back: a dict with ``analysis``,
    ``rewritten_plan``, ``options`` and ``static_binds``."""
    parts = _PlanUnpickler(io.BytesIO(portable)).load()
    if not isinstance(parts, dict) or set(parts) != {
            "analysis", "rewritten_plan", "options", "static_binds"}:
        raise pickle.UnpicklingError("not a plan payload")
    return parts


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def _atomic_write(path: str, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class AOTPlanCache:
    """Disk-backed plan cache: one file per (plan, bucket, signature), and
    one file per kernel library under ``kernels/``.

    Thread-safe (one process-wide lock around the counters) and crash-safe
    (every file is written to a temp file and atomically renamed).  Shared
    by every ``Database`` connected with the same ``aot_cache_path``; safe
    to share across processes — the file name digest pins the full key,
    and a half-written or hand-edited file degrades to a clean cold miss."""

    _lock = threading.Lock()

    def __init__(self, path: str):
        self.path = os.path.abspath(os.fspath(path))
        os.makedirs(self.path, exist_ok=True)
        self.kernel_dir = os.path.join(self.path, "kernels")
        self.counters = {"hits": 0, "misses": 0, "corrupt": 0, "stale": 0,
                         "errors": 0, "saves": 0}

    # -- key / identity -----------------------------------------------------

    @staticmethod
    def _plan_fields(plan_key: tuple) -> dict:
        return {"format": FORMAT_VERSION,
                "plan_fp": _sha(str(plan_key[0]).encode())[:32],
                "options_fp": _sha(str(plan_key[1]).encode())[:32],
                "static_key": _sha(str(plan_key[2]).encode())[:32]}

    def _plan_prefix(self, plan_key: tuple) -> str:
        fields = self._plan_fields(plan_key)
        return _sha(json.dumps(fields, sort_keys=True).encode())[:20]

    def _identity(self, binding: AOTBinding, bucket: int,
                  sig: str) -> tuple[str, dict]:
        """(file name, header echo dict) of one entry."""
        expect = self._plan_fields(binding.plan_key)
        expect.update({
            "bucket": int(bucket),
            "sig": sig,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device": device_identity(binding.device),
            "flags": _flags_digest(),
        })
        digest = _sha(json.dumps(expect, sort_keys=True).encode())[:20]
        return f"{self._plan_prefix(binding.plan_key)}-{digest}.aot", expect

    def entry_path(self, binding: AOTBinding, bucket: int, sig: str) -> str:
        """Absolute path of the entry file for one key (exists or not)."""
        return os.path.join(self.path, self._identity(binding, bucket,
                                                      sig)[0])

    # -- counters / reporting -----------------------------------------------

    def stats(self) -> dict:
        """Snapshot of the disk-cache counters (hit/miss/corrupt/stale/
        errors/saves)."""
        with self._lock:
            return dict(self.counters)

    def _bump(self, counter: str) -> None:
        with self._lock:
            self.counters[counter] += 1

    def reject(self, path: str, counter: str, detail: str) -> None:
        """Count + warn + remove an unusable file (clean cold miss)."""
        self._bump(counter)
        try:
            os.remove(path)
        except OSError:
            pass
        warnings.warn(AOTCacheWarning(
            f"AOT plan cache: {counter} entry {os.path.basename(path)} "
            f"({detail}); falling back to cold compile"), stacklevel=3)

    def note_unserializable(self, plan_key: tuple, exc: Exception) -> None:
        """An export attempt failed: typed warning + ``errors`` bump, then
        the caller proceeds with the plain in-memory executor."""
        self._bump("errors")
        warnings.warn(AOTCacheWarning(
            f"AOT plan cache: plan is not serializable "
            f"({type(exc).__name__}: {exc}); executing without "
            f"persistence"), stacklevel=3)

    # -- save ---------------------------------------------------------------

    def _save_library(self, source: str) -> dict | None:
        """Store one built kernel library under its target name (once) and
        return its annex record, or None when it was never built here."""
        from ..kernels import build
        lib = build.target(source)
        if not lib.exists():
            return None
        data = lib.read_bytes()
        os.makedirs(self.kernel_dir, exist_ok=True)
        dst = os.path.join(self.kernel_dir, lib.name)
        if not os.path.exists(dst):
            _atomic_write(dst, data)
        return {"source": source, "target": lib.name, "sha256": _sha(data)}

    def save(self, binding: AOTBinding, bucket: int, sig: str,
             portable: bytes, libraries=()) -> bool:
        """Atomically persist one bucket entry (write-through: called right
        after the bucket's cold first execute, so LRU eviction later drops
        only the in-memory copy).  ``libraries`` are the kernel sources the
        bucket loaded."""
        name, expect = self._identity(binding, bucket, sig)
        path = os.path.join(self.path, name)
        try:
            records = [r for r in (self._save_library(s)
                                   for s in sorted(libraries))
                       if r is not None]
            annex = json.dumps(records, sort_keys=True).encode()
            header = dict(expect)
            header.update({
                "catalog_token": binding.token(),
                "portable_len": len(portable),
                "annex_len": len(annex),
                "portable_sha": _sha(portable),
                "annex_sha": _sha(annex),
                "created_at": time.time(),
            })
            hj = json.dumps(header, sort_keys=True).encode()
            _atomic_write(path, MAGIC + struct.pack(">I", len(hj)) + hj
                          + portable + annex)
            self._bump("saves")
            return True
        except Exception as exc:                       # noqa: BLE001
            self._bump("errors")
            warnings.warn(AOTCacheWarning(
                f"AOT plan cache: failed to persist entry {name} "
                f"({type(exc).__name__}: {exc})"), stacklevel=2)
            return False

    # -- load ---------------------------------------------------------------

    def _parse(self, blob: bytes, path: str):
        """Validate framing + checksums; None (counted corrupt) on any
        mismatch."""
        if not blob.startswith(MAGIC) or len(blob) < len(MAGIC) + 4:
            self.reject(path, "corrupt", "bad magic / truncated preamble")
            return None
        off = len(MAGIC)
        (hlen,) = struct.unpack(">I", blob[off:off + 4])
        off += 4
        try:
            header = json.loads(blob[off:off + hlen].decode())
        except (UnicodeDecodeError, json.JSONDecodeError):
            self.reject(path, "corrupt", "unparseable header")
            return None
        off += hlen
        plen = header.get("portable_len", -1)
        alen = header.get("annex_len", -1)
        if plen < 0 or alen < 0 or len(blob) != off + plen + alen:
            self.reject(path, "corrupt",
                        f"payload length mismatch ({len(blob) - off} bytes "
                        f"on disk, header claims {plen}+{alen})")
            return None
        portable = blob[off:off + plen]
        annex = blob[off + plen:]
        if (_sha(portable) != header.get("portable_sha")
                or _sha(annex) != header.get("annex_sha")):
            self.reject(path, "corrupt", "payload checksum mismatch")
            return None
        return header, portable, annex

    def _validate(self, path: str, header: dict, binding: AOTBinding,
                  bucket: int, sig: str) -> bool:
        """The header's key echo and catalog token against the current
        process and catalog (counted stale on any mismatch)."""
        name, expect = self._identity(binding, bucket, sig)
        for field, want in expect.items():
            if header.get(field) != want:
                self.reject(path, "stale",
                            f"key field {field!r} mismatch "
                            f"({header.get(field)!r} != {want!r})")
                return False
        if os.path.basename(path) != name:
            self.reject(path, "stale", "file name does not match its key")
            return False
        if header.get("catalog_token") != binding.token():
            self.reject(path, "stale",
                        "catalog structural drift since persist")
            return False
        return True

    def _read(self, path: str):
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        return self._parse(blob, path)

    def restore_plan(self, plan_key: tuple, catalog: Any):
        """The portable part of any valid entry of this plan, with the
        binding it validated against, as ``(parts, binding, path)``; None
        when the plan has no usable entry (a bad one is counted and
        removed).  Called at prepare, before ``analyze``: the dependency
        keys and device come from the stored analysis, and the token is
        checked against the current catalog."""
        pattern = os.path.join(self.path,
                               glob.escape(self._plan_prefix(plan_key))
                               + "-*.aot")
        for path in sorted(glob.glob(pattern)):
            parsed = self._read(path)
            if parsed is None:
                continue
            header, portable, _annex = parsed
            try:
                parts = load_plan(portable)
                binding = plan_binding(self, plan_key, catalog,
                                       parts["analysis"], parts["options"])
                valid = self._validate(path, header, binding,
                                       header.get("bucket", -1),
                                       header.get("sig", ""))
            except Exception as exc:                   # noqa: BLE001
                self.reject(path, "corrupt",
                            f"portable part does not restore "
                            f"({type(exc).__name__}: {exc})")
                continue
            if valid:
                return parts, binding, path
        return None

    def _restore_library(self, record: dict) -> None:
        """Write one annex library back into ``build/kernels/`` under its
        target name after the sha256 check; a bad one is counted corrupt,
        removed, and left to the normal build."""
        from ..kernels import build
        dst = build.target(record["source"])
        if dst.name != record["target"] or dst.exists():
            return                 # other sources or flags, or already built
        src = os.path.join(self.kernel_dir, record["target"])
        try:
            with open(src, "rb") as f:
                data = f.read()
        except OSError:
            return
        if _sha(data) != record["sha256"]:
            self.reject(src, "corrupt", "kernel library sha256 mismatch; "
                        "the kernel builds with nvcc")
            return
        dst.parent.mkdir(parents=True, exist_ok=True)
        _atomic_write(str(dst), data)

    def load(self, binding: AOTBinding, bucket: int, sig: str) -> bool:
        """Load one bucket entry: True (a hit, its kernel annex written
        back) or False (counted) when the entry is absent, corrupt or
        stale."""
        path = self.entry_path(binding, bucket, sig)
        if not os.path.exists(path):
            self._bump("misses")
            return False
        parsed = self._read(path)
        if parsed is None:
            return False
        header, _portable, annex = parsed
        if not self._validate(path, header, binding, bucket, sig):
            return False
        try:
            records = json.loads(annex.decode())
        except (UnicodeDecodeError, json.JSONDecodeError):
            records = []
        for record in records:
            try:
                self._restore_library(record)
            except Exception as exc:                   # noqa: BLE001
                warnings.warn(AOTCacheWarning(
                    f"AOT plan cache: kernel annex record {record!r} not "
                    f"restored ({type(exc).__name__}: {exc})"), stacklevel=2)
        self._bump("hits")
        return True


__all__ = ["MAGIC", "FORMAT_VERSION", "AOTCacheWarning", "AOTBinding",
           "AOTPlanCache", "args_signature", "catalog_token",
           "device_identity", "export_plan", "load_plan", "plan_binding"]
