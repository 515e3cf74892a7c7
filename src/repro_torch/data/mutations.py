"""Live corpus: crash-consistent streaming inserts and deletes (the port of
``src/repro/data/mutations.py``; DESIGN.md §12).

:class:`LiveCorpus` makes a registered (table, vector column) pair mutable
without a re-prepare.  Its state is two fixed-capacity segments in host
numpy, copied to the table's device for the plans:

* **main segment**: a (cap_main, d) padded copy of the corpus and of every
  scalar column, a validity lane (the tombstone bitmap) and user-id slots.
  A delete clears a validity bit; the lane is the row mask every kernel
  and IVF probe already takes, so a dead row is inert as a pad row is.
* **delta segment**: a (delta_cap, d) append-only buffer for inserts,
  scanned by the plain flat scan and merged into the main result as one
  more level of the per-query merge
  (:func:`repro_torch.dist.collectives.merge_topk_level`).

Durability: every mutation first appends a JSON-lines record to a
write-ahead log under an LSN minted by the catalog's version clock
(``Catalog.bump_live``: one clock drives plan re-binding and replay order);
the append is fsynced before the LSN is returned.  ``snapshot()`` writes
the whole segment state through :mod:`repro_torch.checkpoint.checkpointer`
(atomic tmp-dir + rename) at the current LSN; :func:`recover` restores the
newest committed snapshot, replays the WAL records past it, and truncates
at most one torn (half-flushed) tail line off the file, so a later append
starts a fresh record.  A crash at any of
:data:`repro_torch.serving.faults.CRASH_SITES` recovers to a state whose
answers equal an unfailed replay's bit for bit.  The on-disk layout is the
reference's, so either package recovers a directory the other wrote.

Concurrency: mutations, ``snapshot`` and ``plan_arrays`` take one lock, so
racing writers (the serving front door runs mutations on a thread pool)
get distinct LSNs and slots and a WAL in LSN order, and a plan re-bind
never sees a half-applied mutation.

``compact()`` folds the delta rows and tombstones back into the main
segment: survivors sorted by user id, zero tail, the IVF rebuilt from the
fixed seed.  Compiled plans re-bind the new tensors without rebuilding an
executor, and since the canonical layout is a function of the logical
corpus alone, a compacted state equals a fresh :func:`attach_live` on the
same rows bit for bit.

Two deliberate differences from the reference's IVF (ROADMAP.md §3): the
list capacity is derived from the largest cluster at every (re)build
instead of pinned at ``cap_main`` (torch runs eagerly, so a new capacity
rebuilds nothing, and a pinned one would make every probe gather
``cap_main`` rows per list; answers, hit order and counters do not depend
on it); and k-means trains, and the lists hold, the main segment's filled
slots only, not its empty pad slots.  The reference clusters the whole
padded segment: its zero pad rows start some centroids at the origin,
where they draw in every mode no other centroid covers, and that catch-all
list is probed last.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
from typing import Any

import numpy as np
import torch

from .. import tracing
from ..checkpoint import checkpointer
from ..core.schema import Catalog, ColumnKind, Metric
from ..index.ivf import build_ivf
from ..serving.faults import FaultInjector, InjectedCrashError
from ..serving.resilience import (MutationError, validate_delete,
                                  validate_insert)

_SCALAR_KINDS = (ColumnKind.INT, ColumnKind.FLOAT, ColumnKind.BOOL,
                 ColumnKind.CATEGORY)


def _ceil8(n: int) -> int:
    return max(8, -(-int(n) // 8) * 8)


def _host(t) -> np.ndarray:
    """A column as a host numpy array (a tensor is copied off its device)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _record(op: str, ids, vectors=None, cols=None) -> dict:
    rec = {"op": op, "ids": [int(i) for i in ids]}
    if vectors is not None:
        rec["vecs"] = [[float(x) for x in v] for v in vectors]
        rec["cols"] = {n: np.asarray(v).tolist() for n, v in cols.items()}
    return rec


class LiveCorpus:
    """Mutable (table, vector column) state: segments, WAL, snapshots.

    Construct it with :func:`attach_live` or :func:`recover`; both register
    it with the catalog.  The segments are host numpy; :meth:`plan_arrays`
    makes (and caches) the device copies that compiled plans re-bind."""

    def __init__(self, catalog: Catalog, meta: dict, path: str,
                 faults: FaultInjector | None = None):
        self.catalog = catalog
        self.table = meta["table"]
        self.column = meta["column"]
        self.device = catalog.table(self.table).device
        self.dim = int(meta["dim"])
        self.cap_main = int(meta["cap_main"])
        self.delta_cap = int(meta["delta_cap"])
        self.nlist = meta["nlist"]
        self.seed = int(meta["seed"])
        self.iters = int(meta["iters"])
        self.keep_last_k = int(meta.get("keep_last_k", 3))
        self.metric = Metric[meta["metric"]]
        self.col_dtypes = {n: np.dtype(d) for n, d in meta["cols"].items()}
        self.path = path
        self._faults = faults
        self.lsn = 0
        self.compact_lsn = 0
        self.tombstones = 0
        self.main_vec = np.zeros((self.cap_main, self.dim), np.float32)
        self.main_valid = np.zeros((self.cap_main,), bool)
        self.main_uids = np.full((self.cap_main,), -1, np.int64)
        self.cols = {n: np.zeros((self.cap_main,), dt)
                     for n, dt in self.col_dtypes.items()}
        self.delta_vec = np.zeros((self.delta_cap, self.dim), np.float32)
        self.delta_valid = np.zeros((self.delta_cap,), bool)
        self.delta_uids = np.full((self.delta_cap,), -1, np.int64)
        self.dcols = {n: np.zeros((self.delta_cap,), dt)
                      for n, dt in self.col_dtypes.items()}
        self.delta_count = 0
        self._uid_loc: dict[int, tuple[str, int]] = {}
        self._dev: dict[str, Any] = {}
        # serializes mutations against each other and against plan re-binds
        # (the serving front door runs mutations on a thread pool)
        self._lock = threading.RLock()

    # -- plumbing -----------------------------------------------------------

    @property
    def wal_path(self) -> str:
        """Path of the JSON-lines write-ahead log."""
        return os.path.join(self.path, "wal.jsonl")

    @property
    def ckpt_dir(self) -> str:
        """Snapshot directory (checkpointer steps keyed by LSN)."""
        return os.path.join(self.path, "ckpt")

    def _crash(self, site: str) -> None:
        if self._faults is not None:
            self._faults.crash_point(site)

    def _torn(self, site: str | None) -> bool:
        return (site is not None and self._faults is not None
                and self._faults.armed(site))

    def _die(self, site: str, what: str) -> None:
        self._faults.counters["crashes"] += 1
        raise InjectedCrashError(f"injected crash at {site!r} ({what})")

    def _wal_append(self, rec: dict, torn_site: str | None) -> None:
        """Durably append one record (flushed and fsynced before the LSN is
        returned); an armed ``torn_site`` flushes half the line and dies,
        the torn tail recovery must shed."""
        self._wal_append_group([rec], torn_site, "half-flushed WAL line")

    def _wal_append_group(self, recs: list, torn_site: str | None,
                          what: str = "half-flushed group-commit tail"
                          ) -> None:
        """Durably append a GROUP of records with one flush and fsync (N
        records, one durability round trip).  An armed ``torn_site`` flushes
        every line but the last and half of the last, the worst tail a
        group commit can leave: recovery keeps the complete prefix."""
        lines = [json.dumps(r, separators=(",", ":")) for r in recs]
        if self._torn(torn_site):
            with open(self.wal_path, "a") as f:
                for line in lines[:-1]:
                    f.write(line + "\n")
                f.write(lines[-1][: max(1, len(lines[-1]) // 2)])
                f.flush()
            self._die(torn_site, what)
        with open(self.wal_path, "a") as f:
            f.write("".join(line + "\n" for line in lines))
            f.flush()
            os.fsync(f.fileno())

    def _bump(self) -> int:
        return self.catalog.bump_live(self.table, self.column)

    def _invalidate(self, *keys: str) -> None:
        for k in keys:
            self._dev.pop(k, None)

    def _rebuild_uid_map(self) -> None:
        self._uid_loc = {}
        for s in np.flatnonzero(self.main_valid):
            self._uid_loc[int(self.main_uids[s])] = ("m", int(s))
        for s in np.flatnonzero(self.delta_valid):
            self._uid_loc[int(self.delta_uids[s])] = ("d", int(s))

    def _state_tree(self) -> dict:
        """The full durable state as a nested dict (the snapshot unit)."""
        return {"main_vec": self.main_vec, "main_valid": self.main_valid,
                "main_uids": self.main_uids, "delta_vec": self.delta_vec,
                "delta_valid": self.delta_valid,
                "delta_uids": self.delta_uids,
                "lsn": np.int64(self.lsn),
                "compact_lsn": np.int64(self.compact_lsn),
                "delta_count": np.int64(self.delta_count),
                "tombstones": np.int64(self.tombstones),
                "cols": dict(self.cols), "dcols": dict(self.dcols)}

    def _load_state_tree(self, tree: dict) -> None:
        # copies: segment state must stay private, mutable host memory
        self.main_vec = np.array(tree["main_vec"], np.float32)
        self.main_valid = np.array(tree["main_valid"], bool)
        self.main_uids = np.array(tree["main_uids"], np.int64)
        self.delta_vec = np.array(tree["delta_vec"], np.float32)
        self.delta_valid = np.array(tree["delta_valid"], bool)
        self.delta_uids = np.array(tree["delta_uids"], np.int64)
        self.lsn = int(tree["lsn"])
        self.compact_lsn = int(tree["compact_lsn"])
        self.delta_count = int(tree["delta_count"])
        self.tombstones = int(tree["tombstones"])
        self.cols = {n: np.array(v, self.col_dtypes[n])
                     for n, v in tree["cols"].items()}
        self.dcols = {n: np.array(v, self.col_dtypes[n])
                      for n, v in tree["dcols"].items()}

    # -- mutations ----------------------------------------------------------

    def _normalize_columns(self, columns: dict | None, n: int) -> dict:
        out = {}
        for name, vals in (columns or {}).items():
            if name not in self.col_dtypes:
                raise MutationError(f"unknown scalar column {name!r}; "
                                    f"live columns: "
                                    f"{sorted(self.col_dtypes)}")
            arr = _host(vals).astype(self.col_dtypes[name])
            arr = np.broadcast_to(np.atleast_1d(arr), (n,)).copy()
            if (np.issubdtype(arr.dtype, np.floating)
                    and not np.all(np.isfinite(arr))):
                raise MutationError(f"non-finite values for column {name!r}")
            out[name] = arr
        for name, dt in self.col_dtypes.items():
            out.setdefault(name, np.zeros((n,), dt))
        return out

    def insert(self, ids, vectors, columns: dict | None = None) -> int:
        """Admit a batch of new rows into the delta segment; returns the LSN.

        The typed rejections (:mod:`repro_torch.serving.resilience`) fire
        BEFORE the WAL append: a rejected insert has no side effects.  The
        rows are visible at once: the next ``ensure_fresh`` re-binds the
        delta tensors and every Q1-Q6 plan merges them."""
        with self._lock:
            ids, vectors = validate_insert(
                _host(ids), _host(vectors), self.dim, self._uid_loc,
                self.delta_cap - self.delta_count, self.delta_cap)
            cols = self._normalize_columns(columns, len(ids))
            rec = _record("insert", ids, vectors, cols)
            self._crash("wal.pre_append")
            rec["lsn"] = lsn = self._bump()
            self._wal_append(rec, torn_site="wal.torn_append")
            self._crash("wal.post_append")
            self._apply_insert(ids, vectors, cols, lsn)
            return lsn

    def _apply_insert(self, ids, vectors, cols, lsn: int) -> None:
        n = len(ids)
        slots = np.arange(self.delta_count, self.delta_count + n)
        self.delta_vec[slots] = vectors
        self.delta_valid[slots] = True
        self.delta_uids[slots] = ids
        for name, vals in cols.items():
            self.dcols[name][slots] = vals
        for uid, s in zip(ids, slots):
            self._uid_loc[int(uid)] = ("d", int(s))
        self.delta_count += n
        self.lsn = lsn
        self._invalidate("live_delta_vec", "live_delta_valid", "live_dcols")

    def insert_batch(self, batches) -> list[int]:
        """Group commit: admit several insert batches with ONE WAL fsync.

        Each element of ``batches`` is ``(ids, vectors)`` or ``(ids,
        vectors, columns)`` and becomes its own WAL record under its own
        LSN (minted and applied in order), but the group shares one flush
        and fsync.  Admission is all or nothing: every group is validated
        first (duplicate ids across groups and the cumulative delta
        headroom included), so a rejected group rejects the whole call with
        no side effects.  A torn group commit (the ``wal.group_commit``
        crash site) loses only the un-synced suffix: recovery replays the
        durable prefix, as if those inserts had run one by one."""
        with self._lock:
            pending: dict[int, tuple] = {}
            free = self.delta_cap - self.delta_count
            norm = []
            for group in batches:
                ids, vectors = validate_insert(
                    _host(group[0]), _host(group[1]), self.dim,
                    collections.ChainMap(pending, self._uid_loc),
                    free, self.delta_cap)
                cols = self._normalize_columns(
                    group[2] if len(group) > 2 else None, len(ids))
                for uid in ids:
                    pending[int(uid)] = ("pending", -1)
                free -= len(ids)
                norm.append((ids, vectors, cols))
            self._crash("wal.pre_append")
            recs, lsns = [], []
            for ids, vectors, cols in norm:
                rec = _record("insert", ids, vectors, cols)
                rec["lsn"] = lsn = self._bump()
                lsns.append(lsn)
                recs.append(rec)
            self._wal_append_group(recs, torn_site="wal.group_commit")
            self._crash("wal.post_append")
            for (ids, vectors, cols), lsn in zip(norm, lsns):
                self._apply_insert(ids, vectors, cols, lsn)
            return lsns

    def delete(self, ids) -> int:
        """Tombstone a batch of live rows by user id; returns the LSN.

        A main-segment delete clears a validity bit every scan already ANDs
        into its row mask; a delta-segment delete clears the delta validity
        bit.  No data moves until ``compact()``."""
        with self._lock:
            ids = validate_delete(_host(ids), self._uid_loc)
            rec = _record("delete", ids)
            self._crash("wal.pre_append")
            rec["lsn"] = lsn = self._bump()
            self._wal_append(rec, torn_site="wal.torn_append")
            self._crash("wal.post_append")
            self._apply_delete(ids, lsn)
            return lsn

    def _apply_delete(self, ids, lsn: int) -> None:
        touched_main = touched_delta = False
        for uid in ids:
            seg, slot = self._uid_loc.pop(int(uid))
            if seg == "m":
                self.main_valid[slot] = False
                touched_main = True
            else:
                self.delta_valid[slot] = False
                touched_delta = True
            self.tombstones += 1
        self.lsn = lsn
        if touched_main:
            self._invalidate("live_main_valid")
        if touched_delta:
            self._invalidate("live_delta_valid")

    def snapshot(self) -> str:
        """Checkpoint the whole segment state at the current LSN (atomic
        tmp-dir + rename commit); returns the committed directory."""
        with self._lock:
            self._crash("snapshot.pre_commit")
            out = checkpointer.save(self.ckpt_dir, self.lsn,
                                    self._state_tree(),
                                    keep_last_k=self.keep_last_k)
            self._crash("snapshot.post_commit")
            return out

    # -- compaction ---------------------------------------------------------

    def _canonical_state(self) -> dict:
        """The compacted state: the survivors (main and delta, less the
        tombstones) sorted by user id into slots 0..n-1, zero tail, empty
        delta.  A function of the logical corpus alone, which is what makes
        a compacted corpus equal a fresh attach on the same rows."""
        m = np.flatnonzero(self.main_valid)
        d = np.flatnonzero(self.delta_valid)
        uids = np.concatenate([self.main_uids[m], self.delta_uids[d]])
        n = len(uids)
        if n > self.cap_main:
            raise MutationError(
                f"main segment capacity {self.cap_main} cannot hold {n} "
                f"live rows; re-attach with a larger capacity")
        order = np.argsort(uids)
        tree = {"main_vec": np.zeros_like(self.main_vec),
                "main_valid": np.zeros_like(self.main_valid),
                "main_uids": np.full_like(self.main_uids, -1),
                "delta_vec": np.zeros_like(self.delta_vec),
                "delta_valid": np.zeros_like(self.delta_valid),
                "delta_uids": np.full_like(self.delta_uids, -1),
                "delta_count": np.int64(0), "tombstones": np.int64(0),
                "cols": {}, "dcols": {}}
        tree["main_vec"][:n] = np.concatenate(
            [self.main_vec[m], self.delta_vec[d]])[order]
        tree["main_valid"][:n] = True
        tree["main_uids"][:n] = uids[order]
        for name in self.cols:
            merged = np.concatenate([self.cols[name][m],
                                     self.dcols[name][d]])
            col = np.zeros_like(self.cols[name])
            col[:n] = merged[order]
            tree["cols"][name] = col
            tree["dcols"][name] = np.zeros_like(self.dcols[name])
        return tree

    def compact(self) -> int:
        """Fold the delta rows and tombstones into the main segment; returns
        the LSN.

        Durability order: compute the canonical state, log one ``compact``
        WAL record (replay recomputes the state from it), checkpoint the
        compacted state at that LSN, THEN swap in memory and register the
        rebuilt IVF under the version clock: a reader never sees a half
        compacted corpus, and plans re-bind without rebuilding an
        executor."""
        with self._lock:
            staged = self._canonical_state()
            self._crash("compact.pre_log")
            lsn = self._bump()
            self._wal_append({"op": "compact", "lsn": lsn}, torn_site=None)
            self._crash("compact.post_log")
            staged["lsn"] = np.int64(lsn)
            staged["compact_lsn"] = np.int64(lsn)
            checkpointer.save(self.ckpt_dir, lsn, staged,
                              keep_last_k=self.keep_last_k)
            self._crash("compact.pre_swap")
            self._swap_compacted(staged, lsn)
            return lsn

    def _swap_compacted(self, staged: dict, lsn: int) -> None:
        self._load_state_tree(staged)
        self.lsn = lsn
        self.compact_lsn = lsn
        self._rebuild_uid_map()
        self._dev.clear()
        self._register_index()

    def _register_index(self) -> None:
        """(Re)build the IVF over the main segment's filled slots (every
        slot holding a row since the last compaction, tombstoned or not;
        never an empty pad slot) from the fixed seed, a CPU generator, so
        the draws do not depend on the device, and register it.  A function
        of the main segment alone: a recovered or freshly attached corpus
        builds the same index.  The list capacity is derived from the
        largest cluster (see the module docstring)."""
        if self.nlist is None:
            return
        with self._lock:
            corpus = self._on_device("corpus", self.main_vec)
            rows = torch.from_numpy(np.flatnonzero(self.main_uids >= 0)).to(
                self.device)
            ivf = build_ivf(torch.Generator().manual_seed(self.seed),
                            corpus[rows], int(self.nlist), metric=self.metric,
                            iters=self.iters)
            members = ivf.lists.clamp_min(0).long()
            ivf = dataclasses.replace(ivf, lists=torch.where(
                ivf.lists >= 0, rows.to(torch.int32)[members], -1))
            self.catalog.register_index(self.table, self.column, ivf)

    # -- read side ----------------------------------------------------------

    def _on_device(self, key: str, host):
        """The cached device copy of one segment piece.  ``torch.tensor``
        always copies, so a CPU plan never aliases the host segments that
        ``insert`` writes in place (a mutation reaches a plan only through
        an invalidation, as on the card).  Each copy to a device counts as
        an upload (:func:`repro_torch.tracing.count_upload`)."""
        if key not in self._dev:
            pieces = host.values() if isinstance(host, dict) else (host,)
            for v in pieces:
                tracing.count_upload(v, self.device)
            if isinstance(host, dict):
                self._dev[key] = {n: torch.tensor(v, device=self.device)
                                  for n, v in host.items()}
            else:
                self._dev[key] = torch.tensor(host, device=self.device)
        return self._dev[key]

    def plan_arrays(self) -> dict:
        """The tensors compiled plans read, cached per segment piece so a
        delta-only mutation re-uploads only the delta on re-bind.  Runs
        under the mutation lock: a re-bind sees the segments either before
        or after a mutation, never half-applied.  ``live_has_delta`` is the
        host's own knowledge of whether any delta row is live: the plans
        skip the delta top-k merge without a device sync."""
        with self._lock:
            return {"corpus": self._on_device("corpus", self.main_vec),
                    "live_main_valid": self._on_device("live_main_valid",
                                                       self.main_valid),
                    "live_delta_vec": self._on_device("live_delta_vec",
                                                      self.delta_vec),
                    "live_delta_valid": self._on_device("live_delta_valid",
                                                        self.delta_valid),
                    "live_cols": self._on_device("live_cols", self.cols),
                    "live_dcols": self._on_device("live_dcols", self.dcols),
                    "live_has_delta": bool(self.delta_valid.any())}

    def freshness(self) -> dict:
        """Observable corpus freshness (``explain()`` reports it): delta
        rows awaiting compaction, tombstones, and the LSN frontier."""
        with self._lock:
            return {"delta_rows": int(self.delta_valid.sum()),
                    "tombstones": int(self.tombstones),
                    "live_rows": int(self.main_valid.sum()
                                     + self.delta_valid.sum()),
                    "lsn": int(self.lsn),
                    "last_compact_lsn": int(self.compact_lsn)}

    def user_ids(self, slot_ids) -> np.ndarray:
        """Map plan-result slot ids (a main slot, or cap_main + a delta
        slot; -1 invalid) back to user ids."""
        slots = _host(slot_ids)
        flat = slots.reshape(-1)
        out = np.full(flat.shape, -1, np.int64)
        with self._lock:
            main = (flat >= 0) & (flat < self.cap_main)
            out[main] = self.main_uids[flat[main]]
            delta = flat >= self.cap_main
            out[delta] = self.delta_uids[flat[delta] - self.cap_main]
        return out.reshape(slots.shape)


def _write_meta(path: str, meta: dict) -> None:
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def attach_live(catalog: Catalog, table: str, column: str, path: str, *,
                delta_cap: int = 256, cap_main: int | None = None,
                nlist: int | None = None, seed: int = 0, iters: int = 8,
                ids=None, keep_last_k: int = 3,
                faults: FaultInjector | None = None) -> LiveCorpus:
    """Make (table, column) mutable: build the live segments from the
    frozen table, write the meta and a base snapshot, register with the
    catalog, and (when ``nlist`` is given, or an IVF is already registered)
    build the live IVF over the padded main segment.

    Registration bumps the table's version on purpose: plans compiled on
    the frozen layout raise ``StalePlanError`` and re-prepare onto the live
    lowering.  ``ids`` gives the existing rows their user ids (default:
    row positions).  Mutations are visible only to plans that scan
    ``column``; the table's other vector columns stay frozen."""
    tab = catalog.table(table)
    spec = tab.schema[column]
    if spec.kind != ColumnKind.VECTOR:
        raise ValueError(f"{table}.{column} is not a vector column")
    vectors = _host(tab[column]).astype(np.float32, copy=False)
    n0, dim = vectors.shape
    if cap_main is None:
        cap_main = _ceil8(n0 + 4 * delta_cap)
    cap_main = _ceil8(cap_main)
    if cap_main < n0:
        raise ValueError(f"cap_main {cap_main} < existing rows {n0}")
    existing = catalog.index_for(table, column)
    if nlist is None and existing is not None:
        nlist = int(existing.nlist)
    col_names = [n for n, t in tab.schema.columns.items()
                 if t.kind in _SCALAR_KINDS]
    host_cols = {n: _host(tab[n]) for n in col_names}
    meta = {"table": table, "column": column, "dim": int(dim),
            "cap_main": int(cap_main), "delta_cap": int(delta_cap),
            "nlist": None if nlist is None else int(nlist),
            "seed": int(seed), "iters": int(iters),
            "keep_last_k": int(keep_last_k), "metric": spec.metric.name,
            "cols": {n: v.dtype.str for n, v in host_cols.items()}}
    uids = (np.arange(n0, dtype=np.int64) if ids is None
            else _host(ids).astype(np.int64))
    # validate BEFORE touching disk: a rejected attach leaves no partial
    # on-disk state (a bare meta.json would make a later recover() fail
    # with 'no committed snapshot' instead of 'never attached')
    if uids.shape != (n0,):
        raise ValueError(f"attach ids must have shape ({n0},), "
                         f"got {tuple(uids.shape)}")
    if len(np.unique(uids)) != n0:
        raise ValueError("attach ids must be unique")
    os.makedirs(path, exist_ok=True)
    _write_meta(path, meta)
    live = LiveCorpus(catalog, meta, path, faults=faults)
    live.main_vec[:n0] = vectors
    live.main_valid[:n0] = _host(tab.valid)
    live.main_uids[:n0] = uids
    for name, v in host_cols.items():
        live.cols[name][:n0] = v
    live._rebuild_uid_map()
    catalog.register_live(table, column, live)
    live.lsn = catalog.version(("live", table, column))
    open(live.wal_path, "w").close()
    checkpointer.save(live.ckpt_dir, live.lsn, live._state_tree(),
                      keep_last_k=keep_last_k)
    live._register_index()
    return live


def _read_wal(wal_path: str) -> tuple[list[dict], int]:
    """Parse the WAL; returns ``(records, durable_bytes)``.

    ``durable_bytes`` is the length of the longest prefix ending at a
    complete newline-terminated record: at most one torn (unterminated)
    tail line past it is shed.  Every successful append terminates its
    record, so a corrupt *terminated* line is an error anywhere."""
    if not os.path.exists(wal_path):
        return [], 0
    with open(wal_path, "rb") as f:
        chunks = f.read().split(b"\n")
    out, durable = [], 0
    # every chunk but the last was newline-terminated; the last is either
    # b"" (the file ends cleanly) or the torn tail of a mid-append crash
    for i, chunk in enumerate(chunks[:-1]):
        if chunk.strip():
            try:
                out.append(json.loads(chunk))
            except json.JSONDecodeError:
                raise MutationError(f"corrupt WAL record at line {i + 1}")
        durable += len(chunk) + 1
    return out, durable


def recover(catalog: Catalog, table: str, column: str, path: str, *,
            faults: FaultInjector | None = None) -> LiveCorpus:
    """Rebuild a live corpus from disk alone after a crash.

    Restores the newest committed snapshot, replays the WAL records past
    its LSN (a ``compact`` record recomputes the canonical state),
    truncates a torn tail line off the WAL so the next append starts a
    fresh record, fast-forwards the catalog clock past every replayed LSN,
    and registers the corpus and its IVF.  The recovered state's answers
    equal an unfailed replay of the same mutations bit for bit."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["table"] != table or meta["column"] != column:
        raise MutationError(
            f"live state at {path} is for {meta['table']}.{meta['column']}, "
            f"not {table}.{column}")
    live = LiveCorpus(catalog, meta, path, faults=faults)
    step = checkpointer.latest_step(live.ckpt_dir)
    if step is None:
        raise MutationError(f"no committed snapshot under {live.ckpt_dir}")
    live._load_state_tree(checkpointer.restore(live.ckpt_dir, step,
                                               live._state_tree()))
    live._rebuild_uid_map()
    records, durable = _read_wal(live.wal_path)
    if (os.path.exists(live.wal_path)
            and os.path.getsize(live.wal_path) > durable):
        # shed the torn tail ON DISK too: a later append must start a fresh
        # line, not merge with the partial bytes into one corrupt record
        with open(live.wal_path, "rb+") as f:
            f.truncate(durable)
            os.fsync(f.fileno())
    max_lsn = live.lsn
    for rec in records:
        lsn = int(rec["lsn"])
        max_lsn = max(max_lsn, lsn)
        if lsn <= live.lsn:
            continue                       # already folded into the snapshot
        if rec["op"] == "insert":
            cols = {n: np.asarray(v, live.col_dtypes[n])
                    for n, v in rec["cols"].items()}
            live._apply_insert(np.asarray(rec["ids"], np.int64),
                               np.asarray(rec["vecs"], np.float32), cols,
                               lsn)
        elif rec["op"] == "delete":
            live._apply_delete(np.asarray(rec["ids"], np.int64), lsn)
        elif rec["op"] == "compact":
            staged = live._canonical_state()
            staged["lsn"] = np.int64(lsn)
            staged["compact_lsn"] = np.int64(lsn)
            live._load_state_tree(staged)
            live._rebuild_uid_map()
        else:
            raise MutationError(f"unknown WAL op {rec['op']!r}")
    catalog.advance_clock(max_lsn)
    catalog.register_live(table, column, live)
    live._register_index()
    return live
