"""Runtime execution statistics for the adaptive optimizer (the port of
``src/repro/opt/stats.py``; numpy only, copied so that ``to_json`` is
byte-identical to the reference's for the same observation sequence and
a stats file written by either package loads in the other).

Every executed batch leaves behind counters the engine already computes
(per-query probes-to-termination, distance evaluations, selectivity of the
structured filter) — this module is the place they accumulate so the next
execution of the *same plan shape* can spend effort where the last one
needed it.  Two aggregate families:

* **Bucket aggregates** — keyed ``(plan digest, selectivity bucket)``:
  EMA + count of observed selectivity, mean / high-quantile probes, rows
  scanned, and wall latency.  Buckets are log2-spaced in selectivity
  (bucket 0 covers (0.5, 1], each next bucket halves the range) so a plan
  executed with a tight filter and with a loose filter keeps *separate*
  probe profiles — the whole point on skewed workloads.
* **Left profiles** — keyed plan digest: a per-left-row EMA probe vector
  for join plans, whose left rows live in the plan arrays and are therefore
  the SAME rows on every call.  The profile is what turns bind-set-granular
  effort bucketing into per-left budgets inside a single join call.

Entries are stamped with the catalog version token
(``Catalog.version_snapshot`` over the plan's dependency keys) at first
observation; a lookup or observe under a different token drops the entry —
stats never outlive the data/index generation they were measured on.
Everything is plain floats + dicts: deterministic, JSON-round-trippable
(``to_json``/``from_json``), and persistable (``save``/``load``) so stats
survive restarts keyed by the *normalized* plan fingerprint digest.
"""
from __future__ import annotations

import json
import math

import numpy as np

N_BUCKETS = 8          # log2 selectivity buckets: 0 = loose, 7 = needle
EMA_ALPHA = 0.25       # weight of the newest observation
PROBE_QUANTILE = 75.0  # the "high" probe statistic tracked per bucket


def bucket_of(selectivity: float) -> int:
    """Log2 selectivity bucket: ``floor(-log2(sel))`` clipped to
    ``[0, N_BUCKETS)`` — bucket 0 covers (0.5, 1], bucket 1 (0.25, 0.5], …
    Deterministic and monotone: tighter filters land in higher buckets."""
    s = min(max(float(selectivity), 1e-9), 1.0)
    return int(min(N_BUCKETS - 1, math.floor(-math.log2(s) + 1e-12)))


def _blank_entry() -> dict:
    return {"count": 0, "sel": 0.0, "probes_mean": 0.0, "probes_hi": 0.0,
            "rows": 0.0, "latency_ms": 0.0}


class StatsStore:
    """Online per-(plan, selectivity-bucket) execution aggregates.

    All updates are exponential moving averages (``alpha`` = weight of the
    newest observation; the first observation seeds the EMA exactly), so
    the store is O(plans × buckets) regardless of traffic, and two stores
    fed the same observation sequence are bit-identical — the determinism
    the advisor tests assert."""

    def __init__(self, alpha: float = EMA_ALPHA):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        # (digest, bucket) -> {"version": tuple, **_blank_entry()}
        self._entries: dict = {}
        # digest -> {"version": tuple, "count": int, "profile": [float, ...]}
        self._left: dict = {}

    def __len__(self) -> int:
        return len(self._entries)

    def _ema(self, old: float, new: float, count: int) -> float:
        if count == 0:
            return float(new)
        return float(self.alpha * new + (1.0 - self.alpha) * old)

    # -- bucket aggregates --------------------------------------------------

    def observe(self, digest: str, bucket: int, version: tuple, *,
                selectivity: float, probes: np.ndarray, rows: float = 0.0,
                latency_ms: float = 0.0) -> dict:
        """Fold one executed batch into the (digest, bucket) aggregate.

        ``probes`` is the per-query probes-to-termination vector (joins
        reduced to per-bind-set max by the caller); ``rows`` the mean
        distance evaluations per query.  A version-token mismatch resets
        the entry first (catalog-clock invalidation)."""
        key = (digest, int(bucket))
        entry = self._entries.get(key)
        if entry is None or tuple(entry["version"]) != tuple(version):
            entry = dict(_blank_entry(), version=tuple(version))
            self._entries[key] = entry
        p = np.asarray(probes, dtype=np.float64).reshape(-1)
        p_mean = float(p.mean()) if p.size else 0.0
        p_hi = float(np.percentile(p, PROBE_QUANTILE)) if p.size else 0.0
        n = entry["count"]
        entry["sel"] = self._ema(entry["sel"], float(selectivity), n)
        entry["probes_mean"] = self._ema(entry["probes_mean"], p_mean, n)
        entry["probes_hi"] = self._ema(entry["probes_hi"], p_hi, n)
        entry["rows"] = self._ema(entry["rows"], float(rows), n)
        entry["latency_ms"] = self._ema(entry["latency_ms"],
                                        float(latency_ms), n)
        entry["count"] = n + 1
        return entry

    def lookup(self, digest: str, bucket: int, version: tuple) -> dict | None:
        """The (digest, bucket) aggregate, or None if absent or measured
        under a different catalog version (the stale entry is dropped)."""
        key = (digest, int(bucket))
        entry = self._entries.get(key)
        if entry is None:
            return None
        if tuple(entry["version"]) != tuple(version):
            del self._entries[key]
            return None
        return entry

    # -- per-left join profiles ---------------------------------------------

    def observe_left(self, digest: str, version: tuple,
                     probes_ql: np.ndarray) -> None:
        """Fold a join execution's (Q, L) probe counters into the per-left
        EMA profile (reduced over the bind-set axis by max — a left row's
        cost is its worst bind set).  Shape or version drift resets."""
        per_left = np.asarray(probes_ql, dtype=np.float64)
        if per_left.ndim != 2:
            raise ValueError(
                f"per-left profiles need (Q, L) probe counters, got shape "
                f"{per_left.shape}")
        per_left = per_left.max(axis=0)
        rec = self._left.get(digest)
        if (rec is None or tuple(rec["version"]) != tuple(version)
                or len(rec["profile"]) != per_left.shape[0]):
            rec = {"version": tuple(version), "count": 0,
                   "profile": [0.0] * per_left.shape[0]}
            self._left[digest] = rec
        old = np.asarray(rec["profile"])
        if rec["count"] == 0:
            new = per_left
        else:
            new = self.alpha * per_left + (1.0 - self.alpha) * old
        rec["profile"] = [float(x) for x in new]
        rec["count"] += 1

    def left_profile(self, digest: str, version: tuple) -> np.ndarray | None:
        """The (L,) per-left EMA probe profile, or None if absent/stale."""
        rec = self._left.get(digest)
        if rec is None:
            return None
        if tuple(rec["version"]) != tuple(version):
            del self._left[digest]
            return None
        if rec["count"] == 0:
            return None
        return np.asarray(rec["profile"], dtype=np.float64)

    # -- persistence ---------------------------------------------------------

    def to_json(self) -> str:
        """Serialize (sorted keys — byte-stable for identical stores)."""
        entries = [{"digest": d, "bucket": b, "version": list(e["version"]),
                    **{k: e[k] for k in _blank_entry()}}
                   for (d, b), e in sorted(self._entries.items())]
        left = [{"digest": d, "version": list(r["version"]),
                 "count": r["count"], "profile": r["profile"]}
                for d, r in sorted(self._left.items())]
        return json.dumps({"alpha": self.alpha, "entries": entries,
                           "left": left}, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "StatsStore":
        """Rebuild a store serialized by :meth:`to_json`; versions round-trip
        as tuples so invalidation keeps working across restarts."""
        blob = json.loads(text)
        store = cls(alpha=blob.get("alpha", EMA_ALPHA))
        for e in blob.get("entries", ()):
            entry = {k: e[k] for k in _blank_entry()}
            entry["version"] = _version_from_json(e["version"])
            store._entries[(e["digest"], int(e["bucket"]))] = entry
        for r in blob.get("left", ()):
            store._left[r["digest"]] = {
                "version": _version_from_json(r["version"]),
                "count": int(r["count"]),
                "profile": [float(x) for x in r["profile"]]}
        return store

    def save(self, path: str) -> None:
        """Write the JSON form to ``path``."""
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "StatsStore":
        """Read a store written by :meth:`save`."""
        with open(path) as f:
            return cls.from_json(f.read())


def _version_from_json(version) -> tuple:
    # version tokens are tuples of (key-tuple, int) pairs; JSON turns the
    # tuples into lists — restore hashable/comparable tuple form recursively
    def back(v):
        return tuple(back(x) for x in v) if isinstance(v, list) else v
    return back(version)
