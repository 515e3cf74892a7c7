"""Deterministic fault injection for the serving tier (the port of
``src/repro/serving/faults.py``; DESIGN.md §11).

Chaos testing is only useful if a failing run can be replayed: every
injection decision here is drawn from a seeded, *per-fault-type* RNG
stream, so

* the same ``FaultSpec(seed=s)`` driven through the same request sequence
  injects the same faults at the same decision sites, and
* enabling one fault type does not shift the draw sequence of another
  (independent streams keyed by ``(seed, fault-name)``).

Four injectable fault classes, mirroring what production serving actually
sees:

* **latency spikes** — an execute suddenly takes ``latency_spike_ms``
  longer (a slow kernel, a noisy neighbor).  The deadline machinery must
  shed what the spike expired, not hang behind it.
* **kernel exceptions** — the execute raises
  :class:`InjectedKernelError`.  The scheduler must fail that batch's
  requests with the error and keep serving (fault containment).
* **poisoned binds** — a request payload is corrupted to NaN on submit.
  Admission validation must reject it before it reaches a kernel.
* **mid-flight catalog bumps** — ``register_index`` fires between batches
  (a background re-build landing).  The catalog-version invalidation rule
  must re-bind the plan before the next execute (no stale results, no
  crash).

A fifth class — **process crashes** at :data:`CRASH_SITES` durability
boundaries in the live-corpus mutation path (DESIGN.md §12) — is injected
deterministically by (site, Nth-hit) rather than probability: crash tests
need the failure at one exact WAL/snapshot/compaction boundary, and
keeping crashes out of the RNG streams preserves the per-type stream
independence above.

The injector wraps an execute callable (:meth:`FaultInjector.wrap`);
``counters`` record exactly what was injected so chaos tests can assert
counter-exact outcomes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch


class InjectedKernelError(RuntimeError):
    """The fault harness's stand-in for a kernel/runtime failure during a
    batch execution (the scheduler must contain it per batch)."""


class InjectedCrashError(RuntimeError):
    """A process "crash" fired at a :data:`CRASH_SITES` point in the
    mutation path (DESIGN.md §12).  The chaos harness catches it, discards
    all in-memory state, and must recover from disk alone."""


#: Deterministic crash points in the live-corpus mutation path, in
#: durability order.  Each site marks the instant *before* or *after* a
#: durability step, so a crash there is the worst torn state that step can
#: leave on disk: a WAL record lost entirely, a half-written tail line,
#: a snapshot requested but never written, a compaction logged but never
#: swapped (``data/mutations.py`` calls :meth:`FaultInjector.crash_point`
#: at each).
CRASH_SITES = (
    "wal.pre_append",        # mutation validated, nothing durable yet
    "wal.torn_append",       # partial WAL line flushed, then crash
    "wal.group_commit",      # group commit torn: full prefix + half tail
    "wal.post_append",       # record durable, in-memory apply lost
    "snapshot.pre_commit",   # snapshot requested, nothing written yet
    "snapshot.post_commit",  # snapshot committed (rename landed), caller died
    "compact.pre_log",       # compaction computed, nothing durable
    "compact.post_log",      # compact WAL record durable, swap lost
    "compact.pre_swap",      # post-compaction snapshot durable, swap lost
)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """What to inject, with what probability — all draws seeded.

    Probabilities are per decision site: ``poison_bind_p`` per submitted
    request; the others per batch execution."""
    seed: int = 0
    latency_spike_p: float = 0.0
    latency_spike_ms: float = 20.0
    kernel_error_p: float = 0.0
    poison_bind_p: float = 0.0
    catalog_bump_p: float = 0.0
    # crash injection is deterministic (site + Nth hit), NOT probabilistic:
    # a crash must land at one exact durability boundary to test it, and
    # keeping it out of the RNG streams preserves stream independence
    crash_site: str | None = None
    crash_at: int = 1

    def __post_init__(self):
        for f in ("latency_spike_p", "kernel_error_p", "poison_bind_p",
                  "catalog_bump_p"):
            p = getattr(self, f)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{f} must be a probability, got {p}")
        if self.crash_site is not None and self.crash_site not in CRASH_SITES:
            raise ValueError(f"unknown crash_site {self.crash_site!r}; "
                             f"expected one of {CRASH_SITES}")
        if self.crash_at < 1:
            raise ValueError(f"crash_at must be >= 1 (1 = first hit), "
                             f"got {self.crash_at}")


class FaultInjector:
    """Seeded chaos: wraps the serving execute path and corrupts submits.

    ``bump_fn`` is the mid-flight catalog mutation to fire (typically a
    ``register_index`` re-registering a rebuilt index); ``sleep_fn`` lets
    virtual-clock harnesses account spike time without wall-clock sleeping.
    """

    _STREAMS = ("latency", "kernel", "poison", "bump")

    def __init__(self, spec: FaultSpec,
                 bump_fn: Callable[[], None] | None = None,
                 sleep_fn: Callable[[float], None] | None = None):
        self.spec = spec
        self.bump_fn = bump_fn
        self.sleep_fn = sleep_fn if sleep_fn is not None else time.sleep
        # independent streams: enabling/IGNORING one fault type never
        # shifts another type's draw sequence
        self._rng = {name: np.random.default_rng([spec.seed, i])
                     for i, name in enumerate(self._STREAMS)}
        self.counters = {"latency_spikes": 0, "kernel_errors": 0,
                         "poisoned_binds": 0, "catalog_bumps": 0,
                         "crashes": 0}
        self._site_hits = {site: 0 for site in CRASH_SITES}

    # -- submit-side --------------------------------------------------------

    def maybe_poison(self, binds: dict) -> tuple[dict, bool]:
        """With ``poison_bind_p``, corrupt the request's first float-array
        bind (in name order) to NaN (returns (binds, poisoned)); draws
        exactly once per call, so the decision sequence is submit-order
        deterministic.  A tensor bind is poisoned on its own device; the
        caller's dict and arrays are never mutated."""
        if self._rng["poison"].random() >= self.spec.poison_bind_p:
            return binds, False
        out = dict(binds)
        for name in sorted(out):
            v = out[name]
            if isinstance(v, torch.Tensor):
                if torch.is_floating_point(v) and v.ndim >= 1:
                    out[name] = torch.full_like(v, float("nan"))
                    self.counters["poisoned_binds"] += 1
                    return out, True
                continue
            arr = np.asarray(v)
            if np.issubdtype(arr.dtype, np.floating) and arr.ndim >= 1:
                bad = np.array(arr, dtype=arr.dtype)
                bad[...] = np.nan
                out[name] = bad
                self.counters["poisoned_binds"] += 1
                return out, True
        return binds, False

    # -- crash-side ---------------------------------------------------------

    def armed(self, site: str) -> bool:
        """Record a hit on ``site`` and report whether the configured crash
        fires here (site matches and this is the ``crash_at``-th hit).
        Hit counting is unconditional so the same mutation sequence visits
        sites identically whether or not a crash is configured."""
        if site not in self._site_hits:
            raise ValueError(f"unknown crash site {site!r}")
        self._site_hits[site] += 1
        return (self.spec.crash_site == site
                and self._site_hits[site] == self.spec.crash_at)

    def crash_point(self, site: str) -> None:
        """Raise :class:`InjectedCrashError` if the configured crash is
        armed at ``site``; otherwise a no-op (plus hit accounting)."""
        if self.armed(site):
            self.counters["crashes"] += 1
            raise InjectedCrashError(
                f"injected crash at {site!r} "
                f"(hit #{self._site_hits[site]}, seed={self.spec.seed})")

    # -- execute-side -------------------------------------------------------

    def before_execute(self) -> None:
        """Pre-batch decision site: maybe fire the mid-flight catalog bump
        (draws once per batch whether or not a ``bump_fn`` is wired)."""
        fire = self._rng["bump"].random() < self.spec.catalog_bump_p
        if fire and self.bump_fn is not None:
            self.counters["catalog_bumps"] += 1
            self.bump_fn()

    def around_execute(self, fn: Callable[[], Any]) -> Any:
        """Run one batch execution under the latency/kernel fault draws."""
        if self._rng["latency"].random() < self.spec.latency_spike_p:
            self.counters["latency_spikes"] += 1
            self.sleep_fn(self.spec.latency_spike_ms * 1e-3)
        if self._rng["kernel"].random() < self.spec.kernel_error_p:
            self.counters["kernel_errors"] += 1
            raise InjectedKernelError(
                f"injected kernel fault (seed={self.spec.seed}, "
                f"fault #{self.counters['kernel_errors']})")
        return fn()

    def wrap(self, execute: Callable) -> Callable:
        """Wrap a ``execute(binds_list) -> out`` callable with the full
        per-batch fault sequence (catalog bump, spike, kernel error)."""

        def wrapped(binds_list):
            self.before_execute()
            return self.around_execute(lambda: execute(binds_list))

        return wrapped

    def snapshot(self) -> dict:
        """Injection counters (copies — safe to diff across phases)."""
        return dict(self.counters)
