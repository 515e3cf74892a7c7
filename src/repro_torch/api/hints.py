"""Unified execution hints — one frozen knob surface for the session API.

Before the session API, the execution knobs were scattered: ``probe_budget``
rode an ad-hoc kwarg on ``execute_bucketed``, the effort pilot lived in
``SchedulerConfig``, and the join lowering override hid inside
``EngineOptions``.  :class:`ExecutionHints` consolidates them, validates
them eagerly (at construction and again against the prepared plan at
execute time), and is frozen/hashable so a hint set can key derived plan
variants in the cache.
"""
from __future__ import annotations

import dataclasses

_JOIN_LOWERINGS = (None, "batch", "perleft")


@dataclasses.dataclass(frozen=True)
class ExecutionHints:
    """How one ``Statement.execute`` call should run.

    * ``probe_budget`` — per-query IVF cluster budget (the straggler valve):
      an int applies to every query, a sequence gives one budget per query.
      Batched executions only (the single-query pipeline has no budget lane).
    * ``pilot_budget`` — > 0 enables two-phase effort-bucketed execution
      (pilot probe round, then re-run only the heavy remainder); bit-identical
      to the lock-step run.  Batched executions only.
    * ``exact_shape`` — route a batch through the exact-shape
      ``execute_batch`` executable (one trace per distinct Q) instead of the
      size-bucketed serving path.  The bit-parity reference for tests.
    * ``join_lowering`` — override ``EngineOptions.join_lowering`` for this
      statement.  Compile-affecting: a differing override re-prepares through
      the plan cache (a distinct options fingerprint is a distinct entry).
    * ``rescore_factor`` — override ``EngineOptions.rescore_factor`` for
      this statement: the candidate multiple c of the quantized scan's
      fused fp32 rescore (DESIGN.md §13; only meaningful when the plan
      compiled with ``EngineOptions.quant``).  Compile-affecting like
      ``join_lowering``: a differing override re-prepares through the plan
      cache.  Raise it on adversarial near-tie corpora where the default
      candidate set is too small for bit-exactness.
    * ``deadline_ms`` / ``priority`` — serving-tier hints (DESIGN.md §11):
      when a statement is served through a scheduler the request carries this
      relative deadline (shed if still queued past it) and drain priority.
      Inert on direct ``Statement.execute`` calls — there is no queue to
      wait in, so a direct call can never expire while queued.
    * ``no_opt`` — opt out of the adaptive optimizer for this call
      (DESIGN.md §14): run the plain lock-step bucketed path even on an
      adaptive session.  Redundant with any explicit execution knob — the
      advisor already yields whenever ``probe_budget`` / ``pilot_budget`` /
      ``exact_shape`` is set (hints always beat the advisor).
    """
    probe_budget: "int | tuple[int, ...] | None" = None
    pilot_budget: int = 0
    exact_shape: bool = False
    join_lowering: str | None = None
    rescore_factor: int | None = None
    deadline_ms: float | None = None
    priority: int = 0
    no_opt: bool = False

    def __post_init__(self):
        pb = self.probe_budget
        if pb is not None and not isinstance(pb, int):
            # normalize array-likes to a hashable tuple so hints stay frozen
            try:
                pb = tuple(int(v) for v in pb)
            except TypeError:
                raise TypeError(
                    f"probe_budget must be an int or a sequence of ints, "
                    f"got {self.probe_budget!r}") from None
            object.__setattr__(self, "probe_budget", pb)
        if isinstance(pb, int) and pb < 1:
            raise ValueError(f"probe_budget must be >= 1, got {pb}")
        if isinstance(pb, tuple) and any(v < 1 for v in pb):
            raise ValueError(f"per-query probe_budget entries must be >= 1, "
                             f"got {pb}")
        if self.pilot_budget < 0:
            raise ValueError(
                f"pilot_budget must be >= 0, got {self.pilot_budget}")
        if self.join_lowering not in _JOIN_LOWERINGS:
            raise ValueError(
                f"join_lowering must be one of {_JOIN_LOWERINGS[1:]}, "
                f"got {self.join_lowering!r}")
        if self.rescore_factor is not None and (
                not isinstance(self.rescore_factor, int)
                or self.rescore_factor < 1):
            raise ValueError(
                f"rescore_factor must be an int >= 1, "
                f"got {self.rescore_factor!r}")
        if self.exact_shape and self.pilot_budget > 0:
            raise ValueError(
                "exact_shape and pilot_budget are mutually exclusive: "
                "effort bucketing rides the size-bucketed executor")
        if self.exact_shape and self.probe_budget is not None:
            raise ValueError(
                "exact_shape and probe_budget are mutually exclusive: the "
                "exact-shape executable has no probe-budget lane")
        if self.pilot_budget > 0 and self.probe_budget is not None:
            raise ValueError(
                "pilot_budget and probe_budget are mutually exclusive: "
                "effort bucketing IS a probe-budget schedule (the pilot caps "
                "phase 1; phase 2 re-runs the heavy remainder unbudgeted)")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be positive, got {self.deadline_ms}")

    # -- plan-dependent validation (called by Statement) --------------------

    def validate_for_plan(self, batch_native: bool, batch_reason: str) -> None:
        """Reject hints the prepared plan cannot honor (better a loud error
        at execute time than a silently ignored budget)."""
        if not batch_native and self.probe_budget is not None:
            raise ValueError(
                f"probe_budget cannot be honored: the plan's batched "
                f"lowering is {batch_reason} (no probe-budget lane); drop "
                f"the hint or use join_lowering='batch'")

    def validate_for_single(self) -> None:
        """Batch-only hints are errors on the single-query path."""
        for name in ("probe_budget", "pilot_budget", "exact_shape"):
            val = getattr(self, name)
            if val not in (None, 0, False):
                raise ValueError(
                    f"{name} applies to batched execution; a single bind "
                    f"dict runs the single-query pipeline (pass a "
                    f"one-element binds list to run it batched)")
