"""Resilience primitives of the serving tier (the port of
``src/repro/serving/resilience.py``).

The serving path makes every failure mode an explicit, typed stage between
"request arrives" and "kernel runs":

* **Admission control** (:class:`AdmissionController`): a bounded queue
  with a hard depth watermark.  A saturated server rejects at the door with
  :class:`BackpressureError` carrying a ``retry_after_ms`` hint.
* **Bind validation** (:func:`validate_binds`): poisoned payloads
  (non-finite query vectors, on the host or on the card) are rejected with
  :class:`PoisonedBindError` before they reach a kernel, where NaNs would
  corrupt a whole coalesced batch's top-k ordering.
* **Deadlines** (:class:`DeadlineExceededError`): expired requests are shed
  before execution (see :mod:`repro_torch.serving.scheduler`).
* **Graceful degradation** (:class:`LoadController`): under overload the
  controller steps the per-query IVF ``probe_budget`` down through
  configured (queue-depth, budget) steps, with hysteresis.  Executions run
  at a degraded level report it in ``Result.explain()``.

The mutation errors and their admission checks are host numpy; the live
corpus (``data/mutations.py``) runs them before it logs anything.
Everything here is
deterministic given the observed queue depths.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


class ServingError(RuntimeError):
    """Base class for explicit serving-tier failures (every subclass is a
    *terminal, typed* request outcome — never a hang, never a bare
    timeout)."""


class BackpressureError(ServingError):
    """Admission rejected: the queue is at its watermark.

    Carries ``retry_after_ms`` — the client-facing shed signal ("come back
    later"), the opposite of an opaque timeout."""

    def __init__(self, depth: int, watermark: int, retry_after_ms: float):
        super().__init__(
            f"queue depth {depth} at/over admission watermark {watermark}; "
            f"retry after {retry_after_ms:.1f}ms")
        self.depth = depth
        self.watermark = watermark
        self.retry_after_ms = retry_after_ms


class DeadlineExceededError(ServingError):
    """The request's deadline passed while it was still queued; it was shed
    *before* compilation/execution (no kernel time was wasted on it)."""

    def __init__(self, rid: int, late_ms: float):
        super().__init__(f"request {rid} shed: deadline exceeded by "
                         f"{late_ms:.2f}ms while queued")
        self.rid = rid
        self.late_ms = late_ms


class PoisonedBindError(ServingError):
    """A bind payload failed validation (non-finite values) and was rejected
    at admission, before it could reach — and corrupt — a coalesced kernel
    batch."""

    def __init__(self, name: str):
        super().__init__(f"bind parameter {name!r} carries non-finite "
                         f"values; rejected at admission")
        self.name = name


class MutationError(ServingError):
    """Base class for typed mutation rejections (DESIGN.md §12).

    Every subclass is raised *at the door* — by
    :func:`validate_insert` / :func:`validate_delete` before a mutation
    touches the WAL or any device array — so a bad write can never surface
    as a mid-kernel failure or a half-applied log record."""


class UnknownIdError(MutationError):
    """A delete named an id that is not live (never inserted, already
    deleted, or compacted away after deletion)."""

    def __init__(self, ids):
        ids = list(ids)
        super().__init__(f"delete of nonexistent id(s) {ids[:8]}"
                         f"{'...' if len(ids) > 8 else ''}; "
                         f"rejected at admission")
        self.ids = ids


class DuplicateIdError(MutationError):
    """An insert named an id that is already live (in the main segment or
    the delta segment), or repeated an id within one insert batch."""

    def __init__(self, ids):
        ids = list(ids)
        super().__init__(f"insert of duplicate id(s) {ids[:8]}"
                         f"{'...' if len(ids) > 8 else ''}; "
                         f"rejected at admission")
        self.ids = ids


class InvalidVectorError(MutationError):
    """An insert payload failed vector validation (non-finite values or a
    dimension mismatch) — the mutation twin of :class:`PoisonedBindError`:
    a NaN row admitted into the delta segment would poison every scan that
    touches its lane."""

    def __init__(self, reason: str):
        super().__init__(f"insert vector rejected at admission: {reason}")
        self.reason = reason


class DeltaFullError(MutationError):
    """The delta segment has no free slots — mutation backpressure.

    The write-side analogue of :class:`BackpressureError`: carries the
    segment ``capacity``, the remaining ``free_slots``, and a
    ``compact_hint`` telling the client the segment drains via
    ``compact()`` (a retry without compaction will fail again)."""

    def __init__(self, capacity: int, requested: int, free_slots: int):
        super().__init__(
            f"delta segment full ({free_slots} of {capacity} slots free, "
            f"{requested} more requested); run compact() to fold deltas "
            f"into the main index")
        self.capacity = capacity
        self.free_slots = free_slots
        self.requested = requested
        self.compact_hint = True


def validate_insert(ids, vectors, dim: int, live_ids, free_slots: int,
                    delta_cap: int):
    """Admission checks for an insert batch; returns (ids, vectors) as numpy.

    Raises :class:`DuplicateIdError` (id already live, or repeated within
    the batch), :class:`InvalidVectorError` (shape/dim mismatch or
    non-finite values), or :class:`DeltaFullError` (no headroom) — always
    BEFORE anything is logged or applied, so a rejected insert has no
    side effects at any layer."""
    ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
    vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
    if vectors.ndim != 2 or vectors.shape[1] != dim:
        raise InvalidVectorError(
            f"expected shape (n, {dim}), got {tuple(vectors.shape)}")
    if vectors.shape[0] != ids.shape[0]:
        raise InvalidVectorError(
            f"{ids.shape[0]} id(s) but {vectors.shape[0]} vector row(s)")
    if not np.all(np.isfinite(vectors)):
        raise InvalidVectorError("non-finite values")
    uniq, counts = np.unique(ids, return_counts=True)
    batch_dups = uniq[counts > 1]
    existing = [int(i) for i in ids if int(i) in live_ids]
    if len(batch_dups) or existing:
        raise DuplicateIdError(sorted(set(existing) |
                                      {int(i) for i in batch_dups}))
    if ids.shape[0] > free_slots:
        raise DeltaFullError(capacity=delta_cap,
                             requested=int(ids.shape[0]),
                             free_slots=free_slots)
    return ids, vectors


def validate_delete(ids, live_ids):
    """Admission checks for a delete batch; returns the ids as numpy int64.

    Raises :class:`UnknownIdError` for any id that is not currently live
    (and for ids repeated within the batch — the second delete would also
    target a non-live id)."""
    ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
    uniq, counts = np.unique(ids, return_counts=True)
    missing = sorted({int(i) for i in ids if int(i) not in live_ids} |
                     {int(i) for i in uniq[counts > 1]})
    if missing:
        raise UnknownIdError(missing)
    return ids


def validate_binds(binds: dict) -> None:
    """Reject non-finite float bind values (raises PoisonedBindError).

    A NaN query vector inside a coalesced batch poisons every distance the
    kernel computes for that lane and can destabilize the shared top-k; the
    serving tier fails the one bad request at the door instead.  Tensors
    are tested where they live (a card-resident bind is not copied to the
    host); everything else goes through numpy."""
    for name, v in binds.items():
        if isinstance(v, torch.Tensor):
            bad = torch.is_floating_point(v) and not bool(
                torch.isfinite(v).all())
        else:
            arr = np.asarray(v)
            bad = np.issubdtype(arr.dtype, np.floating) and not np.all(
                np.isfinite(arr))
        if bad:
            raise PoisonedBindError(name)


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission-control knobs.

    ``max_queue_depth`` is the hard watermark: a submit that would make the
    number of in-flight requests exceed it is rejected.  ``retry_after_ms``
    scales linearly with how far over the watermark demand is pushing."""
    max_queue_depth: int = 256
    retry_after_ms: float = 10.0

    def __post_init__(self):
        if self.max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, "
                             f"got {self.max_queue_depth}")


class AdmissionController:
    """Bounded-queue admission: admit or reject-with-retry-after.

    Stateless beyond counters: the decision is a pure function of the
    observed depth, so replays are deterministic."""

    def __init__(self, config: AdmissionConfig | None = None):
        self.config = config if config is not None else AdmissionConfig()
        self.admitted = 0
        self.rejected = 0

    def admit(self, depth: int) -> None:
        """Admit a request arriving at queue depth ``depth`` (the in-flight
        count *before* this request), or raise :class:`BackpressureError`."""
        cfg = self.config
        if depth >= cfg.max_queue_depth:
            self.rejected += 1
            over = (depth - cfg.max_queue_depth) / cfg.max_queue_depth
            raise BackpressureError(
                depth, cfg.max_queue_depth,
                cfg.retry_after_ms * (1.0 + over))
        self.admitted += 1

    def snapshot(self) -> dict:
        """Counters: requests admitted / rejected so far."""
        return {"admitted": self.admitted, "rejected": self.rejected}


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """Load-controller policy: queue-depth watermarks -> probe budgets.

    ``steps`` is an ascending sequence of ``(queue_depth, probe_budget)``
    pairs: when the observed depth reaches ``steps[i][0]`` the controller
    moves to level ``i + 1`` and batched IVF executions are capped at
    ``steps[i][1]`` clusters per query (the DESIGN.md §8 straggler valve,
    repurposed as the overload valve).  Level 0 = full effort.
    ``hysteresis`` is how far below a step's watermark the depth must drop
    before stepping back up a level (no flapping at the boundary)."""
    steps: tuple = ((32, 16), (64, 4))
    hysteresis: int = 4

    def __post_init__(self):
        depths = [d for d, _ in self.steps]
        budgets = [b for _, b in self.steps]
        if depths != sorted(depths) or len(set(depths)) != len(depths):
            raise ValueError(f"step depths must be strictly ascending, "
                             f"got {depths}")
        if any(b < 1 for b in budgets):
            raise ValueError(f"probe budgets must be >= 1, got {budgets}")
        if budgets != sorted(budgets, reverse=True):
            raise ValueError(f"probe budgets must be non-increasing "
                             f"(deeper queue -> less effort), got {budgets}")
        if self.hysteresis < 0:
            raise ValueError(f"hysteresis must be >= 0, "
                             f"got {self.hysteresis}")


class LoadController:
    """Graceful-degradation state machine: queue depth -> effort level.

    ``observe(depth)`` is called once per drain with the current queue
    depth; it returns the level to run the next batch at.  Level L > 0 maps
    to ``policy.steps[L-1][1]`` as the per-query probe budget.  Transitions
    are deterministic: UP to the highest level whose watermark the depth
    reaches, DOWN one level at a time once depth falls ``hysteresis`` below
    the current level's watermark."""

    def __init__(self, policy: DegradePolicy | None = None):
        self.policy = policy if policy is not None else DegradePolicy()
        self.level = 0
        self.transitions = 0
        self.degraded_batches = 0

    def observe(self, depth: int) -> int:
        """Update and return the effort level for a drain at ``depth``."""
        steps = self.policy.steps
        up = 0
        for i, (watermark, _budget) in enumerate(steps):
            if depth >= watermark:
                up = i + 1
        if up > self.level:
            self.level = up
            self.transitions += 1
        elif self.level > 0:
            watermark = steps[self.level - 1][0]
            if depth <= max(0, watermark - self.policy.hysteresis):
                self.level -= 1
                self.transitions += 1
        if self.level > 0:
            self.degraded_batches += 1
        return self.level

    def probe_budget(self) -> int | None:
        """The current level's per-query probe budget (None = full effort)."""
        if self.level == 0:
            return None
        return self.policy.steps[self.level - 1][1]

    def snapshot(self) -> dict:
        """Live controller state: level, budget, transition/batch counters."""
        return {"level": self.level, "probe_budget": self.probe_budget(),
                "transitions": self.transitions,
                "degraded_batches": self.degraded_batches}
