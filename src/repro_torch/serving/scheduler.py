"""Dynamic batch scheduler — the serving front end of the size-bucketed
execution stack (the port of ``src/repro/serving/scheduler.py``).

* **Coalescing** (:class:`BatchScheduler`): arriving requests queue until
  the batch fills (``max_batch``) or the OLDEST queued request has waited
  ``max_wait_ms``, then the whole batch drains into the bucketed executor
  (padded to the enclosing power-of-two bucket, outputs sliced per
  request).
* **Effort bucketing** (:func:`run_effort_bucketed`): phase 1 runs the
  whole batch under a small per-query ``probe_budget`` (the pilot); a query
  whose probes stay below its budget terminated naturally and is final.
  Phase 2 re-runs only the heavy remainder, unbudgeted, in a smaller
  bucket, and its rows are scattered back on the outputs' device.  The
  merged result equals the lock-step run bit for bit, counters included.
* **Deadlines, priorities, containment**: expired requests are shed
  before execution (:class:`~repro_torch.serving.resilience.
  DeadlineExceededError`), a forming batch never waits past its tightest
  member's deadline, and an execution that raises fails its own batch
  only.  :class:`ResilientScheduler` adds graceful degradation and fault
  injection.

On the card, every execution runs on the device of the served plan and on
the CUDA stream that was current where the scheduler was built, whichever
thread drains (a front door drains on executor worker threads); the queue
is guarded by a lock, since requests arrive on another thread.
:meth:`BatchScheduler.simulate` synchronises the card before it reads the
clock, so service times are device times, not launch times.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from ..api.hints import ExecutionHints
from ..api.result import ResultBatch
from ..core.compiler import _host, _tree_map
from ..opt.advisor import host_counters
from .resilience import DeadlineExceededError, LoadController


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Coalescing + effort-bucketing + deadline knobs.

    ``max_wait_ms`` bounds the queueing latency the scheduler may add.
    ``pilot_budget`` > 0 enables two-phase effort-bucketed IVF execution
    (cluster units).  ``default_deadline_ms`` stamps every request
    submitted without an explicit deadline (None = no deadline);
    ``deadline_margin_ms`` drains a forming batch that much *before* its
    tightest member deadline (headroom for service time)."""
    max_batch: int = 64
    max_wait_ms: float = 2.0
    pilot_budget: int = 0
    default_deadline_ms: float | None = None
    deadline_margin_ms: float = 0.0


@dataclasses.dataclass
class _Request:
    """One queued request: binds + arrival/deadline/priority metadata."""
    rid: int
    binds: dict
    arrival: float
    deadline: float | None = None     # absolute, clock units (seconds)
    priority: int = 0                 # higher drains first


@dataclasses.dataclass
class SimRecord:
    """One simulated request's timeline (seconds, virtual clock)."""
    rid: int
    arrival: float
    start: float
    finish: float
    batch_size: int

    @property
    def latency(self) -> float:
        """Request latency (finish - arrival) in virtual-clock seconds."""
        return self.finish - self.arrival


def _pilot_info(pilot) -> "int | dict":
    """JSON-able form of a pilot budget (scalar int or array summary)."""
    if np.ndim(pilot) == 0:
        return int(pilot)
    arr = np.asarray(pilot)
    return {"min": int(arr.min()), "max": int(arr.max()),
            "shape": list(arr.shape)}


def _scatter_rows(light, heavy_out, rows: np.ndarray):
    """``light`` with its leading-axis ``rows`` replaced by ``heavy_out``'s
    rows, leaf by leaf on each leaf's device (a copy; nothing moves to the
    host)."""
    index: dict = {}

    def scatter(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.device not in index:
            index[a.device] = torch.as_tensor(rows, dtype=torch.long,
                                              device=a.device)
        return a.index_copy(0, index[a.device], b)

    def walk(a, b):
        if isinstance(a, dict):
            return {k: walk(v, b[k]) for k, v in a.items()}
        return scatter(a, b)

    return walk(light, heavy_out)


def run_effort_bucketed(compiled, binds: dict, pilot_budget=0, *,
                        advisor=None):
    """Two-phase effort-bucketed execution of a stacked bind batch.

    Returns ``(out, info)`` where ``out`` equals ``compiled.executor`` on
    the same binds (lock-step) bit for bit and ``info`` reports the phase
    split: ``n_light`` queries finished in the pilot, ``n_heavy`` re-ran in
    the (smaller) phase-2 batch.

    ``pilot_budget`` may be a scalar, a (Q,) per-bind-set array, or — for
    join plans — a (Q, L) per-left array.  A bind set is heavy if ANY of
    its queries / left rows hit its own budget; phase 2 re-runs those sets
    unbudgeted.  The classification reads the phase-1 probe and eval
    counters on the host in one device-to-host copy; the bind gather runs
    on the host binds and the scatter on the outputs' device.
    ``compiled`` may be a ``CompiledQuery`` or a session-API ``Statement``.

    With ``advisor`` (a :class:`~repro_torch.opt.advisor.LoweringAdvisor`)
    the pilot comes from its stats-driven prediction: a cold or probe-less
    plan runs one lock-step phase, a warmed plan gets a predicted scalar
    pilot or per-left budgets, and the merged counters fold back into the
    advisor's stats either way.  That reading is the same one host copy
    (plus one of the heavy rows' counters when phase 2 ran), and the
    latency it records ends when that copy returns."""
    inner = getattr(compiled, "compiled", compiled)
    executor = compiled.executor
    decision = None
    if advisor is not None and advisor.enabled:
        decision = advisor.advise_batch(inner, binds)
        pilot_budget = decision.pilot if decision.pilot is not None else 0
    scalar_pilot = np.ndim(pilot_budget) == 0
    if scalar_pilot and pilot_budget <= 0 and advisor is None:
        raise ValueError("pilot_budget must be positive")
    t0 = time.perf_counter()
    if not compiled.batch_native or (scalar_pilot and pilot_budget <= 0):
        # one phase: the loop-of-singles fallback has no probe_budget lane
        # (a pilot run would execute the FULL batch and call every query
        # heavy), and an advisor's lock-step decision (a cold or probe-less
        # plan) still feeds its counters back
        out = executor(binds)
        counters = host_counters(out)
        info = {"n_light": _per_bind_set(counters["probes"]).shape[0],
                "n_heavy": 0, "pilot_budget": _pilot_info(pilot_budget)}
        if not compiled.batch_native:
            info["skipped"] = "plan has no native batched lowering"
        return out, _observed(advisor, inner, decision, counters, t0, info)
    budget = (int(pilot_budget) if scalar_pilot
              else np.asarray(pilot_budget, np.int32))
    out1 = executor(binds, probe_budget=budget)
    counters = host_counters(out1)
    probes = counters["probes"]
    limit = budget
    if not scalar_pilot and probes.ndim == 2 and np.ndim(budget) == 1:
        limit = budget[:, None]            # per-bind-set vs (Q, L) stats
    heavy = np.nonzero(_per_bind_set(probes >= limit))[0]
    qn = probes.shape[0]
    info = {"n_light": int(qn - heavy.size), "n_heavy": int(heavy.size),
            "pilot_budget": _pilot_info(budget)}
    if heavy.size == 0:
        return out1, _observed(advisor, inner, decision, counters, t0, info)
    out2 = executor({k: _host(v)[heavy] for k, v in binds.items()})
    if decision is not None:
        for key, v in host_counters(out2).items():
            counters[key][heavy] = v
    merged = _scatter_rows(out1, out2, heavy)
    return merged, _observed(advisor, inner, decision, counters, t0, info)


def _per_bind_set(x: np.ndarray) -> np.ndarray:
    """Per-bind-set values of (Q, ...) host counters or flags: joins report
    (Q, L), reduced by the maximum (a bind set is heavy if ANY of its left
    rows is)."""
    return x.max(axis=tuple(range(1, x.ndim))) if x.ndim > 1 else x


def _observed(advisor, inner, decision, counters: dict, t0: float,
              info: dict) -> dict:
    """Fold the finished execution's host counters into the advisor (if
    any) and attach the decision summary to ``info`` under ``"opt"``."""
    if advisor is not None and decision is not None:
        latency_ms = (time.perf_counter() - t0) * 1e3
        advisor.observe(inner, decision, counters, latency_ms)
        info["opt"] = decision.summary()
    return info


def _device_of(compiled) -> torch.device:
    """The device a served plan's tensors live on."""
    inner = getattr(compiled, "compiled", compiled)
    return inner._arrays["corpus"].device


class BatchScheduler:
    """Coalesce arriving requests into size-bucketed batch executions.

    Online surface: ``submit(**binds)`` enqueues and returns a request id;
    ``poll()`` drains a batch when due (full, or the oldest request's
    ``max_wait_ms`` deadline expired); ``flush()`` drains everything;
    ``result(rid)`` returns that request's sliced outputs (views into the
    batch's tensors, on the plan's device).  One scheduler serves one
    compiled plan.

    ``compiled`` is anything exposing the execution contract —
    ``_stack_binds`` / ``executor`` / ``batch_native`` — i.e. a
    :class:`~repro_torch.core.compiler.CompiledQuery` or a session-API
    :class:`~repro_torch.api.Statement` (``Database.serve`` builds the
    latter; a Statement translates renamed bind parameters onto the cached
    plan before stacking).  With ``advisor`` (a
    :class:`~repro_torch.opt.LoweringAdvisor`) every drain runs the
    advisor's effort decision instead of the static ``pilot_budget``."""

    def __init__(self, compiled, config: SchedulerConfig | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 advisor=None):
        self.compiled = compiled
        self.advisor = advisor
        # None-sentinel, NOT a `config=SchedulerConfig()` default: a
        # class-level default dataclass would be one shared instance
        self.config = config if config is not None else SchedulerConfig()
        self.clock = clock
        self.device = _device_of(compiled)
        # CUDA's current stream is per thread: pin the builder's, so a
        # drain on any worker thread launches where the caller expects
        self.stream = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)
        self._lock = threading.RLock()
        self._queue: collections.deque[_Request] = collections.deque()
        self._results: dict[int, Any] = {}
        self._next_rid = 0
        self.counters = {"submitted": 0, "executed": 0, "batches": 0,
                         "shed_deadline": 0, "failed": 0}

    # -- online API ---------------------------------------------------------

    def submit(self, **binds) -> int:
        """Enqueue a request with default deadline/priority (see
        :meth:`submit_request` for the full contract)."""
        return self.submit_request(binds)

    def submit_request(self, binds: dict, *, deadline_ms: float | None = None,
                       deadline: float | None = None,
                       priority: int = 0) -> int:
        """Enqueue a request and return its id.

        ``deadline_ms`` is relative to now; ``deadline`` is absolute in
        clock units (seconds) and wins when both are given.  Without either,
        ``config.default_deadline_ms`` applies (None = never expires).
        Higher ``priority`` drains first; ties drain in arrival order."""
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            now = self.clock()
            if deadline is None:
                if deadline_ms is None:
                    deadline_ms = self.config.default_deadline_ms
                if deadline_ms is not None:
                    deadline = now + deadline_ms * 1e-3
            self._queue.append(_Request(rid, binds, now, deadline, priority))
            self.counters["submitted"] += 1
        return rid

    def pending(self) -> int:
        """Number of requests queued (submitted, not yet drained/shed)."""
        with self._lock:
            return len(self._queue)

    def due(self, now: float | None = None) -> bool:
        """Drain rule: full batch, OR the oldest request waited out its
        ``max_wait_ms`` coalescing window, OR the tightest queued deadline
        is within ``deadline_margin_ms``."""
        with self._lock:
            if not self._queue:
                return False
            if len(self._queue) >= self.config.max_batch:
                return True
            now = self.clock() if now is None else now
            oldest = self._queue[0].arrival
            if (now - oldest) * 1e3 >= self.config.max_wait_ms:
                return True
            deadlines = [r.deadline for r in self._queue
                         if r.deadline is not None]
            if deadlines:
                margin = self.config.deadline_margin_ms * 1e-3
                return now >= min(deadlines) - margin
            return False

    def shed_expired(self, now: float | None = None) -> list[int]:
        """Drop every queued request whose deadline has passed (strict
        ``now > deadline``).  Each shed rid completes with a stored
        :class:`~repro_torch.serving.resilience.DeadlineExceededError`
        that :meth:`result` re-raises; no kernel time is spent on them."""
        with self._lock:
            if not self._queue:
                return []
            now = self.clock() if now is None else now
            shed: list[int] = []
            keep: collections.deque[_Request] = collections.deque()
            for r in self._queue:
                if r.deadline is not None and now > r.deadline:
                    self._results[r.rid] = DeadlineExceededError(
                        r.rid, (now - r.deadline) * 1e3)
                    shed.append(r.rid)
                else:
                    keep.append(r)
            if shed:
                self._queue = keep
                self.counters["shed_deadline"] += len(shed)
            return shed

    def poll(self, now: float | None = None) -> list[int]:
        """Shed expired requests, then drain ONE batch if due; returns the
        completed request ids (shed rids included — their results raise)."""
        now = self.clock() if now is None else now
        done = self.shed_expired(now)
        if self.due(now):
            done.extend(self._drain(now))
        return done

    def flush(self, now: float | None = None) -> list[int]:
        """Drain everything queued, one max_batch execution at a time."""
        now = self.clock() if now is None else now
        done = self.shed_expired(now)
        while self.pending():
            done.extend(self._drain(now))
        return done

    def result(self, rid: int):
        """Pop the request's outcome: sliced outputs, or — for a shed or
        failed request — re-raise its stored exception."""
        with self._lock:
            out = self._results.pop(rid)
        if isinstance(out, BaseException):
            raise out
        return out

    def synchronize(self) -> None:
        """Wait for the work queued on the scheduler's stream (a no-op off
        the card)."""
        if self.stream is not None:
            self.stream.synchronize()

    # -- execution ----------------------------------------------------------

    def on_device(self) -> contextlib.AbstractContextManager:
        """The scope every execution runs in: the plan's device and the
        pinned stream (nothing off the card)."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def _take(self) -> list[_Request]:
        """Pop up to max_batch requests, highest priority first (arrival
        order within a priority level; all-default priority is FIFO)."""
        take = min(len(self._queue), self.config.max_batch)
        if any(r.priority for r in self._queue):
            ordered = sorted(self._queue,
                             key=lambda r: (-r.priority, r.arrival, r.rid))
            chosen = {r.rid for r in ordered[:take]}
            entries = [r for r in self._queue if r.rid in chosen]
            self._queue = collections.deque(
                r for r in self._queue if r.rid not in chosen)
            return entries
        return [self._queue.popleft() for _ in range(take)]

    def _drain(self, now: float | None = None) -> list[int]:
        now = self.clock() if now is None else now
        done = self.shed_expired(now)
        with self._lock:
            if not self._queue:
                return done
            entries = self._take()
        try:
            with self.on_device():
                out = self.execute([r.binds for r in entries])
        except Exception as e:
            # fault containment: the failure is scoped to this batch —
            # every member completes with the error, the queue keeps
            # draining, and nothing is left dangling (no hangs)
            with self._lock:
                for r in entries:
                    self._results[r.rid] = e
                self.counters["failed"] += len(entries)
        else:
            sliced = [self._slice(out, i) for i in range(len(entries))]
            with self._lock:
                for r, res in zip(entries, sliced):
                    self._results[r.rid] = res
                self.counters["executed"] += len(entries)
                self.counters["batches"] += 1
        return done + [r.rid for r in entries]

    def _slice(self, out, i: int):
        """Request ``i``'s view of a batch output (overridable —
        :class:`ResilientScheduler` slices a structured ResultBatch)."""
        return _tree_map(lambda v: v[i], out)

    def execute(self, binds_list: list[dict]):
        """Execute one coalesced batch through the bucketed executor
        (effort-bucketed when ``pilot_budget`` > 0; the advisor's predicted
        budgets replace the static pilot when one is attached), after
        re-binding the plan to the catalog's current registrations."""
        self.compiled.ensure_fresh()
        binds = self.compiled._stack_binds(binds_list, {})
        if self.advisor is not None:
            out, _info = run_effort_bucketed(self.compiled, binds,
                                             self.config.pilot_budget,
                                             advisor=self.advisor)
            return out
        if self.config.pilot_budget > 0:
            out, _info = run_effort_bucketed(self.compiled, binds,
                                             self.config.pilot_budget)
            return out
        return self.compiled.executor(binds)

    def warm(self, sample_binds: dict, batch_sizes: list[int]) -> None:
        """Run the buckets a traffic mix will touch once (keeps first-call
        costs out of latency measurements and first requests).  With
        ``pilot_budget`` > 0 the budgeted phase-1 run too."""
        with self.on_device():
            for b in sorted({self.compiled.executor.bucket_for(s)
                             for s in batch_sizes}):
                stacked = self.compiled._stack_binds([sample_binds] * b, {})
                self.compiled.executor(stacked)
                if self.config.pilot_budget > 0 and self.compiled.batch_native:
                    self.compiled.executor(
                        stacked, probe_budget=self.config.pilot_budget)
        self.synchronize()

    # -- virtual-clock simulation -------------------------------------------

    def simulate(self, arrivals: np.ndarray,
                 binds_list: list[dict]) -> list[SimRecord]:
        """Single-server queueing simulation of the coalescing policy.

        ``arrivals`` are request arrival times in seconds (sorted ascending,
        virtual clock); ``binds_list`` the matching per-request binds.  Batch
        formation follows the deadline rule; service time is the measured
        wall-clock of the REAL batch execution, synchronised with the card
        (warm the buckets first).  Returns per-request timelines."""
        n = len(arrivals)
        assert len(binds_list) == n
        wait_s = self.config.max_wait_ms * 1e-3
        server_free = 0.0
        records: list[SimRecord] = []
        i = 0
        while i < n:
            deadline = arrivals[i] + wait_s
            close = max(deadline, server_free)
            j = i
            while (j < n and arrivals[j] <= close
                   and (j - i) < self.config.max_batch):
                j += 1
            if j - i >= self.config.max_batch:
                # the batch filled before the window closed
                start = max(server_free, float(arrivals[j - 1]))
            else:
                start = close
            self.synchronize()
            t0 = time.perf_counter()
            with self.on_device():
                self.execute(binds_list[i:j])
            self.synchronize()
            exec_s = time.perf_counter() - t0
            finish = start + exec_s
            for r in range(i, j):
                records.append(SimRecord(r, float(arrivals[r]), start,
                                         finish, j - i))
            server_free = finish
            i = j
        return records


class ResilientScheduler(BatchScheduler):
    """Deadline scheduler + graceful degradation + fault injection.

    Serves a session-API :class:`~repro_torch.api.Statement` (its
    structured results carry the degraded-mode report).  On every drain
    the :class:`~repro_torch.serving.resilience.LoadController` observes
    the pre-drain queue depth and picks an effort level; level L > 0 caps
    batched IVF executions at the policy's per-query ``probe_budget`` and
    the served results' ``explain()`` reports ``degraded``.  A
    :class:`~repro_torch.serving.faults.FaultInjector`, when wired, wraps
    each batch execution (catalog bumps, latency spikes, kernel errors);
    injected errors are contained per batch like any real failure."""

    def __init__(self, statement, config: SchedulerConfig | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 policy=None, faults=None):
        super().__init__(statement, config, clock)
        self.load = LoadController(policy)
        self.faults = faults

    @property
    def statement(self):
        """The served Statement (alias of the scheduler's compiled slot)."""
        return self.compiled

    def execute(self, binds_list: list[dict]):
        depth = self.pending() + len(binds_list)  # pre-drain queue depth
        level = self.load.observe(depth)
        budget = self.load.probe_budget()
        if budget is not None and self.compiled.batch_native:
            hints = ExecutionHints(probe_budget=budget)
        elif self.config.pilot_budget > 0:
            hints = ExecutionHints(pilot_budget=self.config.pilot_budget)
        else:
            hints = None
        run = lambda bl: self.compiled.execute(bl, hints=hints)  # noqa: E731
        if self.faults is not None:
            run = self.faults.wrap(run)
        out = run(binds_list)
        if level > 0 and isinstance(out, ResultBatch):
            info = {"level": level, "probe_budget": budget}
            base_fn = out._explain_fn
            out = ResultBatch(out.data,
                              lambda: dataclasses.replace(base_fn(),
                                                          degraded=info),
                              len(out))
        return out

    def _slice(self, out, i: int):
        if hasattr(out, "query"):
            return out.query(i)
        return super()._slice(out, i)

    def warm(self, sample_binds: dict, batch_sizes: list[int]) -> None:
        """Also run the probe-budgeted executions degraded drains run (a
        load transition must not pay a first call on the hot path)."""
        super().warm(sample_binds, batch_sizes)
        if self.load.policy.steps and self.compiled.batch_native:
            budget = self.load.policy.steps[-1][1]
            ex = self.compiled.executor
            with self.on_device():
                for b in sorted({ex.bucket_for(s) for s in batch_sizes}):
                    stacked = self.compiled._stack_binds([sample_binds] * b,
                                                         {})
                    ex(stacked, probe_budget=budget)
            self.synchronize()

    def snapshot(self) -> dict:
        """Scheduler counters + load-controller state (+ fault counters)."""
        with self._lock:
            snap = {**self.counters, "load": self.load.snapshot()}
        if self.faults is not None:
            snap["faults"] = self.faults.snapshot()
        return snap


def latency_stats(records: list[SimRecord]) -> dict:
    """p50/p95/mean latency (ms) + throughput (QPS) of a simulation run."""
    lats = np.asarray([r.latency for r in records]) * 1e3
    span = max(r.finish for r in records) - min(r.arrival for r in records)
    return {"p50_ms": round(float(np.percentile(lats, 50)), 3),
            "p95_ms": round(float(np.percentile(lats, 95)), 3),
            "mean_ms": round(float(lats.mean()), 3),
            "qps": round(len(records) / span, 1) if span > 0 else float("inf")}
