"""The feedback loop: runtime stats -> execute-time effort decisions (the
port of ``src/repro/opt/advisor.py``).

:class:`LoweringAdvisor` watches every executed batch's counters (through
:class:`~repro_torch.opt.stats.StatsStore`) and decides, at execute time,
how the next batch of the same plan shape spends its probe effort:

* **Decisions never change results.**  The advisor chooses only among
  bit-identical lanes: lock-step bucketed execution, or two-phase effort
  bucketing with a predicted pilot budget (whose phase 2 re-runs every
  query that hit its budget; ``serving/scheduler.run_effort_bucketed``).
  Picking another lowering (flat, IVF, quantized) changes what is
  compiled, so that surface is advisory only: :meth:`score_plan` ranks the
  lanes with the :class:`~repro_torch.opt.cost.CostModel`, and
  ``db.advise(sql)`` and ``explain()`` report it.
* **No new executors on the hot path.**  Predicted budgets ride the
  runtime ``probe_budget`` argument of the bucket executors (a scalar for
  single-table batches, an (Q, L) int32 array for joins), so an execution
  with another prediction builds nothing (``trace_counts`` stay put).

Decision ladder per batch: a join plan with a warmed per-left profile gets
per-left budgets; otherwise a warmed (plan, selectivity bucket) aggregate
predicts a scalar pilot; otherwise the batch runs lock-step and only
observes.  Plans with no probe lane (flat and sharded scans) always run
lock-step.  ``ExecutionHints`` always win: the Statement consults the
advisor only when the caller set no execution knob.

On the card the sketches sample the column where it lives: the same
``linspace`` rows as the reference, gathered on the device, so only those
at most ``sample_rows`` values cross to the host (once per table version).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.compiler import _scan_of, fingerprint_digest, plan_fingerprint
from ..core.physical import probe_ceiling
from ..core.rewriter import selectivity_atoms
from .cost import CostModel
from .stats import StatsStore, bucket_of


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@dataclasses.dataclass(frozen=True)
class OptDecision:
    """One advised execution: the chosen path and the evidence behind it.

    ``pilot`` is the runtime probe budget the decision carries: None
    (lock-step), a scalar int, or a per-left (Q, L) int32 array.
    ``source``: ``cold`` (no stats yet), ``stats`` (bucket EMA),
    ``profile`` (per-left join profile) or ``flat`` (no probe lane)."""
    path: str                        # "lockstep" | "effort"
    source: str                      # "cold" | "stats" | "profile" | "flat"
    digest: str
    bucket: int | None = None
    selectivity: float | None = None
    pilot: object = None             # None | int | np.ndarray
    scores: dict | None = None

    def summary(self) -> dict:
        """JSON-able form for ``explain()``'s ``-- opt:`` line."""
        out = {"path": self.path, "source": self.source,
               "plan": self.digest[:12]}
        if self.bucket is not None:
            out["bucket"] = int(self.bucket)
        if self.selectivity is not None:
            out["sel"] = round(float(self.selectivity), 4)
        if self.pilot is not None:
            if np.ndim(self.pilot) == 0:
                out["pilot"] = int(self.pilot)
            else:
                arr = np.asarray(self.pilot)
                out["pilot"] = {"min": int(arr.min()), "max": int(arr.max()),
                                "shape": list(arr.shape)}
        if self.scores:
            out["scores"] = {k: round(float(v), 1)
                             for k, v in sorted(self.scores.items())}
        return out


def host_counters(out: dict) -> dict | None:
    """An execution's probe and distance-eval counters on the host, in ONE
    device-to-host copy (which waits for the execution that made them);
    None when the output carries no probe counters."""
    stats = out.get("stats") if isinstance(out, dict) else None
    if stats is None or "probes" not in stats:
        return None
    both = _host(torch.stack([stats["probes"].to(torch.int32),
                              stats["distance_evals"].to(torch.int32)]))
    return {"probes": both[0], "distance_evals": both[1]}


class LoweringAdvisor:
    """Stats-driven execute-time effort advisor over one catalog.

    Deterministic: decisions are pure functions of the stats store, the
    catalog version clock and the bind values, so two advisors fed the
    same observation sequence advise identically."""

    def __init__(self, catalog, stats: StatsStore | None = None,
                 cost: CostModel | None = None, *,
                 stats_path: str | None = None, sample_rows: int = 4096,
                 enabled: bool = True):
        self.catalog = catalog
        self.stats_path = stats_path
        if stats is None:
            if stats_path and os.path.exists(stats_path):
                stats = StatsStore.load(stats_path)
            else:
                stats = StatsStore()
        self.stats = stats
        self.cost = cost or CostModel.from_bench()
        self.sample_rows = int(sample_rows)
        self.enabled = enabled
        self._digests: dict[int, str] = {}       # id(compiled) -> digest
        self._sketches: dict = {}   # (table, col) -> (version, sorted sample)

    # -- plan identity -------------------------------------------------------

    def plan_key(self, compiled) -> str:
        """Stats key: normalized-plan fingerprint digest + options digest
        (one plan under two lowerings keeps two stat histories)."""
        digest = self._digests.get(id(compiled))
        if digest is None:
            fp, _ = plan_fingerprint(compiled.logical_plan)
            digest = (f"{fingerprint_digest(fp)}:"
                      f"{fingerprint_digest(compiled.options.fingerprint())}")
            self._digests[id(compiled)] = digest
        return digest

    def version_token(self, compiled) -> tuple:
        """Catalog version snapshot over the plan's dependency keys — the
        invalidation stamp every stats entry carries."""
        cat = getattr(compiled, "_catalog", None)
        keys = getattr(compiled, "_dep_keys", None)
        if cat is None or keys is None:
            return ()
        return cat.version_snapshot(keys)

    # -- selectivity estimation ----------------------------------------------

    def _sketch(self, table: str, column: str) -> np.ndarray | None:
        try:
            tab = self.catalog.table(table)
        except KeyError:
            return None
        ver = self.catalog.version(("table", table))
        cached = self._sketches.get((table, column))
        if cached is not None and cached[0] == ver:
            return cached[1]
        try:
            col = tab[column]
        except (KeyError, TypeError):
            return None
        if col.ndim != 1 or col.dtype == torch.bfloat16 or col.is_complex():
            return None
        n = col.shape[0]
        if n > self.sample_rows:
            take = np.linspace(0, n - 1, self.sample_rows).astype(np.int64)
            col = col[torch.from_numpy(take).to(col.device)]
        sample = np.sort(_host(col).astype(np.float64))
        self._sketches[(table, column)] = (ver, sample)
        return sample

    def selectivity(self, compiled, binds: dict) -> float:
        """Estimated structured-filter selectivity of this batch: product of
        per-atom sketch estimates (conjunct independence), median across the
        batch when thresholds are per-query.  1.0 when there is nothing to
        estimate — the loosest bucket."""
        atoms = selectivity_atoms(compiled.analysis)
        if not atoms:
            return 1.0
        default_table = _scan_of(compiled.analysis)[0]
        sel = np.asarray(1.0)
        for atom in atoms:
            sample = self._sketch(atom["table"] or default_table,
                                  atom["column"])
            if sample is None or sample.size == 0:
                continue
            if atom["param"] is not None:
                value = binds.get(atom["param"])
                if value is None:
                    continue
            else:
                value = atom["value"]
            try:
                v = _host(value).astype(np.float64)
            except (TypeError, ValueError):
                continue
            right = np.searchsorted(sample, v, side="right") / sample.size
            op = atom["op"]
            if op in ("<", "<="):
                frac = right
            elif op in (">", ">="):
                frac = 1.0 - right
            else:
                left = np.searchsorted(sample, v, side="left") / sample.size
                frac = right - left
                if op in ("<>", "!="):
                    frac = 1.0 - frac
            sel = sel * np.clip(frac, 1e-9, 1.0)
        return float(np.median(sel))

    # -- the decision --------------------------------------------------------

    def advise_batch(self, compiled, binds: dict) -> OptDecision:
        """Decide how one stacked batch should spend its probe effort."""
        digest = self.plan_key(compiled)
        token = self.version_token(compiled)
        sel = self.selectivity(compiled, binds)
        bucket = bucket_of(sel)
        scores = self.score_plan(compiled, selectivity=sel,
                                 version=token).get("scores")
        ceiling = probe_ceiling(compiled.options)
        base = dict(digest=digest, bucket=bucket, selectivity=sel,
                    scores=scores)
        if ceiling <= 0:
            return OptDecision("lockstep", "flat", **base)
        floor = int(compiled.options.probe.min_probes) + 1
        profile = self.stats.left_profile(digest, token)
        if profile is not None and profile.max() > 0:
            qn = _stacked_qn_safe(binds)
            budgets = np.asarray(
                [self.cost.probe_budget(p, floor=floor, ceiling=ceiling)
                 for p in profile], np.int32)
            pilot = np.broadcast_to(budgets, (qn, budgets.shape[0])).copy()
            return OptDecision("effort", "profile", pilot=pilot, **base)
        entry = self.stats.lookup(digest, bucket, token)
        if entry is not None and entry["count"] > 0:
            if entry["probes_hi"] <= 0:
                # measured: this plan never probes (flat fallback) — budgets
                # would be inert, two phases pure overhead
                return OptDecision("lockstep", "stats", **base)
            pilot = self.cost.probe_budget(entry["probes_hi"], floor=floor,
                                           ceiling=ceiling)
            if pilot >= ceiling:
                return OptDecision("lockstep", "stats", **base)
            return OptDecision("effort", "stats", pilot=int(pilot), **base)
        return OptDecision("lockstep", "cold", **base)

    def observe(self, compiled, decision: OptDecision, out: dict,
                latency_ms: float = 0.0) -> None:
        """Fold one executed batch's counters into the stats store (the
        merged, phase-complete counters: they equal lock-step's).  ``out``
        is an execution's output, or the host counters of
        :func:`host_counters`."""
        counters = host_counters(out) if "stats" in out else out
        if counters is None or "probes" not in counters:
            return
        token = self.version_token(compiled)
        probes = counters["probes"]
        if probes.ndim == 2:
            self.stats.observe_left(decision.digest, token, probes)
        per_query = probes
        if per_query.ndim > 1:
            per_query = per_query.max(axis=tuple(range(1, per_query.ndim)))
        rows = counters["distance_evals"]
        self.stats.observe(
            decision.digest, decision.bucket or 0, token,
            selectivity=decision.selectivity or 1.0, probes=per_query,
            rows=float(np.mean(rows)), latency_ms=float(latency_ms))

    # -- prepare-time lowering scores ----------------------------------------

    def score_plan(self, compiled, selectivity: float = 1.0,
                   version: tuple | None = None) -> dict:
        """Cost-model lane scores for a compiled plan (advisory: feeds
        ``db.advise`` and the ``-- opt:`` explain line)."""
        a = compiled.analysis
        table, column = _scan_of(a)
        tab = self.catalog.table(table)
        n_rows = int(tab.num_rows)
        idx = self.catalog.index_for(table, column)
        cluster_rows = None
        if idx is not None:
            nlist = int(idx.centroids.shape[0])
            cluster_rows = n_rows / max(nlist, 1)
        quant_modes = tuple(
            mode for mode in ("int8", "bf16")
            if self.catalog.quantized_for(table, column, mode) is not None)
        k = a.k if isinstance(a.k, int) else 10
        probe = compiled.options.probe
        token = (version if version is not None
                 else self.version_token(compiled))
        entry = self.stats.lookup(self.plan_key(compiled),
                                  bucket_of(selectivity), token)
        expected = (entry["probes_mean"]
                    if entry and entry["probes_mean"] > 0 else None)
        scores = self.cost.score(
            n_rows=n_rows, k=k, selectivity=selectivity,
            cluster_rows=cluster_rows, expected_probes=expected,
            quant_modes=quant_modes, min_probes=int(probe.min_probes),
            max_probes=int(probe.max_probes))
        return {"scores": scores, "recommended": self.cost.choose(scores),
                "n_rows": n_rows, "selectivity": round(selectivity, 4),
                "cost_model": self.cost.describe()}

    def save(self, path: str | None = None) -> None:
        """Persist the stats store (to ``stats_path`` unless overridden)."""
        target = path or self.stats_path
        if target:
            self.stats.save(target)


def _stacked_qn_safe(binds: dict) -> int:
    """Leading Q of a stacked bind dict; 1 when every bind is scalar."""
    for v in binds.values():
        if hasattr(v, "ndim") and v.ndim >= 1:
            return int(v.shape[0])
    return 1
