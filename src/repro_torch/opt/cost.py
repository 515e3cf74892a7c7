"""The lane cost model of the adaptive optimizer (the port of
``src/repro/opt/cost.py``).

Costs are in **flat-scan row units**: scanning one fp32 corpus row through
the fused flat kernel costs 1.0, and every other lane is scored relative
to that.  The formulas, the policy constants (``rescore_factor``,
``headroom``) and :meth:`CostModel.from_bench`'s file names and reading
rules are the reference's.  The speed constants are not: the reference's
come from its ``BENCH_*.json`` files, which hold TPU and CPU figures, and
on the card they point the wrong way (there a quantized scan is slower
than the fp32 one, and a probed IVF row costs hundreds to thousands of
streamed flat rows, not two).  So the defaults below are the card's own, and
``CostModel()`` / ``CostModel.from_bench()`` with no ``root`` read no
file.  ``describe()["sources"]`` says where the constants came from.
Everything here is float arithmetic: deterministic by construction.
"""
from __future__ import annotations

import json
import math
import os

# Measured by ``python3 chip_smoke.py`` (phase ``adaptive``, line
# ``e2e_adaptive``, ``measured_constants``) on an NVIDIA H100 80GB HBM3 at
# a 700.00 W power limit: fp32 / int8 and fp32 / bf16 Q1 execute latency
# at a list of 64 (K = 50, selectivity 0.3, 1,000,000 x 512), and the
# per-row time of lock-step chase Q1 (a list of 100 at the serve mix,
# distance evals per query counted) over the flat scan's per-row time.
CARD_DEFAULTS = {
    "int8_speedup": 0.843,    # quantized b64 QPS / fp32 b64 QPS
    "bf16_speedup": 0.872,
    "ivf_gather_penalty": 1689.0,  # per-row cost of probed rows vs flat rows
}
CARD_SOURCE = ("card defaults: chip_smoke.py adaptive phase, NVIDIA H100 "
               "80GB HBM3, 700.00 W")

DEFAULTS = {
    **CARD_DEFAULTS,
    "rescore_factor": 3,      # candidate multiple c of the fused rescore
    "headroom": 1.25,         # predicted budget = EMA high quantile x this
}


def _read_json(root: str, name: str) -> dict | None:
    try:
        with open(os.path.join(root, name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class CostModel:
    """Score the compiled lanes of a plan and predict probe budgets.

    * :meth:`score` — relative cost of the flat / quantized / IVF lowerings
      for a corpus size and selectivity estimate (advisory: execute-time
      picks stay within bit-identical effort lanes);
    * :meth:`probe_budget` — the pilot budget of phase 1 of effort-bucketed
      execution from an observed probe statistic: high-quantile EMA ×
      ``headroom``, +1, clipped to the plan's probe ceiling."""

    def __init__(self, *, int8_speedup: float | None = None,
                 bf16_speedup: float | None = None,
                 rescore_factor: int | None = None,
                 ivf_gather_penalty: float | None = None,
                 headroom: float | None = None,
                 sources: tuple = (CARD_SOURCE,)):
        d = DEFAULTS
        self.int8_speedup = float(int8_speedup or d["int8_speedup"])
        self.bf16_speedup = float(bf16_speedup or d["bf16_speedup"])
        self.rescore_factor = int(rescore_factor or d["rescore_factor"])
        self.ivf_gather_penalty = float(
            ivf_gather_penalty or d["ivf_gather_penalty"])
        self.headroom = float(headroom or d["headroom"])
        self.sources = tuple(sources)

    @classmethod
    def from_bench(cls, root: str | None = None) -> "CostModel":
        """Calibrate from the ``BENCH_*.json`` files under ``root``, read as
        the reference reads them (absent files fall back to the defaults).
        With no ``root`` nothing is read: the card's defaults."""
        if root is None:
            return cls()
        sources = []
        kw: dict = {}
        quant = _read_json(root, "BENCH_quant.json")
        if quant:
            sp = quant.get("speedup_b64") or {}
            if sp.get("int8"):
                kw["int8_speedup"] = sp["int8"]
            if sp.get("bf16"):
                kw["bf16_speedup"] = sp["bf16"]
            if quant.get("rescore_factor"):
                kw["rescore_factor"] = quant["rescore_factor"]
            sources.append("BENCH_quant.json")
        batch = _read_json(root, "BENCH_batch.json")
        if batch:
            pen = _gather_penalty(batch)
            if pen is not None:
                kw["ivf_gather_penalty"] = pen
            sources.append("BENCH_batch.json")
        sched = _read_json(root, "BENCH_sched.json")
        if sched and (sched.get("effort") or {}).get("speedup"):
            sources.append("BENCH_sched.json")
        return cls(sources=tuple(sources), **kw)

    def describe(self) -> dict:
        """The constants and where they came from (JSON-able)."""
        return {"int8_speedup": self.int8_speedup,
                "bf16_speedup": self.bf16_speedup,
                "rescore_factor": self.rescore_factor,
                "ivf_gather_penalty": round(self.ivf_gather_penalty, 3),
                "headroom": self.headroom,
                "sources": list(self.sources)}

    # -- lane scoring --------------------------------------------------------

    def expected_probes(self, selectivity: float, *, min_probes: int,
                        max_probes: int) -> int:
        """Cold-start probe estimate from a selectivity estimate alone:
        every halving of selectivity costs ~2 extra probe rounds."""
        s = min(max(float(selectivity), 1e-9), 1.0)
        est = min_probes + 2.0 * (-math.log2(s))
        return int(min(max(est, min_probes), max_probes))

    def score(self, *, n_rows: int, k: int = 10, selectivity: float = 1.0,
              cluster_rows: float | None = None,
              expected_probes: float | None = None,
              quant_modes: tuple = (), min_probes: int = 4,
              max_probes: int = 64) -> dict:
        """Relative lane costs (flat-scan row units) for one plan shape.
        ``cluster_rows`` is the mean IVF list size (None: no index, no IVF
        lane); ``expected_probes`` comes from the stats EMA when known."""
        scores = {"flat": float(n_rows)}
        for mode in quant_modes:
            speed = (self.int8_speedup if mode == "int8"
                     else self.bf16_speedup)
            rescore = float(self.rescore_factor * k)
            scores[f"quant:{mode}"] = n_rows / speed + rescore
        if cluster_rows is not None and cluster_rows > 0:
            probes = expected_probes
            if probes is None:
                probes = self.expected_probes(
                    selectivity, min_probes=min_probes,
                    max_probes=max_probes)
            scores["ivf"] = (float(probes) * float(cluster_rows)
                             * self.ivf_gather_penalty)
        return scores

    def choose(self, scores: dict) -> str:
        """The cheapest scored lane (ties break lexicographically)."""
        return min(sorted(scores), key=lambda lane: scores[lane])

    # -- probe-budget prediction ---------------------------------------------

    def probe_budget(self, probes_hi: float, *, floor: int,
                     ceiling: int) -> int:
        """Pilot budget from an observed high-quantile probe EMA."""
        want = int(math.ceil(float(probes_hi) * self.headroom)) + 1
        return int(min(max(want, floor), ceiling))


def _gather_penalty(batch: dict) -> float | None:
    """Per-row ms of probed IVF rows over per-row ms of flat rows, from the
    largest-batch rows of a ``BENCH_batch.json`` (None without counters)."""
    def per_row_ms(rows):
        best = None
        for r in rows or ():
            evals = r.get("distance_evals_per_query") or 0
            if evals and r.get("ms") and r.get("batch"):
                best = (r["ms"] / r["batch"]) / evals
        return best

    w = batch.get("workloads") or {}
    flat, ivf = per_row_ms(w.get("flat")), per_row_ms(w.get("ivf"))
    if not flat or not ivf:
        return None
    return max(1.0, ivf / flat)
