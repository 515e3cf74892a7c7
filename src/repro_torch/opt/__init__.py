"""The adaptive optimizer of the port (the port of ``src/repro/opt/``):

* :class:`~repro_torch.opt.stats.StatsStore` — per-(plan, selectivity
  bucket) EMA aggregates and per-left join probe profiles, invalidated by
  the catalog version clock, persisted as the reference's JSON;
* :class:`~repro_torch.opt.cost.CostModel` — lane costs with the card's
  own constants; predicts pilot probe budgets;
* :class:`~repro_torch.opt.advisor.LoweringAdvisor` — the execute-time
  decision maker behind ``connect(cat, adaptive=True)`` and
  ``serving.scheduler.run_effort_bucketed(advisor=...)``: it chooses only
  among bit-identical lanes, ``ExecutionHints`` always win, and it reports
  itself on the ``-- opt:`` explain line.
"""
from .advisor import LoweringAdvisor, OptDecision
from .cost import CostModel
from .stats import StatsStore, bucket_of

__all__ = ["LoweringAdvisor", "OptDecision", "CostModel", "StatsStore",
           "bucket_of"]
