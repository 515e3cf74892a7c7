"""Roofline tooling of the port: the H100 parts' peaks (``hw``), an eager
operation counter in place of the reference's HLO analyzer
(``op_counter``; its ``report`` is the per-op breakdown), the roofline
terms (``analysis``) and the dry-run report tables (``report``)."""
from .analysis import RooflineTerms, bound_ms, roofline_terms
from .hw import H100_NVL, H100_PCIE, H100_SXM, HWSpec, spec_for
from .op_counter import Lowered, OpCost, Work, analyze, lower

__all__ = ["RooflineTerms", "bound_ms", "roofline_terms", "H100_NVL",
           "H100_PCIE", "H100_SXM", "HWSpec", "spec_for", "Lowered",
           "OpCost", "Work", "analyze", "lower"]
