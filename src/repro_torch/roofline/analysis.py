"""Roofline terms from a counted run (the port of
``src/repro/roofline/analysis.py``).

  compute term    = Σ over product classes of FLOPs / (chips × that
                    class's peak)
  memory term     = bytes / (chips × HBM bytes/s)
  collective term = collective bytes per device / link bytes/s

With bf16 FLOPs alone the compute term is the reference's formula.  The
reference's ``collective_bytes_from_hlo`` parses XLA's HLO text; the port
has no HLO, and its collective functions record their bytes into the
counter instead (``op_counter.collective``)."""
from __future__ import annotations

import dataclasses

from .hw import H100_SXM, HWSpec
from .op_counter import Work


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_total: float
    hlo_bytes_total: float
    collective_bytes_per_device: float
    model_flops: float

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    @property
    def step_time_lower_bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        if self.hlo_flops_total <= 0:
            return 0.0
        return self.model_flops / self.hlo_flops_total

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-based MFU bound at the roofline step time."""
        if self.step_time_lower_bound_s <= 0:
            return 0.0
        return self.compute_s * self.useful_flops_fraction \
            / self.step_time_lower_bound_s


def roofline_terms(cost: dict, collective: dict[str, float], chips: int,
                   model_flops: float, hw: HWSpec = H100_SXM) -> RooflineTerms:
    """``cost`` holds one device's ``"flops"`` and ``"bytes accessed"``, and
    optionally ``"flops_by_dtype"`` (``{"bf16", "fp32", "fp64"}``, summing
    to ``"flops"``); without it every FLOP counts at the bf16 peak."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    by_dtype = cost.get("flops_by_dtype") or {"bf16": flops}
    compute = sum(float(f) / hw.peak_flops(dt) for dt, f in by_dtype.items())
    coll_dev = float(sum(collective.values()))
    return RooflineTerms(
        compute_s=compute,
        memory_s=byts / hw.hbm_bw,
        collective_s=coll_dev / hw.link_bw,
        hlo_flops_total=flops * chips,
        hlo_bytes_total=byts * chips,
        collective_bytes_per_device=coll_dev,
        model_flops=model_flops,
    )


def bound_ms(work: Work, hw: HWSpec = H100_SXM) -> tuple[float, str]:
    """The least time (ms) one card takes for a kernel's ``work`` (its
    operations at the fp32 peak, its bytes at the HBM rate), and which of
    the two bounds it: ``"bytes"`` or ``"operations"``."""
    t_bytes = work.nbytes / hw.hbm_bw * 1e3
    t_ops = work.ops / hw.peak_flops_fp32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"
