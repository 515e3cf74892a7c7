"""Quantized corpus twins for the bandwidth-bound scan path.

A :class:`QuantizedCorpus` is a derived, device-resident twin of a vector
column: the same (N, D) rows stored as int8 (per-row symmetric scale) or
bf16, plus the per-row metadata the quantized kernels and the range-query
slack bounds need.  Twins are built at first prepare and registered on the
:class:`~repro_torch.core.schema.Catalog`, so prepared plans re-bind a
re-registered twin in place (``CompiledQuery.ensure_fresh``).

Per-row contract (``x`` the fp32 row, ``x̂`` its dequantization):

* **int8**: ``s = max_j |x_j| / 127`` (``s = 1`` for an all-zero row),
  ``q_j = round(x_j / s)`` ∈ [−127, 127] (half to even), ``x̂_j = s · q_j``,
  and the componentwise error obeys ``|x_j − x̂_j| ≤ s / 2 = half_step``.
* **bf16**: ``q_j = bf16(x_j)`` (round to nearest even, 8 significand bits:
  unit roundoff 2⁻⁸), ``scales ≡ 1`` so one contract serves both modes
  (``1.0 · x`` is a bitwise identity), and
  ``|x_j − x̂_j| ≤ 2⁻⁸ · max_j |x_j| = half_step``.

Every step rounds as the reference's ``jnp`` version does (fp32 division,
half-to-even rounding, bf16 round to nearest even), so ``qvecs``,
``scales`` and ``half_step`` equal the reference's bit for bit;
``row_l1``/``row_l2`` are sums (norms of the *dequantized* rows, which the
kernels score) and agree to rounding.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

MODES = ("int8", "bf16")


@dataclasses.dataclass(frozen=True)
class QuantizedCorpus:
    """Device-resident quantized twin of one vector column."""
    mode: str                 # "int8" | "bf16"
    qvecs: torch.Tensor       # (N, D) int8 | bfloat16
    scales: torch.Tensor      # (N, 1) fp32 dequant scales (ones for bf16)
    half_step: torch.Tensor   # (N,) fp32 componentwise |x − x̂| bound
    row_l1: torch.Tensor      # (N,) fp32 ‖x̂‖₁
    row_l2: torch.Tensor      # (N,) fp32 ‖x̂‖₂

    def plan_arrays(self, prefix: str = "") -> Dict[str, Any]:
        """The tensor bundle prepared plans bind (``ensure_fresh`` re-binds
        the same keys)."""
        return {prefix + "qvecs": self.qvecs,
                prefix + "qscales": self.scales,
                prefix + "qhalf": self.half_step,
                prefix + "ql1": self.row_l1,
                prefix + "ql2": self.row_l2}


def quantize_corpus(vecs, mode: str) -> QuantizedCorpus:
    """Build the quantized twin of an fp32 (N, D) corpus, on its device (a
    numpy array lands on the CPU)."""
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}; "
                         f"expected one of {MODES}")
    vecs = torch.as_tensor(vecs, dtype=torch.float32)
    if vecs.ndim != 2:
        raise ValueError(f"expected (N, D) corpus, got {tuple(vecs.shape)}")
    amax = vecs.abs().amax(dim=1)                               # (N,)
    if mode == "int8":
        scale = torch.where(amax > 0, amax / 127.0, 1.0)        # (N,)
        q = torch.clamp(torch.round(vecs / scale[:, None]), -127, 127)
        q = q.to(torch.int8)
        deq = q.to(torch.float32) * scale[:, None]
        half = torch.where(amax > 0, scale * 0.5, 0.0)
    else:
        q = vecs.to(torch.bfloat16)
        scale = torch.ones_like(amax)
        deq = q.to(torch.float32)
        half = amax * (2.0 ** -8)
    row_l1 = deq.abs().sum(dim=1)
    row_l2 = torch.sqrt((deq * deq).sum(dim=1))
    return QuantizedCorpus(mode=mode, qvecs=q.contiguous(),
                           scales=scale[:, None].contiguous(),
                           half_step=half, row_l1=row_l1, row_l2=row_l2)
