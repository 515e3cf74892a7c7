"""The least time a request's work can take on the card, counted by the
benchmark from the cell's shapes and its own count of rows that pass the
filter, whatever implements the request.

* FLOPs: 2 x live queries x passing rows x D (the similarities the answer
  needs);
* bytes: the passing rows' vectors once, the filter's columns once, and
  the least output (ids and similarities of a top-k, the counts of a
  range; a lower bound);
* the bound: the larger of FLOPs over the fp32 peak outside the tensor
  cores (no TF32) and bytes over the HBM rate.

Padded lanes and rows that fail the filter are not counted: a kernel need
not read them.
"""
from __future__ import annotations

# NVIDIA's H100 SXM data sheet, dense, at the full 700 W
PEAKS = {"H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}}


def peaks(device_kind: str) -> dict | None:
    """The peaks of a card by ``torch.cuda.get_device_name()``, or None
    for a card the table does not hold."""
    for key, value in PEAKS.items():
        if key in device_kind:
            return value
    return None


def request_bound_s(traffic, data, device_kind: str) -> float | None:
    """Seconds of the least time one request of ``traffic`` takes."""
    peak = peaks(device_kind)
    if peak is None:
        return None
    mix = traffic.mix
    q = traffic.per_request
    dim = data.corpus.shape[1]
    n_rows = data.corpus.shape[0]
    passing = traffic.n_passing
    flops = 2.0 * q * passing * dim
    columns = {c for c, _, _ in mix["filter"]}
    nbytes = passing * dim * data.corpus.element_size() + sum(
        n_rows * data.columns[c].element_size() for c in columns)
    if mix["answer"]["kind"] == "topk":
        nbytes += q * traffic.static[mix["answer"]["k"]] * 8
    else:
        nbytes += q * 4
    return max(flops / peak["fp32_flops"], nbytes / peak["hbm_bytes_per_s"])
