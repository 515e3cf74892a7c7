"""The plain reference of the hybrid queries, and the comparison that
decides ``correct``.

Plain PyTorch: inner-product similarities of the queries against every row
as one fp32 matrix product with TF32 off, the mix's filter on the columns,
then the exact answer (a top-k by similarity, or every row at or above the
radius).  It imports nothing of the program and takes nothing the program
made: it gets the benchmark's corpus, columns and binds.

``judge`` reads the program's answers only to judge them, per query:

* ``bad_rows``: structural faults, which must be 0: an id out of range, a
  returned row that fails the filter, an id returned twice, a ``count``
  that disagrees with the valid entries, more matches than the answer's
  buffer holds, and, for an exact top-k, fewer (or more) valid entries
  than min(K, rows that pass);
* ``sim_err``: the largest gap between a returned similarity and the
  reference's similarity of the same row;
* ``rank_gap`` (exact top-k): how far below the reference's K-th best the
  worst returned row lies, or how far a later entry lies above an earlier
  one;
* ``range_gap`` (exact range): how far on the wrong side of the radius a
  returned row, or a row left out, lies;
* ``recall`` (approximate top-k): returned rows at or above the reference's
  K-th best, over min(K, rows that pass), averaged over the queries.

``Control`` is this reference put in the program's place at the nearest
precision below fp32 without TF32: TF32, its inputs rounded to ten
mantissa bits (round to nearest, ties away, as the tensor cores convert)
and its products accumulated in fp32.
"""
from __future__ import annotations

import numpy as np
import torch

from chasebench.generator import exact_matmul, filter_mask

BLOCK = 128     # queries a reference block holds: a (128, N) fp32 matrix


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits), kept as fp32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _stack(answer, single: bool) -> dict:
    data = {k: v for k, v in answer.items() if isinstance(v, torch.Tensor)}
    if single:
        data = {k: v.unsqueeze(0) for k, v in data.items()}
    return data


def _duplicates(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B,) ids that a row returns more than once among its valid
    entries."""
    n = ids.shape[1]
    fill = -1 - torch.arange(n, device=ids.device, dtype=ids.dtype)
    s = torch.sort(torch.where(valid, ids, fill), dim=1).values
    return (s[:, 1:] == s[:, :-1]).sum(1)


def _block_numbers(kind: str, exact: bool, got: dict, sims: torch.Tensor,
                   passing: torch.Tensor, spec: dict) -> dict:
    n_rows = sims.shape[1]
    ids = got["ids"].long()
    valid = got["valid"].bool()
    in_range = (ids >= 0) & (ids < n_rows)
    safe = ids.clamp(0, n_rows - 1)
    ref = sims.gather(1, safe)
    passes = passing[safe] & in_range
    bad = (valid & ~passes).sum(1) + _duplicates(ids, valid)
    ok = valid & passes
    out = {"sim_err": float(torch.where(
        ok, (got["sim"].float() - ref).abs(), 0.0).max())}
    n_pass = passing.sum()
    if kind == "topk":
        k = ids.shape[1]
        masked = sims.masked_fill(~passing[None, :], float("-inf"))
        kth = torch.topk(masked, k, dim=1).values[:, -1:]
        want = torch.clamp(n_pass, max=k)
        above = (ok & (ref >= kth)).sum(1)
        out["recall"] = (above.double() / want.double()).tolist()
        if exact:
            bad += (valid.sum(1) - want).abs()
            below = torch.where(ok, (kth - ref).clamp(min=0), 0.0)
            both = ok[:, 1:] & ok[:, :-1]
            order = torch.where(both, (ref[:, 1:] - ref[:, :-1]).clamp(min=0),
                                0.0)
            out["rank_gap"] = float(torch.maximum(below.max(), order.max()))
    else:
        radius = spec["radius"]
        truth = passing[None, :] & (sims >= radius)
        bad += (got["count"].long() != valid.sum(1)).long()
        bad += (truth.sum(1) > ids.shape[1]).long()
        # entries that are not ok land in a spare last column
        returned = torch.zeros((truth.shape[0], n_rows + 1), dtype=torch.bool,
                               device=truth.device)
        returned.scatter_(1, torch.where(ok, safe, n_rows), True)
        missing = truth & ~returned[:, :n_rows]
        wrong_in = torch.where(ok, (radius - ref).clamp(min=0), 0.0)
        left_out = torch.where(missing, sims - radius, 0.0)
        out["range_gap"] = float(torch.maximum(wrong_in.max(),
                                               left_out.max()))
    out["bad_rows"] = int(bad.sum())
    return out


def judge(samples: list, traffic, data, config: dict) -> dict:
    """The numbers of ``samples``, a list of (pool rows, answer) taken
    from the window, against the reference; each of them as the worst over
    the queries, and ``recall`` as their mean."""
    mix = traffic.mix
    kind = mix["answer"]["kind"]
    exact = config["guarantee"]["answers"] == "exact"
    spec = {}
    if kind == "range":
        spec["radius"] = float(traffic.scalars[mix["answer"]["radius"]])
    rows = np.concatenate([np.asarray(r) for r, _ in samples])
    answers = [_stack(a, traffic.single) for _, a in samples]
    got_all = {k: torch.cat([a[k] for a in answers])
               for k in answers[0] if k in ("ids", "sim", "valid", "count")}
    totals = {"bad_rows": 0, "sim_err": 0.0}
    recalls = []
    for start in range(0, len(rows), BLOCK):
        block = torch.as_tensor(rows[start:start + BLOCK],
                                device=traffic.pool.device)
        sims = exact_matmul(traffic.pool[block], data.corpus.T)
        got = {k: v[start:start + BLOCK] for k, v in got_all.items()}
        nums = _block_numbers(kind, exact, got, sims, traffic.passing, spec)
        recalls += nums.pop("recall", [])
        totals["bad_rows"] += nums.pop("bad_rows")
        for name, value in nums.items():
            totals[name] = max(totals.get(name, 0.0), value)
        del sims
    if kind == "topk" and not exact:
        totals["recall"] = float(np.mean(recalls))
    totals["queries"] = len(rows)
    return totals


def limits(config: dict, numbers: dict) -> dict:
    """{number: (limit, passes)} for each number this guarantee holds."""
    out = {"bad_rows": (0, numbers["bad_rows"] == 0)}
    for name, limit in config["limits"].items():
        if name in numbers:
            out[name] = (limit, numbers[name] <= limit)
    recall = config["guarantee"].get("recall_at_k")
    if recall is not None and "recall" in numbers:
        out["recall"] = (recall, numbers["recall"] >= recall)
    return out


class Control:
    """The reference in the program's place: ``execute`` answers a request
    in the program's answer layout, from products at ``precision``
    (``"tf32"``, the control, or ``"fp32"``, the reference itself)."""

    def __init__(self, traffic, data, precision: str = "tf32"):
        self.traffic = traffic
        self.round = tf32 if precision == "tf32" else (lambda x: x)
        self.corpus_t = self.round(data.corpus).T
        self.columns = data.columns

    def execute(self, binds):
        t = self.traffic
        mix = t.mix
        dicts = [binds] if t.single else binds
        qs = torch.as_tensor(np.stack([b[t.query_bind] for b in dicts]),
                             device=self.corpus_t.device)
        sims = exact_matmul(self.round(qs), self.corpus_t)
        passing = filter_mask(mix["filter"], self.columns, dicts[0])
        sims = sims.masked_fill(~passing[None, :], float("-inf"))
        if mix["answer"]["kind"] == "topk":
            k = t.static[mix["answer"]["k"]]
            top = torch.topk(sims, k, dim=1)
            out = {"ids": top.indices.int(), "sim": top.values,
                   "valid": torch.isfinite(top.values)}
        else:
            radius = float(dicts[0][mix["answer"]["radius"]])
            top = torch.topk(sims, min(mix["answer"]["capacity"],
                                       sims.shape[1]), dim=1)
            valid = top.values >= radius
            out = {"ids": top.indices.int(), "sim": top.values,
                   "valid": valid, "count": valid.sum(1).int()}
        if t.single:
            out = {k: v[0] for k, v in out.items()}
        return out
