"""The plain reference of a store that scans an int8 twin of its vectors
and rescores in fp32, and the comparison that decides ``correct``.

The deployment keeps each row's int8 twin beside its fp32 original, scans
the twin, and rescores the best c·K rows by twin key in fp32 (c the
oversampling, the engine's ``rescore_factor``): Qdrant's scalar
quantization with ``rescore`` and ``oversampling``, FAISS's ``SQ8,RFlat``
with ``k_factor``.  Its guarantee, as the configuration states it: a top-k
answer's similarities are the exact fp32 ones, and every row of the exact
top-K that lies among the c·K best by twin key is returned; a range
answer is exact.

Plain PyTorch.  It imports nothing of the program and takes nothing the
program made: the twin is built here by the configuration's rule
(:func:`quantize`), from the benchmark's corpus, and every similarity is
one fp32 matrix product with TF32 off.  The structural checks,
``sim_err``, ``recall`` and ``range_gap`` are ``hybrid_exact``'s (its
exact rules, so a top-k's valid entries must be min(K, rows that pass),
and its ``rank_gap`` is left out: the rows below the exact K-th best that
a rescore may return are this guarantee's, see ``cover_miss``);
a top-k adds

* ``order_gap``: how far a valid entry's exact similarity lies above the
  valid entry before it, the worst over the queries: the answer's order,
  which ``recall`` and ``cover_miss``, counted over sets, do not read;
* ``cover_miss``: the rows of the exact top-K whose twin similarity beats
  the reference's (c·K)-th best twin similarity among the rows that pass
  by more than ``COVER_MARGIN``, and that the answer left out, summed over
  the queries.  A row counts only where its exact similarity beats the
  best row outside the exact top-K by more than twice the ``sim_err``
  limit, so that a tie within the rounding that limit allows is not read
  as a miss.  ``COVER_MARGIN`` is about a hundred times the fp32
  reordering error of a 512-term product of unit rows, so a row it covers
  is among the program's c·K best by its own twin keys too; the
  program's candidates (whole 8-row segments around those rows) are a
  superset.

``Control`` is this reference put in the program's place at TF32: the
twin's c·K best rows, then their exact top-K, each product from inputs
rounded to TF32; a range answer as ``hybrid_exact``'s control gives it.
"""
from __future__ import annotations

import numpy as np
import torch

from chasebench.generator import exact_matmul, filter_mask
from chasebench.references import hybrid_exact

BLOCK = hybrid_exact.BLOCK
CHUNK = 262_144         # rows quantized per step: bounds the temporaries
COVER_MARGIN = 1e-4
OVERSAMPLING = 2        # the control's c: the configuration's rescore_factor
NEG = float("-inf")

limits = hybrid_exact.limits


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q (N, D) int8, s (N,) fp32) of fp32 rows ``x``, by the
    configuration's rule: s = max|x| / 127 (1 for a row of zeros),
    q = x / s rounded half to even, held to [-127, 127]."""
    amax = x.abs().amax(dim=1)
    s = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(x / s[:, None]), -127, 127)
    return q.to(torch.int8), s


def twin(corpus: torch.Tensor) -> torch.Tensor:
    """x^ = s·q of every row of ``corpus``, (N, D) fp32."""
    out = torch.empty_like(corpus)
    for start in range(0, corpus.shape[0], CHUNK):
        q, s = quantize(corpus[start:start + CHUNK])
        out[start:start + CHUNK] = q.to(torch.float32) * s[:, None]
    return out


def _order_gap(got: dict, sims: torch.Tensor, passing: torch.Tensor) -> float:
    """The largest rise of exact similarity from a valid entry to the
    next (0 for an answer in descending order)."""
    n = sims.shape[1]
    ids = got["ids"].long()
    safe = ids.clamp(0, n - 1)
    ok = got["valid"].bool() & (ids >= 0) & (ids < n) & passing[safe]
    ref = sims.gather(1, safe)
    rise = torch.where(ok[:, 1:] & ok[:, :-1],
                       (ref[:, 1:] - ref[:, :-1]).clamp(min=0), 0.0)
    return float(rise.max()) if rise.numel() else 0.0


def _cover_miss(got: dict, sims: torch.Tensor, twin_sims: torch.Tensor,
                passing: torch.Tensor, factor: int, tie: float) -> int:
    """The block's exact top-K rows that the twin's (factor·K) best cover
    with room and that the answer left out (see the module's text)."""
    ids = got["ids"].long()
    valid = got["valid"].bool()
    k = ids.shape[1]
    n = sims.shape[1]
    off = ~passing[None, :]
    top = torch.topk(sims.masked_fill(off, NEG), min(k + 1, n), dim=1)
    members, member_sims = top.indices[:, :k], top.values[:, :k]
    outside = (top.values[:, k:k + 1] if n > k
               else member_sims.new_full((ids.shape[0], 1), NEG))
    sure = torch.isfinite(member_sims) & (member_sims > outside + 2 * tie)
    twin_sims = twin_sims.masked_fill(off, NEG)
    bar = torch.topk(twin_sims, min(factor * k, n), dim=1).values[:, -1:]
    covered = twin_sims.gather(1, members) > bar + COVER_MARGIN
    returned = ((members[:, :, None] == ids[:, None, :])
                & valid[:, None, :]).any(2)
    return int((sure & covered & ~returned).sum())


def judge(samples: list, traffic, data, config: dict) -> dict:
    """The numbers of ``samples``, a list of (pool rows, answer) taken
    from the window, against the reference: ``bad_rows`` and
    ``cover_miss`` summed over the queries, ``sim_err``, ``order_gap`` and
    ``range_gap`` the worst, ``recall`` the mean."""
    mix = traffic.mix
    kind = mix["answer"]["kind"]
    spec = {}
    if kind == "range":
        spec["radius"] = float(traffic.scalars[mix["answer"]["radius"]])
    rows = np.concatenate([np.asarray(r) for r, _ in samples])
    answers = [hybrid_exact._stack(a, traffic.single) for _, a in samples]
    got_all = {k: torch.cat([a[k] for a in answers])
               for k in answers[0] if k in ("ids", "sim", "valid", "count")}
    totals = {"bad_rows": 0, "sim_err": 0.0}
    recalls = []
    if kind == "topk":
        twin_t = twin(data.corpus).T
        factor = int(config["engine"]["rescore_factor"])
        tie = float(config["limits"]["sim_err"])
        totals["cover_miss"] = 0
    for start in range(0, len(rows), BLOCK):
        block = torch.as_tensor(rows[start:start + BLOCK],
                                device=traffic.pool.device)
        qs = traffic.pool[block]
        sims = exact_matmul(qs, data.corpus.T)
        got = {k: v[start:start + BLOCK] for k, v in got_all.items()}
        nums = hybrid_exact._block_numbers(kind, True, got, sims,
                                           traffic.passing, spec)
        if kind == "topk":
            nums.pop("rank_gap")
            nums["order_gap"] = _order_gap(got, sims, traffic.passing)
            recalls += nums.pop("recall")
            totals["cover_miss"] += _cover_miss(
                got, sims, exact_matmul(qs, twin_t), traffic.passing,
                factor, tie)
        totals["bad_rows"] += nums.pop("bad_rows")
        for name, value in nums.items():
            totals[name] = max(totals.get(name, 0.0), value)
        del sims
    if kind == "topk":
        totals["recall"] = float(np.mean(recalls))
    totals["queries"] = len(rows)
    return totals


class Control(hybrid_exact.Control):
    """The reference in the program's place: ``execute`` answers a request
    in the program's answer layout from products at ``precision``
    (``"tf32"``, the control, or ``"fp32"``, the reference itself), a
    top-k through the twin's ``factor``·K best rows."""

    def __init__(self, traffic, data, precision: str = "tf32",
                 factor: int = OVERSAMPLING):
        super().__init__(traffic, data, precision)
        self.factor = factor
        self.twin_t = self.round(twin(data.corpus)).T

    def execute(self, binds):
        t = self.traffic
        mix = t.mix
        if mix["answer"]["kind"] != "topk":
            return super().execute(binds)
        dicts = [binds] if t.single else binds
        qs = self.round(torch.as_tensor(
            np.stack([b[t.query_bind] for b in dicts]),
            device=self.corpus_t.device))
        off = ~filter_mask(mix["filter"], self.columns, dicts[0])[None, :]
        k = t.static[mix["answer"]["k"]]
        n = self.corpus_t.shape[1]
        twin_sims = exact_matmul(qs, self.twin_t).masked_fill(off, NEG)
        cand = torch.topk(twin_sims, min(self.factor * k, n), dim=1).indices
        cand = torch.sort(cand, dim=1).values
        sims = exact_matmul(qs, self.corpus_t).masked_fill(off, NEG)
        top = torch.topk(sims.gather(1, cand), min(k, cand.shape[1]),
                         dim=1)
        out = {"ids": cand.gather(1, top.indices).int(), "sim": top.values,
               "valid": torch.isfinite(top.values)}
        if t.single:
            out = {key: v[0] for key, v in out.items()}
        return out
