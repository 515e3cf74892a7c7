"""The one traffic generator: turns a mix file of ``chasebench/traffic/``
into the requests of a run.

A mix file (JSON) gives the statement (``sql``, its ``static`` binds), the
request shape (``request``: ``"list"`` of ``list_size`` bind dicts, or
``"single"`` dicts), the pool of seeded queries (``pool``), how each bind
is made (``binds``), the relational filter the statement applies
(``filter``, for the reference and the work count), the answer's kind
(``answer``) and how many of the window's queries the check compares
(``check_queries``).

Bind kinds:

* ``"query"``: the request's query vector, a row of the pool (host fp32,
  as a client hands it over);
* ``{"quantile": {"column": c, "q": s}}``: the value under which a share
  ``s`` of column ``c`` lies (the selectivity calibration of §7.1);
* ``{"kth_sim_median": {"k": k, "queries": m}}``: the median, over the
  first ``m`` queries of the run's order, of the ``k``-th best similarity
  over every row (the radius of §7.1, "about ``k`` matches").

Requests are the pool in a seeded order, cut into lists, and cycled: every
seed gives the same sizes in another order.
"""
from __future__ import annotations

import math
import operator

import numpy as np
import torch

from . import laion

STREAM = 2      # the traffic's draw stream (see systems/ for the others)
OPS = {"<": operator.lt, "<=": operator.le, ">": operator.gt,
       ">=": operator.ge, "==": operator.eq, "!=": operator.ne}


def filter_mask(conjuncts: list, columns: dict, binds: dict) -> torch.Tensor:
    """(N,) bool: the rows that pass every ``[column, op, bind]``."""
    mask = None
    for column, op, bind in conjuncts:
        value = torch.tensor(binds[bind], dtype=columns[column].dtype,
                             device=columns[column].device)
        part = OPS[op](columns[column], value)
        mask = part if mask is None else mask & part
    return mask


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full fp32, TF32 off whatever the process set."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


class Traffic:
    """The requests of one run: ``request(i)`` gives the i-th request's
    binds (a dict, or a list of dicts) and the pool rows it asks about."""

    def __init__(self, mix: dict, config: dict, data, seed: int):
        self.mix = mix
        device = data.corpus.device
        gen = laion.generator(device, seed, STREAM)
        self.pool = laion.mixture(gen, data.modes, mix["pool"],
                                  config["data"]["query_spread"])
        self.pool_host = self.pool.cpu().numpy()
        self.single = mix["request"] == "single"
        self.per_request = 1 if self.single else mix["list_size"]
        order = np.random.default_rng([int(seed), STREAM]).permutation(
            mix["pool"])
        self.sets = order[:len(order) // self.per_request
                          * self.per_request].reshape(-1, self.per_request)
        self.scalars = {}
        for name, spec in mix["binds"].items():
            if spec != "query":
                self.scalars[name] = self._scalar(spec, data)
        self.query_bind = next(n for n, s in mix["binds"].items()
                               if s == "query")
        self.static = dict(mix.get("static", {}))
        self.passing = filter_mask(mix["filter"], data.columns, self.scalars)
        self.n_passing = int(self.passing.sum())
        self._requests = [self._binds(rows) for rows in self.sets]

    def _scalar(self, spec: dict, data) -> np.float32:
        (kind, args), = spec.items()
        if kind == "quantile":
            column = data.columns[args["column"]].double()
            return np.float32(torch.quantile(column, args["q"]).item())
        if kind == "kth_sim_median":
            first = self.sets.reshape(-1)[:args["queries"]]
            qs = self.pool[torch.as_tensor(first, device=self.pool.device)]
            sims = exact_matmul(qs, data.corpus.T)
            kth = torch.topk(sims, args["k"], dim=1).values[:, -1]
            return np.float32(np.median(kth.cpu().numpy()))
        raise ValueError(f"unknown bind kind {kind!r}")

    def _binds(self, rows: np.ndarray):
        dicts = [{self.query_bind: self.pool_host[r], **self.scalars}
                 for r in rows]
        return dicts[0] if self.single else dicts

    def request(self, i: int):
        """(binds, pool rows) of the i-th request, cycling the order."""
        j = i % len(self._requests)
        return self._requests[j], self.sets[j]

    def check_requests(self) -> int:
        """How many of the window's requests the check compares."""
        return max(1, math.ceil(self.mix["check_queries"] / self.per_request))
