"""The LAION hybrid-query deployment: the benchmark's data as the port's
``laion`` table, an optional IVF index, and a session of the port.

``make_data`` draws the inputs (the benchmark's, handed to program and
reference alike); ``Program`` is the system under test, built only through
the port's public API: the schema helpers, ``Table``, ``Catalog.register``,
``kmeans`` / ``build_ivf`` / ``Catalog.register_index`` and ``connect``.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from chasebench import laion

DATA_STREAM, INDEX_STREAM, STRUCTURE_STREAM = 0, 1, 3


@dataclasses.dataclass
class Data:
    corpus: torch.Tensor        # (N, D) fp32 unit rows
    columns: dict               # scalar columns, (N,) each
    modes: torch.Tensor         # (modes, D) the mixture's centres
    metric: str


def make_data(config: dict, seed: int, device: torch.device) -> Data:
    """The run's corpus: the modes and each row's mode from the
    configuration's ``structure_seed``, so that every run's k-means finds
    the same clusters and its IVF lists the same sizes (the work of a probe
    follows the largest list); the rows' noise and the columns from
    ``seed``."""
    d = config["data"]
    structure = laion.generator(device, d["structure_seed"],
                                STRUCTURE_STREAM)
    modes = laion.unit_modes(structure, d["modes"], d["dim"])
    which = torch.randint(d["modes"], (d["rows"],), generator=structure,
                          device=device)
    gen = laion.generator(device, seed, DATA_STREAM)
    corpus = laion.mixture(gen, modes, d["rows"], d["row_spread"], which)
    columns = laion.columns(gen, d["rows"], d["categories"])
    return Data(corpus, columns, modes, d["metric"])


def build_seconds() -> float:
    """Seconds this process spent compiling the port's kernels, from the
    port's own log of ``nvcc`` runs: a checkout's first run builds them,
    later runs load them from the checkout's ``build/kernels/``."""
    from repro_torch.kernels import build
    return sum(b["seconds"] for b in build.BUILDS)


class Program:
    """The port over ``data``: ``db`` is the session the window drives;
    ``setup`` holds the seconds of each set-up stage."""

    def __init__(self, config: dict, data: Data, seed: int):
        from repro_torch.api import connect
        from repro_torch.core.schema import (Catalog, Metric, Schema, Table,
                                             category_col, float_col,
                                             int_col, vector_col)
        d = config["data"]
        metric = Metric(d["metric"])
        cats = d["categories"]
        schema = Schema({
            "sample_id": int_col(), "height": int_col(), "width": int_col(),
            "nsfw": category_col(3), "similarity": float_col(),
            "price": float_col(), "capture_date": int_col(),
            "calorie_level": category_col(cats),
            "cuisine": category_col(cats), "rating": category_col(5),
            "release_year": int_col(),
            "vec": vector_col(d["dim"], metric),
            "embedding": vector_col(d["dim"], metric),
        }, primary_key="sample_id")
        table = Table(schema, {**data.columns, "vec": data.corpus,
                               "embedding": data.corpus})
        self.catalog = Catalog()
        for name in config["tables"]:
            self.catalog.register(name, table)
        self.setup = {}
        spec = config.get("index")
        if spec is not None:
            self._build_ivf(spec, data, metric, d["structure_seed"])
        options = dict(config["engine"])
        if "probe" in options:
            from repro_torch.index import ProbeConfig
            options["probe"] = ProbeConfig(**options["probe"])
        self.db = connect(self.catalog, **options)

    def _build_ivf(self, spec: dict, data: Data, metric,
                   structure_seed: int) -> None:
        from repro_torch.index import build_ivf, kmeans
        if spec["kind"] != "ivf":
            raise ValueError(f"unknown index kind {spec['kind']!r}")
        t0 = time.perf_counter()
        # k-means draws from the structure's seed too: the same rows start
        # the same clusters in every run
        gen = laion.generator(data.corpus.device, structure_seed,
                              INDEX_STREAM)
        centroids = kmeans(gen, data.corpus, spec["nlist"],
                           iters=spec["kmeans_iters"])
        index = build_ivf(None, data.corpus, spec["nlist"], metric,
                          centroids=centroids)
        for name in spec["tables"]:
            self.catalog.register_index(name, "embedding", index)
        if data.corpus.is_cuda:
            torch.cuda.synchronize()
        self.setup["index_s"] = time.perf_counter() - t0
        self.setup["index_cap"] = index.cap
