"""Synthetic LAION-shaped corpus (paper §7.1, Table 2), on a torch device.

The same numpy draws in the same order as the reference package, so one seed
gives the same tables; only the placement differs (every column is a tensor
on ``device``).  ``vec`` and ``embedding`` share one tensor.

Tables:
  laion(sample_id, height, width, nsfw:category{0,1,2}, similarity, price,
        capture_date, calorie_level, cuisine, rating, release_year, vec,
        embedding)
  queries(id, preferred_rating, preferred_release_year, cuisine,
          capture_date, embedding, vec)
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.schema import (Catalog, ColumnKind, ColumnType, Metric, Schema,
                           Table, category_col, float_col, int_col,
                           vector_col)

# the reference's table aliases: the Q1-Q6 templates name one corpus table
# under five names and one query table under two
CORPUS_ALIASES = ("laion", "products", "images", "recipes", "movies")
QUERY_ALIASES = ("queries", "users")


def _make_modes(rng: np.random.Generator, n_modes: int,
                dim: int) -> np.ndarray:
    modes = rng.standard_normal((n_modes, dim)).astype(np.float32)
    modes /= np.linalg.norm(modes, axis=1, keepdims=True)
    return modes


def _mixture_vectors(rng: np.random.Generator, n: int, dim: int,
                     modes: np.ndarray, spread: float = 0.35) -> np.ndarray:
    """Gaussian mixture on the unit sphere around shared ``modes``;
    ``spread`` is the noise norm relative to the unit mode vector."""
    which = rng.integers(0, modes.shape[0], size=n)
    sigma = spread / np.sqrt(dim)
    x = modes[which] + sigma * rng.standard_normal((n, dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def selectivity_threshold(column, selectivity: float) -> float:
    """Quantile calibration (§7.1): value v s.t. P(col < v) ≈ selectivity."""
    if isinstance(column, torch.Tensor):
        column = column.cpu().numpy()
    return float(np.quantile(column, selectivity))


def make_laion_catalog(n_rows: int = 100_000, n_queries: int = 100,
                       dim: int = 128, n_modes: int = 64,
                       num_categories: int = 8, seed: int = 0,
                       metric: Metric = Metric.INNER_PRODUCT,
                       query_spread: float = 0.15,
                       device: str | torch.device = "cuda") -> Catalog:
    """Synthetic LAION-shaped catalog placed on ``device`` (the card unless
    the caller asks for the CPU), registered under the table aliases the
    Q1–Q6 SQL expects."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    modes = _make_modes(rng, n_modes, dim)
    vec = _mixture_vectors(rng, n_rows, dim, modes)
    qvec = _mixture_vectors(rng, n_queries, dim, modes, spread=query_spread)

    corpus = {
        "sample_id": np.arange(n_rows, dtype=np.int32),
        "height": rng.integers(64, 2048, size=n_rows).astype(np.int32),
        "width": rng.integers(64, 2048, size=n_rows).astype(np.int32),
        "nsfw": rng.choice(3, size=n_rows,
                           p=[0.9, 0.07, 0.03]).astype(np.int32),
        "similarity": rng.beta(2.0, 4.0, size=n_rows).astype(np.float32),
        "price": rng.lognormal(3.5, 1.0, size=n_rows).astype(np.float32),
        "capture_date": rng.integers(0, 3650, size=n_rows).astype(np.int32),
        "calorie_level": rng.integers(0, num_categories,
                                      size=n_rows).astype(np.int32),
        "cuisine": rng.integers(0, num_categories,
                                size=n_rows).astype(np.int32),
        "rating": rng.integers(0, 5, size=n_rows).astype(np.int32),
        "release_year": rng.integers(1980, 2026,
                                     size=n_rows).astype(np.int32),
        "vec": vec,
    }
    queries = {
        "id": np.arange(n_queries, dtype=np.int32),
        "preferred_rating": rng.integers(0, 5,
                                         size=n_queries).astype(np.int32),
        "preferred_release_year": rng.integers(
            1990, 2020, size=n_queries).astype(np.int32),
        "cuisine": rng.integers(0, num_categories,
                                size=n_queries).astype(np.int32),
        "capture_date": rng.integers(0, 3650,
                                     size=n_queries).astype(np.int32),
        "vec": qvec,
    }
    laion_schema = Schema({
        "sample_id": int_col(),
        "height": int_col(), "width": int_col(),
        "nsfw": category_col(3),
        "similarity": float_col(),
        "price": float_col(),
        "capture_date": int_col(),
        "calorie_level": category_col(num_categories),
        "cuisine": category_col(num_categories),
        "rating": category_col(5),
        "release_year": int_col(),
        "vec": vector_col(dim, metric),
        "embedding": vector_col(dim, metric),
    }, primary_key="sample_id")
    queries_schema = Schema({
        "id": int_col(),
        "preferred_rating": category_col(5),
        "preferred_release_year": int_col(),
        "cuisine": category_col(num_categories),
        "capture_date": int_col(),
        "embedding": vector_col(dim, metric),
        "vec": vector_col(dim, metric),
    }, primary_key="id")
    return _catalog(laion_schema, corpus, queries_schema, queries, device)


def _catalog(laion_schema: Schema, corpus: dict, queries_schema: Schema,
             queries: dict, device: torch.device) -> Catalog:
    def table(schema: Schema, cols: dict) -> Table:
        tensors = {n: torch.tensor(v, device=device) for n, v in cols.items()}
        tensors["embedding"] = tensors["vec"]
        return Table(schema, tensors)

    laion = table(laion_schema, corpus)
    qtab = table(queries_schema, queries)
    cat = Catalog()
    for name in CORPUS_ALIASES:
        cat.register(name, laion)
    for name in QUERY_ALIASES:
        cat.register(name, qtab)
    return cat


def _schema_from_numpy(columns: dict, kinds: dict, primary_key) -> Schema:
    out = {}
    for name, spec in kinds.items():
        kind, dim, metric = (spec + (None, None))[:3]
        kind = ColumnKind(kind)
        if kind == ColumnKind.VECTOR:
            out[name] = vector_col(dim or columns[name].shape[1],
                                   Metric(metric or "ip"))
        else:
            out[name] = ColumnType(kind)
    return Schema(out, primary_key)


def catalog_from_numpy(tables: dict, aliases: dict,
                       device: str | torch.device = "cuda") -> Catalog:
    """Build the port's Catalog from another catalog's tables given as
    numpy arrays.

    ``tables`` maps a table name to ``{"columns": {name: ndarray},
    "kinds": {name: (kind, dim, metric)}, "primary_key": name}``, where
    ``kind`` is a :class:`ColumnKind` value (``"int"``, ``"vector"``, ...),
    and ``dim``/``metric`` (a :class:`Metric` value) are given for vector
    columns.  ``aliases`` maps each registered name to the table it
    aliases (one table object per source table, as the reference shares
    it).  Tensors land on ``device``; 64-bit columns are narrowed to 32
    bits, as the reference holds them."""
    device = torch.device(device)
    built = {}
    for name, spec in tables.items():
        cols = spec["columns"]
        schema = _schema_from_numpy(cols, spec["kinds"],
                                    spec.get("primary_key"))
        tensors = {}
        for cname, arr in cols.items():
            arr = np.ascontiguousarray(arr)
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            elif arr.dtype == np.int64:
                arr = arr.astype(np.int32)
            tensors[cname] = torch.tensor(arr, device=device)
        built[name] = Table(schema, tensors)
    cat = Catalog()
    for alias, source in aliases.items():
        cat.register(alias, built[source])
    return cat
