"""Relational schema with first-class vector columns (PyTorch port).

A :class:`Table` is a columnar batch of torch tensors that all live on one
device, with a typed :class:`Schema`; vector columns carry their
dimensionality and metric.  Tables are fixed-capacity: row selection is a
validity mask, never a physical shrink.

The :class:`Catalog` keeps the reference's versioned registration clock so
compiled plans can detect a re-registered table or re-bind a re-registered
IVF index, quantized twin or sharded handle, and a live corpus's
mutations through its ``("live", table, column)`` key.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Mapping

import torch


class ColumnKind(enum.Enum):
    """Column type tags for the relational schema."""
    INT = "int"
    FLOAT = "float"
    BOOL = "bool"
    CATEGORY = "category"  # small-int category codes (dictionary-encoded)
    VECTOR = "vector"      # dense embedding


class Metric(enum.Enum):
    """Vector distance/similarity metric of a vector column."""
    L2 = "l2"
    INNER_PRODUCT = "ip"
    COSINE = "cosine"

    def is_similarity(self) -> bool:
        """True when larger values mean *more* similar (IP / cosine)."""
        return self in (Metric.INNER_PRODUCT, Metric.COSINE)


_DEFAULT_DTYPES = {
    ColumnKind.INT: torch.int32,
    ColumnKind.FLOAT: torch.float32,
    ColumnKind.BOOL: torch.bool,
    ColumnKind.CATEGORY: torch.int32,
    ColumnKind.VECTOR: torch.float32,
}


@dataclasses.dataclass(frozen=True)
class ColumnType:
    """Typed column declaration (kind, dtype, and vector/category extras)."""
    kind: ColumnKind
    dtype: Any = None          # torch dtype; defaulted per kind
    dim: int | None = None     # vector dimensionality
    num_categories: int | None = None  # category cardinality (when known)
    metric: Metric = Metric.INNER_PRODUCT

    def __post_init__(self):
        if self.dtype is None:
            object.__setattr__(self, "dtype", _DEFAULT_DTYPES[self.kind])
        if self.kind == ColumnKind.VECTOR and not self.dim:
            raise ValueError("vector columns require dim")


def int_col(dtype=torch.int32) -> ColumnType:
    """Integer column declaration."""
    return ColumnType(ColumnKind.INT, dtype)


def float_col(dtype=torch.float32) -> ColumnType:
    """Float column declaration."""
    return ColumnType(ColumnKind.FLOAT, dtype)


def bool_col() -> ColumnType:
    """Boolean column declaration."""
    return ColumnType(ColumnKind.BOOL)


def category_col(num_categories: int | None = None) -> ColumnType:
    """Dictionary-encoded category column declaration."""
    return ColumnType(ColumnKind.CATEGORY, num_categories=num_categories)


def vector_col(dim: int, metric: Metric = Metric.INNER_PRODUCT,
               dtype=torch.float32) -> ColumnType:
    """Dense vector column declaration (first-class: carries dim + metric)."""
    return ColumnType(ColumnKind.VECTOR, dtype, dim=dim, metric=metric)


@dataclasses.dataclass(frozen=True)
class Schema:
    """Ordered column-name -> ColumnType mapping for one table."""
    columns: Mapping[str, ColumnType]
    primary_key: str | None = None

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __getitem__(self, name: str) -> ColumnType:
        return self.columns[name]

    def vector_columns(self) -> list[str]:
        """Names of the schema's vector columns."""
        return [n for n, t in self.columns.items() if t.kind == ColumnKind.VECTOR]

    def names(self) -> list[str]:
        """All column names, in declaration order."""
        return list(self.columns.keys())


class Table:
    """Columnar fixed-capacity table: dict of equally-sized tensors on one
    device.

    ``valid`` marks live rows (static-shape selection)."""

    def __init__(self, schema: Schema, columns: Mapping[str, torch.Tensor],
                 valid: torch.Tensor | None = None, name: str = "t"):
        self.schema = schema
        self.columns = dict(columns)
        self.name = name
        sizes = {v.shape[0] for v in self.columns.values()}
        if len(sizes) != 1:
            raise ValueError(f"ragged columns: {sizes}")
        (self.num_rows,) = sizes
        devices = {v.device for v in self.columns.values()}
        if len(devices) != 1:
            raise ValueError(f"columns on several devices: {devices}")
        (self.device,) = devices
        for cname, ctype in schema.columns.items():
            if cname not in self.columns:
                raise ValueError(f"missing column {cname}")
            if ctype.kind == ColumnKind.VECTOR:
                arr = self.columns[cname]
                if arr.ndim != 2 or arr.shape[1] != ctype.dim:
                    raise ValueError(
                        f"vector column {cname}: expected (N,{ctype.dim}), got {tuple(arr.shape)}")
        if valid is None:
            valid = torch.ones((self.num_rows,), dtype=torch.bool,
                               device=self.device)
        self.valid = valid

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def with_column(self, name: str, ctype: ColumnType,
                    values: torch.Tensor) -> "Table":
        """A new Table with one extra (or replaced) column."""
        cols = dict(self.columns)
        cols[name] = values
        schema = Schema({**dict(self.schema.columns), name: ctype},
                        self.schema.primary_key)
        return Table(schema, cols, self.valid, self.name)

    def with_valid(self, valid: torch.Tensor) -> "Table":
        """A new Table sharing columns but with a replaced validity mask."""
        return Table(self.schema, self.columns, valid, self.name)

    def take(self, idx: torch.Tensor,
             valid: torch.Tensor | None = None) -> "Table":
        """Gather rows by index on the table's device (output size = idx
        size); a row stays valid where it was valid and ``valid`` (when
        given) holds."""
        idx = torch.as_tensor(idx, device=self.device)
        cols = {n: v[idx] for n, v in self.columns.items()}
        base_valid = self.valid[idx]
        if valid is not None:
            base_valid = base_valid & torch.as_tensor(valid,
                                                      device=self.device)
        return Table(self.schema, cols, base_valid, self.name)

    def to_numpy(self) -> dict:
        """Host-side copy of all columns plus the ``__valid`` mask."""
        out = {n: v.detach().cpu().numpy() for n, v in self.columns.items()}
        out["__valid"] = self.valid.detach().cpu().numpy()
        return out


class Catalog:
    """Name -> Table registry with the reference's versioned registration
    clock.

    Every registration bumps a monotonic catalog clock and stamps the
    touched key (``("table", name)``, ``("index", table, column)``,
    ``("sharded", table, column)``, ``("quantized", table, column)`` or
    ``("live", table, column)``);
    compiled plans snapshot the versions of the keys they captured and
    compare at execute time (``CompiledQuery.ensure_fresh``), so a
    re-registered table raises ``StalePlanError`` instead of serving frozen
    data, and a re-registered index or twin, or a live corpus's mutation,
    re-binds in place."""

    def __init__(self):
        self._tables: dict[str, Table] = {}
        self._indexes: dict[tuple, Any] = {}
        self._sharded: dict[tuple, Any] = {}
        self._quantized: dict[tuple, Any] = {}
        self._live: dict[tuple, Any] = {}
        self._clock = 0
        self._versions: dict[tuple, int] = {}

    def _bump(self, key: tuple) -> None:
        self._clock += 1
        self._versions[key] = self._clock

    def version(self, key: tuple) -> int:
        """Monotonic version of one registration key (0 if never
        registered).  One global clock: equal snapshots mean nothing
        changed."""
        return self._versions.get(key, 0)

    def version_snapshot(self, keys: tuple) -> tuple:
        """Versions of ``keys`` as a tuple."""
        return tuple(self.version(k) for k in keys)

    def register(self, name: str, table: Table) -> None:
        """Register (or replace) a table under ``name``; bumps
        ``("table", name)`` and drops the old table's quantized twins and
        sharded handles (their fp32 source changed; the reference keeps the
        sharded handles, which a re-prepared plan would then read)."""
        table.name = name
        self._tables[name] = table
        for reg in (self._quantized, self._sharded):
            for key in [k for k in reg if k[0] == name]:
                del reg[key]
        self._bump(("table", name))

    def table(self, name: str) -> Table:
        """Look up a registered table (KeyError when absent)."""
        return self._tables[name]

    def has_table(self, name: str) -> bool:
        """True iff ``name`` is a registered table."""
        return name in self._tables

    def register_index(self, table: str, column: str, index: Any) -> None:
        """Attach (or replace) an ANN index (an
        :class:`~repro_torch.index.ivf.IVFIndex`) on a (table, vector
        column) pair.  Bumps ``("index", table, column)``: compiled plans
        carry the index in their bound ``arrays`` dict and re-bind a
        replacement on their next execute."""
        self._indexes[(table, column)] = index
        self._bump(("index", table, column))

    def index_for(self, table: str, column: str):
        """The ANN index registered for (table, column), or None."""
        return self._indexes.get((table, column))

    def register_quantized(self, table: str, column: str, quant: Any,
                           key: Any = None) -> None:
        """Attach a :class:`~repro_torch.data.quantized.QuantizedCorpus` twin
        to a (table, vector column) pair, keyed by ``key`` (default
        ``quant.mode``, so int8 and bf16 twins coexist; a sharded plan's
        per-shard twin is keyed ``(mode, spec)``).  Bumps
        ``("quantized", table, column)``: quant plans carry the twin's
        tensors in their bound ``arrays`` dict and re-bind a re-registered
        twin in place."""
        self._quantized[(table, column, key or quant.mode)] = quant
        self._bump(("quantized", table, column))

    def quantized_for(self, table: str, column: str, key: Any):
        """The twin registered for (table, column) under ``key`` (a mode
        string, or ``(mode, spec)`` for a sharded twin), or None."""
        return self._quantized.get((table, column, key))

    def register_live(self, table: str, column: str, live: Any) -> None:
        """Attach a :class:`~repro_torch.data.mutations.LiveCorpus` to a
        (table, vector column) pair.

        Bumps BOTH ``("live", table, column)`` and ``("table", table)``:
        attaching changes the corpus layout (fixed-capacity padded segments
        replace the frozen column), so plans compiled before the attach
        raise ``StalePlanError`` and re-prepare.  Later inserts, deletes
        and compactions bump only the live key: live plans carry every
        segment tensor from their first compile and re-bind in place."""
        self._live[(table, column)] = live
        self._bump(("live", table, column))
        self._bump(("table", table))

    def bump_live(self, table: str, column: str) -> int:
        """Advance ``("live", table, column)`` (a mutation or compaction
        landed) and return the new clock value: the WAL's LSN source, so
        log sequence numbers ride the clock that drives plan re-binding."""
        self._bump(("live", table, column))
        return self._versions[("live", table, column)]

    def live_for(self, table: str, column: str):
        """The LiveCorpus attached to (table, column), or None."""
        return self._live.get((table, column))

    def live_columns(self, table: str) -> list[str]:
        """Vector columns of ``table`` with a live corpus attached."""
        return [c for (t, c) in self._live if t == table]

    def advance_clock(self, to: int) -> None:
        """Fast-forward the clock to at least ``to``: recovery replays LSNs
        minted by an earlier process's clock, and the bumps after it must
        stay past them."""
        self._clock = max(self._clock, int(to))

    def register_sharded(self, table: str, column: str, sharded: Any) -> None:
        """Attach a :class:`~repro_torch.dist.sharding.ShardedCorpus` handle
        to a (table, vector column) pair, keyed by the handle's own mesh
        spec (``sharded.spec``), so handles for different meshes coexist:
        every plan compiled with a matching ``EngineOptions.dist`` reuses
        the handle's placement instead of re-slicing the corpus per
        prepare.  Bumps ``("sharded", table, column)`` (spec-independent:
        any handle change re-binds every dist plan on the pair)."""
        self._sharded[(table, column, sharded.spec)] = sharded
        self._bump(("sharded", table, column))

    def sharded_for(self, table: str, column: str, spec: Any):
        """The ShardedCorpus registered for (table, column) on exactly the
        mesh ``spec`` (a ``DistSpec``) describes, or None."""
        return self._sharded.get((table, column, spec))

    def tables(self) -> list[str]:
        """Names of all registered tables."""
        return list(self._tables)
