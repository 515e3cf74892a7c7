"""CHASE core of the port: schema and catalog, expressions, the SQL front
end, semantic analysis, rewriting, physical lowering and compilation, in
PyTorch, with the Volcano interpreter (``interpreter.py``) and the on-disk
plan cache (``aot.py``).  New code goes through the session API
(:mod:`repro_torch.api`)."""
from .compiler import (BucketedExecutor, CompiledPlan, CompiledQuery,
                       StalePlanError, compile_plan, compile_query,
                       plan_fingerprint)
from .expr import Bindings, Column, Const, Distance, Param
from .physical import EngineOptions, ProbeConfig
from .schema import (Catalog, ColumnKind, ColumnType, Metric, Schema, Table,
                     bool_col, category_col, float_col, int_col, vector_col)
from .semantics import Analysis, QueryClass, analyze
from .sql import parse_sql
from .rewriter import rewrite

__all__ = [
    "BucketedExecutor", "CompiledPlan", "CompiledQuery", "StalePlanError",
    "compile_plan", "compile_query", "plan_fingerprint", "Bindings", "Column",
    "Const", "Distance", "Param", "EngineOptions", "ProbeConfig", "Catalog",
    "ColumnKind", "ColumnType", "Metric", "Schema", "Table", "bool_col",
    "category_col", "float_col", "int_col", "vector_col", "Analysis",
    "QueryClass", "analyze", "parse_sql", "rewrite",
]
