"""Session API of the port — the one front door to the engine.

    from repro_torch.api import connect

    db = connect(catalog, engine="brute", use_pallas=True)
    stmt = db.prepare(sql, K=10)               # cached across textual variants
    res = stmt.execute({"qv": q, "p": 12.0})   # single -> Result
    batch = stmt.execute([b1, b2, b3])         # list -> bucketed ResultBatch
    server = db.serve(stmt)                    # submit/poll scheduler
    db.attach_live("products", "embedding", path)   # a mutable corpus
    db.insert("products", ids, vectors)        # seen at the next execute
    db = connect(catalog, aot_cache_path=dir)  # on-disk plan cache

Results hold torch tensors on the catalog's device.
"""
from ..core.aot import AOTCacheWarning
from .database import CacheInfo, Database, Statement, connect
from .hints import ExecutionHints
from .result import ExplainReport, Result, ResultBatch

__all__ = ["connect", "Database", "Statement", "CacheInfo", "ExecutionHints",
           "ExplainReport", "Result", "ResultBatch", "AOTCacheWarning"]
