"""CHASE-backed retrieval tier for serving (the port of
``src/repro/serving/rag.py``): the paper's VKNN-SF as a feature of the LM
stack.

The paper motivates VKNN-SF with RAG (§2.2): retrieve the top-k documents
by embedding similarity subject to structured filters (freshness, safety).
:class:`HybridRetriever` wraps a prepared CHASE statement over a document
corpus; ``retrieve_for_decode`` plugs into the serving loop: retrieve once
at prefill, prepend the retrieved docs' embeddings to the prompt."""
from __future__ import annotations

import dataclasses

import torch

from ..api import Database, Statement, connect
from ..core import Catalog, EngineOptions, Metric
from ..core.schema import (Schema, Table, category_col, float_col, int_col,
                           vector_col)
from ..index import build_ivf
from ..index.ivf import ProbeConfig

RAG_SQL = """
SELECT doc_id FROM docs
WHERE freshness >= ${min_freshness} AND safety = ${safety_class}
ORDER BY DISTANCE(embedding, ${query_embedding})
LIMIT ${K}
"""


@dataclasses.dataclass
class HybridRetriever:
    """Rides the session API: one :class:`~repro_torch.api.Database`
    session over the doc catalog, one prepared
    :class:`~repro_torch.api.Statement`, so every retrieval surface
    (single, batched, scheduled) shares the statement's plan-cache entry
    and bucket executors."""
    db: Database
    statement: Statement
    k: int

    @property
    def catalog(self) -> Catalog:
        """The session's catalog (docs table + IVF index)."""
        return self.db.catalog

    @property
    def compiled(self):
        """Legacy handle (the statement's cached CompiledQuery)."""
        return self.statement.compiled

    @classmethod
    def build(cls, doc_embeddings: torch.Tensor, freshness: torch.Tensor,
              safety: torch.Tensor, k: int = 4, nlist: int = 64,
              metric: Metric = Metric.INNER_PRODUCT,
              probe: ProbeConfig = ProbeConfig(), seed: int = 0):
        """Build a retriever over doc embeddings on their device: catalog +
        IVF index (k-means draws from a ``torch.Generator`` seeded with
        ``seed`` on that device) + prepared hybrid statement."""
        n, dim = doc_embeddings.shape
        dev = doc_embeddings.device
        schema = Schema({
            "doc_id": int_col(),
            "freshness": float_col(),
            "safety": category_col(4),
            "embedding": vector_col(dim, metric),
        }, primary_key="doc_id")
        table = Table(schema, {
            "doc_id": torch.arange(n, dtype=torch.int32, device=dev),
            "freshness": freshness,
            "safety": safety,
            "embedding": doc_embeddings,
        })
        cat = Catalog()
        cat.register("docs", table)
        gen = torch.Generator(device=dev).manual_seed(seed)
        idx = build_ivf(gen, doc_embeddings, nlist=nlist, metric=metric)
        cat.register_index("docs", "embedding", idx)
        db = connect(cat, EngineOptions(engine="chase", probe=probe))
        statement = db.prepare(RAG_SQL, K=k)
        return cls(db, statement, k)

    def retrieve(self, query_embedding, min_freshness=0.0, safety_class=0):
        """Single-query hybrid retrieval: (ids, sims, valid) top-k under the
        freshness / safety filters."""
        out = self.statement.execute({
            "query_embedding": query_embedding,
            "min_freshness": min_freshness,
            "safety_class": safety_class})
        return out["ids"], out["sim"], out["valid"]

    def retrieve_batch(self, query_embeddings, min_freshness=0.0,
                       safety_class=0):
        """Batched retrieval for a serving batch (a stacked (Q, d) bind):
        one pipeline runs the batched IVF probes for the whole batch on the
        size-bucketed executor."""
        out = self.statement.execute({
            "query_embedding": query_embeddings,
            "min_freshness": min_freshness, "safety_class": safety_class})
        return out["ids"], out["sim"], out["valid"]

    def make_scheduler(self, max_batch: int = 32, max_wait_ms: float = 2.0,
                       pilot_budget: int = 0):
        """A :class:`~repro_torch.serving.scheduler.BatchScheduler` over
        this retriever's prepared statement (``Database.serve``): it
        coalesces arriving retrieval requests into bucketed batches
        (``pilot_budget`` > 0 adds effort-bucketed IVF probing)."""
        return self.db.serve(self.statement, max_batch=max_batch,
                             max_wait_ms=max_wait_ms,
                             pilot_budget=pilot_budget)

    def retrieve_for_decode(self, query_embeddings, doc_token_embeds,
                            min_freshness=0.0, safety_class=0,
                            scheduler=None):
        """Prefill hookup: retrieve each sequence's docs and build the
        (B, K, d_model) embedding prefix to prepend to the prompt embeds.

        ``doc_token_embeds`` maps doc id -> model-space embedding
        (n_docs, d_model); invalid retrieval slots contribute zeros.  With
        a ``scheduler`` (see :meth:`make_scheduler`) the requests join its
        coalescing queue.  Returns (prefix, ids, valid)."""
        qs = query_embeddings
        if scheduler is not None:
            rids = [scheduler.submit(query_embedding=q,
                                     min_freshness=min_freshness,
                                     safety_class=safety_class) for q in qs]
            scheduler.flush()
            outs = [scheduler.result(rid) for rid in rids]
            ids = torch.stack([o["ids"] for o in outs])
            valid = torch.stack([o["valid"] for o in outs])
        else:
            ids, _sims, valid = self.retrieve_batch(
                qs, min_freshness=min_freshness, safety_class=safety_class)
        table = torch.as_tensor(doc_token_embeds)
        safe = torch.clamp(ids, min=0).to(table.device).long()
        prefix = table[safe]                                  # (B, K, d_model)
        prefix = torch.where(valid.to(table.device)[..., None], prefix, 0.0)
        return prefix, ids, valid
