"""The port's RAG retrieval tier (``repro_torch.serving.rag``) against the
reference's, on the CPU.

Both retrievers probe ONE index: the reference builds its retriever with
``HybridRetriever.build`` (JAX k-means), and the port's retriever is
``HybridRetriever(db, statement, k)`` over the same docs table with the
reference's IVF index carried over by ``ivf_from_numpy``.  Ids and valid
lanes must be equal and sims within 1e-5, for single queries and
batches, under ``counter`` and ``bound`` termination; the prefix of
``retrieve_for_decode`` must equal the reference's, with and without the
scheduler.  On its own, the port's ``build`` must respect the filters and
return the flat answer under ``bound`` (``tests/test_rag.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.schema import Metric as RefMetric
from repro.index.ivf import ProbeConfig as RefProbe
from repro.serving.rag import HybridRetriever as RefRetriever
from repro_torch.api import connect
from repro_torch.core import Catalog, EngineOptions, Metric
from repro_torch.core.schema import (Schema, Table, category_col, float_col,
                                     int_col, vector_col)
from repro_torch.index import FlatIndex, ivf_from_numpy
from repro_torch.index.ivf import ProbeConfig
from repro_torch.serving import RAG_SQL, HybridRetriever
from repro_torch.serving.scheduler import BatchScheduler

FIELDS = ("centroids", "lists", "list_sizes", "radii", "centroid_sq")
N, D, NLIST, K = 2000, 32, 16, 5
PROBES = {"counter": {}, "bound": {"max_probes": NLIST,
                                   "termination": "bound"}}


def _docs(n=N, d=D, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    fresh = rng.random(n).astype(np.float32)
    safety = rng.integers(0, 4, n).astype(np.int32)
    return x, fresh, safety


def _queries(x, q=6, seed=1):
    rng = np.random.default_rng(seed)
    return (x[:q] + 0.05 * rng.standard_normal((q, x.shape[1]))
            ).astype(np.float32)


def _port_retriever(ref, x, fresh, safety, probe):
    idx = ref.catalog.index_for("docs", "embedding")
    fields = {f: np.asarray(getattr(idx, f)) for f in FIELDS}
    fields.update(nlist=idx.nlist, cap=idx.cap)
    schema = Schema({"doc_id": int_col(), "freshness": float_col(),
                     "safety": category_col(4),
                     "embedding": vector_col(D, Metric.INNER_PRODUCT)},
                    primary_key="doc_id")
    cat = Catalog()
    cat.register("docs", Table(schema, {
        "doc_id": torch.arange(len(x), dtype=torch.int32),
        "freshness": torch.from_numpy(fresh),
        "safety": torch.from_numpy(safety),
        "embedding": torch.from_numpy(x)}))
    cat.register_index("docs", "embedding",
                       ivf_from_numpy(fields, Metric.INNER_PRODUCT, "cpu"))
    db = connect(cat, EngineOptions(engine="chase", probe=probe))
    return HybridRetriever(db, db.prepare(RAG_SQL, K=K), K)


@pytest.fixture(scope="module")
def pair():
    """Per termination, the reference's retriever and the port's over its
    index, built once."""
    x, fresh, safety = _docs()
    out = {}
    for name, kw in PROBES.items():
        ref = RefRetriever.build(jnp.asarray(x), jnp.asarray(fresh),
                                 jnp.asarray(safety), k=K, nlist=NLIST,
                                 probe=RefProbe(**kw))
        out[name] = (ref, _port_retriever(ref, x, fresh, safety,
                                          ProbeConfig(**kw)))
    return x, fresh, safety, out


def _same(got, want, what):
    ids, sims, valid = (np.asarray(v) for v in got)
    rids, rsims, rvalid = (np.asarray(v) for v in want)
    np.testing.assert_array_equal(valid, rvalid, err_msg=what)
    np.testing.assert_array_equal(np.where(valid, ids, -1),
                                  np.where(rvalid, rids, -1), err_msg=what)
    np.testing.assert_allclose(np.where(valid, sims, 0),
                               np.where(rvalid, rsims, 0), rtol=0,
                               atol=1e-5, err_msg=what)


@pytest.mark.parametrize("termination", list(PROBES))
@pytest.mark.parametrize("filters", [(0.0, 0), (0.5, 1), (0.9, 3)])
def test_single_retrieval_matches_reference(pair, termination, filters):
    x, _fresh, _safety, out = pair
    ref, mine = out[termination]
    for i, q in enumerate(_queries(x)):
        _same(mine.retrieve(q, *filters), ref.retrieve(q, *filters),
              f"{termination} {filters} query {i}")


@pytest.mark.parametrize("termination", list(PROBES))
def test_batched_retrieval_matches_reference(pair, termination):
    x, _fresh, _safety, out = pair
    ref, mine = out[termination]
    qs = _queries(x)
    got = mine.retrieve_batch(qs, min_freshness=0.25, safety_class=0)
    assert got[0].shape == (len(qs), K)
    _same(got, ref.retrieve_batch(qs, min_freshness=0.25, safety_class=0),
          termination)


@pytest.mark.parametrize("scheduled", [False, True])
def test_retrieve_for_decode_matches_reference(pair, scheduled):
    x, _fresh, _safety, out = pair
    ref, mine = out["counter"]
    qs = _queries(x, q=5, seed=2)
    table = np.random.default_rng(4).standard_normal((N, 24)).astype(
        np.float32)
    want_prefix, want_ids, want_valid = ref.retrieve_for_decode(
        qs, table, min_freshness=0.6, safety_class=2)
    sched = mine.make_scheduler(max_batch=8) if scheduled else None
    prefix, ids, valid = mine.retrieve_for_decode(
        torch.from_numpy(qs), torch.from_numpy(table), min_freshness=0.6,
        safety_class=2, scheduler=sched)
    assert prefix.shape == (5, K, 24)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(prefix.numpy(), np.asarray(want_prefix),
                               rtol=0, atol=0)


def test_make_scheduler_rides_the_statement(pair):
    _x, _fresh, _safety, out = pair
    sched = out["counter"][1].make_scheduler(max_batch=4, max_wait_ms=1.0)
    assert isinstance(sched, BatchScheduler)
    assert sched.config.max_batch == 4


def test_retriever_respects_filters():
    x, fresh, safety = _docs()
    r = HybridRetriever.build(torch.from_numpy(x), torch.from_numpy(fresh),
                              torch.from_numpy(safety), k=5, nlist=16,
                              probe=ProbeConfig(max_probes=16,
                                                termination="bound"))
    assert r.catalog.index_for("docs", "embedding").nlist == 16
    q = torch.from_numpy(x[3] + 0.01)
    ids, sims, valid = r.retrieve(q, min_freshness=0.5, safety_class=1)
    got = ids[valid].numpy()
    assert (fresh[got] >= 0.5).all() and (safety[got] == 1).all()
    # exact = flat under 'bound'
    flat = FlatIndex(Metric.INNER_PRODUCT, torch.from_numpy(x))
    mask = torch.from_numpy((fresh >= 0.5) & (safety == 1))
    gt_ids, _, gt_valid = flat.topk(q, 5, mask)
    assert set(got.tolist()) == set(gt_ids[gt_valid].tolist())


def test_retriever_batched_and_seeded():
    x, fresh, safety = _docs(seed=1)
    args = (torch.from_numpy(x), torch.from_numpy(fresh),
            torch.from_numpy(safety))
    r = HybridRetriever.build(*args, k=3, nlist=16)
    qs = torch.from_numpy(x[:6]) + 0.01
    ids, sims, valid = r.retrieve_batch(qs)
    assert ids.shape == (6, 3)
    assert torch.isfinite(sims).all()
    again = HybridRetriever.build(*args, k=3, nlist=16)
    assert torch.equal(again.catalog.index_for("docs", "embedding").centroids,
                       r.catalog.index_for("docs", "embedding").centroids)
    assert r.compiled is r.statement.compiled
