"""The Q1 slice end to end — SQL -> connect -> prepare -> execute — in the
port against the reference's session API on the same seed.

Both sides run ``engine="brute", use_pallas=True`` (the reference's Pallas
kernels in interpret mode, the port's plain kernel versions on the CPU) and
``use_pallas=False``.  Across packages results agree under
``assert_topk_close`` (1e-5, D <= 32); inside the port, bucketed,
exact-shape and ``execute_batch`` results are bitwise equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import ExecutionHints as RefHints
from repro.api import connect as ref_connect
from repro.data import make_laion_catalog as ref_make_catalog
from repro_torch.api import ExecutionHints, connect
from repro_torch.data import make_laion_catalog
from repro_torch.dist import DistSpec
from repro_torch.index import build_ivf
from repro_torch.opt import LoweringAdvisor
from repro_torch.serving import (BatchScheduler, MutationError,
                                 run_effort_bucketed)
from repro_torch.testing import assert_topk_close

TOL = 1e-5
SMALL = dict(n_rows=3000, n_queries=8, dim=32, n_modes=8, num_categories=4,
             seed=0)
Q1 = ("SELECT sample_id FROM products WHERE price < ${p} "
      "ORDER BY DISTANCE(embedding, ${qv}) LIMIT ${K}")
Q1_SPACED = ("SELECT  sample_id  FROM products\n WHERE price <  ${p}\n"
             " ORDER BY DISTANCE(embedding,  ${qv})  LIMIT ${K}")
Q1_RENAMED = ("SELECT sample_id FROM products WHERE price < ${cap} "
              "ORDER BY DISTANCE(embedding, ${vec}) LIMIT ${n}")
Q1_NOFILTER = ("SELECT sample_id FROM products "
               "ORDER BY DISTANCE(embedding, ${qv}) LIMIT ${K}")
K = 10


@pytest.fixture(scope="module")
def env():
    ref_cat = ref_make_catalog(**SMALL)
    cat = make_laion_catalog(**SMALL, device="cpu")
    return ref_cat, cat


def _binds(qn: int, seed: int = 1) -> list[dict]:
    rng = np.random.default_rng(seed)
    base = make_laion_catalog(**SMALL, device="cpu")
    qs = base.table("queries")["embedding"].numpy()
    price = base.table("laion")["price"].numpy()
    out = []
    for i in range(qn):
        q = qs[i % qs.shape[0]] + 0.01 * rng.standard_normal(qs.shape[1])
        out.append({"qv": q.astype(np.float32),
                    "p": np.float32(np.quantile(price,
                                                rng.uniform(0.2, 0.9)))})
    return out


def _stacked(binds: list[dict]) -> dict:
    return {k: np.stack([b[k] for b in binds]) for k in binds[0]}


def _ref_data(res) -> dict:
    return {"ids": res["ids"], "sim": res["sim"], "valid": res["valid"],
            "stats": res["stats"]}


@pytest.mark.parametrize("use_pallas", [True, False])
def test_single_dict_matches_reference(env, use_pallas):
    ref_cat, cat = env
    ref_st = ref_connect(ref_cat, engine="brute",
                         use_pallas=use_pallas).prepare(Q1, K=K)
    st = connect(cat, engine="brute", use_pallas=use_pallas).prepare(Q1, K=K)
    for b in _binds(3):
        got = st.execute(b)
        assert got["ids"].device == torch.device("cpu")
        assert_topk_close(got.data, _ref_data(st_ref := ref_st.execute(b)),
                          atol=TOL, tie_tol=TOL)
        assert got.explain().path == st_ref.explain().path == "single"


@pytest.mark.parametrize("qn,bucket", [(3, 4), (9, 16)])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_bucketed_lists_match_reference(env, qn, bucket, use_pallas):
    ref_cat, cat = env
    binds = _binds(qn, seed=qn)
    ref_st = ref_connect(ref_cat, engine="brute",
                         use_pallas=use_pallas).prepare(Q1, K=K)
    st = connect(cat, engine="brute", use_pallas=use_pallas).prepare(Q1, K=K)
    got = st.execute(binds)
    ref = ref_st.execute(binds)
    assert_topk_close(got.data, _ref_data(ref), atol=TOL, tie_tol=TOL)
    rep, ref_rep = got.explain(), ref.explain()
    assert rep.path == ref_rep.path == "bucketed"
    assert rep.bucket == ref_rep.bucket == bucket
    assert rep.buckets == ref_rep.buckets == (bucket,)
    assert rep.trace_counts == ref_rep.trace_counts == {bucket: 1}
    assert len(got) == qn and got.query(qn - 1)["ids"].shape == (K,)
    # inside the port: bucketed == exact-shape == execute_batch, bitwise
    exact = st.execute(binds, hints=ExecutionHints(exact_shape=True))
    direct = st.compiled.execute_batch(binds)
    stacked = st.execute(_stacked(binds))
    for other in (exact.data, direct, stacked.data):
        for key in ("ids", "sim", "valid"):
            assert torch.equal(got[key], other[key]), key
        for key in ("probes", "distance_evals"):
            assert torch.equal(got["stats"][key], other["stats"][key]), key
    assert st.explain().trace_counts == {bucket: 1}


@pytest.fixture(scope="module", params=["l2", "cosine"])
def metric_env(request):
    """Both catalogs under another metric than the default inner product:
    the batched kernel's keys run the L2 and cosine epilogues."""
    from repro.core.schema import Metric as RefMetric
    from repro_torch.core.schema import Metric

    metric = request.param
    return (ref_make_catalog(**SMALL, metric=RefMetric(metric)),
            make_laion_catalog(**SMALL, metric=Metric(metric), device="cpu"))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_bucketed_lists_match_reference_under_l2_and_cosine(metric_env,
                                                            use_pallas):
    """Q1's bucketed list under L2 and cosine: the reference's answer, and
    bucketed == exact-shape bitwise inside the port."""
    ref_cat, cat = metric_env
    binds = _binds(9, seed=9)
    ref_st = ref_connect(ref_cat, engine="brute",
                         use_pallas=use_pallas).prepare(Q1, K=K)
    st = connect(cat, engine="brute", use_pallas=use_pallas).prepare(Q1, K=K)
    got = st.execute(binds)
    ref = ref_st.execute(binds)
    assert_topk_close(got.data, _ref_data(ref), atol=TOL, tie_tol=TOL)
    assert got.explain().path == ref.explain().path == "bucketed"
    assert got.explain().bucket == 16 and got["valid"].any()
    exact = st.execute(binds, hints=ExecutionHints(exact_shape=True))
    for key in ("ids", "sim", "valid"):
        assert torch.equal(got[key], exact[key]), key


def test_pad_queries_are_inert(env):
    _, cat = env
    st = connect(cat, engine="brute", use_pallas=True).prepare(Q1, K=K)
    binds = st.compiled._stack_binds(_binds(5), {})
    out, bucket, valid = st.executor.run_padded(binds, 5)
    assert bucket == 8 and valid.tolist() == [True] * 5 + [False] * 3
    assert not out["valid"][5:].any() and (out["ids"][5:] == -1).all()
    assert (out["stats"]["distance_evals"][5:] == 0).all()
    assert (out["stats"]["distance_evals"][:5] == SMALL["n_rows"]).all()


def test_stacked_and_exact_shape_match_reference(env):
    ref_cat, cat = env
    binds = _stacked(_binds(6, seed=4))
    ref_st = ref_connect(ref_cat, engine="brute",
                         use_pallas=True).prepare(Q1, K=K)
    st = connect(cat, engine="brute", use_pallas=True).prepare(Q1, K=K)
    assert_topk_close(st.execute(binds).data, _ref_data(ref_st.execute(binds)),
                      atol=TOL, tie_tol=TOL)
    exact = st.execute(binds, hints=ExecutionHints(exact_shape=True))
    ref_exact = ref_st.execute(binds, hints=RefHints(exact_shape=True))
    assert_topk_close(exact.data, _ref_data(ref_exact), atol=TOL, tie_tol=TOL)
    assert exact.explain().path == "batch" and exact.explain().bucket is None


def test_q1_fast_path_exact_shape_without_predicate(env, monkeypatch):
    """Q=1 with no predicate and no pad lane runs the single-query kernel,
    in both packages."""
    import repro_torch.kernels.ops as port_ops

    ref_cat, cat = env
    b = {"qv": _binds(1)[0]["qv"][None]}
    ref = ref_connect(ref_cat, engine="brute", use_pallas=True).prepare(
        Q1_NOFILTER, K=K).execute(b, hints=RefHints(exact_shape=True))
    st = connect(cat, engine="brute", use_pallas=True).prepare(Q1_NOFILTER,
                                                               K=K)
    calls = []
    single = port_ops.fused_scan_topk
    monkeypatch.setattr(port_ops, "fused_scan_topk",
                        lambda *a, **kw: calls.append(1) or single(*a, **kw))
    got = st.execute(b, hints=ExecutionHints(exact_shape=True))
    assert calls == [1]
    assert_topk_close(got.data, _ref_data(ref), atol=TOL, tie_tol=TOL)
    one = st.execute({"qv": b["qv"][0]})
    assert_topk_close({k: v[None] for k, v in one.data.items()
                       if k != "stats"}, got.data, atol=0.0, tie_tol=0.0)


def test_plan_cache_matches_reference(env):
    ref_cat, cat = env
    db = connect(cat, engine="brute", use_pallas=True)
    ref_db = ref_connect(ref_cat, engine="brute", use_pallas=True)
    seen = []
    for sql, static in ((Q1, {"K": K}), (Q1_SPACED, {"K": K}),
                        (Q1_RENAMED, {"n": K}), (Q1, {"K": 4}),
                        (Q1_NOFILTER, {"K": K})):
        st, ref_st = db.prepare(sql, **static), ref_db.prepare(sql, **static)
        assert st.cache_hit == ref_st.cache_hit
        seen.append(st.cache_hit)
        assert (dataclasses.astuple(db.cache_info())
                == dataclasses.astuple(ref_db.cache_info()))
    assert seen == [False, True, True, False, False]
    renamed = db.prepare(Q1_RENAMED, n=K)
    b = _binds(2)
    got = renamed.execute([{"vec": x["qv"], "cap": x["p"]} for x in b])
    base = db.prepare(Q1, K=K).execute(b)
    assert torch.equal(got["ids"], base["ids"])
    assert renamed.executor is db.prepare(Q1, K=K).executor
    assert renamed.explain().trace_counts == {2: 1}
    with pytest.raises(ValueError, match="unknown bind"):
        renamed.execute({"qv": b[0]["qv"], "p": b[0]["p"]})


def test_stale_table_reprepares(env):
    _, cat = env
    local = make_laion_catalog(**SMALL, device="cpu")
    db = connect(local, engine="brute", use_pallas=True)
    st = db.prepare(Q1, K=K)
    b = _binds(1)[0]
    before = st.execute(b)
    local.register("products", cat.table("laion"))
    after = st.execute(b)
    assert db.cache_info().misses == 2 and not st.cache_hit
    assert torch.equal(before["ids"], after["ids"])


def test_unported_surfaces_raise(env, tmp_path):
    _, cat = env
    # the default engine (chase) and the Q4-Q6 classes run on the flat path
    # without an index; over one, chase probes it on every class
    assert connect(cat).prepare(Q1, K=K).compiled.options.engine == "chase"
    q4 = ("SELECT qid, tid FROM (SELECT users.id AS qid, "
          "movies.sample_id AS tid, RANK() OVER (PARTITION BY users.id "
          "ORDER BY DISTANCE(users.embedding, movies.embedding)) AS rank "
          "FROM users JOIN movies ON users.preferred_rating = movies.rating"
          ") AS ranked WHERE ranked.rank <= 5")
    q5 = ("SELECT qid, category FROM (SELECT sample_id AS qid, "
          "calorie_level AS category, RANK() OVER (PARTITION BY "
          "calorie_level ORDER BY DISTANCE(embedding, ${qv})) AS rank "
          "FROM recipes WHERE DISTANCE(embedding, ${qv}) <= ${r}"
          ") AS ranked WHERE ranked.rank <= 4")
    connect(cat, engine="brute").prepare(q4)             # Q4, a KNN join
    local = make_laion_catalog(**SMALL, device="cpu")
    index = build_ivf(torch.Generator().manual_seed(0),
                      local.table("laion")["embedding"], 8, iters=2)
    for name in ("products", "movies", "recipes"):
        local.register_index(name, "embedding", index)
        assert local.index_for(name, "embedding") is index
    assert connect(local).prepare(Q1, K=K).compiled._arrays["index"] is index
    for sql in (q4, q5):
        assert connect(local).prepare(sql).compiled._arrays["index"] is index
    # the sharded scans are ported: one shard is the flat path bit for bit,
    # and a dist option that is no DistSpec is refused
    flat = connect(cat, engine="brute", use_pallas=True).prepare(Q1, K=K)
    sharded = connect(cat, engine="brute", use_pallas=True,
                      dist=DistSpec()).prepare(Q1, K=K)
    for key in ("ids", "sim", "valid"):
        assert torch.equal(sharded.execute(_binds(3))[key],
                           flat.execute(_binds(3))[key])
    assert sharded.explain().shards == 1
    with pytest.raises(TypeError, match="DistSpec"):
        connect(cat, engine="brute", use_pallas=True,
                dist=object()).prepare(Q1, K=K)
    # the on-disk plan cache is ported: a cold execute persists its entry
    aot_db = connect(cat, engine="brute", aot_cache_path=str(tmp_path))
    aot_db.prepare(Q1, K=K).execute(_binds(3))
    assert aot_db.cache_info().aot["saves"] == 1
    db = connect(cat, engine="brute")
    st = db.prepare(Q1, K=K)
    # the live corpus is ported: a table without one rejects a mutation
    with pytest.raises(MutationError, match="no live corpus"):
        db.insert("laion", [1], None)
    # the adaptive optimizer is ported: advise scores the lanes, and an
    # advised flat plan runs lock-step (no probe lane) with its answer
    advice = db.advise(Q1, K=K)
    assert advice["recommended"] == "flat"
    assert advice["n_rows"] == SMALL["n_rows"]
    binds = st._stack_binds(_binds(2), {})
    out, info = run_effort_bucketed(st, binds, 0,
                                    advisor=LoweringAdvisor(cat))
    assert info["opt"]["path"] == "lockstep"
    assert info["opt"]["source"] == "flat"
    assert torch.equal(out["ids"], st.execute(_binds(2))["ids"])
    adb = connect(cat, engine="brute", adaptive=True)
    res = adb.prepare(Q1, K=K).execute(_binds(2))
    assert res.explain().path == "opt"
    assert torch.equal(res["ids"], st.execute(_binds(2))["ids"])
    # the serving tier is ported: serve() schedules and pilot_budget runs
    # the effort path (flat plans probe nothing, so every query is light)
    assert isinstance(db.serve(st), BatchScheduler)
    eff = st.execute(_binds(2), hints=ExecutionHints(pilot_budget=2))
    assert eff.explain().path == "effort"
    assert eff.explain().effort["n_heavy"] == 0
    assert torch.equal(eff["ids"], st.execute(_binds(2))["ids"])
