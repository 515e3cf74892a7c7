"""The Q4 (KNN join), Q5 (category partition) and Q6 (category join) slices
end to end — SQL -> connect -> prepare -> execute — in the port against the
reference's session API on the same seed; the engines with no index
(``EngineOptions()`` included) on Q1–Q6; and Q4–Q6 under ``quant``.

Both sides run the flat path with ``use_pallas`` True (the reference's
Pallas kernels in interpret mode, the port's plain kernel versions on the
CPU) and False.  Radii sit inside the widest gap between adjacent
similarities near the target hit count, so no row lies within fp32 error of
the radius: ids, valid lanes, qid, category, rank and the counters must be
exactly equal, sims within 1e-5 (D = 32).  The reference's single-dict Q5
and perleft Q6 plans take a top-``capacity`` that fails when the capacity
exceeds N, so those comparisons run at ``ProbeConfig(capacity=256)``, as
the reference's own join tests do; the port caps the buffer at N instead.
Inside the port: bucketed = exact-shape = stacked, batch = perleft bit for
bit under ``use_pallas=False``, and quantized = fp32 bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.api import ExecutionHints as RefHints
from repro.api import connect as ref_connect
from repro.core.physical import ProbeConfig as RefProbe
from repro.core.schema import Metric as RefMetric
from repro.data import make_laion_catalog as ref_make_catalog
from repro_torch.api import ExecutionHints, connect
from repro_torch.core import EngineOptions, compile_query
from repro_torch.core.physical import ProbeConfig
from repro_torch.core.schema import Metric
from repro_torch.data import make_laion_catalog
from repro_torch.testing import assert_range_close, assert_topk_close

TOL = 1e-5
SMALL = dict(n_rows=3000, n_queries=6, dim=32, n_modes=8, num_categories=4,
             seed=0)
K4, K5, K6 = 5, 4, 3
Q4 = """
SELECT qid, tid FROM (
 SELECT users.id AS qid, movies.sample_id AS tid,
 RANK() OVER (PARTITION BY users.id
   ORDER BY DISTANCE(users.embedding, movies.embedding)) AS rank
 FROM users JOIN movies ON users.preferred_rating = movies.rating
) AS ranked WHERE ranked.rank <= 5
"""
# Q4 with a bind, so that it can run as a list of bind sets
Q4Y = """
SELECT qid, tid FROM (
 SELECT users.id AS qid, movies.sample_id AS tid,
 RANK() OVER (PARTITION BY users.id
   ORDER BY DISTANCE(users.embedding, movies.embedding)) AS rank
 FROM users JOIN movies ON users.preferred_rating = movies.rating
 AND movies.release_year >= ${y}
) AS ranked WHERE ranked.rank <= 5
"""
Q5 = """
SELECT qid, category FROM (
 SELECT sample_id AS qid, calorie_level AS category,
 RANK() OVER (PARTITION BY calorie_level
   ORDER BY DISTANCE(embedding, ${qv})) AS rank
 FROM recipes
 WHERE DISTANCE(embedding, ${qv}) <= ${r} AND cuisine <> ${ex}
) AS ranked WHERE ranked.rank <= 4
"""
Q6 = """
SELECT qid, category, tid FROM (
 SELECT queries.id AS qid, recipes.sample_id AS tid,
 recipes.calorie_level AS category,
 RANK() OVER (PARTITION BY queries.id, recipes.calorie_level
   ORDER BY DISTANCE(queries.embedding, recipes.embedding)) AS rank
 FROM queries JOIN recipes
 ON DISTANCE(queries.embedding, recipes.embedding) <= ${r}
 AND queries.cuisine <> recipes.cuisine
) AS ranked WHERE ranked.rank <= 3
"""
Q1 = ("SELECT sample_id FROM products WHERE price < ${p} "
      "ORDER BY DISTANCE(embedding, ${qv}) LIMIT 5")
Q2 = ("SELECT sample_id FROM images WHERE DISTANCE(embedding, ${qv}) <= ${r} "
      "AND price < ${p}")
Q3 = """
SELECT queries.id AS qid, images.sample_id AS tid
FROM queries JOIN images
ON DISTANCE(queries.embedding, images.embedding) <= ${r}
AND images.capture_date > queries.capture_date
"""
SMALL_BUFFER = dict(probe=ProbeConfig(capacity=256))
REF_SMALL_BUFFER = dict(probe=RefProbe(capacity=256))
PERLEFT = ExecutionHints(join_lowering="perleft")
EXACT = ExecutionHints(exact_shape=True)


def _gap_radius(sims: np.ndarray, rank: int) -> float:
    """A radius in the middle of the widest gap between adjacent sims
    (descending) around ``rank``: about ``rank`` hits, none at the edge."""
    srt = np.sort(sims.reshape(-1))[::-1]
    window = srt[max(0, rank - 20):rank + 20]
    j = int(np.argmax(-np.diff(window)))
    return float((window[j] + window[j + 1]) / 2)


@pytest.fixture(scope="module")
def env():
    cat = make_laion_catalog(**SMALL, device="cpu")
    laion, queries = cat.table("laion"), cat.table("queries")
    corpus = laion["embedding"].numpy().astype(np.float64)
    left = queries["embedding"].numpy()
    return {"ref_cat": ref_make_catalog(**SMALL), "cat": cat,
            "corpus": corpus, "left": left,
            "left_sims": left.astype(np.float64) @ corpus.T,
            **{name: laion[name].numpy()
               for name in ("rating", "release_year", "calorie_level",
                            "cuisine", "price")},
            "qrating": queries["preferred_rating"].numpy(),
            "qcuisine": queries["cuisine"].numpy()}


def _statements(env, sql: str, use_pallas: bool, engine: str = "brute",
                small_buffer: bool = False, **kw):
    extra = SMALL_BUFFER if small_buffer else {}
    ref_extra = REF_SMALL_BUFFER if small_buffer else {}
    return (connect(env["cat"], engine=engine, use_pallas=use_pallas,
                    **extra, **kw).prepare(sql),
            ref_connect(env["ref_cat"], engine=engine, use_pallas=use_pallas,
                        **ref_extra, **kw).prepare(sql))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_exact(got: dict, want: dict) -> None:
    """Every integer and bool leaf (ids, tid, valid, qid, category, rank,
    the counters) exactly equal; sims within TOL."""
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, dict):
            _assert_exact(got[key], w)
            continue
        g, w = _np(got[key]), _np(w)
        assert g.shape == w.shape, (key, g.shape, w.shape)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def _assert_bitwise(a, b) -> None:
    for key, v in a.items():
        if isinstance(v, dict):
            _assert_bitwise(v, b[key])
        else:
            assert torch.equal(v, b[key]), key


def _q5_binds(env, qn: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(qn):
        q = (env["left"][i % env["left"].shape[0]]
             + 0.01 * rng.standard_normal(env["left"].shape[1])
             ).astype(np.float32)
        out.append({"qv": q,
                    "r": np.float32(_gap_radius(env["corpus"] @ q,
                                                int(rng.integers(40, 120)))),
                    "ex": np.int32(rng.integers(0, 4))})
    return out


def _stacked(binds: list[dict]) -> dict:
    return {k: np.stack([b[k] for b in binds]) for k in binds[0]}


def _q6_radius(env, per_left: int = 60) -> float:
    return _gap_radius(env["left_sims"], SMALL["n_queries"] * per_left)


# ---------------------------------------------------------------------------
# Q4 KNN join
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("lowering", ["batch", "perleft"])
@pytest.mark.parametrize("engine", ["brute", "brute_sort"])
def test_q4_matches_reference(env, engine, lowering, use_pallas):
    st, ref_st = _statements(env, Q4, use_pallas, engine=engine,
                             join_lowering=lowering)
    got, ref = st.execute(), ref_st.execute()
    assert got["tid"].shape == (SMALL["n_queries"], K4)
    _assert_exact(got.data, ref.data)
    assert got["valid"].all()
    rep, ref_rep = got.explain(), ref.explain()
    assert rep.batch_native == ref_rep.batch_native == (lowering == "batch")
    assert rep.batch_lowering == ref_rep.batch_lowering


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("lowering", ["batch", "perleft"])
def test_q4_bind_set_lists_match_reference(env, lowering, use_pallas):
    """Lists of bind sets: (Q, L, K) results and (Q, L) counters."""
    binds = [{"y": np.int32(1980)}, {"y": np.int32(2010)}]
    st, ref_st = _statements(env, Q4Y, use_pallas, join_lowering=lowering)
    got, ref = st.execute(binds), ref_st.execute(binds)
    assert got["tid"].shape == (2, SMALL["n_queries"], K4)
    assert got["stats"]["distance_evals"].shape == (2, SMALL["n_queries"])
    _assert_exact(got.data, ref.data)
    _assert_bitwise(got.data, st.execute(binds, hints=EXACT).data)
    _assert_bitwise(got.data, st.execute(_stacked(binds)).data)
    for i, b in enumerate(binds):
        one = st.execute(b)
        for key in ("tid", "sim", "valid", "rank", "qid"):
            assert torch.equal(got[key][i], one[key]), (key, i)


@pytest.mark.parametrize("engine", ["brute", "brute_sort"])
def test_q4_batch_equals_perleft(env, engine):
    """Plain scans: the two lowerings are bit for bit equal (the
    reference's test_q4_batch_matches_perleft)."""
    st, _ = _statements(env, Q4Y, False, engine=engine)
    binds = [{"y": np.int32(1990)}, {"y": np.int32(2020)}]
    _assert_bitwise(st.execute(binds[0]).data,
                    st.execute(binds[0], hints=PERLEFT).data)
    _assert_bitwise(st.execute(binds).data,
                    st.execute(binds, hints=PERLEFT).data)


def test_q4_rows_satisfy_the_join_and_come_best_first(env):
    for engine in ("brute", "brute_sort"):
        out = _statements(env, Q4Y, True, engine=engine)[0].execute(
            {"y": np.int32(2000)})
        for i in range(SMALL["n_queries"]):
            live = ((env["rating"] == env["qrating"][i])
                    & (env["release_year"] >= 2000))
            want = np.flatnonzero(live)[
                np.argsort(-env["left_sims"][i][live], kind="stable")][:K4]
            np.testing.assert_array_equal(out["tid"][i].numpy(), want)
            np.testing.assert_allclose(out["sim"][i].numpy(),
                                       env["left_sims"][i][want], atol=TOL)
        assert (out["rank"] == torch.arange(1, K4 + 1)).all()


def test_q4_pad_bind_sets_are_inert(env):
    for lowering in ("batch", "perleft"):
        st, _ = _statements(env, Q4Y, True, join_lowering=lowering)
        binds = st.compiled._stack_binds([{"y": np.int32(2000)}] * 3, {})
        out, bucket, _ = st.executor.run_padded(binds, 3)
        assert bucket == 4 and not out["valid"][3].any()
        assert out["valid"][:3].all()
        assert (out["stats"]["distance_evals"][3] == 0).all()
        if lowering == "batch":   # the loop-of-singles masks lanes only
            assert (out["tid"][3] == -1).all()


def test_q4_perleft_launches_one_single_query_scan_per_left_row(
        env, monkeypatch):
    import repro_torch.kernels.ops as port_ops

    calls = []
    for name in ("fused_scan_topk", "fused_scan_topk_batch",
                 "pairwise_keys"):
        real = getattr(port_ops, name)
        monkeypatch.setattr(
            port_ops, name,
            lambda *a, _n=name, _f=real, **kw: calls.append(_n) or _f(*a,
                                                                      **kw))
    st, _ = _statements(env, Q4, True, join_lowering="perleft")
    st.execute()
    assert calls == ["fused_scan_topk"] * SMALL["n_queries"]
    calls.clear()
    _statements(env, Q4, True)[0].execute()
    assert calls == ["fused_scan_topk_batch"]
    calls.clear()
    _statements(env, Q4, True, engine="brute_sort")[0].execute()
    assert calls == ["pairwise_keys"]


@pytest.fixture(scope="module", params=["l2", "cosine"])
def metric_env(request):
    """Both catalogs under another metric than the default inner product
    (the `brute_sort` key matrix runs every metric's epilogue)."""
    metric = request.param
    return (metric,
            make_laion_catalog(**SMALL, metric=Metric(metric), device="cpu"),
            ref_make_catalog(**SMALL, metric=RefMetric(metric)))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("lowering", ["batch", "perleft"])
def test_q4_brute_sort_matches_reference_under_l2_and_cosine(
        metric_env, lowering, use_pallas):
    metric, cat, ref_cat = metric_env
    kw = dict(engine="brute_sort", use_pallas=use_pallas,
              join_lowering=lowering)
    got = connect(cat, **kw).prepare(Q4).execute()
    ref = ref_connect(ref_cat, **kw).prepare(Q4).execute()
    assert got["tid"].shape == (SMALL["n_queries"], K4)
    _assert_exact(got.data, ref.data)
    assert got["valid"].all()
    # the brute scan ranks the same rows
    brute = connect(cat, engine="brute", use_pallas=use_pallas,
                    join_lowering=lowering).prepare(Q4).execute()
    assert torch.equal(got["tid"], brute["tid"]), metric


# ---------------------------------------------------------------------------
# Q5 category partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [True, False])
def test_q5_single_dict_matches_reference(env, use_pallas):
    st, ref_st = _statements(env, Q5, use_pallas, small_buffer=True)
    for b in _q5_binds(env, 3, seed=2):
        got, ref = st.execute(b), ref_st.execute(b)
        assert got["ids"].shape == (SMALL["num_categories"], K5)
        _assert_exact(got.data, ref.data)
        assert got["valid"].any()
        assert got.explain().path == ref.explain().path == "single"


@pytest.mark.parametrize("qn,bucket", [(1, 1), (3, 4), (8, 8)])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_q5_lists_match_reference(env, qn, bucket, use_pallas):
    st, ref_st = _statements(env, Q5, use_pallas)
    binds = _q5_binds(env, qn, seed=qn)
    got, ref = st.execute(binds), ref_st.execute(binds)
    assert got["ids"].shape == (qn, SMALL["num_categories"], K5)
    _assert_exact(got.data, ref.data)
    rep, ref_rep = got.explain(), ref.explain()
    assert rep.path == ref_rep.path == "bucketed"
    assert rep.bucket == ref_rep.bucket == bucket
    assert rep.trace_counts == ref_rep.trace_counts == {bucket: 1}
    # inside the port: bucketed == exact-shape == stacked == execute_batch
    for other in (st.execute(binds, hints=EXACT),
                  st.execute(_stacked(binds))):
        _assert_bitwise(got.data, other.data)
    _assert_bitwise(got.data, st.compiled.execute_batch(binds))
    # a batch row is the single-dict plan's answer (the single plan is the
    # plain scan: bit for bit against the plain batch)
    one = st.execute(binds[0])
    for key in ("ids", "valid", "category"):
        assert torch.equal(got[key][0], one[key]), key
    if use_pallas:
        np.testing.assert_allclose(got["sim"][0], one["sim"], atol=TOL)
    else:
        assert torch.equal(got["sim"][0], one["sim"])


def test_q5_stacked_and_exact_shape_match_reference(env):
    st, ref_st = _statements(env, Q5, True)
    binds = _stacked(_q5_binds(env, 6, seed=4))
    _assert_exact(st.execute(binds).data, ref_st.execute(binds).data)
    exact = st.execute(binds, hints=EXACT)
    _assert_exact(exact.data,
                  ref_st.execute(binds, hints=RefHints(exact_shape=True)).data)
    assert exact.explain().path == "batch" and exact.explain().bucket is None


def test_q5_rows_satisfy_the_predicate_and_rank(env):
    st, _ = _statements(env, Q5, True)
    binds = _q5_binds(env, 4, seed=5)
    out = st.execute(binds)
    for i, b in enumerate(binds):
        sims = env["corpus"] @ b["qv"].astype(np.float64)
        hit = (sims >= b["r"]) & (env["cuisine"] != b["ex"])
        for c in range(SMALL["num_categories"]):
            rows = np.flatnonzero(hit & (env["calorie_level"] == c))
            want = rows[np.argsort(-sims[rows], kind="stable")][:K5]
            v = out["valid"][i, c].numpy()
            np.testing.assert_array_equal(out["ids"][i, c].numpy()[v], want)
            assert (out["category"][i, c] == c).all()
            assert (out["ids"][i, c].numpy()[~v] == -1).all()


def test_q5_pad_queries_are_inert(env):
    st, _ = _statements(env, Q5, True)
    binds = st.compiled._stack_binds(_q5_binds(env, 5), {})
    out, bucket, valid = st.executor.run_padded(binds, 5)
    assert bucket == 8 and valid.tolist() == [True] * 5 + [False] * 3
    assert not out["valid"][5:].any() and (out["ids"][5:] == -1).all()
    assert out["valid"][:5].any(-1).any(-1).all()
    assert (out["stats"]["distance_evals"][5:] == 0).all()


def test_q5_capacity_beyond_n_is_capped(env):
    """The default buffer (4096) exceeds the 3,000-row corpus: the port
    caps it at N (the reference's single-dict plan cannot take it), and the
    single-dict answer is the batch row's bit for bit."""
    st, _ = _statements(env, Q5, False)
    assert st.compiled.options.probe.capacity > SMALL["n_rows"]
    b = _q5_binds(env, 1, seed=6)[0]
    one, batch = st.execute(b), st.execute([b])
    _assert_bitwise(one.data, {k: (v[0] if k != "stats" else
                                   {s: x[0] for s, x in v.items()})
                               for k, v in batch.data.items()})


# ---------------------------------------------------------------------------
# Q6 category join
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("lowering", ["batch", "perleft"])
def test_q6_matches_reference(env, lowering, use_pallas):
    radius = _q6_radius(env)
    st, ref_st = _statements(env, Q6, use_pallas, small_buffer=True,
                             join_lowering=lowering)
    got, ref = st.execute({"r": radius}), ref_st.execute({"r": radius})
    assert got["tid"].shape == (SMALL["n_queries"], SMALL["num_categories"],
                                K6)
    _assert_exact(got.data, ref.data)
    assert got["valid"].any()


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("lowering", ["batch", "perleft"])
def test_q6_radius_lists_match_reference(env, lowering, use_pallas):
    """Lists of bind sets with two radii: (Q, L, C, K) results and (Q, L)
    counters."""
    radii = [_q6_radius(env, 30), _q6_radius(env, 90)]
    binds = [{"r": np.float32(r)} for r in radii]
    st, ref_st = _statements(env, Q6, use_pallas, small_buffer=True,
                             join_lowering=lowering)
    got, ref = st.execute(binds), ref_st.execute(binds)
    shape = (2, SMALL["n_queries"], SMALL["num_categories"], K6)
    assert got["tid"].shape == shape
    assert got["stats"]["probes"].shape == (2, SMALL["n_queries"])
    _assert_exact(got.data, ref.data)
    assert got["valid"][1].sum() >= got["valid"][0].sum()
    _assert_bitwise(got.data, st.execute(binds, hints=EXACT).data)
    for i, b in enumerate(binds):
        one = st.execute(b)
        for key in ("tid", "sim", "valid", "category", "qid"):
            assert torch.equal(got[key][i], one[key]), (key, i)


def test_q6_batch_equals_perleft(env):
    """Plain scans: the two lowerings are bit for bit equal, at the default
    buffer too (the perleft loop caps it at N as the batch does)."""
    radius = _q6_radius(env)
    for small_buffer in (True, False):
        st, _ = _statements(env, Q6, False, small_buffer=small_buffer)
        _assert_bitwise(st.execute({"r": radius}).data,
                        st.execute({"r": radius}, hints=PERLEFT).data)
        binds = [{"r": np.float32(radius)}, {"r": np.float32(radius - 0.02)}]
        _assert_bitwise(st.execute(binds).data,
                        st.execute(binds, hints=PERLEFT).data)


def test_q6_rows_satisfy_the_join_and_rank(env):
    radius = _q6_radius(env)
    out = _statements(env, Q6, True)[0].execute({"r": radius})
    for i in range(SMALL["n_queries"]):
        sims = env["left_sims"][i]
        hit = (sims >= radius) & (env["cuisine"] != env["qcuisine"][i])
        for c in range(SMALL["num_categories"]):
            rows = np.flatnonzero(hit & (env["calorie_level"] == c))
            want = rows[np.argsort(-sims[rows], kind="stable")][:K6]
            v = out["valid"][i, c].numpy()
            np.testing.assert_array_equal(out["tid"][i, c].numpy()[v], want)
            np.testing.assert_allclose(out["sim"][i, c].numpy()[v],
                                       sims[want], atol=TOL)
    assert (out["qid"] == torch.arange(SMALL["n_queries"])[:, None,
                                                           None]).all()


def test_q6_pad_bind_sets_are_inert(env):
    radius = _q6_radius(env)
    for lowering in ("batch", "perleft"):
        st, _ = _statements(env, Q6, True, join_lowering=lowering)
        binds = st.compiled._stack_binds([{"r": np.float32(radius)}] * 3,
                                         {})
        out, bucket, _ = st.executor.run_padded(binds, 3)
        assert bucket == 4 and not out["valid"][3].any()
        assert out["valid"][:3].any()
        assert (out["stats"]["distance_evals"][3] == 0).all()


# ---------------------------------------------------------------------------
# Q4–Q6 under quant: the fp32 answers bit for bit
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _metric_catalog(metric: str):
    return make_laion_catalog(**SMALL, metric=Metric(metric), device="cpu")


def _in_metric(metric: str, b: dict, query=None) -> dict:
    """An inner-product bind set with its radius in ``metric``'s raw units
    (the corpus rows are unit vectors): a squared distance under l2, the
    inner product over ``|q|`` under cosine.  Without ``query`` the query
    side is the unit-norm left rows."""
    if "r" not in b or metric == "ip":
        return b
    qn = 1.0 if query is None else float(np.linalg.norm(query))
    r = float(b["r"])
    r = 1.0 + qn * qn - 2.0 * r if metric == "l2" else r / qn
    return {**b, "r": np.float32(r)}


@pytest.mark.parametrize("query", ["q4", "q5", "q6"])
@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
def test_quant_equals_fp32(env, metric, mode, query):
    sql, single, many = {
        "q4": (Q4Y, {"y": np.int32(2000)},
               [{"y": np.int32(1980)}, {"y": np.int32(2010)}]),
        "q5": (Q5, _q5_binds(env, 1, seed=7)[0], _q5_binds(env, 5, seed=8)),
        "q6": (Q6, {"r": np.float32(_q6_radius(env))},
               [{"r": np.float32(_q6_radius(env, k))} for k in (30, 90)]),
    }[query]
    single = _in_metric(metric, single, single.get("qv"))
    many = [_in_metric(metric, b, b.get("qv")) for b in many]
    cat = env["cat"] if metric == "ip" else _metric_catalog(metric)
    fp32 = connect(cat, engine="brute", use_pallas=True).prepare(sql)
    quant = connect(cat, engine="brute", use_pallas=True,
                    quant=mode).prepare(sql)
    # a quantized plan's single dict runs its batched lowering at Q = 1, so
    # it is held against the fp32 batch of one (the fp32 single-dict Q5
    # plan is the kernel-less plain scan)
    got = quant.execute(single)
    want = fp32.execute([single], hints=EXACT).query(0)
    _assert_bitwise(got.data, want.data)
    got = quant.execute(many)
    _assert_bitwise(got.data, fp32.execute(many, hints=EXACT).data)
    assert got["valid"].any()


# ---------------------------------------------------------------------------
# every engine with no index: the reference's missing-index lowering
# ---------------------------------------------------------------------------

def _q1_binds(env, qn: int):
    rng = np.random.default_rng(9)
    return [{"qv": env["left"][i % env["left"].shape[0]],
             "p": np.float32(np.quantile(env["price"], rng.uniform(0.3, 0.9)))}
            for i in range(qn)]


@pytest.mark.parametrize("query", ["q1", "q2", "q3"])
@pytest.mark.parametrize("engine", ["chase", "vbase", "pase", "brute_sort"])
def test_engines_without_an_index_match_reference(env, engine, query):
    """The default EngineOptions() (chase) and the comparison engines
    prepare and answer as the reference does with no index: the flat
    scan."""
    opts = {} if engine == "chase" else {"engine": engine}
    st = connect(env["cat"], **opts).prepare(
        {"q1": Q1, "q2": Q2, "q3": Q3}[query])
    ref_st = ref_connect(env["ref_cat"], **opts).prepare(
        {"q1": Q1, "q2": Q2, "q3": Q3}[query])
    assert st.compiled.options.engine == engine
    if query == "q1":
        binds = _q1_binds(env, 3)
        for b in (binds[0], binds):
            assert_topk_close(st.execute(b).data, ref_st.execute(b).data,
                              atol=TOL, tie_tol=TOL)
        return
    if query == "q2":
        binds = [dict(b, r=np.float32(_gap_radius(
            env["corpus"] @ b["qv"].astype(np.float64), 50)))
            for b in _q1_binds(env, 3)]
        radius = np.array([b["r"] for b in binds])
        got, ref = st.execute(binds), ref_st.execute(binds)
    else:
        radius = _q6_radius(env)
        got, ref = st.execute({"r": radius}), ref_st.execute({"r": radius})
    assert_range_close(got.data, ref.data, radius=radius, atol=TOL,
                       tie_tol=TOL)


@pytest.mark.parametrize("query", ["q4", "q5", "q6"])
def test_default_options_run_q4_to_q6(env, query):
    sql, binds = {"q4": (Q4, {}), "q5": (Q5, _q5_binds(env, 1, seed=3)[0]),
                  "q6": (Q6, {"r": np.float32(_q6_radius(env))})}[query]
    got = connect(env["cat"], **SMALL_BUFFER).prepare(sql).execute(binds)
    ref = ref_connect(env["ref_cat"], **REF_SMALL_BUFFER).prepare(
        sql).execute(binds)
    assert got.explain().engine == "chase"
    _assert_exact(got.data, ref.data)


def test_an_index_engine_over_a_registered_index_compiles_with_it(
        env, monkeypatch):
    """Over a registered IVF index the engines that probe it lower every
    class (tests/test_torch_ivf_slice.py, tests/test_torch_ivf_joins_slice.py):
    each plan compiles with the index among its arrays; brute and
    brute_sort still run."""
    cat = env["cat"]
    marker = object()
    monkeypatch.setattr(cat, "index_for", lambda table, column: marker)
    for engine in ("chase", "vbase", "pase"):
        for sql in (Q1, Q2, Q3, Q4, Q5, Q6):
            compiled = compile_query(sql, cat, EngineOptions(engine=engine))
            assert compiled._arrays["index"] is marker
    for engine in ("brute", "brute_sort"):
        compile_query(Q4, cat, dataclasses.replace(EngineOptions(),
                                                   engine=engine))
