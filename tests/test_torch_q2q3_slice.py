"""The Q2 (DR-SF) and Q3 (distance join) slices end to end — SQL -> connect
-> prepare -> execute — in the port against the reference's session API on
the same seed, and the range parity helper they are held with.

Both sides run ``engine="brute"`` with ``use_pallas`` True (the reference's
Pallas range kernels in interpret mode, the port's plain kernel versions on
the CPU) and False.  Radii sit inside the widest gap between adjacent
similarities near the target hit count, so no row lies within fp32 error of
the radius: across packages results agree under ``assert_range_close`` at
1e-5 (D = 32) with counts and counters exactly equal.  The Q2 lists and the
Q3 bind-set lists also run under L2 and cosine (catalogs rebuilt under that
metric), at 1e-4 on sims with ids and counts exactly equal.  Inside the port
the reference's bitwise rules hold: bucketed = exact-shape =
``execute_batch``, and Q3 batch = perleft under ``use_pallas=False``.
"""
import numpy as np
import pytest
import torch

from repro.api import ExecutionHints as RefHints
from repro.api import connect as ref_connect
from repro.core.schema import Metric as RefMetric
from repro.data import make_laion_catalog as ref_make_catalog
from repro_torch.api import ExecutionHints, connect
from repro_torch.core.schema import Metric
from repro_torch.data import make_laion_catalog
from repro_torch.testing import assert_range_close

TOL = 1e-5
METRIC_TOL = {"ip": TOL, "l2": 1e-4, "cosine": 1e-4}   # sims
SMALL = dict(n_rows=3000, n_queries=8, dim=32, n_modes=8, num_categories=4,
             seed=0)
Q2 = ("SELECT sample_id FROM images WHERE DISTANCE(embedding, ${qv}) <= ${r} "
      "AND price < ${p}")
Q2_PLAIN = ("SELECT sample_id FROM images "
            "WHERE DISTANCE(embedding, ${qv}) <= ${r}")
Q3 = """
SELECT queries.id AS qid, images.sample_id AS tid
FROM queries JOIN images
ON DISTANCE(queries.embedding, images.embedding) <= ${r}
AND images.capture_date > queries.capture_date
"""
PERLEFT = ExecutionHints(join_lowering="perleft")


def _gap_radius(sims: np.ndarray, rank: int) -> float:
    """A radius in the middle of the widest gap between adjacent sims
    (descending) around ``rank``: about ``rank`` hits, none at the edge."""
    srt = np.sort(sims.reshape(-1))[::-1]
    window = srt[max(0, rank - 20):rank + 20]
    j = int(np.argmax(-np.diff(window)))
    return float((window[j] + window[j + 1]) / 2)


def _better(corpus: np.ndarray, left: np.ndarray, metric: str):
    """Raw metric values of the left rows against the corpus in float64,
    larger = better: the similarity (ip, cosine) or the negated squared
    distance (l2)."""
    left = left.astype(np.float64)
    ip = left @ corpus.T
    if metric == "ip":
        return ip
    lsq = (left * left).sum(-1)[..., None]
    csq = (corpus * corpus).sum(-1)
    if metric == "l2":
        return -(lsq - 2.0 * ip + csq)
    return ip / np.sqrt(lsq * csq)


def _metric_radius(better: np.ndarray, metric: str, rank: int) -> float:
    """:func:`_gap_radius` over ``_better`` values, as a raw radius: a
    squared distance under l2."""
    r = _gap_radius(better, rank)
    return -r if metric == "l2" else r


@pytest.fixture(scope="module")
def env():
    cat = make_laion_catalog(**SMALL, device="cpu")
    corpus = cat.table("laion")["embedding"].numpy().astype(np.float64)
    left = cat.table("queries")["embedding"].numpy()
    return {"ref_cat": ref_make_catalog(**SMALL), "cat": cat,
            "corpus": corpus, "left": left,
            "left_sims": left.astype(np.float64) @ corpus.T,
            "price": cat.table("laion")["price"].numpy(),
            "cdate": cat.table("laion")["capture_date"].numpy(),
            "qdate": cat.table("queries")["capture_date"].numpy(),
            "metric": "ip"}


@pytest.fixture(scope="module")
def metric_envs(env):
    """``env`` under a metric: inner product is ``env`` itself; L2 and
    cosine rebuild both catalogs under that metric (the same vectors and
    columns), once each."""
    cache = {"ip": env}

    def get(metric: str) -> dict:
        if metric not in cache:
            cache[metric] = dict(
                env, metric=metric,
                cat=make_laion_catalog(**SMALL, metric=Metric(metric),
                                       device="cpu"),
                ref_cat=ref_make_catalog(**SMALL, metric=RefMetric(metric)))
        return cache[metric]
    return get


def _assert_exact_ids(got, ref, key: str) -> None:
    """Ids (or a join's tids), valid slots and counts equal the
    reference's exactly."""
    for k in (key, "valid", "count"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)


def _q2_binds(env, qn: int, seed: int = 1, filtered: bool = True):
    rng = np.random.default_rng(seed)
    metric = env.get("metric", "ip")
    out = []
    for i in range(qn):
        q = (env["left"][i % env["left"].shape[0]]
             + 0.01 * rng.standard_normal(env["left"].shape[1])
             ).astype(np.float32)
        b = {"qv": q, "r": np.float32(_metric_radius(
            _better(env["corpus"], q, metric), metric,
            int(rng.integers(20, 80))))}
        if filtered:
            b["p"] = np.float32(np.quantile(env["price"],
                                            rng.uniform(0.2, 0.9)))
        out.append(b)
    return out


def _stacked(binds: list[dict]) -> dict:
    return {k: np.stack([b[k] for b in binds]) for k in binds[0]}


def _statements(env, sql: str, use_pallas: bool, **kw):
    return (connect(env["cat"], engine="brute", use_pallas=use_pallas,
                    **kw).prepare(sql),
            ref_connect(env["ref_cat"], engine="brute", use_pallas=use_pallas,
                        **kw).prepare(sql))


def _assert_bitwise(a, b) -> None:
    for key, v in a.items():
        if isinstance(v, dict):
            _assert_bitwise(v, b[key])
        else:
            assert torch.equal(v, b[key]), key


# ---------------------------------------------------------------------------
# Q2 DR-SF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filtered", [True, False])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_q2_single_dict_matches_reference(env, use_pallas, filtered):
    st, ref_st = _statements(env, Q2 if filtered else Q2_PLAIN, use_pallas)
    for b in _q2_binds(env, 3, seed=2, filtered=filtered):
        got, ref = st.execute(b), ref_st.execute(b)
        assert got["ids"].shape == (SMALL["n_rows"],)      # min(4096, N)
        assert_range_close(got.data, ref.data, radius=b["r"], atol=TOL,
                           tie_tol=TOL)
        assert int(got["count"]) > 0
        assert got.explain().path == ref.explain().path == "single"


@pytest.mark.parametrize("qn,bucket", [(1, 1), (3, 4), (8, 8)])
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
def test_q2_lists_match_reference(metric_envs, metric, qn, bucket,
                                  use_pallas):
    env = metric_envs(metric)
    tol = METRIC_TOL[metric]
    st, ref_st = _statements(env, Q2, use_pallas)
    binds = _q2_binds(env, qn, seed=qn)
    got, ref = st.execute(binds), ref_st.execute(binds)
    radius = np.array([b["r"] for b in binds])
    assert_range_close(got.data, ref.data, radius=radius, atol=tol,
                       tie_tol=TOL)
    _assert_exact_ids(got, ref, "ids")
    assert int(got["count"].min()) > 0
    rep, ref_rep = got.explain(), ref.explain()
    assert rep.path == ref_rep.path == "bucketed"
    assert rep.bucket == ref_rep.bucket == bucket
    assert rep.batch_lowering == ref_rep.batch_lowering
    assert rep.trace_counts == ref_rep.trace_counts == {bucket: 1}
    # inside the port: bucketed == exact-shape == execute_batch == stacked
    for other in (st.execute(binds, hints=ExecutionHints(exact_shape=True)),
                  st.execute(_stacked(binds))):
        _assert_bitwise(got.data, other.data)
    _assert_bitwise(got.data, st.compiled.execute_batch(binds))
    # a batch row equals the single-dict plan's answer
    one = st.execute(binds[0])
    assert_range_close({k: v[0] for k, v in got.data.items()
                        if k != "stats"}, one.data, radius=radius[0],
                       atol=tol, tie_tol=TOL)


@pytest.mark.parametrize("filtered", [True, False])
def test_q2_stacked_and_exact_shape_match_reference(env, filtered):
    st, ref_st = _statements(env, Q2 if filtered else Q2_PLAIN, True)
    binds = _stacked(_q2_binds(env, 6, seed=4, filtered=filtered))
    assert_range_close(st.execute(binds).data, ref_st.execute(binds).data,
                       radius=binds["r"], atol=TOL, tie_tol=TOL)
    exact = st.execute(binds, hints=ExecutionHints(exact_shape=True))
    ref_exact = ref_st.execute(binds, hints=RefHints(exact_shape=True))
    assert_range_close(exact.data, ref_exact.data, radius=binds["r"],
                       atol=TOL, tie_tol=TOL)
    assert exact.explain().path == "batch" and exact.explain().bucket is None


def test_q2_pad_queries_are_inert(env):
    st, _ = _statements(env, Q2, True)
    binds = st.compiled._stack_binds(_q2_binds(env, 5), {})
    out, bucket, valid = st.executor.run_padded(binds, 5)
    assert bucket == 8 and valid.tolist() == [True] * 5 + [False] * 3
    assert not out["valid"][5:].any() and (out["ids"][5:] == -1).all()
    assert (out["count"][5:] == 0).all() and (out["count"][:5] > 0).all()
    assert (out["stats"]["distance_evals"][5:] == 0).all()


def test_q2_single_dict_is_the_reference_lowering(env, monkeypatch):
    """The reference lowers the single-dict brute Q2 plan with the plain
    flat scan even under use_pallas; the port does the same, and its
    batches go through the query-batched range kernel."""
    import repro_torch.kernels.ops as port_ops

    calls = []
    for name in ("fused_range_scan", "fused_range_topk_batch"):
        real = getattr(port_ops, name)
        monkeypatch.setattr(
            port_ops, name,
            lambda *a, _n=name, _f=real, **kw: calls.append(_n) or _f(*a,
                                                                      **kw))
    st, _ = _statements(env, Q2, True)
    binds = _q2_binds(env, 2)
    st.execute(binds[0])
    assert calls == []
    st.execute(binds)
    assert calls == ["fused_range_topk_batch"]


# capacities of the range compaction against the lists' counts (20 to 80
# hits a query over 3,000 rows): below them (the dense fallback), above
# them, and above N
SLICE_CAPACITIES = [8, 512, 5000]


def _dense_path(monkeypatch):
    """Every range compaction on the dense keys and one sort over N (the
    path above the append compaction's width)."""
    import repro_torch.kernels.ops as port_ops
    monkeypatch.setattr(port_ops, "APPEND_WIDTH", 0)


@pytest.mark.parametrize("capacity", SLICE_CAPACITIES)
@pytest.mark.parametrize("qn", [3, 5])
@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
def test_q2_lists_compacted_on_hits_equal_the_dense_sort(
        metric_envs, metric, qn, capacity, monkeypatch):
    """A Q2 list through the append compaction equals, bit for bit, the
    same list through the dense keys and one sort over N, pad lanes
    included; ``range_overflows`` rises once per live query with more hits
    than the capacity."""
    from repro_torch import tracing
    from repro_torch.core.physical import ProbeConfig

    env = metric_envs(metric)
    st = connect(env["cat"], engine="brute", use_pallas=True,
                 probe=ProbeConfig(capacity=capacity)).prepare(Q2)
    binds = _q2_binds(env, qn, seed=qn + 10)
    before = tracing.snapshot()["counters"]["range_overflows"]
    got = st.execute(binds)
    over = tracing.snapshot()["counters"]["range_overflows"] - before
    cap = min(capacity, SMALL["n_rows"])
    assert got["ids"].shape == (qn, cap)
    assert over == int((got["count"] > cap).sum())
    assert (over > 0) if capacity == SLICE_CAPACITIES[0] else over == 0
    _dense_path(monkeypatch)
    _assert_bitwise(got.data, st.execute(binds).data)


@pytest.mark.parametrize("max_pairs", [8, 512])
@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
def test_q3_batch_compacted_on_hits_equals_the_dense_sort(
        metric_envs, metric, max_pairs, monkeypatch):
    """The Q3 batch lowering's per-left-row compaction: the append path
    equals the dense keys and one sort over N bit for bit."""
    env = metric_envs(metric)
    radius = _metric_radius(_better(env["corpus"], env["left"], metric),
                            metric, 8 * 60)
    st = connect(env["cat"], engine="brute", use_pallas=True,
                 max_pairs=max_pairs).prepare(Q3)
    got = st.execute({"r": np.float32(radius)})
    assert (got["count"] > 8).any()
    _dense_path(monkeypatch)
    _assert_bitwise(got.data, st.execute({"r": np.float32(radius)}).data)


# ---------------------------------------------------------------------------
# Q3 distance join
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lowering", ["batch", "perleft"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_q3_single_dict_matches_reference(env, lowering, use_pallas):
    radius = _gap_radius(env["left_sims"], 8 * 50)
    st, ref_st = _statements(env, Q3, use_pallas, join_lowering=lowering)
    got, ref = st.execute({"r": radius}), ref_st.execute({"r": radius})
    assert got["tid"].shape == (SMALL["n_queries"], 512)
    assert_range_close(got.data, ref.data, radius=radius, atol=TOL,
                       tie_tol=TOL)
    assert int(got["count"].sum()) > 0
    rep, ref_rep = got.explain(), ref.explain()
    assert rep.batch_lowering == ref_rep.batch_lowering
    assert rep.batch_native == ref_rep.batch_native == (lowering == "batch")


@pytest.mark.parametrize("lowering", ["batch", "perleft"])
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
def test_q3_bind_set_lists_match_reference(metric_envs, metric, lowering,
                                           use_pallas):
    """Lists of bind sets with two radii (the reference's
    test_execute_batch_join_matches_singles shape): (Q, L, P) results."""
    env = metric_envs(metric)
    better = _better(env["corpus"], env["left"], metric)
    radii = [_metric_radius(better, metric, 8 * 30),
             _metric_radius(better, metric, 8 * 80)]
    binds = [{"r": np.float32(r)} for r in radii]
    st, ref_st = _statements(env, Q3, use_pallas, join_lowering=lowering)
    got, ref = st.execute(binds), ref_st.execute(binds)
    assert got["tid"].shape == (2, SMALL["n_queries"], 512)
    assert_range_close(got.data, ref.data,
                       radius=np.array(radii, np.float32)[:, None],
                       atol=METRIC_TOL[metric], tie_tol=TOL)
    _assert_exact_ids(got, ref, "tid")
    assert (got["count"][0] <= got["count"][1]).all()
    exact = st.execute(binds, hints=ExecutionHints(exact_shape=True))
    _assert_bitwise(got.data, exact.data)
    for i, b in enumerate(binds):
        one = st.execute(b)
        for key in ("tid", "sim", "valid", "count"):
            assert torch.equal(got[key][i], one[key]), (key, i)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_q3_batch_equals_perleft(env, use_pallas):
    """Plain scans: the two lowerings are bit for bit equal (the
    reference's test_q3_batch_matches_perleft).  Kernels: two different
    kernels (batched vs single-query) agree within 1e-5, as the
    reference's two kernels do."""
    radius = _gap_radius(env["left_sims"], 8 * 60)
    st, _ = _statements(env, Q3, use_pallas)
    batch = st.execute({"r": radius})
    perleft = st.execute({"r": radius}, hints=PERLEFT)
    if use_pallas:
        assert_range_close(batch.data, perleft.data, radius=radius,
                           atol=TOL, tie_tol=TOL)
    else:
        _assert_bitwise(batch.data, perleft.data)


def test_q3_pairs_satisfy_the_residual_predicate(env):
    radius = _gap_radius(env["left_sims"], 8 * 60)
    for lowering in ("batch", "perleft"):
        st, _ = _statements(env, Q3, True, join_lowering=lowering)
        out = st.execute({"r": radius})
        for i in range(SMALL["n_queries"]):
            tids = out["tid"][i][out["valid"][i]].numpy()
            assert (env["cdate"][tids] > env["qdate"][i]).all()
            assert (env["left_sims"][i][tids] >= radius - TOL).all()
            sims = out["sim"][i][out["valid"][i]].numpy()
            assert (np.diff(sims) <= 0).all()             # best first


@pytest.mark.parametrize("lowering", ["batch", "perleft"])
def test_q3_max_pairs_truncation_keeps_counts(env, lowering):
    radius = _gap_radius(env["left_sims"], 8 * 60)
    for use_pallas in (True, False):
        st, ref_st = _statements(env, Q3, use_pallas, join_lowering=lowering,
                                 max_pairs=8)
        got, ref = st.execute({"r": radius}), ref_st.execute({"r": radius})
        assert got["tid"].shape == (SMALL["n_queries"], 8)
        assert_range_close(got.data, ref.data, radius=radius, atol=TOL,
                           tie_tol=TOL)
        assert (got["count"] > 8).any()
        assert (got["count"] >= got["valid"].sum(1)).all()


def test_q3_perleft_launches_one_single_query_scan_per_left_row(
        env, monkeypatch):
    import repro_torch.kernels.ops as port_ops

    calls = []
    real = port_ops.fused_range_scan
    monkeypatch.setattr(port_ops, "fused_range_scan",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    st, _ = _statements(env, Q3, True, join_lowering="perleft")
    st.execute({"r": 0.9})
    assert len(calls) == SMALL["n_queries"]
    st.execute([{"r": 0.9}, {"r": 0.95}])          # the loop-of-singles batch
    assert len(calls) == 3 * SMALL["n_queries"]


def test_q3_pad_bind_sets_are_inert(env):
    for lowering in ("batch", "perleft"):
        st, _ = _statements(env, Q3, True, join_lowering=lowering)
        binds = st.compiled._stack_binds([{"r": 0.9}] * 3, {})
        out, bucket, _ = st.executor.run_padded(binds, 3)
        assert bucket == 4 and not out["valid"][3].any()
        assert (out["count"][3] == 0).all() and (out["count"][:3] > 0).any()
        assert (out["stats"]["distance_evals"][3] == 0).all()


def test_perleft_hint_reprepares_and_rejects_probe_budget(env):
    db = connect(env["cat"], engine="brute", use_pallas=True)
    st = db.prepare(Q3)
    assert st.batch_native
    perleft = st.execute({"r": 0.9}, hints=PERLEFT)
    assert not perleft.explain().batch_native
    assert db.cache_info().misses == 2
    assert st.compiled.options.join_lowering == "batch"
    with pytest.raises(ValueError, match="probe_budget"):
        db.prepare(Q3, hints=PERLEFT).execute(
            [{"r": 0.9}], hints=ExecutionHints(join_lowering="perleft",
                                               probe_budget=2))


def test_stale_join_table_reprepares(env):
    local = make_laion_catalog(**SMALL, device="cpu")
    db = connect(local, engine="brute", use_pallas=True)
    st = db.prepare(Q3)
    before = st.execute({"r": 0.9})
    local.register("queries", env["cat"].table("queries"))   # the left side
    after = st.execute({"r": 0.9})
    assert db.cache_info().misses == 2 and not st.cache_hit
    assert torch.equal(before["tid"], after["tid"])


# ---------------------------------------------------------------------------
# assert_range_close
# ---------------------------------------------------------------------------

def _result(ids, sims, count):
    ids = np.array(ids + [-1] * (4 - len(ids)), np.int32)
    sims = np.array(sims + [0.0] * (4 - len(sims)), np.float32)
    return {"ids": ids, "sim": sims, "valid": ids >= 0,
            "count": np.int32(count)}


# radius 0.5, buffer of 4, tolerance 1e-3
RANGE_CASES = {
    "equal": (_result([3, 1], [0.9, 0.7], 2), _result([3, 1], [0.9, 0.7], 2),
              None),
    "boundary row on one side": (_result([3, 1, 8], [0.9, 0.7, 0.5002], 3),
                                 _result([3, 1], [0.9, 0.7], 2), None),
    "near-tie swap": (_result([3, 1], [0.9, 0.89995], 2),
                      _result([1, 3], [0.89995, 0.9], 2), None),
    "last member of a full buffer": (
        _result([3, 1, 2, 6], [0.9, 0.8, 0.7, 0.65], 9),
        _result([3, 1, 2, 4], [0.9, 0.8, 0.7, 0.6502], 9), None),
    "truncated, count within near": (
        _result([3, 1, 2, 6], [0.9, 0.8, 0.7, 0.65], 9),
        _result([3, 1, 2, 6], [0.9, 0.8, 0.7, 0.65], 10), 1),
    "one-sided hit off the radius": (_result([3, 1, 8], [0.9, 0.7, 0.6], 3),
                                     _result([3, 1], [0.9, 0.7], 2),
                                     "one side only"),
    "count disagrees with the hits held": (_result([3, 1], [0.9, 0.7], 3),
                                       _result([3, 1], [0.9, 0.7], 2),
                                       "hits held"),
    "truncated count without near": (
        _result([3, 1, 2, 6], [0.9, 0.8, 0.7, 0.65], 9),
        _result([3, 1, 2, 6], [0.9, 0.8, 0.7, 0.65], 10), "counts"),
    "sims beyond atol": (_result([3, 1], [0.9, 0.7], 2),
                         _result([3, 1], [0.9, 0.71], 2), "atol"),
    "far swap": (_result([3, 1], [0.9, 0.7], 2),
                 _result([1, 3], [0.7, 0.9], 2), "swap"),
}


@pytest.mark.parametrize("case", list(RANGE_CASES))
def test_assert_range_close_rules(case):
    actual, expected, outcome = RANGE_CASES[case]
    near = outcome if isinstance(outcome, int) else None
    if outcome is None or isinstance(outcome, int):
        assert_range_close(actual, expected, radius=0.5, atol=1e-3,
                           tie_tol=1e-3, near=near)
        assert_range_close(expected, actual, radius=0.5, atol=1e-3,
                           tie_tol=1e-3, near=near)
    else:
        with pytest.raises(AssertionError, match=outcome):
            assert_range_close(actual, expected, radius=0.5, atol=1e-3,
                               tie_tol=1e-3)


def test_assert_range_close_checks_counters_and_qid():
    a, b = _result([3], [0.9], 1), _result([3], [0.9], 1)
    a["stats"] = {"distance_evals": np.int32(5)}
    b["stats"] = {"distance_evals": np.int32(6)}
    with pytest.raises(AssertionError, match="distance_evals"):
        assert_range_close(a, b, radius=0.5, atol=1e-3, tie_tol=1e-3)
    a["stats"] = b["stats"]
    a["qid"], b["qid"] = np.zeros(4, np.int32), np.ones(4, np.int32)
    with pytest.raises(AssertionError, match="qid"):
        assert_range_close(a, b, radius=0.5, atol=1e-3, tie_tol=1e-3)
