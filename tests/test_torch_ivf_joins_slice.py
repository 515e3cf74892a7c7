"""Q3 (distance join), Q4 (KNN join), Q5 (category partition) and Q6
(category join) over an IVF index, end to end — SQL -> connect -> prepare
-> execute — in the port against the reference's session API, under the
paper's engines (``chase``, ``vbase``, ``pase``, ``chase_no_updatestate``)
and ``brute`` (``brute_sort`` for Q4) with the index registered.

Both catalogs carry the reference's index (``ivf_from_numpy`` of
``build_ivf(jax.random.key(0), ...)``), registered on every table the
queries scan.  Ids, valid lanes, qid, rank, category, counts and the
``probes`` / ``distance_evals`` / ``categories_seen`` counters must be
equal, sims within 1e-5 (D = 32; 1e-4 under L2 and cosine); radii sit in
the widest gap between adjacent similarities near the target hit count.
The reference's single-dict Q5 and perleft Q6 flat plans take a
top-``capacity`` that fails when the capacity exceeds N, so every
comparison runs at ``capacity=64`` (and Q3 at ``max_pairs=64``), below the
larger hit counts.  Inside the port: bucketed = exact-shape, batch =
perleft row for row at ``probe_batch`` 1, a Q5 list row = its single dict,
a budgeted left row = a run capped at its budget, and quantized chase =
fp32 chase bit for bit (the probes stay fp32).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.api import ExecutionHints as RefHints
from repro.api import connect as ref_connect
from repro.core import physical as ref_physical
from repro.core.physical import ProbeConfig as RefProbe
from repro.core.schema import Metric as RefMetric
from repro.data import make_laion_catalog as ref_make_catalog
from repro.index import build_ivf as ref_build_ivf
from repro_torch.api import ExecutionHints, connect
from repro_torch.core import physical
from repro_torch.core.physical import ProbeConfig
from repro_torch.core.schema import Metric
from repro_torch.data import make_laion_catalog
from repro_torch.index import ivf_from_numpy

TOL = {"ip": 1e-5, "l2": 1e-4, "cosine": 1e-4}
SMALL = dict(n_rows=3000, n_queries=6, dim=32, n_modes=8, num_categories=4,
             seed=0)
NLIST = 16
FIELDS = ("centroids", "lists", "list_sizes", "radii", "centroid_sq")
INDEXED = ("laion", "products", "images", "recipes", "movies")
Q3 = """
SELECT queries.id AS qid, images.sample_id AS tid
FROM queries JOIN images
ON DISTANCE(queries.embedding, images.embedding) <= ${r}
AND images.capture_date > queries.capture_date
"""
Q3_NOPRED = """
SELECT queries.id AS qid, images.sample_id AS tid
FROM queries JOIN images
ON DISTANCE(queries.embedding, images.embedding) <= ${r}
"""
Q4 = """
SELECT qid, tid FROM (
 SELECT users.id AS qid, movies.sample_id AS tid,
 RANK() OVER (PARTITION BY users.id
   ORDER BY DISTANCE(users.embedding, movies.embedding)) AS rank
 FROM users JOIN movies ON users.preferred_rating = movies.rating{extra}
) AS ranked WHERE ranked.rank <= 5
"""
Q4Y = Q4.format(extra=" AND movies.release_year >= ${y}")
Q4 = Q4.format(extra="")
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
 ON DISTANCE(queries.embedding, recipes.embedding) <= ${r}{extra}
) AS ranked WHERE ranked.rank <= 3
"""
Q6_NOPRED = Q6.replace("{extra}", "")
Q6 = Q6.replace("{extra}", "\n AND queries.cuisine <> recipes.cuisine")
SQL = {"q3": Q3, "q3_nopred": Q3_NOPRED, "q4": Q4, "q4y": Q4Y, "q5": Q5,
       "q6": Q6, "q6_nopred": Q6_NOPRED}
# the probe knobs both packages run with: buffers below the larger hit
# counts, and enough probes that the counters differ between left rows
PROBE = dict(max_probes=12, min_probes=3, stop_after_no_improve=3,
             out_range_stop=2, capacity=64, no_new_category_stop=1)
MAX_PAIRS = 64
EXACT = ExecutionHints(exact_shape=True)
ENGINES = ("chase", "vbase", "pase", "chase_no_updatestate", "brute")


def _raw(metric: str, corpus: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Each row's raw metric value against ``q``, larger = better (L2
    negated)."""
    if metric == "l2":
        return -((corpus - q.astype(np.float64)) ** 2).sum(-1)
    ip = corpus @ q.astype(np.float64)
    if metric == "cosine":
        ip = ip / (np.linalg.norm(corpus, axis=-1) * np.linalg.norm(q))
    return ip


def _gap_radius(metric: str, goodness: np.ndarray, rank: int) -> np.float32:
    """A raw radius in the widest gap between adjacent values (best first)
    around ``rank``: about ``rank`` hits, none at the edge."""
    srt = np.sort(goodness.reshape(-1))[::-1]
    window = srt[max(0, rank - 20):rank + 20]
    j = int(np.argmax(-np.diff(window)))
    mid = (window[j] + window[j + 1]) / 2
    return np.float32(-mid if metric == "l2" else mid)


@functools.lru_cache(maxsize=None)
def _env(metric: str) -> dict:
    """Both catalogs under ``metric``, each with the reference's index
    registered on every scanned table, and the radii and binds."""
    ref_cat = ref_make_catalog(**SMALL, metric=RefMetric(metric))
    cat = make_laion_catalog(**SMALL, metric=Metric(metric), device="cpu")
    ref_idx = ref_build_ivf(jax.random.key(0),
                            ref_cat.table("laion")["embedding"], nlist=NLIST,
                            metric=RefMetric(metric), iters=5)
    fields = {f: np.asarray(getattr(ref_idx, f)) for f in FIELDS}
    fields.update(nlist=ref_idx.nlist, cap=ref_idx.cap)
    idx = ivf_from_numpy(fields, Metric(metric), "cpu")
    for name in INDEXED:
        ref_cat.register_index(name, "embedding", ref_idx)
        cat.register_index(name, "embedding", idx)
    corpus = cat.table("laion")["embedding"].numpy().astype(np.float64)
    left = cat.table("queries")["embedding"].numpy()
    left_good = np.stack([_raw(metric, corpus, q) for q in left])
    # the join radius: about 60 hits a left row, and two either side
    join_r = [_gap_radius(metric, left_good, SMALL["n_queries"] * n)
              for n in (60, 40, 90)]
    rng = np.random.default_rng(7)
    q5 = []
    for i in range(3):
        q = (left[i] + 0.01 * rng.standard_normal(left.shape[1])
             ).astype(np.float32)
        q5.append({"qv": q, "r": _gap_radius(metric, _raw(metric, corpus, q),
                                             int(rng.integers(40, 120))),
                   "ex": np.int32(rng.integers(0, 4))})
    binds = {"q3": [{"r": r} for r in join_r],
             "q4": [{}], "q4y": [{"y": np.int32(y)}
                                 for y in (1990, 1980, 2005)],
             "q5": q5, "q6": [{"r": r} for r in join_r]}
    binds["q3_nopred"], binds["q6_nopred"] = binds["q3"], binds["q6"]
    return {"ref_cat": ref_cat, "cat": cat, "binds": binds,
            "tol": TOL[metric]}


def _statements(env, query: str, engine: str, lowering: str = "batch",
                **kw):
    probe = dict(PROBE, **kw.pop("probe", {}))
    opts = dict(engine=engine, join_lowering=lowering, max_pairs=MAX_PAIRS,
                **kw)
    return (connect(env["cat"], probe=ProbeConfig(**probe),
                    **opts).prepare(SQL[query]),
            ref_connect(env["ref_cat"], probe=RefProbe(**probe),
                        **opts).prepare(SQL[query]))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_exact(got: dict, want: dict, tol: float, what: str) -> None:
    """Every integer and bool leaf (ids, tid, valid, qid, category, rank,
    count, the counters) exactly equal; sims within ``tol``."""
    assert set(got) == set(want), what
    for key, w in want.items():
        if isinstance(w, dict):
            _assert_exact(got[key], w, tol, f"{what} {key}")
            continue
        g, w = _np(got[key]), _np(w)
        assert g.shape == w.shape, (what, key, g.shape, w.shape)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                       err_msg=f"{what} {key}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {key}")


def _assert_bitwise(a: dict, b: dict, what: str) -> None:
    for key, v in a.items():
        if isinstance(v, dict):
            _assert_bitwise(v, b[key], f"{what} {key}")
        else:
            assert torch.equal(v, b[key]), (what, key)


def _probed(query: str, engine: str) -> bool:
    """Whether the reference's plan probes the index (else the flat scan)."""
    if query.startswith("q4"):
        return engine == "chase"
    if query.startswith("q3"):
        return engine in ("chase", "vbase")
    return engine in ("chase", "vbase", "chase_no_updatestate")


# (query, lowering, engine): Q5 has no left side, so no perleft lowering;
# brute_sort is Q4's full-sort plan
PATHS = [(q, low) for q in ("q3", "q3_nopred", "q4", "q4y", "q6",
                            "q6_nopred") for low in ("batch", "perleft")]
PATHS += [("q5", "batch")]
CASES = [(q, low, e) for q, low in PATHS
         for e in ENGINES + (("brute_sort",) if q.startswith("q4") else ())]


@pytest.mark.parametrize("query,lowering,engine", CASES,
                         ids=["-".join(c) for c in CASES])
def test_engines_over_an_index_match_reference(query, lowering, engine):
    """A single dict and (where the query has binds) a list of 3 bind sets
    give the reference's answers and counters."""
    env = _env("ip")
    port, ref = _statements(env, query, engine, lowering)
    binds = env["binds"][query]
    calls = [binds[0]] + ([binds] if binds[0] else [])
    for b in calls:
        what = f"{query} {engine} {lowering} {type(b).__name__}"
        got, want = port.execute(b), ref.execute(b)
        _assert_exact(got.data, want.data, env["tol"], what)
        assert got.explain().batch_lowering == want.explain().batch_lowering
        probes = _np(got["stats"]["probes"])
        if _probed(query, engine):
            assert (probes > 0).all(), what
        else:
            assert (probes == 0).all(), what
        assert _np(got["valid"]).any(), what
        assert ("categories_seen" in got["stats"]) == (
            engine == "chase" and query[:2] in ("q5", "q6")), what


METRIC_PATHS = ("q3", "q4y", "q5", "q6")


@pytest.mark.parametrize("query", METRIC_PATHS)
@pytest.mark.parametrize("termination", ["counter", "bound"])
@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
def test_probe_engines_match_reference_per_metric_and_termination(
        metric, termination, query):
    """The probing engines of each class under every metric and both
    terminations, a list of 3 bind sets in the batch lowering (and the
    perleft one for the joins)."""
    env = _env(metric)
    engines = {"q3": ("chase", "vbase"), "q4y": ("chase",),
               "q5": ("chase", "chase_no_updatestate"),
               "q6": ("chase", "vbase")}[query]
    lowerings = ("batch",) if query == "q5" else ("batch", "perleft")
    binds = env["binds"][query]
    probes = {}
    for engine in engines:
        for lowering in lowerings:
            port, ref = _statements(env, query, engine, lowering,
                                    probe={"termination": termination})
            what = f"{metric} {termination} {query} {engine} {lowering}"
            got, want = port.execute(binds), ref.execute(binds)
            _assert_exact(got.data, want.data, env["tol"], what)
            probes[engine] = _np(got["stats"]["probes"])
            assert (probes[engine] > 0).all(), what
            assert _np(got["valid"]).any(), what
    if query in ("q5", "q6"):
        # updateState only adds a way to stop: chase probes no more
        # clusters than the plain range probe of the other engine
        assert (probes["chase"] <= probes[engines[1]]).all()


@pytest.mark.parametrize("budget", [2, (1, 4, 12)])
@pytest.mark.parametrize("query", METRIC_PATHS)
def test_probe_budget_hint_matches_reference(query, budget):
    """ExecutionHints(probe_budget=...) — a scalar, or one budget per bind
    set — caps every left row's probes, as in the reference."""
    env = _env("ip")
    port, ref = _statements(env, query, "chase")
    binds = env["binds"][query]
    got = port.execute(binds, hints=ExecutionHints(probe_budget=budget))
    want = ref.execute(binds, hints=RefHints(probe_budget=budget))
    _assert_exact(got.data, want.data, env["tol"], f"{query} {budget}")
    probes = _np(got["stats"]["probes"])
    cap = np.asarray(budget).reshape((-1,) + (1,) * (probes.ndim - 1))
    assert (probes <= cap).all()
    free = _np(port.execute(binds)["stats"]["probes"])
    assert (free >= probes).all() and (free > probes).any()


@pytest.mark.parametrize("query", ["q4y", "q6"])
def test_budgeted_left_row_freezes_with_best_so_far(query):
    """A budgeted left row stops at its budget with the answer it held
    then: the same as a run whose cluster cap is the budget."""
    env = _env("ip")
    never_early = {"min_probes": 12}
    port, _ = _statements(env, query, "chase", probe=never_early)
    capped, _ = _statements(env, query, "chase",
                            probe=dict(never_early, max_probes=4))
    binds = env["binds"][query]
    got = port.execute(binds, hints=ExecutionHints(probe_budget=4))
    want = capped.execute(binds)
    _assert_bitwise(got.data, want.data, query)
    assert (got["stats"]["probes"] == 4).all()


@pytest.mark.parametrize("engine", ["chase", "vbase",
                                    "chase_no_updatestate"])
@pytest.mark.parametrize("query", ["q3", "q4y", "q5", "q6"])
def test_port_rules_bucketed_batch_perleft_single(query, engine):
    """Inside the port, at probe_batch 1: a list of 3 in bucket 4 (one
    inert pad bind set) equals the exact-shape batch bit for bit, the
    batch lowering equals the perleft lowering row for row (counters
    included), and a Q5 list row equals its single dict."""
    env = _env("ip")
    binds = env["binds"][query]
    port, _ = _statements(env, query, engine)
    bucketed = port.execute(binds)
    assert bucketed.explain().bucket == 4
    _assert_bitwise(bucketed.data, port.execute(binds, hints=EXACT).data,
                    f"{query} {engine} bucketed")
    if query == "q5":
        for i, b in enumerate(binds):
            _assert_bitwise(port.execute(b).data, bucketed.query(i).data,
                            f"q5 {engine} single {i}")
        return
    perleft, _ = _statements(env, query, engine, "perleft")
    _assert_bitwise(perleft.execute(binds).data, bucketed.data,
                    f"{query} {engine} perleft")
    _assert_bitwise(perleft.execute(binds[0]).data,
                    port.execute(binds[0]).data,
                    f"{query} {engine} perleft single")


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("query", METRIC_PATHS)
def test_quantized_chase_equals_fp32(query, mode):
    """Under quant, chase probes the index in fp32: its answers are the
    fp32 chase answers bit for bit (a single dict runs the batched
    lowering at Q = 1, so it is held against the fp32 batch of one)."""
    env = _env("ip")
    fp32, _ = _statements(env, query, "chase", use_pallas=True)
    quant, _ = _statements(env, query, "chase", use_pallas=True, quant=mode)
    binds = env["binds"][query]
    _assert_bitwise(quant.execute(binds).data, fp32.execute(binds).data,
                    f"{query} {mode} list")
    _assert_bitwise(quant.execute(binds[0]).data,
                    fp32.execute([binds[0]], hints=EXACT).query(0).data,
                    f"{query} {mode} single")
    assert (quant.execute(binds)["stats"]["probes"] > 0).all()


def test_category_rank_breaks_ties_by_buffer_position():
    """An IVF buffer holds its hits in discovery order, not best-first:
    equal keys rank in buffer order, as the reference's ``lax.top_k``
    ranks them, never by id."""
    rng = np.random.default_rng(3)
    M, P, C, K = 4, 40, 3, 5
    ids = rng.permutation(1000)[:M * P].reshape(M, P).astype(np.int32)
    keys = rng.choice(np.float32([-0.9, -0.8, -0.7]), size=(M, P))
    valid = rng.random((M, P)) < 0.8
    cats = np.where(valid, rng.integers(0, C, size=(M, P)), -1).astype(
        np.int32)
    keys = np.where(valid, keys, np.inf).astype(np.float32)
    want = ref_physical._rank_per_category_batch(
        RefMetric.INNER_PRODUCT, ids, keys, valid, cats, C, K)
    got = physical._rank_per_category(
        Metric.INNER_PRODUCT, torch.from_numpy(ids), torch.from_numpy(keys),
        torch.from_numpy(valid), torch.from_numpy(cats), C, K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    # and the ties really are many: equal keys with ids out of order
    assert (np.diff(_np(got[0]), axis=-1) < 0).any()
