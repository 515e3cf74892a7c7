"""Q1 (VKNN-SF) and Q2 (DR-SF) over an IVF index, end to end — SQL ->
connect -> prepare -> execute — in the port against the reference's
session API, under the paper's own engines (``chase``, ``vbase``,
``pase``) and ``brute`` with the index registered (still the flat scan).

Both catalogs carry the reference's index (``ivf_from_numpy`` of
``build_ivf(jax.random.key(0), ...)``), registered on the tables Q1 and Q2
scan.  Ids, valid lanes, counts and the probe / distance-eval counters
must be equal, sims within 1e-5 (D = 32); radii sit in the widest gap
between adjacent similarities near the target hit count.  Inside the port:
bucketed = exact-shape, a single dict = its row of the batch at
``probe_batch`` 1, and quantized chase = fp32 chase bit for bit (the
probes stay fp32).
"""
import jax
import numpy as np
import pytest
import torch

from repro.api import ExecutionHints as RefHints
from repro.api import connect as ref_connect
from repro.core import compile_query as ref_compile_query
from repro.core.compiler import StalePlanError as RefStalePlanError
from repro.core.physical import ProbeConfig as RefProbe
from repro.data import make_laion_catalog as ref_make_catalog
from repro.index import build_ivf as ref_build_ivf
from repro_torch.api import ExecutionHints, connect
from repro_torch.core import compile_query
from repro_torch.core.compiler import StalePlanError
from repro_torch.core.physical import ProbeConfig
from repro_torch.core.schema import Metric
from repro_torch.data import make_laion_catalog
from repro_torch.index import build_ivf, ivf_from_numpy
from repro_torch.testing import assert_topk_close

TOL = 1e-5
SMALL = dict(n_rows=3000, n_queries=6, dim=32, n_modes=8, num_categories=4,
             seed=0)
NLIST = 16
FIELDS = ("centroids", "lists", "list_sizes", "radii", "centroid_sq")
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
Q4 = """
SELECT qid, tid FROM (
 SELECT users.id AS qid, movies.sample_id AS tid,
 RANK() OVER (PARTITION BY users.id
   ORDER BY DISTANCE(users.embedding, movies.embedding)) AS rank
 FROM users JOIN movies ON users.preferred_rating = movies.rating
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
# the probe knobs both packages run with: a buffer below the larger hit
# counts, and enough probes that the counters differ between queries
PROBE = dict(max_probes=12, min_probes=3, stop_after_no_improve=3,
             out_range_stop=2, capacity=48)
EXACT = ExecutionHints(exact_shape=True)
ENGINES = ("chase", "vbase", "pase", "brute")
INDEXED = ("laion", "products", "images", "recipes", "movies")


def _ref_index(ref_cat):
    return ref_build_ivf(jax.random.key(0),
                         ref_cat.table("laion")["embedding"], nlist=NLIST,
                         iters=5)


def _carry(ref_idx, device="cpu"):
    fields = {f: np.asarray(getattr(ref_idx, f)) for f in FIELDS}
    fields.update(nlist=ref_idx.nlist, cap=ref_idx.cap)
    return ivf_from_numpy(fields, Metric.INNER_PRODUCT, device)


def _register(cat, index) -> None:
    for name in INDEXED:
        cat.register_index(name, "embedding", index)


@pytest.fixture(scope="module")
def env():
    ref_cat = ref_make_catalog(**SMALL)
    cat = make_laion_catalog(**SMALL, device="cpu")
    ref_idx = _ref_index(ref_cat)
    _register(ref_cat, ref_idx)
    _register(cat, _carry(ref_idx))
    laion, queries = cat.table("laion"), cat.table("queries")
    corpus = laion["embedding"].numpy().astype(np.float64)
    return {"ref_cat": ref_cat, "cat": cat, "corpus": corpus,
            "left": queries["embedding"].numpy(),
            "price": laion["price"].numpy()}


def _gap_radius(sims: np.ndarray, rank: int) -> float:
    srt = np.sort(sims.reshape(-1))[::-1]
    window = srt[max(0, rank - 20):rank + 20]
    j = int(np.argmax(-np.diff(window)))
    return float((window[j] + window[j + 1]) / 2)


def _binds(env, query: str, qn: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(qn):
        q = (env["left"][i % env["left"].shape[0]]
             + 0.02 * rng.standard_normal(env["left"].shape[1])
             ).astype(np.float32)
        b = {"qv": q, "p": np.float32(np.quantile(env["price"],
                                                  rng.uniform(0.3, 0.9)))}
        if query == "q2":
            b["r"] = np.float32(_gap_radius(env["corpus"] @ q,
                                            int(rng.integers(40, 160))))
        out.append(b)
    return out


def _statements(env, query: str, engine: str, **kw):
    sql = Q1 if query == "q1" else Q2
    port = connect(env["cat"], engine=engine, probe=ProbeConfig(**PROBE),
                   **kw).prepare(sql)
    ref = ref_connect(env["ref_cat"], engine=engine,
                      probe=RefProbe(**PROBE), **kw).prepare(sql)
    return port, ref


def _assert_equal_answers(got: dict, want: dict, query: str, what: str):
    """Ids, valid, count and counters exact; sims within TOL on valid
    slots.  (VBASE's Q2 filter keeps the scan's ids on the slots it
    rejects, in both packages.)"""
    if query == "q1":
        assert_topk_close(got, {k: want[k] for k in got}, atol=TOL,
                          tie_tol=0.0, what=what)
        return
    for key in ("ids", "valid", "count"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]),
                                      err_msg=f"{what}: {key}")
    for key in got["stats"]:
        np.testing.assert_array_equal(np.asarray(got["stats"][key]),
                                      np.asarray(want["stats"][key]),
                                      err_msg=f"{what}: {key}")
    valid = np.asarray(got["valid"])
    np.testing.assert_allclose(np.asarray(got["sim"])[valid],
                               np.asarray(want["sim"])[valid], atol=TOL,
                               rtol=0, err_msg=f"{what}: sims")


@pytest.mark.parametrize("shape", ["single", "list5"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("query", ["q1", "q2"])
def test_engines_over_an_index_match_reference(env, query, engine, shape):
    port, ref = _statements(env, query, engine)
    binds = _binds(env, query, 5, seed=11)
    b = binds[0] if shape == "single" else binds
    got, want = port.execute(b), ref.execute(b)
    _assert_equal_answers(got.data, want.data, query,
                          f"{query} {engine} {shape}")
    assert got.explain().path == want.explain().path
    probes = np.asarray(got["stats"]["probes"])
    flat = engine == "brute" or (engine == "pase" and query == "q2")
    assert (probes == 0).all() if flat else (probes > 0).all()
    assert np.asarray(got["valid"]).any()


@pytest.mark.parametrize("budget", [2, (1, 3, 12, 2, 5)])
@pytest.mark.parametrize("query", ["q1", "q2"])
def test_probe_budget_hint_matches_reference(env, query, budget):
    port, ref = _statements(env, query, "chase")
    binds = _binds(env, query, 5, seed=12)
    got = port.execute(binds, hints=ExecutionHints(probe_budget=budget))
    want = ref.execute(binds, hints=RefHints(probe_budget=budget))
    _assert_equal_answers(got.data, want.data, query, f"{query} {budget}")
    cap = np.broadcast_to(np.asarray(budget), (5,))
    assert (got["stats"]["probes"].numpy() <= cap).all()
    free = port.execute(binds)
    assert (free["stats"]["probes"].numpy()
            >= got["stats"]["probes"].numpy()).all()


@pytest.mark.parametrize("engine", ["chase", "vbase", "pase"])
@pytest.mark.parametrize("query", ["q1", "q2"])
def test_bucketed_equals_exact_shape_and_singles(env, query, engine):
    """A list of 5 runs in bucket 8 with 3 inert pad queries: equal bit for
    bit to the exact-shape batch, and at probe_batch 1 each row equal to
    its single dict."""
    port, _ = _statements(env, query, engine)
    binds = _binds(env, query, 5, seed=13)
    bucketed = port.execute(binds)
    exact = port.execute(binds, hints=EXACT)
    assert bucketed.explain().bucket == 8
    for key, v in bucketed.data.items():
        if isinstance(v, dict):
            for s, t in v.items():
                assert torch.equal(t, exact[key][s]), (key, s)
        else:
            assert torch.equal(v, exact[key]), key
    for i, b in enumerate(binds):
        one = port.execute(b).data
        row = bucketed.query(i).data
        for key, v in one.items():
            if isinstance(v, dict):
                for s, t in v.items():
                    assert torch.equal(t, row[key][s]), (i, key, s)
            else:
                assert torch.equal(v, row[key]), (i, key)
    stmt = port.compiled
    padded, bucket, valid = stmt.executor.run_padded(
        stmt._stack_binds(binds, {}), 5)
    assert not padded["valid"][5:].any()
    assert (padded["stats"]["probes"][5:] == 0).all()


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("query", ["q1", "q2"])
def test_quantized_chase_equals_fp32(env, query, mode):
    """Under quant, chase probes the index in fp32: its answers are the
    fp32 chase answers bit for bit (a single dict runs the batched
    lowering at Q = 1, so it is held against the fp32 batch of one)."""
    fp32, _ = _statements(env, query, "chase", use_pallas=True)
    quant, _ = _statements(env, query, "chase", use_pallas=True, quant=mode)
    binds = _binds(env, query, 5, seed=14)

    def same(a: dict, b: dict):
        for key, v in a.items():
            if isinstance(v, dict):
                same(v, b[key])
            else:
                assert torch.equal(v, b[key]), key

    same(quant.execute(binds).data, fp32.execute(binds).data)
    same(quant.execute(binds[0]).data,
         fp32.execute([binds[0]], hints=EXACT).query(0).data)
    assert (quant.execute(binds)["stats"]["probes"] > 0).all()


def test_plan_before_register_index_is_stale(env):
    """A plan compiled before register_index chose the flat lowering: it
    raises StalePlanError in both packages; the session API re-prepares
    onto the index; re-registering an index re-binds in place."""
    ref_cat = ref_make_catalog(**SMALL)
    cat = make_laion_catalog(**SMALL, device="cpu")
    b = _binds(env, "q1", 1, seed=15)[0]
    q = ref_compile_query(Q1, ref_cat)
    c = compile_query(Q1, cat)
    st = connect(cat, probe=ProbeConfig(**PROBE)).prepare(Q1)
    flat = st.execute(b)
    assert int(flat["stats"]["probes"]) == 0
    ref_idx = _ref_index(ref_cat)
    ref_cat.register_index("products", "embedding", ref_idx)
    cat.register_index("products", "embedding", _carry(ref_idx))
    with pytest.raises(RefStalePlanError):
        q(**b)
    with pytest.raises(StalePlanError, match="array set"):
        c(**b)
    probed = st.execute(b)
    assert int(probed["stats"]["probes"]) > 0 and not st.cache_hit
    # a replacement index of the same structure re-binds, no re-prepare
    compiled = st.compiled
    again = _carry(ref_idx)
    cat.register_index("products", "embedding", again)
    out = st.execute(b)
    assert st.compiled is compiled and compiled.rebinds == 1
    assert compiled._arrays["index"] is again
    assert torch.equal(out["ids"], probed["ids"])
    # the index built on the port's side buckets the same rows
    mine = build_ivf(None, cat.table("laion")["embedding"], NLIST,
                     centroids=again.centroids)
    assert torch.equal(mine.lists, again.lists)


@pytest.mark.parametrize("sql", [Q3, Q4, Q5, Q6], ids=["q3", "q4", "q5",
                                                        "q6"])
@pytest.mark.parametrize("engine", ["chase", "vbase"])
def test_joins_and_category_paths_over_an_index_match_reference(env, sql,
                                                                engine):
    """Q3–Q6 compile over the index under chase and vbase, and give the
    reference's answers and counters (the full grid is in
    tests/test_torch_ivf_joins_slice.py)."""
    probe = dict(PROBE, capacity=256)
    port = connect(env["cat"], engine=engine,
                   probe=ProbeConfig(**probe)).prepare(sql)
    ref = ref_connect(env["ref_cat"], engine=engine,
                      probe=RefProbe(**probe)).prepare(sql)
    assert "index" in port.compiled._arrays
    if sql is Q5:
        b = dict(_binds(env, "q2", 1, seed=16)[0], ex=np.int32(1))
        del b["p"]
    elif sql is Q4:
        b = {}
    else:
        left = env["left"].astype(np.float64)
        b = {"r": np.float32(_gap_radius(left @ env["corpus"].T,
                                         60 * left.shape[0]))}
    got, want = port.execute(b).data, ref.execute(b).data

    def same(g: dict, w: dict):
        assert set(g) == set(w)
        for key, v in w.items():
            if isinstance(v, dict):
                same(g[key], v)
            elif np.asarray(v).dtype.kind == "f":
                np.testing.assert_allclose(np.asarray(g[key]), np.asarray(v),
                                           atol=TOL, rtol=0, err_msg=key)
            else:
                np.testing.assert_array_equal(np.asarray(g[key]),
                                              np.asarray(v), err_msg=key)

    same(got, want)
    probes = np.asarray(got["stats"]["probes"])
    # vbase's Q4 is the flat scan, as in the reference
    assert (probes == 0).all() if (engine, sql) == ("vbase", Q4) \
        else (probes > 0).all()
