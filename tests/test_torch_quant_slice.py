"""``EngineOptions(quant="int8" | "bf16")`` on the Q1–Q3 slices end to end —
SQL -> connect -> prepare -> execute — in the port against the reference's
quantized session API on the same seed, and inside the port against its own
fp32 ``use_pallas=True`` answers.

Across packages (the reference's quantized Pallas kernels in interpret mode,
the port's plain kernel versions on the CPU) answers agree under
``assert_topk_close`` / ``assert_range_close`` at 1e-5 (D = 16, radii inside
wide gaps) with counts and counters exactly equal.  Inside the port the
reference's rule holds bit for bit: a quantized answer equals the fp32
answer of the same call — bucketed, exact-shape and stacked — and a
quantized single dict (the batched lowering at Q = 1) equals the fp32
exact-shape list of one.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import connect as ref_connect
from repro.core.schema import Metric as RefMetric
from repro.data import make_laion_catalog as ref_make_catalog
from repro_torch.api import ExecutionHints, connect
from repro_torch.core import EngineOptions, StalePlanError, compile_query
from repro_torch.core.schema import Metric, Table
from repro_torch.data import make_laion_catalog
from repro_torch.data.quantized import quantize_corpus
from repro_torch.testing import assert_range_close, assert_topk_close

TOL = 1e-5
MODES = ["int8", "bf16"]
SMALL = dict(n_rows=3000, n_queries=8, dim=16, n_modes=8, num_categories=4,
             seed=0)
K = 10
Q1 = ("SELECT sample_id FROM products WHERE price < ${p} "
      "ORDER BY DISTANCE(embedding, ${qv}) LIMIT ${K}")
Q2 = ("SELECT sample_id FROM images WHERE DISTANCE(embedding, ${qv}) <= ${r} "
      "AND price < ${p}")
Q3 = """
SELECT queries.id AS qid, images.sample_id AS tid
FROM queries JOIN images
ON DISTANCE(queries.embedding, images.embedding) <= ${r}
AND images.capture_date > queries.capture_date
"""
SQL = {"q1": Q1, "q2": Q2, "q3": Q3}
EXACT = ExecutionHints(exact_shape=True)


def _gap(sims: np.ndarray, rank: int) -> float:
    """A sim in the middle of the widest gap between adjacent sims
    (descending) around ``rank``."""
    srt = np.sort(sims.reshape(-1))[::-1]
    window = srt[max(0, rank - 20):rank + 20]
    j = int(np.argmax(-np.diff(window)))
    return float((window[j] + window[j + 1]) / 2)


@pytest.fixture(scope="module")
def env():
    cat = make_laion_catalog(**SMALL, device="cpu")
    corpus = cat.table("laion")["embedding"].numpy().astype(np.float64)
    left = cat.table("queries")["embedding"].numpy()
    ref_cat = ref_make_catalog(**SMALL)
    dbs = {}

    def db(quant=None, ref=False):
        """One session per (mode, package), shared so that repeated
        prepares hit the plan cache."""
        key = (quant, ref)
        if key not in dbs:
            dbs[key] = (ref_connect if ref else connect)(
                ref_cat if ref else cat, engine="brute", use_pallas=True,
                quant=quant)
        return dbs[key]

    return {"cat": cat, "db": db, "corpus": corpus, "left": left,
            "price": cat.table("laion")["price"].numpy(),
            "q3_r": _gap(left.astype(np.float64) @ corpus.T, 60)}


def _binds(env, case: str, qn: int, seed: int = 1) -> list[dict]:
    rng = np.random.default_rng(seed)
    left = env["left"]
    out = []
    for i in range(qn):
        q = (left[i % left.shape[0]]
             + 0.01 * rng.standard_normal(left.shape[1])).astype(np.float32)
        p = np.float32(np.quantile(env["price"], rng.uniform(0.3, 0.9)))
        if case == "q1":
            out.append({"qv": q, "p": p})
        elif case == "q2":
            out.append({"qv": q, "p": p, "r": np.float32(_gap(
                env["corpus"] @ q, int(rng.integers(20, 60))))})
        else:
            out.append({"r": np.float32(env["q3_r"])})
    return out


def _stacked(binds: list[dict]) -> dict:
    return {k: np.stack([b[k] for b in binds]) for k in binds[0]}


def _assert_bitwise(a, b, ctx="") -> None:
    assert set(a) == set(b), ctx
    for key, v in a.items():
        if isinstance(v, dict):
            _assert_bitwise(v, b[key], ctx)
        else:
            assert torch.equal(v, b[key]), (ctx, key)


def _first(tree):
    return {k: _first(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def _assert_close(case: str, got, ref, binds, single=False) -> None:
    if case == "q1":
        assert_topk_close(got, ref, atol=TOL, tie_tol=TOL)
        return
    radius = np.array([b["r"] for b in binds])
    if single:
        radius = radius[0]
    elif case == "q3":
        radius = radius[:, None]
    assert_range_close(got, ref, radius=radius, atol=TOL, tie_tol=TOL)


# ---------------------------------------------------------------------------
# Q1-Q3 under both modes: the reference's answers, the port's fp32 bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(SQL))
@pytest.mark.parametrize("mode", MODES)
def test_quant_matches_reference_and_fp32(env, mode, case):
    db = env["db"]
    binds = _binds(env, case, 5)                         # bucket 8
    st = db(mode).prepare(SQL[case], K=K)
    got = st.execute(binds)
    ref = db(mode, ref=True).prepare(SQL[case], K=K).execute(binds)
    _assert_close(case, got.data, dict(ref.data), binds)
    assert got.explain().bucket == 8
    fp32 = db().prepare(SQL[case], K=K)
    _assert_bitwise(got.data, fp32.execute(binds).data, "bucketed")
    _assert_bitwise(st.execute(binds, hints=EXACT).data,
                    fp32.execute(binds, hints=EXACT).data, "exact_shape")
    _assert_bitwise(st.execute(_stacked(binds)).data, got.data, "stacked")


@pytest.mark.parametrize("mode", MODES)
def test_quant_batch_sizes_are_fp32_bits(env, mode):
    db = env["db"]
    for case in ("q1", "q2"):
        st, fp32 = (db(mode).prepare(SQL[case], K=K),
                    db().prepare(SQL[case], K=K))
        for qn in (1, 3, 8, 16):
            binds = _binds(env, case, qn, seed=qn)
            _assert_bitwise(st.execute(binds).data,
                            fp32.execute(binds).data, f"{case} {qn}")
            _assert_bitwise(st.execute(binds, hints=EXACT).data,
                            fp32.execute(binds, hints=EXACT).data,
                            f"{case} {qn} exact")


@pytest.mark.parametrize("case", sorted(SQL))
@pytest.mark.parametrize("mode", MODES)
def test_single_dict_is_the_fp32_list_of_one(env, mode, case):
    """A quantized single dict runs the batched lowering at Q = 1, so its
    bitwise reference is the fp32 exact-shape list of one."""
    db = env["db"]
    b = _binds(env, case, 1, seed=9)
    got = db(mode).prepare(SQL[case], K=K).execute(b[0])
    assert got.explain().path == "single"
    want = db().prepare(SQL[case], K=K).execute(b, hints=EXACT)
    _assert_bitwise(got.data, _first(want.data))
    ref = db(mode, ref=True).prepare(SQL[case], K=K).execute(b[0])
    _assert_close(case, got.data, dict(ref.data), b, single=True)


@pytest.fixture(scope="module", params=["l2", "cosine"])
def metric_env(request):
    """Both catalogs under another metric than the default inner product:
    the quantized kernel's keys, segment minima and the replay run each
    metric's epilogue."""
    metric = request.param
    cat = make_laion_catalog(**SMALL, metric=Metric(metric), device="cpu")
    return {"metric": metric, "cat": cat,
            "ref_cat": ref_make_catalog(**SMALL, metric=RefMetric(metric)),
            "corpus": cat.table("laion")["embedding"].numpy().astype(
                np.float64),
            "left": cat.table("queries")["embedding"].numpy(),
            "price": cat.table("laion")["price"].numpy()}


@pytest.mark.parametrize("mode", MODES)
def test_q1_quant_matches_reference_under_l2_and_cosine(metric_env, mode):
    """Quantized Q1 under L2 and cosine: the reference's quantized answer
    (ids and valid exact, sims to 1e-5) and the port's fp32 answer bit for
    bit, for a bucketed list and for a single dict (the fp32 exact-shape
    list of one)."""
    cat, ref_cat = metric_env["cat"], metric_env["ref_cat"]
    binds = _binds(metric_env, "q1", 5, seed=3)             # bucket 8
    st = connect(cat, engine="brute", use_pallas=True,
                 quant=mode).prepare(Q1, K=K)
    got = st.execute(binds)
    ref = ref_connect(ref_cat, engine="brute", use_pallas=True,
                      quant=mode).prepare(Q1, K=K).execute(binds)
    assert_topk_close(got.data, dict(ref.data), atol=TOL, tie_tol=TOL)
    assert got["valid"].any()
    fp32 = connect(cat, engine="brute", use_pallas=True).prepare(Q1, K=K)
    _assert_bitwise(got.data, fp32.execute(binds).data, metric_env["metric"])
    one = st.execute(binds[0])
    _assert_bitwise(one.data,
                    _first(fp32.execute(binds[:1], hints=EXACT).data),
                    "single dict")


def _metric_radius(corpus: np.ndarray, left: np.ndarray, metric: str,
                   rank: int) -> float:
    """A raw radius of ``metric`` (a squared distance under l2, else a
    similarity) in the middle of the widest gap around ``rank``."""
    left = np.atleast_2d(left).astype(np.float64)
    ip = left @ corpus.T
    lsq = (left * left).sum(-1)[:, None]
    csq = (corpus * corpus).sum(-1)
    if metric == "l2":
        return -_gap(-(lsq - 2.0 * ip + csq), rank)
    return _gap(ip / np.sqrt(lsq * csq), rank)


@pytest.mark.parametrize("case", ["q2", "q3"])
@pytest.mark.parametrize("mode", MODES)
def test_q2_q3_quant_match_reference_under_l2_and_cosine(metric_env, mode,
                                                         case):
    """Quantized Q2 (a list of 5 binds, bucket 8) and Q3 (a list of two
    radii) under L2 and cosine: the reference's quantized answer (ids,
    valid and counts exact, sims to 1e-5) and the port's fp32 answer bit
    for bit, for the list and for a single dict (the fp32 exact-shape list
    of one)."""
    metric, corpus = metric_env["metric"], metric_env["corpus"]
    rng = np.random.default_rng(7)
    left = metric_env["left"]
    if case == "q2":
        binds = []
        for i in range(5):
            q = (left[i] + 0.01 * rng.standard_normal(left.shape[1])
                 ).astype(np.float32)
            binds.append({"qv": q, "p": np.float32(np.quantile(
                metric_env["price"], rng.uniform(0.3, 0.9))),
                "r": np.float32(_metric_radius(
                    corpus, q, metric, int(rng.integers(20, 60))))})
    else:
        binds = [{"r": np.float32(_metric_radius(corpus, left, metric,
                                                 rank))}
                 for rank in (8 * 30, 8 * 80)]
    opts = dict(engine="brute", use_pallas=True)
    st = connect(metric_env["cat"], quant=mode, **opts).prepare(SQL[case])
    got = st.execute(binds)
    ref = ref_connect(metric_env["ref_cat"], quant=mode,
                      **opts).prepare(SQL[case]).execute(binds)
    _assert_close(case, got.data, dict(ref.data), binds)
    for key in ("valid", "count"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), err_msg=key)
    assert int(got["count"].max()) > 0
    fp32 = connect(metric_env["cat"], **opts).prepare(SQL[case])
    _assert_bitwise(got.data, fp32.execute(binds).data, f"{case} {metric}")
    _assert_bitwise(st.execute(binds[0]).data,
                    _first(fp32.execute(binds[:1], hints=EXACT).data),
                    "single dict")


# ---------------------------------------------------------------------------
# adversarial corpus: ties the quantized keys cannot see
# ---------------------------------------------------------------------------

def _adversarial_catalog():
    """512 rows: eight exact duplicates of the query direction u at rows
    256..263, sixteen near-ties 0.9·u + eps_i·e1 at rows 264..279 whose
    differences vanish under both int8 and bf16, 0.1-scale noise elsewhere
    (the reference's tests/test_quant.py corpus)."""
    n, dim = 512, 16
    cat = make_laion_catalog(n_rows=n, n_queries=4, dim=dim, n_modes=8,
                             num_categories=4, seed=0, device="cpu")
    raw = np.linspace(1.0, 0.2, dim).astype(np.float32)
    u = raw / np.linalg.norm(raw)
    rng = np.random.default_rng(5)
    vecs = 0.1 * rng.standard_normal((n, dim)).astype(np.float32)
    vecs /= np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-6)
    vecs *= 0.1
    vecs[256:264] = u
    near = np.tile(0.9 * u, (16, 1))
    near[:, 1] += (1e-6 * np.arange(1, 17)).astype(np.float32)
    vecs[264:280] = near
    tab = cat.table("laion")
    cols = dict(tab.columns)
    cols["vec"] = cols["embedding"] = torch.from_numpy(vecs)
    fresh = Table(tab.schema, cols)
    for name in ("laion", "products", "images"):
        cat.register(name, fresh)
    return cat, u


@pytest.mark.parametrize("mode", MODES)
def test_adversarial_ties_and_duplicates(mode):
    cat, u = _adversarial_catalog()
    binds = [{"qv": u.astype(np.float32), "p": np.float32(1e9)}] * 2
    want = connect(cat, engine="brute", use_pallas=True).prepare(
        Q1, K=12).execute(binds)
    got = connect(cat, engine="brute", use_pallas=True,
                  quant=mode).prepare(Q1, K=12).execute(binds)
    _assert_bitwise(got.data, want.data)
    ids = got["ids"][0].tolist()
    assert ids[:8] == list(range(256, 264)), ids       # lowest ids first
    assert ids[8:] == [279, 278, 277, 276], ids        # only fp32 sees it


# ---------------------------------------------------------------------------
# twins in the catalog, hints, option validation
# ---------------------------------------------------------------------------

def test_reregistered_twin_rebinds_in_place():
    cat = make_laion_catalog(n_rows=240, n_queries=4, dim=16, n_modes=8,
                             num_categories=4, seed=0, device="cpu")
    db = connect(cat, engine="brute", use_pallas=True, quant="int8")
    st = db.prepare(Q1, K=4)
    qs = cat.table("queries")["embedding"].numpy()
    binds = [{"qv": qs[i], "p": np.float32(1e9)} for i in range(3)]
    before = st.execute(binds)
    twin = cat.quantized_for("products", "embedding", "int8")
    assert twin is not None
    assert st.compiled._arrays["qvecs"] is twin.qvecs
    fresh = quantize_corpus(cat.table("products")["embedding"], "int8")
    cat.register_quantized("products", "embedding", fresh)
    after = st.execute(binds)                    # no StalePlanError
    assert st.compiled.rebinds == 1
    assert st.compiled._arrays["qvecs"] is fresh.qvecs
    assert st.executor.arrays is st.compiled._arrays
    _assert_bitwise(before.data, after.data)
    assert db.cache_info().misses == 1


def test_reregistered_table_stales_the_plan_and_drops_its_twins():
    cat = make_laion_catalog(n_rows=240, n_queries=4, dim=16, n_modes=8,
                             num_categories=4, seed=0, device="cpu")
    opts = EngineOptions(engine="brute", use_pallas=True, quant="bf16")
    q = compile_query(Q1, cat, opts, K=4)
    assert cat.quantized_for("products", "embedding", "bf16") is not None
    cat.register("products", cat.table("products"))
    assert cat.quantized_for("products", "embedding", "bf16") is None
    with pytest.raises(StalePlanError):
        q.ensure_fresh()


def test_rescore_factor_hint_is_a_separate_plan(env):
    cat = env["cat"]
    db = connect(cat, engine="brute", use_pallas=True, quant="int8")
    st = db.prepare(Q1, K=K)
    binds = _binds(env, "q1", 3)
    base = st.execute(binds)
    assert db.cache_info().entries == 1
    wide = st.execute(binds, hints=ExecutionHints(rescore_factor=3))
    assert db.cache_info().entries == 2
    assert st.compiled.options.rescore_factor == 2
    _assert_bitwise(base.data, wide.data)


@pytest.mark.parametrize("change,match", [
    (dict(use_pallas=False), "use_pallas"),
    (dict(engine="vbase"), "chase"),
    (dict(quant="fp8"), "one of"),
    (dict(join_lowering="perleft"), "join_lowering"),
    (dict(rescore_factor=0), ">= 1"),
    (dict(quant=None, rescore_factor=0), ">= 1"),
])
def test_validate_quant(env, change, match):
    opts = dataclasses.replace(
        EngineOptions(engine="brute", use_pallas=True, quant="int8"),
        **change)
    with pytest.raises(ValueError, match=match):
        compile_query(Q1, env["cat"], opts, K=K)


def test_quant_engines_not_ported_yet(env):
    """With no IVF index (none can be registered yet) engine 'chase' under
    quant is the flat quantized scan, as in the reference: brute's answer
    bit for bit."""
    binds = _binds(env, "q1", 3)
    chase = connect(env["cat"], engine="chase", use_pallas=True,
                    quant="int8").prepare(Q1, K=K)
    brute = connect(env["cat"], engine="brute", use_pallas=True,
                    quant="int8").prepare(Q1, K=K)
    _assert_bitwise(chase.execute(binds).data, brute.execute(binds).data)
