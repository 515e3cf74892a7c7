"""LIMIT and rank above the top-k kernels' list length (``MAX_K`` = 1,024):
every flat top-k path of the port against the reference's, on the CPU.

The reference's fused top-k takes any k; the port's top-k kernels keep
their lists in shared memory and stop at 1,024, so the ops-level wrappers
route a larger k, on the host and before any launch, to the range kernels
at an infinite radius (fp32) or the quantized key kernel (int8 / bf16) and
a stable smallest-k.  Here (N = 3,000, D = 16; the reference's Pallas
kernels in interpret mode, the port's plain kernel versions) at K in
{1,024, 1,025, 2,000, N, N + 7}:

* Q1 single dicts, lists, stacked and exact-shape binds, the no-predicate
  fast path, L2 and cosine, int8 and bf16, Q4 in both lowerings, one shard
  and a live corpus (zero delta and with a delta) against the reference:
  ids, valid and counters exact (a swap only within 1e-6 of a tie), sims
  within 1e-5;
* inside the port, bit for bit: the K = 2,000 answer's first 1,024
  entries are the K = 1,024 answer, bucketed = exact-shape = stacked,
  quantized = fp32, a single dict = its list of one (= its row of a
  longer list within the tie rule: see the list test), two shards = one
  shard = flat;
* the route: above 1,024 the range and key kernels run and the top-k
  kernels do not, at 1,024 the reverse; ``lower_batch`` counts the range
  kernel's work.
"""
import os

import numpy as np
import pytest
import torch

from repro.api import connect as ref_connect
from repro.data import make_laion_catalog as ref_make_catalog
from repro.data.mutations import attach_live as ref_attach_live
from repro.dist import DistSpec as RefDistSpec
from repro_torch.api import ExecutionHints, connect
from repro_torch.core.schema import Metric
from repro_torch.data import make_laion_catalog
from repro_torch.data.mutations import attach_live
from repro_torch.dist import DistSpec
from repro_torch.kernels import ops, quant, range_scan, scan_topk
from repro_torch.testing import assert_topk_close

TOL = 1e-5
TIE = 1e-6
N = 3000
SMALL = dict(n_rows=N, n_queries=6, dim=16, n_modes=8, num_categories=4,
             seed=0)
KS = (1024, 1025, 2000, N, N + 7)
Q1 = ("SELECT sample_id FROM products WHERE price < ${p} "
      "ORDER BY DISTANCE(embedding, ${qv}) LIMIT ${K}")
Q1_NOFILTER = ("SELECT sample_id FROM products "
               "ORDER BY DISTANCE(embedding, ${qv}) LIMIT ${K}")
Q4 = """
SELECT qid, tid FROM (
 SELECT users.id AS qid, movies.sample_id AS tid,
 RANK() OVER (PARTITION BY users.id
   ORDER BY DISTANCE(users.embedding, movies.embedding)) AS rank
 FROM users JOIN movies ON users.preferred_rating <= movies.rating
) AS ranked WHERE ranked.rank <= ${K}
"""
PALLAS = dict(engine="brute", use_pallas=True)
KEYS = ("ids", "sim", "valid")


@pytest.fixture(scope="module")
def env():
    return ref_make_catalog(**SMALL), make_laion_catalog(**SMALL,
                                                         device="cpu")


def _binds(cat, qn: int, seed: int = 1) -> list[dict]:
    rng = np.random.default_rng(seed)
    qs = cat.table("queries")["embedding"].numpy()
    price = cat.table("laion")["price"].numpy()
    return [{"qv": (qs[i % qs.shape[0]] + 0.01 * rng.standard_normal(
                qs.shape[1])).astype(np.float32),
             "p": np.float32(np.quantile(price, rng.uniform(0.3, 0.9)))}
            for i in range(qn)]


def _nofilter(binds: list[dict]) -> list[dict]:
    return [{"qv": b["qv"]} for b in binds]


def _stacked(binds: list[dict]) -> dict:
    return {k: np.stack([b[k] for b in binds]) for k in binds[0]}


def _data(res) -> dict:
    return {k: res[k] for k in KEYS + ("stats",)}


def _hold(got, want, what: str) -> None:
    assert_topk_close(_data(got), _data(want), atol=TOL, tie_tol=TIE,
                      what=what)


def _bitwise(a, b, what: str, width: int | None = None) -> None:
    for key in KEYS:
        x, y = a[key], b[key]
        if width is not None:
            x, y = x[..., :width], y[..., :width]
        if key == "sim":
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{what}: {key}"


def _row(res, i: int) -> dict:
    return {k: res[k][i] for k in KEYS}


# ---------------------------------------------------------------------------
# Q1 against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("sql", [Q1, Q1_NOFILTER], ids=["pred", "fast"])
def test_q1_single_dict_matches_reference(env, sql, k):
    ref_cat, cat = env
    binds = _binds(cat, 2)
    if sql is Q1_NOFILTER:
        binds = _nofilter(binds)
    st = connect(cat, **PALLAS).prepare(sql, K=k)
    ref_st = ref_connect(ref_cat, **PALLAS).prepare(sql, K=k)
    for b in binds:
        got = st.execute(b)
        assert got["ids"].shape == (k,)
        _hold(got, ref_st.execute(b), f"single K={k}")
    if k > N:
        assert int(got["valid"].sum()) <= N and not bool(got["valid"][-1])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("sql", [Q1, Q1_NOFILTER], ids=["pred", "fast"])
def test_q1_lists_match_reference(env, sql, k):
    """A bucketed list of 3 (bucket 4) against the reference; in the port
    bucketed = exact-shape = stacked = ``execute_batch`` and a single dict
    = its list of one, bit for bit.  A row of the list is held against its
    single dict under the tie rule: the CPU's plain matmul rounds a row of
    a 4-query product differently from a 1-query one, and on the card the
    single-query kernels add a dot product in another order than the
    batched tiles (``chip_smoke.py``'s large_k phase holds the rows of
    lists of 1, 8 and 100 bit for bit there)."""
    ref_cat, cat = env
    binds = _binds(cat, 3, seed=k)
    if sql is Q1_NOFILTER:
        binds = _nofilter(binds)
    st = connect(cat, **PALLAS).prepare(sql, K=k)
    got = st.execute(binds)
    _hold(got, ref_connect(ref_cat, **PALLAS).prepare(sql, K=k).execute(
        binds), f"list K={k}")
    assert got.explain().bucket == 4
    for other in (st.execute(binds, hints=ExecutionHints(exact_shape=True)),
                  st.execute(_stacked(binds)),
                  st.compiled.execute_batch(binds)):
        _bitwise(got, other, f"bucketed vs other K={k}")
    for i, b in enumerate(binds):
        one = st.execute(b)
        _bitwise(one, _row(st.compiled.execute_batch([b]), 0),
                 "single = list of 1")
        assert_topk_close(_row(got, i), {k_: one[k_] for k_ in KEYS},
                          atol=TOL, tie_tol=TIE, what=f"row {i} vs single")


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_q1_under_l2_and_cosine(metric):
    from repro.core.schema import Metric as RefMetric
    ref_cat = ref_make_catalog(**SMALL, metric=RefMetric(metric))
    cat = make_laion_catalog(**SMALL, metric=Metric(metric), device="cpu")
    binds = _binds(cat, 3, seed=4)
    for k in (1025, 2000):
        st = connect(cat, **PALLAS).prepare(Q1, K=k)
        ref_st = ref_connect(ref_cat, **PALLAS).prepare(Q1, K=k)
        _hold(st.execute(binds), ref_st.execute(binds), f"{metric} list")
        _hold(st.execute(binds[0]), ref_st.execute(binds[0]),
              f"{metric} single")


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("k", (1025, 2000, N + 7))
def test_q1_quantized_matches_reference_and_fp32(env, mode, k):
    """Quantized Q1 against the reference's, and bit for bit the port's
    fp32 answer (single dicts and lists)."""
    ref_cat, cat = env
    binds = _binds(cat, 3, seed=k + 1)
    st = connect(cat, **PALLAS, quant=mode).prepare(Q1, K=k)
    ref_st = ref_connect(ref_cat, **PALLAS, quant=mode).prepare(Q1, K=k)
    fp32 = connect(cat, **PALLAS).prepare(Q1, K=k)
    got = st.execute(binds)
    _hold(got, ref_st.execute(binds), f"{mode} list K={k}")
    _bitwise(got, fp32.execute(binds), f"{mode} list = fp32")
    one = st.execute(binds[0])
    _hold(one, ref_st.execute(binds[0]), f"{mode} single K={k}")
    _bitwise(one, fp32.execute(binds[0]), f"{mode} single = fp32")


# ---------------------------------------------------------------------------
# the K = 2,000 prefix is the K = 1,024 answer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [None, "int8", "bf16"])
@pytest.mark.parametrize("sql", [Q1, Q1_NOFILTER], ids=["pred", "fast"])
def test_prefix_of_a_longer_answer_is_the_shorter_one(env, sql, mode):
    _ref_cat, cat = env
    binds = _binds(cat, 5, seed=9)
    if sql is Q1_NOFILTER:
        binds = _nofilter(binds)
    db = connect(cat, **PALLAS, quant=mode)
    short, long_ = db.prepare(sql, K=1024), db.prepare(sql, K=2000)
    _bitwise(short.execute(binds), long_.execute(binds), "list", 1024)
    _bitwise(short.execute(binds[0]), long_.execute(binds[0]), "single",
             1024)


# ---------------------------------------------------------------------------
# Q4, one shard, a live corpus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", (1024, 1025, 2000))
def test_q4_rank_above_the_lists(env, k):
    """Q4 at ``rank <= K`` in both lowerings against the reference's, and
    batch = perleft in the port."""
    ref_cat, cat = env
    out = {}
    for lowering in ("batch", "perleft"):
        got = connect(cat, **PALLAS, join_lowering=lowering).prepare(
            Q4, K=k).execute()
        want = ref_connect(ref_cat, **PALLAS, join_lowering=lowering
                           ).prepare(Q4, K=k).execute()
        assert set(got.data) == set(want.data)
        for key in got.data:
            if key == "stats":
                for sk in got["stats"]:
                    np.testing.assert_array_equal(
                        got["stats"][sk].numpy(),
                        np.asarray(want["stats"][sk]))
            elif got[key].dtype.is_floating_point:
                np.testing.assert_allclose(got[key].numpy(),
                                           np.asarray(want[key]), rtol=0,
                                           atol=TOL, err_msg=key)
            else:
                np.testing.assert_array_equal(got[key].numpy(),
                                              np.asarray(want[key]),
                                              err_msg=f"{lowering} {key}")
        out[lowering] = got.data
    assert int(out["batch"]["valid"].sum(-1).max()) >= min(k, 1024)
    # batch = perleft under the tie rule: a perleft row is a 1-query
    # product, which the CPU's plain matmul rounds differently
    assert_topk_close({"ids": out["batch"]["tid"], **{
        key: out["batch"][key] for key in ("sim", "valid")}},
        {"ids": out["perleft"]["tid"], **{
            key: out["perleft"][key] for key in ("sim", "valid")}},
        atol=TOL, tie_tol=TIE, what="batch vs perleft")


@pytest.mark.parametrize("mode", [None, "int8", "bf16"])
def test_shards_equal_flat_and_the_reference(env, mode):
    """Q1 at K = 2,000 under ``DistSpec``: one shard against the
    reference's one shard (fp32), and two shards = one shard = the flat
    bucketed path bit for bit."""
    ref_cat, cat = env
    binds = _binds(cat, 3, seed=5)
    k = 2000
    flat = connect(cat, **PALLAS, quant=mode).prepare(Q1, K=k)
    one = connect(cat, **PALLAS, quant=mode,
                  dist=DistSpec((1,), ("data",))).prepare(Q1, K=k)
    two = connect(cat, **PALLAS, quant=mode, dist=DistSpec((2,))).prepare(
        Q1, K=k)
    got = one.execute(binds)
    _bitwise(flat.execute(binds), got, "one shard = flat")
    _bitwise(two.execute(binds), got, "two shards = one shard")
    if mode is None:
        want = ref_connect(ref_cat, **PALLAS, dist=RefDistSpec(
            (1,), ("data",))).prepare(Q1, K=k).execute(binds)
        _hold(got, want, "one shard vs reference")


def test_live_corpus_matches_reference(env, tmp_path):
    """Q1 at K = 2,000 over a live corpus, at zero delta and with a delta
    (inserts and deletes in both segments), against the reference's live
    corpus at the user-id level."""
    ref_cat = ref_make_catalog(**SMALL)
    cat = make_laion_catalog(**SMALL, device="cpu")
    kw = dict(delta_cap=64, cap_main=N + 64)
    ref_live = ref_attach_live(ref_cat, "products", "embedding",
                               os.fspath(tmp_path / "ref"), **kw)
    live = attach_live(cat, "products", "embedding",
                       os.fspath(tmp_path / "port"), **kw)
    binds = _binds(cat, 3, seed=6)
    k = 2000
    st = connect(cat, **PALLAS).prepare(Q1, K=k)
    ref_st = ref_connect(ref_cat, **PALLAS).prepare(Q1, K=k)

    def hold(what):
        for b in (binds, binds[0]):
            got, want = st.execute(b), ref_st.execute(b)
            g = {**_data(got), "ids": torch.as_tensor(np.where(
                got["valid"].numpy(), live.user_ids(got["ids"].numpy()),
                -1))}
            w = {**_data(want), "ids": np.where(
                np.asarray(want["valid"]),
                ref_live.user_ids(np.asarray(want["ids"])), -1)}
            assert_topk_close(g, w, atol=TOL, tie_tol=TIE, what=what)

    hold("zero delta")
    rng = np.random.default_rng(11)
    vec = rng.standard_normal((6, SMALL["dim"])).astype(np.float32)
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    for lv in (ref_live, live):
        lv.insert(np.arange(5000, 5006), vec,
                  {"price": np.full(6, 1.0, np.float32)})
        lv.delete([3, 17, 5001])
    hold("delta")


# ---------------------------------------------------------------------------
# the route, the counter, the check
# ---------------------------------------------------------------------------

def _counting(monkeypatch) -> dict:
    """Count calls of every kernel wrapper, wherever it is imported."""
    calls = {}
    mods = (ops, quant, scan_topk, range_scan)
    names = ("scan_topk", "scan_topk_batch", "range_scan",
             "range_scan_batch", "quant_scan_topk_batch", "quant_keys_batch",
             "replay_keys")
    for name in names:
        for mod in mods:
            fn = getattr(mod, name, None)
            if fn is None:
                continue

            def wrapped(*a, _fn=fn, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **kw)

            monkeypatch.setattr(mod, name, wrapped)
    return calls


@pytest.mark.parametrize("mode", [None, "int8"])
def test_route_by_k(env, monkeypatch, mode):
    _ref_cat, cat = env
    calls = _counting(monkeypatch)
    binds = _binds(cat, 3, seed=2)
    db = connect(cat, **PALLAS, quant=mode)
    want = {None: {1024: {"scan_topk": 1, "scan_topk_batch": 1},
                   2000: {"range_scan": 1, "range_scan_batch": 1}},
            "int8": {1024: {"quant_scan_topk_batch": 2, "replay_keys": 2},
                     2000: {"quant_keys_batch": 2, "replay_keys": 2}}}[mode]
    for k in (1024, 2000):
        st = db.prepare(Q1, K=k)
        calls.clear()
        st.execute(binds[0])
        st.execute(binds)
        assert calls == want[k], (mode, k)


@pytest.mark.parametrize("lowering,kernel", [("batch", "range_scan_batch"),
                                              ("perleft", "range_scan")])
def test_q4_route(env, monkeypatch, lowering, kernel):
    _ref_cat, cat = env
    calls = _counting(monkeypatch)
    connect(cat, **PALLAS, join_lowering=lowering).prepare(
        Q4, K=2000).execute()
    assert set(calls) == {kernel}


def test_lower_batch_counts_the_routed_kernel(env):
    _ref_cat, cat = env
    binds = _binds(cat, 4, seed=3)
    cost = connect(cat, **PALLAS).prepare(Q1, K=2000).compiled.lower_batch(
        binds).cost
    meta = dict(device="meta")
    work = range_scan.range_scan_batch_work(
        torch.empty(N, 16, **meta), torch.empty(4, 16, **meta),
        torch.empty(4, **meta), torch.empty(4, N, dtype=torch.int8, **meta),
        None)
    assert set(cost.kernels) == {"range_scan_batch"}
    assert cost.kernels["range_scan_batch"] == {
        "launches": 1, "ops": float(work.ops), "bytes": float(work.nbytes)}


def test_ops_wrappers_take_any_k_from_one(env):
    _ref_cat, cat = env
    corpus = cat.table("laion")["embedding"][:50]
    qs = corpus[:3] + 0.01
    for bad in (0, -1):
        with pytest.raises(ValueError, match="at least 1"):
            ops.fused_scan_topk(corpus, qs[0], bad, None,
                                Metric.INNER_PRODUCT)
        with pytest.raises(ValueError, match="at least 1"):
            ops.fused_scan_topk_batch(corpus, qs, bad, None,
                                      Metric.INNER_PRODUCT)
    # the stage-1 kernels keep their list limit
    with pytest.raises(ValueError, match="k must be"):
        scan_topk.scan_topk_batch(corpus, qs, None, None,
                                  scan_topk.MAX_K + 1, Metric.INNER_PRODUCT)
    ids, sims, valid = ops.fused_scan_topk_batch(
        corpus, qs, 1100, None, Metric.INNER_PRODUCT)
    assert ids.shape == (3, 1100) and int(valid.sum()) == 150
    assert bool((ids[:, 50:] == -1).all()) and bool((sims[:, 50:] == 0).all())
