"""The port's adaptive optimizer (``repro_torch.opt``) against the
reference's (``repro.opt``), on the CPU.

Mirrors ``tests/test_opt.py``.  Both packages run one seeded catalog
(1,200 rows, D = 16) with the reference's IVF index (carried into the port
with ``ivf_from_numpy``) under ``chase``.  Held:

* ``bucket_of`` equal over a grid; ``StatsStore.to_json`` byte-identical
  for one observation sequence, and a stats file written by either package
  loads in the other; entries drop on a version change, and an advisor's
  stats drop on a catalog bump;
* ``CostModel`` with explicit constants: ``score``, ``choose``,
  ``probe_budget`` and ``expected_probes`` equal over a grid, and
  ``from_bench(root)`` reads the same files the same way; the port's bare
  ``CostModel()`` / ``from_bench()`` read no ``BENCH_*.json`` (the card's
  constants);
* the advisors' decision streams (explicit constants) equal on Q1 and Q3,
  the plan digest aside (it hashes each package's ``EngineOptions`` repr);
* inside the port, adaptive = bucketed = exact-shape bit for bit across
  Q1–Q6, cold and warmed; against the reference's adaptive run, ids,
  valid lanes, counts and counters exact, sims within 1e-5;
* hints beat the advisor, changing predictions build no executor, join
  profiles give (Q, L) pilots, ``stats_path`` persists through
  ``connect``, ``Database.advise`` scores the lanes, ``db.serve`` drains
  through the advisor, and an adaptive execute adds one device-to-host
  copy (two when phase 2 ran).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.api import ExecutionHints as RefHints
from repro.api import connect as ref_connect
from repro.core import Metric as RefMetric
from repro.data import make_laion_catalog as ref_make_catalog
from repro.index import build_ivf as ref_build_ivf
from repro.index.ivf import ProbeConfig as RefProbe
from repro.opt import CostModel as RefCost
from repro.opt import LoweringAdvisor as RefAdvisor
from repro.opt import StatsStore as RefStats
from repro.opt import bucket_of as ref_bucket_of
from repro_torch.api import ExecutionHints, connect
from repro_torch.core.schema import Metric
from repro_torch.data import make_laion_catalog
from repro_torch.index import ivf_from_numpy
from repro_torch.index.ivf import ProbeConfig
from repro_torch.opt import (CostModel, LoweringAdvisor, StatsStore,
                             bucket_of)
from repro_torch.opt import cost as cost_mod
from repro_torch.opt.stats import N_BUCKETS
from repro_torch.serving import BatchScheduler

SMALL = dict(n_rows=1200, n_queries=4, dim=16, n_modes=8, num_categories=4,
             seed=0)
FIELDS = ("centroids", "lists", "list_sizes", "radii", "centroid_sq")
PROBE = dict(max_probes=16, capacity=128, termination="bound", probe_batch=2)
TOL = 1e-5
CONSTS = dict(int8_speedup=1.67, bf16_speedup=1.41, ivf_gather_penalty=2.0,
              rescore_factor=3, headroom=1.25)

Q1 = ("SELECT sample_id FROM products WHERE price < ${p} "
      "ORDER BY DISTANCE(embedding, ${qv}) LIMIT 4")
Q2 = ("SELECT sample_id FROM images "
      "WHERE DISTANCE(embedding, ${qv}) <= ${r} AND capture_date > ${d}")
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
 AND movies.release_year >= ${y}
) AS ranked WHERE ranked.rank <= 4
"""
Q5 = """
SELECT qid, category FROM (
 SELECT sample_id AS qid, calorie_level AS category,
 RANK() OVER (PARTITION BY calorie_level
   ORDER BY DISTANCE(embedding, ${qv})) AS rank
 FROM recipes WHERE DISTANCE(embedding, ${qv}) <= ${r}
) AS ranked WHERE ranked.rank <= 3
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
CASES = {"q1": Q1, "q2": Q2, "q3": Q3, "q4": Q4, "q5": Q5, "q6": Q6}
INDEXED = ("laion", "products", "images", "recipes", "movies")


def _carry(ref_idx):
    fields = {f: np.asarray(getattr(ref_idx, f)) for f in FIELDS}
    fields.update(nlist=ref_idx.nlist, cap=ref_idx.cap)
    return ivf_from_numpy(fields, Metric.INNER_PRODUCT, "cpu")


def _build(seed: int = 0):
    """The two catalogs with one index, registered in the same order on
    both (so their version clocks agree)."""
    ref_cat = ref_make_catalog(**SMALL)
    cat = make_laion_catalog(**SMALL, device="cpu")
    ref_idx = ref_build_ivf(jax.random.key(seed), ref_cat.table("laion")["vec"],
                            nlist=16, metric=RefMetric.INNER_PRODUCT, iters=3)
    idx = _carry(ref_idx)
    for name in INDEXED:
        for col in ("vec", "embedding"):
            ref_cat.register_index(name, col, ref_idx)
            cat.register_index(name, col, idx)
    return ref_cat, cat


@pytest.fixture(scope="module")
def env():
    ref_cat, cat = _build()
    sims = (cat.table("queries")["embedding"].numpy()
            @ cat.table("laion")["vec"].numpy().T)
    radius = float(np.median(np.partition(sims, -30, axis=1)[:, -30]))
    return ref_cat, cat, radius


def _qvecs(cat, qn: int) -> np.ndarray:
    base = np.asarray(cat.table("queries")["embedding"])
    rng = np.random.default_rng(3)
    reps = -(-qn // base.shape[0])
    qs = np.tile(base, (reps, 1))[:qn]
    return (qs + 0.01 * rng.standard_normal(qs.shape)).astype(np.float32)


def _binds_for(case: str, cat, radius: float, qn: int, seed: int = 7) -> dict:
    """The reference test's binds (``tests/test_opt.py``)."""
    rng = np.random.default_rng(seed)
    price = np.asarray(cat.table("laion")["price"])
    dates = np.asarray(cat.table("laion")["capture_date"])
    if case == "q1":
        return {"qv": _qvecs(cat, qn),
                "p": np.quantile(price, rng.uniform(0.3, 1.0, qn)).astype(
                    np.float32)}
    if case == "q2":
        return {"qv": _qvecs(cat, qn),
                "r": (radius * rng.uniform(0.95, 1.0, qn)).astype(
                    np.float32),
                "d": np.quantile(dates, rng.uniform(0.2, 0.8, qn)).astype(
                    np.int32)}
    if case in ("q3", "q6"):
        return {"r": (radius * rng.uniform(0.95, 1.0, qn)).astype(
            np.float32)}
    if case == "q4":
        years = np.asarray(cat.table("movies")["release_year"])
        return {"y": np.quantile(years, rng.uniform(0.1, 0.6, qn)).astype(
            np.int32)}
    if case == "q5":
        return {"qv": _qvecs(cat, qn),
                "r": (radius * rng.uniform(0.95, 1.0, qn)).astype(
                    np.float32)}
    raise ValueError(case)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _bitwise(a: dict, b: dict, ctx: str = "") -> None:
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys(), ctx
    for k in la:
        assert torch.equal(la[k], lb[k]), f"{ctx}: {k}"


def _close_to_ref(port: dict, ref: dict, ctx: str = "") -> None:
    lp, lr = dict(_leaves(port)), dict(_leaves(ref))
    assert lp.keys() == lr.keys(), ctx
    for k in lp:
        p, r = lp[k].numpy(), np.asarray(lr[k])
        if np.issubdtype(p.dtype, np.floating):
            np.testing.assert_allclose(p, r, atol=TOL, rtol=0,
                                       err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_array_equal(p, r, err_msg=f"{ctx} {k}")


def _opts(case: str) -> dict:
    opts = dict(engine="chase")
    if case in ("q3", "q6"):
        opts["max_pairs"] = 64
    return opts


def _dbs(ref_cat, cat, case: str = "q1", **kw):
    """A port and a reference adaptive session, each advisor on the same
    explicit constants."""
    db = connect(cat, adaptive=True, probe=ProbeConfig(**PROBE),
                 **_opts(case), **kw)
    ref_db = ref_connect(ref_cat, adaptive=True, probe=RefProbe(**PROBE),
                         **_opts(case), **kw)
    db.advisor.cost = CostModel(**CONSTS)
    ref_db.advisor.cost = RefCost(**CONSTS)
    return db, ref_db


def _summary(opt: dict) -> dict:
    return {k: v for k, v in opt.items() if k != "plan"}


# ---------------------------------------------------------------------------
# StatsStore
# ---------------------------------------------------------------------------

def test_bucket_of_matches_reference_over_a_grid():
    sels = np.concatenate([np.linspace(0.0, 1.0, 401),
                           np.logspace(-12, 0, 200), [0.5, 0.25, 2.0]])
    assert [bucket_of(s) for s in sels] == [ref_bucket_of(s) for s in sels]
    assert bucket_of(1e-6) == N_BUCKETS - 1 and bucket_of(0.6) == 0


def _observe_sequence(store):
    v = ((("table", "laion"), 3),)
    store.observe("plan-a", 2, v, selectivity=0.1,
                  probes=np.array([3, 5, 9]), rows=120.0, latency_ms=1.5)
    store.observe("plan-a", 2, v, selectivity=0.12,
                  probes=np.array([4, 4, 4]), rows=100.0, latency_ms=1.1)
    store.observe("plan-b", 0, (7, 9), selectivity=0.9,
                  probes=np.array([1.0]), rows=5.5, latency_ms=0.25)
    store.observe_left("plan-c", v, np.array([[2, 8], [3, 5]]))
    store.observe_left("plan-c", v, np.array([[1, 1], [6, 2]]))
    return v


def test_stats_json_byte_identical_and_cross_loaded(tmp_path):
    port, ref = StatsStore(), RefStats()
    v = _observe_sequence(port)
    _observe_sequence(ref)
    assert port.to_json() == ref.to_json()
    port.save(str(tmp_path / "port.json"))
    ref.save(str(tmp_path / "ref.json"))
    from_ref, from_port = (StatsStore.load(str(tmp_path / "ref.json")),
                           RefStats.load(str(tmp_path / "port.json")))
    assert from_ref.to_json() == from_port.to_json() == ref.to_json()
    assert from_ref.lookup("plan-a", 2, v) == ref.lookup("plan-a", 2, v)
    np.testing.assert_array_equal(from_ref.left_profile("plan-c", v),
                                  ref.left_profile("plan-c", v))


def test_stats_version_invalidation():
    store = StatsStore()
    v1, v2 = (1,), (2,)
    store.observe("p", 0, v1, selectivity=1.0, probes=np.array([5]))
    assert store.lookup("p", 0, v1) is not None
    assert store.lookup("p", 0, v2) is None
    assert store.lookup("p", 0, v1) is None
    store.observe_left("p", v1, np.array([[4, 6]]))
    assert store.left_profile("p", v1) is not None
    assert store.left_profile("p", v2) is None


def test_advisor_invalidates_on_catalog_bump(env):
    ref_cat, cat, radius = env
    local_ref, local = _build()
    db, ref_db = _dbs(local_ref, local)
    st, ref_st = db.prepare(Q1), ref_db.prepare(Q1)
    binds = _binds_for("q1", cat, radius, 4)
    for _ in range(2):
        rep, ref_rep = (st.execute(binds).explain(),
                        ref_st.execute(binds).explain())
    assert rep.opt["source"] == ref_rep.opt["source"] == "stats"
    assert (db.advisor.version_token(st.compiled)
            == ref_db.advisor.version_token(ref_st.compiled))
    ref_idx2 = ref_build_ivf(jax.random.key(1), local_ref.table("laion")["vec"],
                             nlist=16, metric=RefMetric.INNER_PRODUCT,
                             iters=2)
    local_ref.register_index("products", "embedding", ref_idx2)
    local.register_index("products", "embedding", _carry(ref_idx2))
    assert st.execute(binds).explain().opt["source"] == "cold"
    assert ref_st.execute(binds).explain().opt["source"] == "cold"


# ---------------------------------------------------------------------------
# CostModel
# ---------------------------------------------------------------------------

def test_cost_model_matches_reference_over_a_grid():
    port, ref = CostModel(**CONSTS), RefCost(**CONSTS)
    for n in (1_000, 10_000, 1_000_000):
        for k in (1, 10, 50):
            for sel in (1.0, 0.3, 0.05, 1e-4):
                for cl in (None, 100.0, 3900.0):
                    for modes in ((), ("int8",), ("int8", "bf16")):
                        kw = dict(n_rows=n, k=k, selectivity=sel,
                                  cluster_rows=cl, quant_modes=modes)
                        s = port.score(**kw)
                        assert s == ref.score(**kw)
                        assert port.choose(s) == ref.choose(s)
                        kw["expected_probes"] = 7.5
                        assert port.score(**kw) == ref.score(**kw)
            assert (port.expected_probes(sel, min_probes=k, max_probes=64)
                    == ref.expected_probes(sel, min_probes=k, max_probes=64))
    for hi in (0.0, 0.5, 3.2, 8.0, 100.0):
        for floor, ceiling in ((1, 16), (3, 16), (9, 64)):
            assert (port.probe_budget(hi, floor=floor, ceiling=ceiling)
                    == ref.probe_budget(hi, floor=floor, ceiling=ceiling))


def test_from_bench_reads_the_same_files(tmp_path):
    (tmp_path / "BENCH_quant.json").write_text(json.dumps(
        {"speedup_b64": {"int8": 1.9, "bf16": 1.3}, "rescore_factor": 4}))
    (tmp_path / "BENCH_batch.json").write_text(json.dumps({"workloads": {
        "flat": [{"batch": 64, "ms": 3.0, "distance_evals_per_query": 1e6}],
        "ivf": [{"batch": 64, "ms": 40.0,
                 "distance_evals_per_query": 3e4}]}}))
    (tmp_path / "BENCH_sched.json").write_text(json.dumps(
        {"effort": {"speedup": 1.4}}))
    port, ref = (CostModel.from_bench(str(tmp_path)),
                 RefCost.from_bench(str(tmp_path)))
    assert port.describe() == ref.describe()
    assert port.describe()["sources"] == ["BENCH_quant.json",
                                          "BENCH_batch.json",
                                          "BENCH_sched.json"]
    empty = tmp_path / "empty"
    empty.mkdir()
    assert CostModel.from_bench(str(empty)).describe()["sources"] == []


def test_bare_cost_model_reads_no_bench_file(monkeypatch):
    def refuse(root, name):
        raise AssertionError(f"read {name} under {root}")

    monkeypatch.setattr(cost_mod, "_read_json", refuse)
    for model in (CostModel(), CostModel.from_bench()):
        d = model.describe()
        assert d["int8_speedup"] == cost_mod.CARD_DEFAULTS["int8_speedup"]
        assert d["bf16_speedup"] == cost_mod.CARD_DEFAULTS["bf16_speedup"]
        assert d["ivf_gather_penalty"] == cost_mod.CARD_DEFAULTS[
            "ivf_gather_penalty"]
        assert d["rescore_factor"] == 3 and d["headroom"] == 1.25
        assert d["sources"] == [cost_mod.CARD_SOURCE]
        assert "H100" in d["sources"][0]
    # the card's constants: a quantized scan is no faster than fp32, and a
    # probed row costs far more than a streamed flat row
    s = CostModel().score(n_rows=1_000_000, k=50, cluster_rows=3906.0,
                          quant_modes=("int8", "bf16"))
    assert CostModel().choose(s) == "flat"


# ---------------------------------------------------------------------------
# advisor decisions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["q1", "q3"])
def test_decision_streams_match_reference(env, case):
    ref_cat, cat, radius = env
    db, ref_db = _dbs(ref_cat, cat, case)
    st, ref_st = db.prepare(CASES[case]), ref_db.prepare(CASES[case])
    got, want = [], []
    for i in range(4):
        binds = _binds_for(case, cat, radius, 4, seed=i)
        got.append(_summary(st.execute(binds).explain().opt))
        want.append(_summary(ref_st.execute(binds).explain().opt))
    assert got == want
    assert {d["source"] for d in got} >= {"cold"}
    assert len({d["source"] for d in got}) > 1


def test_advisor_decisions_deterministic(env):
    _ref_cat, cat, radius = env

    def run():
        db = connect(cat, adaptive=True, engine="chase",
                     probe=ProbeConfig(**PROBE))
        st = db.prepare(Q1)
        return [st.execute(_binds_for("q1", cat, radius, 4,
                                      seed=i)).explain().opt
                for i in range(4)]

    assert run() == run()


@pytest.mark.parametrize("case", sorted(CASES))
def test_adaptive_bit_parity_inside_the_port(env, case):
    """Advised executions, cold and warmed, equal the plain bucketed path
    and the exact-shape batch bit for bit."""
    _ref_cat, cat, radius = env
    opts = dict(probe=ProbeConfig(**PROBE), **_opts(case))
    ast, pst = (connect(cat, adaptive=True, **opts).prepare(CASES[case]),
                connect(cat, **opts).prepare(CASES[case]))
    binds = _binds_for(case, cat, radius, 4)
    for i in range(3):
        got = ast.execute(binds)
        assert got.explain().path == "opt"
        _bitwise(got.data, pst.execute(binds).data, f"{case}/iter{i}")
    exact = pst.execute(binds, hints=ExecutionHints(exact_shape=True))
    _bitwise(got.data, exact.data, f"{case}/exact")


@pytest.mark.parametrize("case", sorted(CASES))
def test_adaptive_against_reference(env, case):
    """The port's advised run against the reference's: ids, valid lanes,
    counts and counters exact, sims within 1e-5, cold and warmed."""
    ref_cat, cat, radius = env
    db, ref_db = _dbs(ref_cat, cat, case)
    st, ref_st = db.prepare(CASES[case]), ref_db.prepare(CASES[case])
    binds = _binds_for(case, cat, radius, 4)
    for i in range(2):
        got, want = st.execute(binds), ref_st.execute(binds)
        _close_to_ref(got.data, want.data, f"{case}/iter{i}")
        assert (_summary(got.explain().opt)
                == _summary(want.explain().opt)), i


def test_hints_always_beat_advisor(env):
    _ref_cat, cat, radius = env
    db = connect(cat, adaptive=True, engine="chase",
                 probe=ProbeConfig(**PROBE))
    st = db.prepare(Q1)
    binds = _binds_for("q1", cat, radius, 4)
    st.execute(binds)
    for hints in (ExecutionHints(exact_shape=True),
                  ExecutionHints(pilot_budget=5),
                  ExecutionHints(probe_budget=6),
                  ExecutionHints(no_opt=True)):
        rep = st.execute(binds, hints=hints).explain()
        assert rep.path != "opt", hints
        assert rep.opt is None, hints
    ref_cat = env[0]
    ref_st = ref_connect(ref_cat, adaptive=True, engine="chase",
                         probe=RefProbe(**PROBE)).prepare(Q1)
    ref_st.execute(binds)
    assert ref_st.execute(binds, hints=RefHints(no_opt=True)
                          ).explain().path == "bucketed"


def test_no_new_executors_on_the_hot_path(env):
    """Changing predicted budgets ride the runtime probe_budget argument:
    after the first round, further advised executions build nothing."""
    _ref_cat, cat, radius = env
    db = connect(cat, adaptive=True, engine="chase",
                 probe=ProbeConfig(**PROBE))
    st = db.prepare(Q1)
    binds = _binds_for("q1", cat, radius, 4, seed=0)
    for _ in range(2):
        st.execute(binds)
    warm = dict(st.explain().trace_counts)
    pilots = set()
    for i in range(1, 6):
        rep = st.execute(_binds_for("q1", cat, radius, 4, seed=i)).explain()
        assert rep.path == "opt"
        pilots.add(rep.opt.get("pilot"))
    assert dict(st.explain().trace_counts) == warm
    assert pilots != {None}


def test_join_profiles_give_per_left_pilots(env):
    _ref_cat, cat, radius = env
    db = connect(cat, adaptive=True, probe=ProbeConfig(**PROBE),
                 **_opts("q3"))
    st = db.prepare(Q3)
    binds = _binds_for("q3", cat, radius, 2)
    lock = connect(cat, probe=ProbeConfig(**PROBE),
                   **_opts("q3")).prepare(Q3).execute(binds)
    st.execute(binds)                                   # cold: observes
    res = st.execute(binds)
    opt = res.explain().opt
    nleft = cat.table("queries").num_rows
    assert opt["source"] == "profile" and opt["path"] == "effort"
    assert opt["pilot"]["shape"] == [2, nleft]
    _bitwise(res.data, lock.data, "profile pilot")


def test_stats_path_persists_through_connect(env, tmp_path):
    _ref_cat, cat, radius = env
    path = str(tmp_path / "opt_stats.json")
    db = connect(cat, adaptive=True, stats_path=path, engine="chase",
                 probe=ProbeConfig(**PROBE))
    binds = _binds_for("q1", cat, radius, 4)
    db.prepare(Q1).execute(binds)
    db.advisor.save()
    assert os.path.exists(path)
    db2 = connect(cat, adaptive=True, stats_path=path, engine="chase",
                  probe=ProbeConfig(**PROBE))
    rep = db2.prepare(Q1).execute(binds).explain()
    assert rep.opt["source"] in ("stats", "profile")
    assert RefStats.load(path).to_json() == db.advisor.stats.to_json()


def test_advise_surface(env):
    ref_cat, cat, _radius = env
    db = connect(cat, engine="chase", probe=ProbeConfig(**PROBE))
    advice = db.advise(Q1, selectivity=0.1)
    assert {"scores", "recommended", "n_rows", "cost_model"} <= set(advice)
    assert advice["recommended"] in advice["scores"]
    assert advice["n_rows"] == SMALL["n_rows"]
    assert set(advice["scores"]) == {"flat", "ivf"}
    # with equal constants the port scores as the reference
    adb, ref_adb = _dbs(ref_cat, cat)
    got = adb.advise(Q1, selectivity=0.1)
    want = ref_adb.advise(Q1, selectivity=0.1)
    assert got["scores"] == want["scores"]
    assert got["recommended"] == want["recommended"]


def test_serve_drains_through_the_advisor(env):
    _ref_cat, cat, radius = env
    db = connect(cat, adaptive=True, engine="chase",
                 probe=ProbeConfig(**PROBE))
    st = db.prepare(Q1)
    sched = db.serve(st, max_batch=4, max_wait_ms=0.0)
    assert isinstance(sched, BatchScheduler) and sched.advisor is db.advisor
    binds = _binds_for("q1", cat, radius, 8)
    reqs = [{k: v[i] for k, v in binds.items()} for i in range(8)]
    rids = [sched.submit(**r) for r in reqs]
    sched.flush()
    assert len(db.advisor.stats) == 1          # the drains were observed
    direct = connect(cat, engine="chase", probe=ProbeConfig(**PROBE)
                     ).prepare(Q1)
    for i, rid in enumerate(rids):
        want = direct.execute(reqs[4 * (i // 4):4 * (i // 4) + 4])
        got = sched.result(rid)
        for key in ("ids", "sim", "valid"):
            assert torch.equal(got[key], want[key][i % 4]), (i, key)


@pytest.mark.parametrize("engine", ["brute", "chase"])
def test_one_host_copy_per_adaptive_execute(env, monkeypatch, engine):
    """An advised execute reads its counters in one device-to-host copy
    (the probe loops' own syncs aside): one more than the plain bucketed
    execute, two more when phase 2 ran (its heavy rows' counters)."""
    _ref_cat, cat, radius = env
    copies = []
    real = torch.Tensor.cpu

    def counting(self, *a, **kw):
        copies.append(1)
        return real(self, *a, **kw)

    opts = dict(engine=engine, probe=ProbeConfig(**PROBE))
    ast = connect(cat, adaptive=True, **opts).prepare(Q1)
    pst = connect(cat, **opts).prepare(Q1)
    # the first execute samples the predicate column for the sketch (one
    # copy of at most sample_rows values per table version)
    ast.execute(_binds_for("q1", cat, radius, 4, seed=9))
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    for i in range(3):
        binds = _binds_for("q1", cat, radius, 4, seed=i)
        copies.clear()
        pst.execute(binds)
        plain = len(copies)
        copies.clear()
        res = ast.execute(binds)
        heavy = (res.explain().effort or {}).get("n_heavy", 0)
        assert len(copies) - plain == (2 if heavy else 1), (i, heavy)
