"""The port's category probe (paper Algorithm 2, updateState) against the
reference's, and the single range probes' stop before the first cluster.

Both packages probe ONE index: the reference builds it with
``build_ivf(jax.random.key(0), ...)`` and ``ivf_from_numpy`` carries its
arrays across.  Ids, valid lanes, counts and the ``probes`` /
``distance_evals`` / ``categories_seen`` counters must be equal, sims
within 1e-5 (D = 24).  Range radii sit in the middle of the widest gap
between adjacent sims near the target hit count, so no row lies within
fp32 error of the radius.  The categories follow the corpus's modes (with
some noise), so the record table converges at different points for
different queries.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.schema import Metric as RefMetric
from repro.index import build_ivf as ref_build_ivf
from repro.index import ivf as ref_ivf
from repro_torch.core.schema import Metric
from repro_torch.index import (ProbeConfig, ivf_from_numpy, ivf_range,
                               ivf_range_batch, ivf_range_category,
                               ivf_range_category_batch)

TOL = 1e-5
N, D, NLIST, QN = 3000, 24, 24, 6
FIELDS = ("centroids", "lists", "list_sizes", "radii", "centroid_sq")
METRICS = ("ip", "l2", "cosine")
QVALID = np.array([True, True, True, True, False, False])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    modes = rng.standard_normal((16, D)).astype(np.float32)
    mode = rng.integers(0, 16, size=N)
    x = modes[mode] + 0.3 * rng.standard_normal((N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    qs = x[rng.integers(0, N, size=QN)] + 0.05 * rng.standard_normal(
        (QN, D)).astype(np.float32)
    noise = rng.random(N) < 0.2
    return {"x": x.astype(np.float32), "qs": qs.astype(np.float32),
            "mode": mode, "noise": noise,
            "noise_cat": rng.integers(0, 8, size=N),
            "shared": rng.random(N) < 0.5,
            "per_query": rng.random((QN, N)) < 0.4}


@pytest.fixture(scope="module")
def indexes(data):
    """metric -> (reference IVFIndex, the port's copy of its arrays)."""
    out = {}
    for m in METRICS:
        ref = ref_build_ivf(jax.random.key(0), jnp.asarray(data["x"]),
                            nlist=NLIST, metric=RefMetric(m), iters=5)
        fields = {f: np.asarray(getattr(ref, f)) for f in FIELDS}
        fields.update(nlist=ref.nlist, cap=ref.cap)
        out[m] = (ref, ivf_from_numpy(fields, Metric(m), "cpu"))
    return out


def _categories(data, C: int) -> np.ndarray:
    """A category per row: its mode's, mostly, so nearby clusters share
    categories and far ones bring new ones."""
    cats = np.where(data["noise"], data["noise_cat"], data["mode"]) % C
    return cats.astype(np.int32)


def _raw(metric: str, x: np.ndarray, q: np.ndarray) -> np.ndarray:
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "l2":
        return ((x64 - q64) ** 2).sum(-1)
    ip = x64 @ q64
    if metric == "cosine":
        ip = ip / (np.linalg.norm(x64, axis=-1) * np.linalg.norm(q64))
    return ip


def _gap_radius(metric: str, x, q, count: int) -> float:
    raw = np.sort(_raw(metric, x, q))
    if metric != "l2":
        raw = raw[::-1]
    window = raw[max(0, count - 15):count + 15]
    j = int(np.argmax(np.abs(np.diff(window))))
    return float((window[j] + window[j + 1]) / 2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_equal(got, want, what: str, keys=None):
    """(ids, sims, valid, count, stats): everything exact but the sims."""
    ids, sims, valid, count, stats = got
    rids, rsims, rvalid, rcount, rstats = want
    np.testing.assert_array_equal(_np(ids), _np(rids), err_msg=f"{what}: ids")
    np.testing.assert_array_equal(_np(valid), _np(rvalid),
                                  err_msg=f"{what}: valid")
    np.testing.assert_array_equal(_np(count), _np(rcount),
                                  err_msg=f"{what}: count")
    v = _np(valid)
    np.testing.assert_allclose(_np(sims)[v], _np(rsims)[v], atol=TOL, rtol=0,
                               err_msg=f"{what}: sims")
    assert set(stats) == set(rstats) == set(
        keys or ("probes", "distance_evals", "categories_seen"))
    for key in stats:
        assert stats[key].dtype == torch.int32, key
        np.testing.assert_array_equal(_np(stats[key]), _np(rstats[key]),
                                      err_msg=f"{what}: {key}")


# (metric, termination, probe_batch): every combination; each case takes
# its own (C, K), mask kind and budget in turn, so every value of each
# meets every metric
CASES = [(m, t, b) for m in METRICS for t in ("counter", "bound")
         for b in (1, 3)]
CK = ((3, 1), (8, 10), (3, 10), (8, 1))
MASKS = ("none", "shared", "per_query")
BUDGETS = ("none", "scalar", "tuple")


def _knobs(i: int):
    return CK[i % 4], MASKS[i % 3], BUDGETS[(i // 3) % 3]


def _mask(data, kind: str):
    return {"none": None, "shared": data["shared"],
            "per_query": data["per_query"]}[kind]


def _budget(kind: str):
    return {"none": None, "scalar": 3,
            "tuple": np.array([1, 2, 64, 5, 3, 64], np.int32)}[kind]


def _radii(metric: str, data) -> np.ndarray:
    return np.array([_gap_radius(metric, data["x"], q, 40 + 25 * j)
                     for j, q in enumerate(data["qs"])], np.float32)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["-".join(map(str, c)) for c in CASES])
def test_category_batch_matches_reference(data, indexes, i):
    metric, term, pb = CASES[i]
    (C, K), mask_kind, budget_kind = _knobs(i)
    ref, idx = indexes[metric]
    mask, budget = _mask(data, mask_kind), _budget(budget_kind)
    cats = _categories(data, C)
    radius = _radii(metric, data)
    # a buffer below the larger hit counts: the appends past it drop
    kw = dict(termination=term, probe_batch=pb, max_probes=16, min_probes=2,
              out_range_stop=2, capacity=64, num_categories=C,
              k_per_category=K, no_new_category_stop=2)
    want = ref_ivf.ivf_range_category_batch(
        ref, jnp.asarray(data["x"]), jnp.asarray(cats),
        jnp.asarray(data["qs"]), jnp.asarray(radius),
        None if mask is None else jnp.asarray(mask),
        ref_ivf.ProbeConfig(**kw),
        probe_budget=None if budget is None else jnp.asarray(budget),
        qvalid=jnp.asarray(QVALID))
    got = ivf_range_category_batch(
        idx, torch.from_numpy(data["x"]), torch.from_numpy(cats),
        torch.from_numpy(data["qs"]), torch.from_numpy(radius),
        None if mask is None else torch.from_numpy(mask), ProbeConfig(**kw),
        probe_budget=budget, qvalid=QVALID)
    what = f"category {CASES[i]} C={C} K={K} {mask_kind} {budget_kind}"
    _assert_equal(got, want, what)
    stats = got[4]
    assert (stats["probes"][~torch.from_numpy(QVALID)] == 0).all()
    assert (stats["categories_seen"] <= C).all()
    assert not got[2][~torch.from_numpy(QVALID)].any()
    if mask_kind == "none" and budget_kind == "none":
        assert int(got[3].max()) == 64    # some query fills the buffer


@pytest.mark.parametrize("metric", METRICS)
def test_updatestate_stops_no_later_than_the_range_probe(data, indexes,
                                                         metric):
    """Algorithm 2 only adds a way to stop: every query probes at most as
    many clusters as the plain range probe, its buffer is that probe's
    prefix, and at this shape some query stops earlier."""
    _, idx = indexes[metric]
    x, qs = torch.from_numpy(data["x"]), torch.from_numpy(data["qs"])
    cats = torch.from_numpy(_categories(data, 3))
    radius = torch.from_numpy(_radii(metric, data))
    cfg = ProbeConfig(max_probes=24, min_probes=1, out_range_stop=6,
                      capacity=4096, num_categories=3, k_per_category=1,
                      no_new_category_stop=1)
    ids, _s, valid, count, stats = ivf_range_category_batch(
        idx, x, cats, qs, radius, None, cfg)
    ids2, _s2, valid2, count2, stats2 = ivf_range_batch(idx, x, qs, radius,
                                                        None, cfg)
    assert (stats["probes"] <= stats2["probes"]).all()
    assert (stats["probes"] < stats2["probes"]).any()
    assert (count <= count2).all()
    for q in range(QN):
        n = int(count[q])
        assert torch.equal(ids[q, :n], ids2[q, :n])


@pytest.mark.parametrize("metric", METRICS)
def test_single_category_probe_matches_reference_and_batch(data, indexes,
                                                           metric):
    """ivf_range_category against the reference's sequential loop (its
    cfg.probe_budget tightens the cluster cap), and equal bit for bit to
    its row of the batched probe at probe_batch 1."""
    ref, idx = indexes[metric]
    x, xt = jnp.asarray(data["x"]), torch.from_numpy(data["x"])
    cats = _categories(data, 8)
    for q_i, budget, mask in ((0, 0, None), (1, 3, data["shared"]),
                              (2, 0, data["shared"])):
        q = data["qs"][q_i]
        kw = dict(max_probes=12, min_probes=2, probe_budget=budget,
                  probe_batch=3, capacity=48, num_categories=8,
                  k_per_category=4)
        cfg, rcfg = ProbeConfig(**kw), ref_ivf.ProbeConfig(**kw)
        radius = np.float32(_gap_radius(metric, data["x"], q, 60))
        want = ref_ivf.ivf_range_category(
            ref, x, jnp.asarray(cats), jnp.asarray(q), radius,
            None if mask is None else jnp.asarray(mask), rcfg)
        got = ivf_range_category(
            idx, xt, torch.from_numpy(cats), torch.from_numpy(q), radius,
            None if mask is None else torch.from_numpy(mask), cfg)
        _assert_equal(got, want, f"single category {metric} {q_i}")
        assert got[-1]["probes"].ndim == 0
        row = ivf_range_category_batch(
            idx, xt, torch.from_numpy(cats), torch.from_numpy(data["qs"]),
            radius, None if mask is None else torch.from_numpy(mask),
            dataclasses.replace(cfg, probe_batch=1))
        for g, r in zip(got[:-1], row[:-1]):
            assert torch.equal(g, r[q_i])
        for key in got[-1]:
            assert torch.equal(got[-1][key], row[-1][key][q_i])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", ["range", "category"])
def test_single_probes_stop_before_the_first_cluster(data, indexes, metric,
                                                     kind):
    """At min_probes 0 under 'bound' with no reachable hit, the reference's
    single probes test their condition before the first cluster and stop
    at 0 probes and 0 evals; its batched probes run round 0.  The port's
    do the same."""
    ref, idx = indexes[metric]
    x, xt = jnp.asarray(data["x"]), torch.from_numpy(data["x"])
    q = data["qs"][0]
    # a radius no row can reach: similarity 1e6, or an L2 distance below 0
    radius = np.float32(-1.0 if metric == "l2" else 1e6)
    kw = dict(termination="bound", min_probes=0, max_probes=NLIST,
              capacity=32, num_categories=8, k_per_category=2)
    cfg, rcfg = ProbeConfig(**kw), ref_ivf.ProbeConfig(**kw)
    cats = _categories(data, 8)
    if kind == "range":
        want = ref_ivf.ivf_range(ref, x, jnp.asarray(q), radius, None, rcfg)
        got = ivf_range(idx, xt, torch.from_numpy(q), radius, None, cfg)
        rb = ref_ivf.ivf_range_batch(ref, x, jnp.asarray(q[None]), radius,
                                     None, rcfg)
        gb = ivf_range_batch(idx, xt, torch.from_numpy(q[None]), radius,
                             None, cfg)
        keys = ("probes", "distance_evals")
    else:
        want = ref_ivf.ivf_range_category(ref, x, jnp.asarray(cats),
                                          jnp.asarray(q), radius, None, rcfg)
        got = ivf_range_category(idx, xt, torch.from_numpy(cats),
                                 torch.from_numpy(q), radius, None, cfg)
        rb = ref_ivf.ivf_range_category_batch(
            ref, x, jnp.asarray(cats), jnp.asarray(q[None]), radius, None,
            rcfg)
        gb = ivf_range_category_batch(idx, xt, torch.from_numpy(cats),
                                      torch.from_numpy(q[None]), radius,
                                      None, cfg)
        keys = None
    _assert_equal(got, want, f"single {kind} {metric}", keys)
    assert int(got[4]["probes"]) == 0 and int(got[4]["distance_evals"]) == 0
    assert int(got[3]) == 0 and not got[2].any() and (got[0] == -1).all()
    _assert_equal(gb, rb, f"batch {kind} {metric}", keys)
    assert int(gb[4]["probes"][0]) == 1
    assert int(gb[4]["distance_evals"][0]) > 0


def test_category_probe_needs_categories(data, indexes):
    _, idx = indexes["ip"]
    x, qs = torch.from_numpy(data["x"]), torch.from_numpy(data["qs"])
    cats = torch.from_numpy(_categories(data, 3))
    for fn, q in ((ivf_range_category_batch, qs),
                  (ivf_range_category, qs[0])):
        with pytest.raises(ValueError, match="num_categories"):
            fn(idx, x, cats, q, 0.5, None, ProbeConfig())
