"""The port's IVF index and probes against the reference's.

Both packages probe ONE index: the reference builds it with
``build_ivf(jax.random.key(0), ...)`` and ``ivf_from_numpy`` carries its
arrays across, so the probe orders, lists and radii are the same.  Ids,
valid lanes, counts and the ``probes`` / ``distance_evals`` counters must
be equal, sims within 1e-5 (D = 24).  Range radii sit in the middle of
the widest gap between adjacent sims near the target hit count, so no row
lies within fp32 error of the radius.  The port's k-means draws from a
``torch.Generator`` and cannot reproduce JAX's draws: it is tested on its
own, and its ``assign`` and ``build_ivf`` on the reference's centroids.
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
from repro.index.kmeans import assign as ref_assign
from repro_torch.core.schema import Metric
from repro_torch.index import (ProbeConfig, assign, build_ivf,
                               ivf_from_numpy, ivf_range, ivf_range_batch,
                               ivf_topk, ivf_topk_batch, kmeans)
from repro_torch.index import ivf as ivf_mod
from repro_torch.index.kmeans import _lloyd

TOL = 1e-5
N, D, NLIST, QN, K = 3000, 24, 24, 6, 10
FIELDS = ("centroids", "lists", "list_sizes", "radii", "centroid_sq")
METRICS = ("ip", "l2", "cosine")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    modes = rng.standard_normal((16, D)).astype(np.float32)
    x = (modes[rng.integers(0, 16, size=N)]
         + 0.3 * rng.standard_normal((N, D)).astype(np.float32))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    qs = x[rng.integers(0, N, size=QN)] + 0.05 * rng.standard_normal(
        (QN, D)).astype(np.float32)
    return {"x": x.astype(np.float32), "qs": qs.astype(np.float32),
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


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_probe_equal(got, want, what: str):
    """(ids, sims, valid[, count], stats): everything exact but the sims."""
    *arrays, gstats = got
    *ref_arrays, wstats = want
    np.testing.assert_array_equal(_np(arrays[0]), _np(ref_arrays[0]),
                                  err_msg=f"{what}: ids")
    np.testing.assert_array_equal(_np(arrays[2]), _np(ref_arrays[2]),
                                  err_msg=f"{what}: valid")
    valid = _np(arrays[2])
    np.testing.assert_allclose(_np(arrays[1])[valid],
                               _np(ref_arrays[1])[valid], atol=TOL, rtol=0,
                               err_msg=f"{what}: sims")
    if len(arrays) == 4:
        np.testing.assert_array_equal(_np(arrays[3]), _np(ref_arrays[3]),
                                      err_msg=f"{what}: count")
    assert set(gstats) == set(wstats) == {"probes", "distance_evals"}
    for key in gstats:
        np.testing.assert_array_equal(_np(gstats[key]), _np(wstats[key]),
                                      err_msg=f"{what}: {key}")


def _raw(metric: str, x: np.ndarray, q: np.ndarray) -> np.ndarray:
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "l2":
        return ((x64 - q64) ** 2).sum(-1)
    ip = x64 @ q64
    if metric == "cosine":
        ip = ip / (np.linalg.norm(x64, axis=-1) * np.linalg.norm(q64))
    return ip


def _gap_radius(metric: str, x, q, count: int) -> float:
    """A raw radius in the widest gap between adjacent values around the
    ``count``-th best row: about ``count`` hits, none at the edge."""
    raw = np.sort(_raw(metric, x, q))
    if metric != "l2":
        raw = raw[::-1]
    window = raw[max(0, count - 15):count + 15]
    j = int(np.argmax(np.abs(np.diff(window))))
    return float((window[j] + window[j + 1]) / 2)


def _mask(data, kind: str):
    return {"none": None, "shared": data["shared"],
            "per_query": data["per_query"]}[kind]


def _budget(kind: str):
    return {"none": None, "scalar": 3,
            "tuple": np.array([1, 2, 64, 5, 3, 64], np.int32)}[kind]


QVALID = np.array([True, True, True, True, False, False])

# (metric, termination, probe_batch): every combination, each with its own
# mask kind and budget so that all of them meet every metric
CASES = [(m, t, b) for m in METRICS for t in ("counter", "bound")
         for b in (1, 3)]
MASKS = ("none", "shared", "per_query")
BUDGETS = ("none", "scalar", "tuple")


def _case_knobs(i: int):
    return MASKS[i % 3], BUDGETS[(i // 3) % 3]


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["-".join(map(str, c)) for c in CASES])
def test_topk_batch_matches_reference(data, indexes, i):
    metric, term, pb = CASES[i]
    mask_kind, budget_kind = _case_knobs(i)
    ref, idx = indexes[metric]
    mask, budget = _mask(data, mask_kind), _budget(budget_kind)
    kw = dict(termination=term, probe_batch=pb, max_probes=16, min_probes=2,
              stop_after_no_improve=3)
    want = ref_ivf.ivf_topk_batch(
        ref, jnp.asarray(data["x"]), jnp.asarray(data["qs"]), K,
        None if mask is None else jnp.asarray(mask),
        ref_ivf.ProbeConfig(**kw),
        probe_budget=None if budget is None else jnp.asarray(budget),
        qvalid=jnp.asarray(QVALID))
    got = ivf_topk_batch(
        idx, torch.from_numpy(data["x"]), torch.from_numpy(data["qs"]), K,
        None if mask is None else torch.from_numpy(mask), ProbeConfig(**kw),
        probe_budget=budget, qvalid=QVALID)
    _assert_probe_equal(got, want, f"topk {CASES[i]} {mask_kind} "
                                   f"{budget_kind}")
    probes = got[3]["probes"].numpy()
    assert (probes[~QVALID] == 0).all() and not got[2][~QVALID].any()
    if budget is not None:
        # a round of probe_batch clusters may pass the budget by its rest
        assert (probes <= -(-np.asarray(budget) // pb) * pb).all()


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["-".join(map(str, c)) for c in CASES])
def test_range_batch_matches_reference(data, indexes, i):
    metric, term, pb = CASES[i]
    mask_kind, budget_kind = _case_knobs(i + 1)
    ref, idx = indexes[metric]
    mask, budget = _mask(data, mask_kind), _budget(budget_kind)
    radius = np.array([_gap_radius(metric, data["x"], q, 40 + 20 * j)
                       for j, q in enumerate(data["qs"])], np.float32)
    # a buffer below the larger hit counts: the appends past it drop
    kw = dict(termination=term, probe_batch=pb, max_probes=16, min_probes=2,
              out_range_stop=2, capacity=64)
    want = ref_ivf.ivf_range_batch(
        ref, jnp.asarray(data["x"]), jnp.asarray(data["qs"]),
        jnp.asarray(radius), None if mask is None else jnp.asarray(mask),
        ref_ivf.ProbeConfig(**kw),
        probe_budget=None if budget is None else jnp.asarray(budget),
        qvalid=jnp.asarray(QVALID))
    got = ivf_range_batch(
        idx, torch.from_numpy(data["x"]), torch.from_numpy(data["qs"]),
        torch.from_numpy(radius),
        None if mask is None else torch.from_numpy(mask), ProbeConfig(**kw),
        probe_budget=budget, qvalid=QVALID)
    _assert_probe_equal(got, want, f"range {CASES[i]} {mask_kind} "
                                   f"{budget_kind}")
    count = got[3].numpy()
    assert (count[~QVALID] == 0).all()
    if mask_kind == "none" and budget_kind == "none":
        assert count.max() == 64          # some query fills the buffer


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", ["topk", "range"])
def test_single_probes_match_reference_and_batch(data, indexes, metric,
                                                 kind):
    """ivf_topk / ivf_range against the reference's sequential loops
    (their cfg.probe_budget tightens the cluster cap), and each equal bit
    for bit to its row of the batched probe at probe_batch 1."""
    ref, idx = indexes[metric]
    x, xt = jnp.asarray(data["x"]), torch.from_numpy(data["x"])
    mask = data["shared"]
    for q_i, budget in ((0, 0), (1, 3), (2, 0)):
        q = data["qs"][q_i]
        kw = dict(max_probes=12, min_probes=2, probe_budget=budget,
                  probe_batch=3, capacity=48)
        cfg, rcfg = ProbeConfig(**kw), ref_ivf.ProbeConfig(**kw)
        if kind == "topk":
            want = ref_ivf.ivf_topk(ref, x, jnp.asarray(q), K,
                                    jnp.asarray(mask), rcfg)
            got = ivf_topk(idx, xt, torch.from_numpy(q), K,
                           torch.from_numpy(mask), cfg)
            row = ivf_topk_batch(idx, xt, torch.from_numpy(data["qs"]), K,
                                 torch.from_numpy(mask),
                                 dataclasses.replace(cfg, probe_batch=1))
        else:
            radius = np.float32(_gap_radius(metric, data["x"], q, 60))
            want = ref_ivf.ivf_range(ref, x, jnp.asarray(q), radius,
                                     jnp.asarray(mask), rcfg)
            got = ivf_range(idx, xt, torch.from_numpy(q), radius,
                            torch.from_numpy(mask), cfg)
            row = ivf_range_batch(
                idx, xt, torch.from_numpy(data["qs"]), radius,
                torch.from_numpy(mask),
                dataclasses.replace(cfg, probe_batch=1))
        _assert_probe_equal(got, want, f"single {kind} {metric} {q_i}")
        assert got[-1]["probes"].ndim == 0
        for g, r in zip(got[:-1], row[:-1]):
            assert torch.equal(g, r[q_i])
        for key in got[-1]:
            assert torch.equal(got[-1][key], row[-1][key][q_i])


def test_probe_batch_only_improves_the_kth(data, indexes):
    ref, idx = indexes["ip"]
    xt, qs = torch.from_numpy(data["x"]), torch.from_numpy(data["qs"])
    kths = []
    for pb in (1, 2, 4):
        _, sims, valid, stats = ivf_topk_batch(
            idx, xt, qs, K, None, ProbeConfig(probe_batch=pb, max_probes=16))
        assert valid.all()
        kths.append(sims[:, -1])
        # counters advance in cluster units: a whole number of rounds
        assert (stats["probes"] % pb == 0).all() or pb == 1
    assert (kths[1] >= kths[0]).all() and (kths[2] >= kths[0]).all()


def test_budget_freezes_with_best_so_far(data, indexes):
    """A budgeted query stops at its budget with the answer it held
    then: the same as a run whose cluster cap is the budget."""
    _, idx = indexes["l2"]
    xt, qs = torch.from_numpy(data["x"]), torch.from_numpy(data["qs"])
    cfg = ProbeConfig(max_probes=20, min_probes=20)     # never done early
    got = ivf_topk_batch(idx, xt, qs, K, None, cfg, probe_budget=5)
    want = ivf_topk_batch(idx, xt, qs, K, None,
                          dataclasses.replace(cfg, max_probes=5))
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert (got[3]["probes"] == 5).all()
    per_query = np.array([1, 2, 3, 4, 5, 6], np.int32)
    got = ivf_topk_batch(idx, xt, qs, K, None, cfg, probe_budget=per_query)
    np.testing.assert_array_equal(got[3]["probes"].numpy(), per_query)
    cfg_budget = ivf_topk_batch(idx, xt, qs, K, None,
                                dataclasses.replace(cfg, probe_budget=5))
    assert torch.equal(cfg_budget[0], want[0])


@pytest.mark.parametrize("every", [1, 3, 64])
def test_active_check_cadence_changes_nothing(data, indexes, monkeypatch,
                                              every):
    """The host reads ``active.any()`` every few rounds: any cadence gives
    the same answer and counters, and fewer reads with a longer one."""
    _, idx = indexes["cosine"]
    xt, qs = torch.from_numpy(data["x"]), torch.from_numpy(data["qs"])
    cfg = ProbeConfig(max_probes=24, min_probes=2)
    want = ivf_range_batch(idx, xt, qs, 0.9, None, cfg, qvalid=QVALID)
    monkeypatch.setattr(ivf_mod, "ACTIVE_CHECK_EVERY", every)
    ivf_mod.loop_stats.update(rounds=0, syncs=0)
    got = ivf_range_batch(idx, xt, qs, 0.9, None, cfg, qvalid=QVALID)
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    assert torch.equal(got[4]["probes"], want[4]["probes"])
    rounds, syncs = ivf_mod.loop_stats["rounds"], ivf_mod.loop_stats["syncs"]
    last = int(want[4]["probes"].max())
    assert last <= rounds <= 24
    assert syncs == (rounds - 1) // every + (rounds < 24 and rounds % every
                                             == 0)


def test_assign_matches_reference(data):
    """The port's assignment equals the reference's on the same centroids,
    except rows whose two nearest centroids lie within 1e-5."""
    cents = np.asarray(ref_build_ivf(jax.random.key(1),
                                     jnp.asarray(data["x"]), nlist=NLIST,
                                     iters=3).centroids)
    want = np.asarray(ref_assign(jnp.asarray(data["x"]), jnp.asarray(cents),
                                 chunk=1024))
    got = assign(torch.from_numpy(data["x"]),
                 torch.from_numpy(cents.copy()), chunk=700)
    assert got.dtype == torch.int32
    d = ((data["x"][:, None, :].astype(np.float64) - cents[None]) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) > 1e-5
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])


@pytest.mark.parametrize("metric", METRICS)
def test_build_ivf_reproduces_reference_lists(data, indexes, metric):
    ref, carried = indexes[metric]
    got = build_ivf(None, torch.from_numpy(data["x"]), NLIST, Metric(metric),
                    centroids=carried.centroids)
    assert got.metric == Metric(metric)
    assert (got.nlist, got.cap) == (ref.nlist, ref.cap)
    np.testing.assert_array_equal(got.lists.numpy(), np.asarray(ref.lists))
    np.testing.assert_array_equal(got.list_sizes.numpy(),
                                  np.asarray(ref.list_sizes))
    np.testing.assert_allclose(got.radii.numpy(), np.asarray(ref.radii),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got.centroid_sq.numpy(),
                               np.asarray(ref.centroid_sq), atol=TOL, rtol=0)
    for t in (got.lists, got.list_sizes):
        assert t.dtype == torch.int32 and t.device == torch.device("cpu")


def test_build_ivf_fixed_cap(data, indexes):
    ref, carried = indexes["ip"]
    x = torch.from_numpy(data["x"])
    largest = int(np.asarray(ref.list_sizes).max())
    with pytest.raises(ValueError, match="fixed cap"):
        build_ivf(None, x, NLIST, centroids=carried.centroids,
                  cap=largest - 1)
    got = build_ivf(None, x, NLIST, centroids=carried.centroids,
                    cap=ref.cap + 16)
    assert got.cap == ref.cap + 16
    np.testing.assert_array_equal(got.lists.numpy()[:, :ref.cap],
                                  np.asarray(ref.lists))
    assert (got.lists[:, ref.cap:] == -1).all()


def test_kmeans_deterministic_and_trained_on_the_device(data):
    x = torch.from_numpy(data["x"])
    a = kmeans(torch.Generator().manual_seed(3), x, 16, iters=4,
               train_points_per_centroid=64)
    b = kmeans(torch.Generator().manual_seed(3), x, 16, iters=4,
               train_points_per_centroid=64)
    c = kmeans(torch.Generator().manual_seed(4), x, 16, iters=4,
               train_points_per_centroid=64)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (16, D) and a.device == x.device
    idx = build_ivf(torch.Generator().manual_seed(3), x, 16, iters=4)
    assert int(idx.list_sizes.sum()) == N
    members = np.sort(idx.lists.numpy()[idx.lists.numpy() >= 0])
    np.testing.assert_array_equal(members, np.arange(N))


def test_lloyd_keeps_dead_centroids():
    """A centroid that wins no point stays where it was; the others move
    to their clusters' means."""
    x = torch.tensor([[0.0, 0.0], [0.0, 1.0], [10.0, 0.0], [10.0, 1.0]])
    init = torch.tensor([[0.0, 0.5], [10.0, 0.5], [0.0, 0.5],
                         [100.0, 100.0]])
    out = _lloyd(x, init, 4, iters=3, chunk=3)
    assert torch.equal(out[2], init[2])        # tied with 0: loses
    assert torch.equal(out[3], init[3])        # far away: empty
    assert torch.allclose(out[0], torch.tensor([0.0, 0.5]))
    assert torch.allclose(out[1], torch.tensor([10.0, 0.5]))


def test_single_probe_counts_and_order(data, indexes):
    """Range hits come in probe discovery order, not key order."""
    _, idx = indexes["ip"]
    xt = torch.from_numpy(data["x"])
    q = torch.from_numpy(data["qs"][0])
    ids, sims, valid, count, stats = ivf_range(
        idx, xt, q, 0.5, None, ProbeConfig(max_probes=8, capacity=4096))
    held = sims[valid]
    assert int(count) == int(valid.sum()) and held.numel() > 0
    assert (held >= 0.5).all()
    assert not bool((held[1:] <= held[:-1]).all())
    assert int(stats["distance_evals"]) <= N
