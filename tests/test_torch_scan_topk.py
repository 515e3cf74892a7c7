"""The port's fused scan + top-k (plain versions on the CPU) against the
reference's Pallas kernels in interpret mode, on the same numpy inputs.

The single-query form is held against the reference's single-query
``ops.fused_scan_topk`` (the reference's own single and batched kernels
differ by ~1e-7 in sim), the batched form against
``ops.fused_scan_topk_batch``.  Tolerance: 1e-5 on sims and on the key gap
that may reorder a near-tie, for unit-scale fp32 data at D <= 130.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core.schema import Metric as RefMetric
from repro.kernels import ops as ref_ops
from repro_torch.core.schema import Metric
from repro_torch.index.flat import stable_smallest_k
from repro_torch.kernels import ops
from repro_torch.kernels import scan_topk as st
from repro_torch.kernels.scan_topk import (MAX_K, batch_plan, scan_topk,
                                           scan_topk_batch, single_plan)
from repro_torch.testing import assert_topk_close

TOL = 1e-5
METRICS = ["ip", "l2", "cosine"]
MASKS = ["none", "shared", "per_query"]
# (N, D, Q, k): ragged N and D, Q off every tile size, k up to 50
SHAPES = [(2000, 32, 8, 10), (1531, 130, 5, 50), (777, 16, 3, 1)]


def _inputs(seed: int, n: int, d: int, qn: int):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.standard_normal((qn, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return rng, corpus, queries


def _mask(rng, kind: str, qn: int, n: int):
    if kind == "none":
        return None
    if kind == "shared":
        return rng.random(n) < 0.4
    return rng.random((qn, n)) < 0.4


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _ref_result(out) -> dict:
    ids, sims, valid = (np.asarray(v) for v in out)
    return {"ids": ids, "sim": sims, "valid": valid}


def _port_result(out) -> dict:
    ids, sims, valid = out
    assert ids.dtype == torch.int32
    return {"ids": ids, "sim": sims, "valid": valid}


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mask", MASKS)
def test_batch_matches_reference(metric, mask):
    case = METRICS.index(metric) * len(MASKS) + MASKS.index(mask)
    n, d, qn, k = SHAPES[case % len(SHAPES)]
    rng, corpus, queries = _inputs(case, n, d, qn)
    rm = _mask(rng, mask, qn, n)
    qvalid = None if case % 2 else np.arange(qn) < qn - 1   # one pad query
    ref = ref_ops.fused_scan_topk_batch(
        jnp.asarray(corpus), jnp.asarray(queries), k, _j(rm),
        RefMetric(metric), qvalid=_j(qvalid))
    got = ops.fused_scan_topk_batch(_t(corpus), _t(queries), k, _t(rm),
                                    Metric(metric), qvalid=_t(qvalid))
    assert_topk_close(_port_result(got), _ref_result(ref), atol=TOL,
                      tie_tol=TOL)
    if qvalid is not None:
        assert not got[2][-1].any() and (got[0][-1] == -1).all()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mask", ["none", "shared"])
def test_single_matches_reference(metric, mask):
    case = METRICS.index(metric) * 2 + (mask == "shared")
    n, d, _, k = SHAPES[case % len(SHAPES)]
    rng, corpus, queries = _inputs(100 + case, n, d, 1)
    rm = _mask(rng, mask, 1, n)
    ref = ref_ops.fused_scan_topk(jnp.asarray(corpus), jnp.asarray(queries[0]),
                                  k, _j(rm), RefMetric(metric))
    got = ops.fused_scan_topk(_t(corpus), _t(queries[0]), k, _t(rm),
                              Metric(metric))
    assert_topk_close(_port_result(got), _ref_result(ref), atol=TOL,
                      tie_tol=TOL)


@pytest.mark.parametrize("form", ["single", "batch"])
def test_duplicate_rows_break_ties_by_lowest_id(form):
    """Exact duplicates have bitwise-equal keys in both packages, so both
    must rank them lowest id first, across split boundaries too."""
    rng, corpus, queries = _inputs(7, 1300, 24, 3)
    dup = np.arange(40, 1300, 97)                 # spread over many splits
    corpus[dup] = corpus[5]
    queries[:] = corpus[5] + 0.01 * queries
    k = 20
    if form == "single":
        ref = ref_ops.fused_scan_topk(jnp.asarray(corpus),
                                      jnp.asarray(queries[0]), k, None,
                                      RefMetric.INNER_PRODUCT)
        got = ops.fused_scan_topk(_t(corpus), _t(queries[0]), k, None,
                                  Metric.INNER_PRODUCT)
    else:
        ref = ref_ops.fused_scan_topk_batch(jnp.asarray(corpus),
                                            jnp.asarray(queries), k, None,
                                            RefMetric.INNER_PRODUCT)
        got = ops.fused_scan_topk_batch(_t(corpus), _t(queries), k, None,
                                        Metric.INNER_PRODUCT)
    ids = np.asarray(got[0]).reshape(-1, k)
    want = np.sort(np.concatenate([[5], dup]))
    np.testing.assert_array_equal(ids[:, :want.size],
                                  np.broadcast_to(want, (ids.shape[0],
                                                         want.size)))
    np.testing.assert_array_equal(ids, np.asarray(ref[0]).reshape(-1, k))


@pytest.mark.parametrize("form", ["single", "batch"])
def test_k_beyond_live_rows(form):
    rng, corpus, queries = _inputs(11, 900, 20, 4)
    rm = np.zeros(900, bool)
    rm[[3, 250, 251, 899]] = True
    k = 12
    if form == "single":
        ref = ref_ops.fused_scan_topk(jnp.asarray(corpus),
                                      jnp.asarray(queries[0]), k,
                                      jnp.asarray(rm), RefMetric.L2)
        got = ops.fused_scan_topk(_t(corpus), _t(queries[0]), k, _t(rm),
                                  Metric.L2)
    else:
        ref = ref_ops.fused_scan_topk_batch(jnp.asarray(corpus),
                                            jnp.asarray(queries), k,
                                            jnp.asarray(rm), RefMetric.L2)
        got = ops.fused_scan_topk_batch(_t(corpus), _t(queries), k, _t(rm),
                                        Metric.L2)
    assert_topk_close(_port_result(got), _ref_result(ref), atol=TOL,
                      tie_tol=TOL)
    assert int(np.asarray(got[2]).reshape(-1, k).sum(1).max()) == 4


def test_stable_smallest_k_keeps_lax_top_k_tie_order():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 5, size=(16, 300)).astype(np.float32)
    keys[:, ::7] = np.inf
    neg, ref_idx = lax.top_k(-jnp.asarray(keys), 40)
    vals, idx = stable_smallest_k(torch.from_numpy(keys), 40)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))
    assert idx.dtype == torch.int32


def test_stage1_layout_is_sorted_per_split():
    """Each split's list ascends by (key, id) and ids stay in its rows."""
    _, corpus, queries = _inputs(5, 3000, 16, 6)
    k = 7
    keys, ids = scan_topk_batch(_t(corpus), _t(queries), None, None, k,
                                Metric.INNER_PRODUCT)
    _, splits, rows = batch_plan(3000, 6, k)
    assert keys.shape == (6, splits * k)
    kk = keys.reshape(6, splits, k)
    ii = ids.reshape(6, splits, k)
    assert bool((kk[..., 1:] >= kk[..., :-1]).all())
    lo = (torch.arange(splits) * rows)[None, :, None]
    assert bool(((ii >= lo) & (ii < lo + rows)).all())
    blocks, brows = single_plan(3000)
    skeys, sids = scan_topk(_t(corpus), _t(queries[0]), None, k,
                            Metric.INNER_PRODUCT)
    assert skeys.shape == (blocks, k) and blocks * brows >= 3000


def test_wrappers_reject_bad_inputs():
    corpus = torch.zeros((64, 8))
    q = torch.zeros(8)
    with pytest.raises(ValueError, match="k must be"):
        scan_topk(corpus, q, None, MAX_K + 1, Metric.L2)
    with pytest.raises(ValueError, match="k must be"):
        scan_topk_batch(corpus, q[None], None, None, 0, Metric.L2)
    with pytest.raises(ValueError, match="query"):
        scan_topk(corpus, q.double(), None, 4, Metric.L2)
    with pytest.raises(ValueError, match="mask"):
        scan_topk_batch(corpus, q[None], torch.ones((2, 64), dtype=torch.int8),
                        None, 4, Metric.L2)
    with pytest.raises(ValueError, match="contiguous"):
        scan_topk(torch.zeros((8, 64)).T, q, None, 4, Metric.L2)
    with pytest.raises(ValueError, match="runs on cuda"):
        scan_topk(corpus.to("meta"), q.to("meta"), None, 4, Metric.L2)


@pytest.mark.parametrize("metric", METRICS)
def test_oracles_match_reference_and_fused_scan(metric):
    """``kernels/ref.py`` against the reference's oracle, and the fused
    scan (plain versions) against the port's own oracle."""
    from repro.kernels import ref as ref_oracle
    from repro_torch.kernels import ref

    rng, corpus, queries = _inputs(21, 1200, 40, 1)
    rm = _mask(rng, "shared", 1, 1200)
    want = ref_oracle.scan_topk_ref(jnp.asarray(corpus),
                                    jnp.asarray(queries[0]), 25,
                                    jnp.asarray(rm), RefMetric(metric))
    ids, keys, valid = ref.scan_topk_ref(_t(corpus), _t(queries[0]), 25,
                                         _t(rm), Metric(metric))
    got = {"ids": ids, "sim": keys, "valid": valid}
    assert_topk_close(got, {"ids": want[0], "sim": want[1],
                            "valid": want[2]}, atol=TOL, tie_tol=TOL)
    np.testing.assert_allclose(
        ref.keys_ref(_t(corpus), _t(queries[0]), Metric(metric)).numpy(),
        np.asarray(ref_oracle.keys_ref(jnp.asarray(corpus),
                                       jnp.asarray(queries[0]),
                                       RefMetric(metric))), atol=TOL)
    f_ids, f_sims, f_valid = ops.fused_scan_topk(_t(corpus), _t(queries[0]),
                                                 25, _t(rm), Metric(metric))
    oracle_sims = -keys if Metric(metric).is_similarity() else keys
    assert_topk_close({"ids": f_ids, "sim": f_sims, "valid": f_valid},
                      {"ids": ids, "sim": oracle_sims, "valid": valid},
                      atol=TOL, tie_tol=TOL)


# ---------------------------------------------------------------------------
# the batched kernel's launch plan and its plain version under it
# ---------------------------------------------------------------------------

PLAN_QS = [1, 8, 16, 17, 32, 33, 100, 128, 130, 540]
PLAN_NS = [1, 8, 5003, 1_000_000]
PLAN_KS = [1, 50, 128, 129, 256, 257, 600, 1024]


@pytest.mark.parametrize("k", PLAN_KS)
@pytest.mark.parametrize("n", PLAN_NS)
@pytest.mark.parametrize("qn", PLAN_QS)
def test_batch_plan_covers_and_fits(qn, n, k):
    """The plan covers every row with splits of whole row tiles of its
    shape and fits CUDA's grid; the narrow shape takes Q <= 16 and the mid
    one at most 32 queries; the lists (kp = next power of two >= max(k,
    128)) and the staging fit one block's 232,448 bytes; a shape that
    takes more queries is chosen wherever its lists fit."""
    qt, splits, rows = batch_plan(n, qn, k)
    tile = st.BATCH_SHAPES[qt][0]
    kp = st.batch_kp(k)
    assert kp == max(128, 1 << (k - 1).bit_length())
    assert (splits - 1) * rows < n <= splits * rows
    assert rows % tile == 0 and rows >= tile
    assert splits <= 65535 and -(-qn // qt) <= 2**31 - 1    # the grid
    assert st.batch_smem(qt, kp) <= 232_448
    if qn <= 16:
        assert qt == 8
    elif qn <= 32:
        assert qt == (32 if st.batch_smem(32, kp) <= 232_448 else 8)
    else:
        want = next((t for t in (64, 32)
                     if st.batch_smem(t, kp) <= 232_448), 8)
        assert qt == want


def test_batch_plan_main_shapes():
    """Q1's bucket of 128 at K = 50 over 1M rows: the wide shape, 66 splits
    of 15,360 rows, both 64-query tiles in one wave of 132 blocks; buckets
    1 and 8: the narrow shape at two blocks per SM, 245 splits; 17..32
    queries: the mid shape; lists of kp = 256 fit 32 queries but not 64,
    and kp >= 512 only the narrow shape."""
    assert batch_plan(1_000_000, 128, 50) == (64, 66, 15360)
    assert batch_plan(1_000_000, 100, 50) == (64, 66, 15360)
    for qn in (1, 8):
        assert batch_plan(1_000_000, qn, 50) == (8, 245, 4096)
    assert batch_plan(1_000_000, 30, 50)[0] == 32
    assert batch_plan(1_000_000, 100, 200)[0] == 32
    assert batch_plan(1_000_000, 100, 300)[0] == 8
    assert st.batch_smem(64, 128) == 174_848    # Wide::smem_bytes + static


def _ordered(qn: int, n: int, d: int):
    """A corpus whose every row beats the one before it for the query q
    under every metric (t·q + 2(1 − t)·u, u ⊥ q, t rising from 0.5 to 1:
    a larger inner product and cosine, a smaller L2 distance), and q
    repeated ``qn`` times."""
    rng = np.random.default_rng(13)
    q = rng.standard_normal(d).astype(np.float32)
    q /= np.linalg.norm(q)
    u = rng.standard_normal(d).astype(np.float32)
    u -= (u @ q) * q
    u /= np.linalg.norm(u)
    t = np.linspace(0.5, 1.0, n, dtype=np.float32)[:, None]
    corpus = (t * q + 2.0 * (1.0 - t) * u).astype(np.float32)
    return corpus, np.repeat(q[None], qn, 0)


# (N, D, Q, k): every block shape and list length of the plan (the narrow
# shape at kp = 128 and 1,024, the mid one at kp = 128 and 256, the wide
# one at kp = 128), k beyond a split's rows
LARGE_K = [(3000, 16, 5, 1000), (2600, 24, 20, 200), (3100, 16, 40, 200),
           (2900, 20, 40, 50), (2048, 16, 20, 10)]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", range(len(LARGE_K)))
def test_batch_plan_shapes_match_reference(metric, case):
    """The plain version under every block shape and list length of the
    plan, per-query masks and a dead lane, through stage 2, against the
    reference's Pallas kernel."""
    n, d, qn, k = LARGE_K[case]
    rng, corpus, queries = _inputs(30 + case, n, d, qn)
    rm = _mask(rng, "per_query", qn, n)
    qvalid = np.arange(qn) != 1
    ref = ref_ops.fused_scan_topk_batch(
        jnp.asarray(corpus), jnp.asarray(queries), k, jnp.asarray(rm),
        RefMetric(metric), qvalid=jnp.asarray(qvalid))
    got = ops.fused_scan_topk_batch(_t(corpus), _t(queries), k, _t(rm),
                                    Metric(metric), qvalid=_t(qvalid))
    assert_topk_close(_port_result(got), _ref_result(ref), atol=TOL,
                      tie_tol=TOL)
    assert not got[2][1].any()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [50, 1000])
def test_ordered_corpus_matches_reference(metric, k):
    """Rows each beating the one before (on the card every insertion round
    overflows its lists): the plain version through stage 2 gives the
    reference's answer, the last k rows best first."""
    corpus, queries = _ordered(4, 3000, 16)
    ref = ref_ops.fused_scan_topk_batch(jnp.asarray(corpus),
                                        jnp.asarray(queries), k, None,
                                        RefMetric(metric))
    got = ops.fused_scan_topk_batch(_t(corpus), _t(queries), k, None,
                                    Metric(metric))
    assert_topk_close(_port_result(got), _ref_result(ref), atol=TOL,
                      tie_tol=TOL)
    ids = got[0].numpy()
    assert (np.abs(ids - np.arange(2999, 2999 - k, -1)) <= 3).all()


@pytest.mark.parametrize("mask", MASKS)
def test_replayed_reference_is_the_plain_kernel(mask):
    """``scan_topk_batch_replayed`` (the card's bitwise reference: replay
    keys of every pair, masked, each split's best k under ``batch_plan``)
    has the plain version's layout and answer on the CPU, where both take
    the plain keys: per split, the same entries up to near-ties."""
    rng, corpus, queries = _inputs(17, 2000, 24, 20)
    rm = _mask(rng, mask, 20, 2000)
    rm = None if rm is None else _t(rm).to(torch.int8)
    qvalid = torch.ones(20, dtype=torch.int8)
    qvalid[3] = 0
    for k in (7, 200):
        a = (_t(corpus), _t(queries), rm, qvalid, k, Metric.L2)
        got = st.scan_topk_batch_replayed(*a)
        want = st.scan_topk_batch_plain(*a)
        assert got[0].shape == want[0].shape == (20, batch_plan(
            2000, 20, k)[1] * k)
        slab = {"ids": got[1].reshape(-1, k), "sim": got[0].reshape(-1, k),
                "valid": torch.isfinite(got[0].reshape(-1, k))}
        ref = {"ids": want[1].reshape(-1, k), "sim": want[0].reshape(-1, k),
               "valid": torch.isfinite(want[0].reshape(-1, k))}
        assert_topk_close(slab, ref, atol=TOL, tie_tol=TOL)
        assert (got[1][3] == -1).all()                   # the dead query
