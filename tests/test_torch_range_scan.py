"""The port's fused range scans (plain versions on the CPU) against the
reference's Pallas range kernels in interpret mode, on the same numpy
inputs.

The single-query form is held against the reference's ``fused_range_scan``,
the batched form against ``fused_range_scan_batch`` (``block_n=128``,
``block_q=8``, as the reference's own tests run them) and the compaction
against ``fused_range_topk_batch``.  Radii lie strictly inside the widest
gap between adjacent keys near the target rank, so fp32 summation order
cannot flip a hit: hits and counts must be exactly equal, raw sims on the
hits agree to 1e-5 (unit-scale fp32 data at D <= 130).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.schema import Metric as RefMetric
from repro.kernels import ops as ref_ops
from repro_torch.core.schema import Metric
from repro_torch.index.flat import compact_range
from repro_torch.kernels import ops
from repro_torch.kernels import range_scan as rs
from repro_torch.kernels.distance import MAX_GRID_Y
from repro_torch.kernels.range_scan import (batch_plan, range_scan,
                                            range_scan_batch)
from repro_torch.kernels.scan_topk import BLOCK_SMEM, SM_COUNT

TOL = 1e-5
METRICS = ["ip", "l2", "cosine"]
MASKS = ["none", "shared", "per_query"]
# (N, D, Q): ragged N and D, Q off every tile size
SHAPES = [(2000, 32, 8), (1531, 130, 5), (777, 16, 3)]
REF_BLOCKS = dict(block_q=8, block_n=128)


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


def _keys(corpus: np.ndarray, queries: np.ndarray, metric: str):
    """(Q, N) order keys in float64, the reference's formulas."""
    c, q = corpus.astype(np.float64), queries.astype(np.float64)
    ip = q @ c.T
    if metric == "ip":
        return -ip
    if metric == "l2":
        return ((q[:, None, :] - c[None]) ** 2).sum(-1)
    return -ip / (np.linalg.norm(q, axis=1)[:, None]
                  * np.linalg.norm(c, axis=1)[None] + 1e-12)


def _tie_safe_radius(keys: np.ndarray, metric: str, rank: int) -> np.ndarray:
    """Per query, a raw radius in the middle of the widest gap between
    adjacent sorted keys around ``rank`` (so about ``rank`` rows hit)."""
    srt = np.sort(keys, axis=1)
    lo = max(0, rank - 15)
    window = srt[:, lo:rank + 15]
    j = np.argmax(np.diff(window, axis=1), axis=1)
    rows = np.arange(srt.shape[0])
    rk = (window[rows, j] + window[rows, j + 1]) / 2.0
    return (-rk if metric != "l2" else rk).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _assert_same_hits(got, ref, what: str) -> None:
    hit, raw, cnt = (np.asarray(v) for v in got)
    r_hit, r_raw, r_cnt = (np.asarray(v) for v in ref)
    np.testing.assert_array_equal(hit, r_hit, err_msg=f"{what}: hits")
    np.testing.assert_array_equal(cnt, r_cnt, err_msg=f"{what}: counts")
    np.testing.assert_allclose(raw[hit], r_raw[r_hit], rtol=0, atol=TOL,
                               err_msg=f"{what}: raw sims on hits")
    assert (raw[~hit] == 0).all()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mask", MASKS)
def test_batch_matches_reference(metric, mask):
    case = METRICS.index(metric) * len(MASKS) + MASKS.index(mask)
    n, d, qn = SHAPES[case % len(SHAPES)]
    rng, corpus, queries = _inputs(case, n, d, qn)
    rm = _mask(rng, mask, qn, n)
    radius = _tie_safe_radius(_keys(corpus, queries, metric), metric,
                              rank=60 + 40 * (case % 3))
    qvalid = None if case % 2 else np.arange(qn) < qn - 1   # one pad query
    ref = ref_ops.fused_range_scan_batch(
        jnp.asarray(corpus), jnp.asarray(queries), jnp.asarray(radius),
        _j(rm), RefMetric(metric), qvalid=_j(qvalid), **REF_BLOCKS)
    got = ops.fused_range_scan_batch(_t(corpus), _t(queries), _t(radius),
                                     _t(rm), Metric(metric),
                                     qvalid=_t(qvalid))
    assert got[0].dtype == torch.bool and got[2].dtype == torch.int32
    _assert_same_hits(got, ref, f"batch {metric} {mask}")
    assert int(got[2].min()) > 0 or qvalid is not None
    if qvalid is not None:
        assert not got[0][-1].any() and int(got[2][-1]) == 0


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mask", ["none", "shared"])
def test_single_matches_reference(metric, mask):
    case = METRICS.index(metric) * 2 + (mask == "shared")
    n, d, _ = SHAPES[case % len(SHAPES)]
    rng, corpus, queries = _inputs(100 + case, n, d, 1)
    rm = _mask(rng, mask, 1, n)
    radius = _tie_safe_radius(_keys(corpus, queries, metric), metric,
                              rank=80)[0]
    ref = ref_ops.fused_range_scan(jnp.asarray(corpus),
                                   jnp.asarray(queries[0]), float(radius),
                                   _j(rm), RefMetric(metric), block_n=128)
    got = ops.fused_range_scan(_t(corpus), _t(queries[0]), float(radius),
                               _t(rm), Metric(metric))
    assert got[2].shape == () and got[2].dtype == torch.int32
    _assert_same_hits(got, ref, f"single {metric} {mask}")


@pytest.mark.parametrize("form", ["single", "batch"])
@pytest.mark.parametrize("extreme", ["nothing", "everything"])
def test_radius_hitting_nothing_or_everything(form, extreme):
    """Radii beyond every key: no hit at all, or every (masked) row."""
    rng, corpus, queries = _inputs(31, 900, 20, 4)
    rm = _mask(rng, "shared", 4, 900)
    radius = 3.0 if extreme == "nothing" else -3.0      # IP: sim >= radius
    if form == "single":
        ref = ref_ops.fused_range_scan(jnp.asarray(corpus),
                                       jnp.asarray(queries[0]), radius,
                                       jnp.asarray(rm),
                                       RefMetric.INNER_PRODUCT, block_n=128)
        got = ops.fused_range_scan(_t(corpus), _t(queries[0]), radius,
                                   _t(rm), Metric.INNER_PRODUCT)
    else:
        ref = ref_ops.fused_range_scan_batch(
            jnp.asarray(corpus), jnp.asarray(queries), radius,
            jnp.asarray(rm), RefMetric.INNER_PRODUCT, **REF_BLOCKS)
        got = ops.fused_range_scan_batch(_t(corpus), _t(queries), radius,
                                         _t(rm), Metric.INNER_PRODUCT)
    _assert_same_hits(got, ref, f"{form} hits {extreme}")
    want = 0 if extreme == "nothing" else int(rm.sum())
    assert (np.asarray(got[2]) == want).all()


@pytest.mark.parametrize("capacity,mask", [(16, "per_query"), (40, "none"),
                                           (700, "shared")])
def test_range_topk_batch_matches_reference(capacity, mask):
    """Compaction to a fixed buffer: best hits first, lowest id on equal
    keys, and the count before truncation (capacity 16 < every count,
    700 > every count)."""
    rng, corpus, queries = _inputs(41, 777, 24, 5)
    corpus[100:130] = corpus[7]                    # exact duplicates: ties
    queries[0] = corpus[7]
    rm = _mask(rng, mask, 5, 777)
    radius = _tie_safe_radius(_keys(corpus, queries, "ip"), "ip", rank=90)
    qvalid = np.arange(5) != 2
    ref = ref_ops.fused_range_topk_batch(
        jnp.asarray(corpus), jnp.asarray(queries), jnp.asarray(radius),
        _j(rm), RefMetric.INNER_PRODUCT, capacity, qvalid=jnp.asarray(qvalid),
        **REF_BLOCKS)
    got = ops.fused_range_topk_batch(_t(corpus), _t(queries), _t(radius),
                                     _t(rm), Metric.INNER_PRODUCT, capacity,
                                     qvalid=_t(qvalid))
    ids, sims, valid, count = (np.asarray(v) for v in got)
    r_ids, r_sims, r_valid, r_count = (np.asarray(v) for v in ref)
    assert got[0].dtype == torch.int32 and ids.shape == (5, capacity)
    np.testing.assert_array_equal(count, r_count)
    np.testing.assert_array_equal(valid, r_valid)
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_allclose(sims, r_sims, rtol=0, atol=TOL)
    np.testing.assert_array_equal(valid.sum(1), np.minimum(count, capacity))
    if capacity == 16:
        assert (count[qvalid] > capacity).all()
    if capacity == 700:
        assert (count < capacity).all()
    assert count[2] == 0 and (ids[2] == -1).all()


def test_batch_rows_equal_single_query_scans():
    """Each query of the batched scan equals the single-query scan of that
    query alone (the reference's test_range_scan_batch_matches_single)."""
    rng, corpus, queries = _inputs(51, 700, 40, 5)
    per_q = _mask(rng, "per_query", 5, 700)
    radius = _tie_safe_radius(_keys(corpus, queries, "l2"), "l2", rank=100)
    hit, raw, cnt = ops.fused_range_scan_batch(
        _t(corpus), _t(queries), _t(radius), _t(per_q), Metric.L2)
    for qi in range(5):
        shit, sraw, scnt = ops.fused_range_scan(
            _t(corpus), _t(queries[qi]), float(radius[qi]), _t(per_q[qi]),
            Metric.L2)
        assert torch.equal(hit[qi], shit) and int(cnt[qi]) == int(scnt)
        np.testing.assert_allclose(raw[qi][hit[qi]], sraw[shit], rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("metric", METRICS)
def test_oracle_matches_reference(metric):
    """``kernels/ref.py`` ``range_scan_ref`` against the reference's
    oracle, and the fused scan against the port's own oracle."""
    from repro.kernels import ref as ref_oracle
    from repro_torch.kernels import ref

    rng, corpus, queries = _inputs(61, 1200, 40, 1)
    rm = _mask(rng, "shared", 1, 1200)
    radius = _tie_safe_radius(_keys(corpus, queries, metric), metric,
                              rank=70)[0]
    rk = float(-radius if metric != "l2" else radius)
    w_hit, w_keys = ref_oracle.range_scan_ref(
        jnp.asarray(corpus), jnp.asarray(queries[0]), rk, jnp.asarray(rm),
        RefMetric(metric))
    hit, keys = ref.range_scan_ref(_t(corpus), _t(queries[0]), rk, _t(rm),
                                   Metric(metric))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(w_hit))
    np.testing.assert_allclose(keys.numpy(), np.asarray(w_keys), rtol=0,
                               atol=TOL)
    f_hit, _raw, f_cnt = ops.fused_range_scan(_t(corpus), _t(queries[0]),
                                              float(radius), _t(rm),
                                              Metric(metric))
    assert torch.equal(f_hit, hit) and int(f_cnt) == int(hit.sum())


# ---------------------------------------------------------------------------
# the batched kernel's launch plan and its bitwise reference
# ---------------------------------------------------------------------------

PLAN_QS = [1, 2, 8, 16, 17, 32, 33, 64, 100, 128, 130, 400]
PLAN_NS = [1, 127, 128, 5003, 1_000_000, 1_000_003]


@pytest.mark.parametrize("n", PLAN_NS)
@pytest.mark.parametrize("qn", PLAN_QS)
def test_batch_plan_covers_and_fits(qn, n):
    """The plan covers every row once with splits of whole row tiles of
    its shape, keeps the grid within CUDA's limits and one wave of the
    card's SMs (at most two blocks each), fits the shape's
    shared memory in one block, and takes the narrow shape up to 16
    queries, the mid one up to 32 and the 128-query one beyond (buckets 64
    and 128 in one query tile)."""
    qt, splits, rows = batch_plan(n, qn)
    tile = rs.BATCH_SHAPES[qt][0]
    assert (splits - 1) * rows < n <= splits * rows
    assert rows % tile == 0 and rows >= tile
    assert 1 <= splits <= MAX_GRID_Y and -(-qn // qt) <= 2**31 - 1
    assert -(-qn // qt) * splits <= 2 * SM_COUNT        # one wave
    assert rs.batch_smem(qt) <= BLOCK_SMEM
    assert qt == (8 if qn <= 16 else 32 if qn <= 32 else 128)
    if qn in (64, 128):
        assert qt == 128 and -(-qn // qt) == 1



def test_batch_plan_main_shapes():
    """Q2's bucket of 128 over 1M rows: the wide shape, 131 splits of 7,680
    rows, one wave of 132 SMs at one block each; bucket 8: the narrow
    shape at two blocks per SM, 245 splits; bucket 32: the mid shape."""
    assert batch_plan(1_000_000, 128) == (128, 131, 7680)
    assert batch_plan(1_000_000, 100) == (128, 131, 7680)
    assert batch_plan(1_000_000, 64) == (128, 131, 7680)
    for qn in (1, 8):
        assert batch_plan(1_000_000, qn) == (8, 245, 4096)
    assert batch_plan(1_000_000, 32) == (32, 261, 3840)
    assert rs.batch_smem(128) == 4 * (2 * 16 * 256 + 128) + 16 * 128
    with pytest.raises(ValueError, match="N, Q >= 1"):
        batch_plan(0, 8)


def test_batch_shapes_mirror_the_kernel():
    """``BATCH_SHAPES`` holds the kernel's ``Wide``, ``Mid`` and
    ``Narrow`` shapes: (queries, rows, columns per chunk, blocks per
    SM).  They live in the tile header that the kernel includes."""
    csrc = Path(rs.__file__).with_name("csrc")
    assert '#include "range_tile.cuh"' in (
        csrc / "range_scan_batch.cu").read_text()
    src = (csrc / "range_tile.cuh").read_text()
    shapes = {}
    for m in re.finditer(r"using (Wide|Mid|Narrow) = Shape<([^>]*)>;", src):
        bq, br, _qm, _rm, _lr, bk, minb = (int(v) for v in
                                           m.group(2).split(","))
        shapes[bq] = (br, bk, minb)
    assert shapes == rs.BATCH_SHAPES


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mask", MASKS)
def test_replayed_oracle_matches_plain_and_reference(metric, mask):
    """``range_scan_batch_replayed`` (the card's bitwise reference: replay
    keys of every pair, then the mask, the valid lane and the radius) has
    the plain version's hits and counts, and its keys within 1e-5, on the
    CPU; and it gives the reference's Pallas kernel's answer (interpret
    mode), with the last query a dead lane."""
    case = METRICS.index(metric) * len(MASKS) + MASKS.index(mask)
    n, d, qn = SHAPES[case % len(SHAPES)]
    rng, corpus, queries = _inputs(70 + case, n, d, qn)
    rm = _mask(rng, mask, qn, n)
    radius = _tie_safe_radius(_keys(corpus, queries, metric), metric,
                              rank=50 + 30 * (case % 3))
    qvalid = np.arange(qn) < qn - 1
    m = Metric(metric)
    rk = ops._radius_keys(_t(radius), m, qn, torch.device("cpu"))
    a = (_t(corpus), _t(queries), rk,
         None if rm is None else _t(rm).to(torch.int8),
         _t(qvalid).to(torch.int8))
    keys, hits, counts = rs.range_scan_batch_replayed(*a, m)
    p_keys, p_hits, p_counts = rs.range_scan_batch_plain(*a, m)
    assert keys.dtype == torch.float32 and hits.dtype == torch.int8
    assert torch.equal(hits, p_hits) and torch.equal(counts, p_counts)
    assert torch.equal(torch.isinf(keys), torch.isinf(p_keys))
    live = torch.isfinite(keys)
    np.testing.assert_allclose(keys[live].numpy(), p_keys[live].numpy(),
                               rtol=0, atol=TOL)
    assert not hits[-1].any() and int(counts[-1]) == 0
    ref = ref_ops.fused_range_scan_batch(
        jnp.asarray(corpus), jnp.asarray(queries), jnp.asarray(radius),
        _j(rm), RefMetric(metric), qvalid=_j(qvalid), **REF_BLOCKS)
    hit = hits.bool()
    _assert_same_hits((hit, ops._raw(keys, hit, m), counts), ref,
                      f"replayed {metric} {mask}")


def test_wrappers_reject_bad_inputs():
    corpus = torch.zeros((64, 8))
    q = torch.zeros(8)
    rk = torch.zeros(1)
    with pytest.raises(ValueError, match="radius_key"):
        range_scan(corpus, q, rk.double(), None, Metric.L2)
    with pytest.raises(ValueError, match="radius_keys"):
        range_scan_batch(corpus, q[None], torch.zeros(2), None, None,
                         Metric.L2)
    with pytest.raises(ValueError, match="mask"):
        range_scan_batch(corpus, q[None], rk, torch.ones((2, 64),
                                                         dtype=torch.int8),
                         None, Metric.L2)
    with pytest.raises(ValueError, match="qvalid"):
        range_scan_batch(corpus, q[None], rk, None,
                         torch.ones(1, dtype=torch.bool), Metric.L2)
    with pytest.raises(ValueError, match="contiguous"):
        range_scan(torch.zeros((8, 64)).T, q, rk, None, Metric.L2)
    with pytest.raises(ValueError, match="runs on cuda"):
        range_scan_batch(corpus.to("meta"), q[None].to("meta"),
                         rk.to("meta"), None, None, Metric.L2)


# ---------------------------------------------------------------------------
# the compaction on the card's path (range_topk_batch: the append epilogue
# and the per-query sort) against compact_range over the dense keys
# ---------------------------------------------------------------------------

def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_bitwise(got, want, rows, what: str) -> None:
    for name, a, b in zip(("ids", "sims", "valid", "counts"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        assert torch.equal(_bits(a)[rows], _bits(b)[rows]), (what, name)


def _dense_compaction(corpus, queries, rk, m8, qv8, metric, capacity):
    keys, _hits, counts = range_scan_batch(corpus, queries, rk, m8, qv8,
                                           metric)
    return compact_range(keys, capacity, metric) + (counts,)


# capacities against the counts (about 90 hits a live query, 777 rows):
# below every count (each live query takes the dense fallback), above
# every count, and above N
CAPACITIES = [16, 300, 1000]


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("metric", METRICS)
def test_append_compaction_is_the_dense_sort_bit_for_bit(metric, mask,
                                                         capacity):
    """``range_topk_batch`` (plain) equals ``compact_range`` of the dense
    keys bit for bit on every query whose count fits, and leaves the
    others empty with their full count; ``fused_range_topk_batch`` equals
    it on every query, raising ``range_overflows`` once per query past
    the capacity.  Duplicate rows give equal keys; lane 2 is a pad
    query."""
    from repro_torch import tracing

    m = Metric(metric)
    rng, corpus, queries = _inputs(43, 777, 24, 5)
    corpus[100:130] = corpus[7]                    # exact duplicates: ties
    queries[0] = corpus[7]
    rm = _mask(rng, mask, 5, 777)
    radius = _tie_safe_radius(_keys(corpus, queries, metric), metric,
                              rank=90)
    qvalid = np.arange(5) != 2
    c, q = _t(corpus), _t(queries)
    rk = ops._radius_keys(_t(radius), m, 5, c.device)
    m8, qv8 = ops._mask_i8(_t(rm)), ops._mask_i8(_t(qvalid))
    want = _dense_compaction(c, q, rk, m8, qv8, m, capacity)
    counts = want[3]
    fits = counts <= capacity
    assert int(counts[2]) == 0 and (counts[qvalid] > 0).all()

    got = rs.range_topk_batch(c, q, rk, m8, qv8, m, capacity)
    _assert_bitwise(got, want, fits, "kernel")
    assert torch.equal(got[3], counts)
    assert (got[0][~fits] == -1).all() and not got[2][~fits].any()
    assert (got[1][~fits] == 0).all()

    before = tracing.snapshot()["counters"]["range_overflows"]
    fused = ops.fused_range_topk_batch(c, q, _t(radius), _t(rm), m,
                                       capacity, qvalid=_t(qvalid))
    over = tracing.snapshot()["counters"]["range_overflows"] - before
    _assert_bitwise(fused, want, slice(None), "fused")
    assert over == int((~fits).sum())
    if capacity == CAPACITIES[0]:
        assert over == int(qvalid.sum())
    else:
        assert over == 0


def _crafted(seed: int, qn: int, n: int):
    """(Q, N) keys drawn from zeros of both signs, infinities, repeated
    values and subnormals, and hit masks with every count from 0 up."""
    g = torch.Generator().manual_seed(seed)
    pool = torch.tensor([0.0, -0.0, 1.5, -1.5, float("inf"), -float("inf"),
                         2.0 ** -140, -(2.0 ** -140), 0.25])
    keys = pool[torch.randint(len(pool), (qn, n), generator=g)]
    hit = torch.zeros((qn, n), dtype=torch.bool)
    for i in range(qn):
        hit[i, torch.randperm(n, generator=g)[:i * 7]] = True
    return g, keys, hit


@pytest.mark.parametrize("order", ["rows", "shuffled"])
@pytest.mark.parametrize("metric", METRICS)
def test_sort_of_appended_hits_keeps_the_stable_sort_ties(metric, order):
    """The sort kernel's plain version over appended words equals the
    stable sort of the dense keys: −0.0 ties +0.0 with the lower row
    first, each sim carries its key's own bits, −inf and +inf hits are
    not valid; the order the slots were filled in (the card's atomics
    choose it) cannot show; a query past the width is empty."""
    m = Metric(metric)
    qn, n, width = 12, 90, 48
    g, keys, hit = _crafted(5, qn, n)
    dense = torch.where(hit, keys, float("inf"))
    perm = (None if order == "rows" else
            torch.stack([torch.randperm(n, generator=g) for _ in range(qn)]))
    words = rs.append_hits_plain(keys, hit, width, perm)
    counts = hit.sum(1, dtype=torch.int32)
    got = rs.sort_hits_plain(words, counts, m) + (counts,)
    want = compact_range(dense, width, m) + (counts,)
    fits = counts <= width
    assert (~fits).any() and fits.any()
    _assert_bitwise(got, want, fits, f"{metric} {order}")
    assert (got[0][~fits] == -1).all() and not got[2][~fits].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_words_order_as_key_then_row(seed):
    """``pack_hits`` words order as (key compared as a float, row), so
    −0.0 and +0.0 tie, and ``unpack_hits`` returns each key's own bits and
    its row."""
    g, keys, _hit = _crafted(seed, 1, 400)
    keys = keys[0]
    rows = torch.randperm(400, generator=g).to(torch.int32)
    words = rs.pack_hits(keys, rows)
    back, back_rows = rs.unpack_hits(words)
    assert torch.equal(back.view(torch.int32), keys.view(torch.int32))
    assert torch.equal(back_rows, rows)
    by_word = torch.argsort(words)
    by_row = torch.argsort(rows.long(), stable=True)
    by_key = by_row[torch.sort(keys[by_row], stable=True).indices]
    assert torch.equal(by_word, by_key)


def test_capacity_past_the_bound_keeps_the_dense_sort():
    """Past ``APPEND_WIDTH`` (the sort kernel's shared memory) the
    compaction stays the dense kernel and one sort over N; the wrapper
    refuses such a capacity, and an empty one."""
    from repro_torch.kernels.range_scan import APPEND_WIDTH, range_topk_batch
    from repro_torch.roofline import analyze

    assert APPEND_WIDTH * 8 <= BLOCK_SMEM < APPEND_WIDTH * 16
    src = (Path(rs.__file__).with_name("csrc")
           / "range_scan_batch.cu").read_text()
    assert re.search(r"constexpr int kMaxWidth = (\d+);", src).group(1) \
        == str(APPEND_WIDTH)
    rng, corpus, queries = _inputs(47, 300, 16, 3)
    radius = _tie_safe_radius(_keys(corpus, queries, "l2"), "l2", rank=40)
    c, q = _t(corpus), _t(queries)
    rk = ops._radius_keys(_t(radius), Metric.L2, 3, c.device)
    for cap in (0, APPEND_WIDTH + 1):
        with pytest.raises(ValueError, match="capacity"):
            range_topk_batch(c, q, rk, None, None, Metric.L2, cap)
    kernels = {}
    for cap in (APPEND_WIDTH + 1, APPEND_WIDTH):
        kernels[cap] = set(analyze(ops.fused_range_topk_batch, c, q,
                                   _t(radius), None, Metric.L2,
                                   cap).kernels)
    assert kernels == {APPEND_WIDTH + 1: {"range_scan_batch"},
                       APPEND_WIDTH: {"range_topk_batch"}}
    wide = ops.fused_range_topk_batch(c, q, _t(radius), None, Metric.L2,
                                      APPEND_WIDTH + 1)
    narrow = ops.fused_range_topk_batch(c, q, _t(radius), None, Metric.L2,
                                        APPEND_WIDTH)
    for a, b in zip(wide, narrow):
        assert torch.equal(_bits(a[:, :APPEND_WIDTH] if a.ndim == 2 else a),
                           _bits(b))
