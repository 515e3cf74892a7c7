"""The port's quantized scans (plain kernel versions on the CPU) against the
reference's quantized Pallas kernels in interpret mode, on the same numpy
inputs.

* ``quantize_corpus`` equals the reference's bit for bit on ``qvecs``,
  ``scales`` and ``half_step`` (the same fp32 division, half-to-even and
  bf16 rounding), and to 1e-6 relative on the norms (sums);
* ``_range_slack`` agrees to 1e-6, the plain quantized keys agree with
  ``quant_keys_batch_pallas`` (transposed) to 1e-5 (D <= 130, unit rows);
* ``fused_scan_topk_batch_q`` and ``fused_range_topk_batch_q`` give the
  reference's ids, valid and counts exactly and its sims to 1e-5: the data
  has no near-tie at the k-th rank, and radii lie inside wide gaps;
* inside the port, a quantized answer is the fp32 ``use_pallas`` answer bit
  for bit: the replay reproduces the fp32 plain kernels' keys exactly, and
  the range path's full branch is the fp32 range kernel itself.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.schema import Metric as RefMetric
from repro.data.quantized import quantize_corpus as ref_quantize
from repro.kernels import ops as ref_ops
from repro.kernels import quant as ref_quant
from repro_torch.core.schema import Metric
from repro_torch.data.quantized import QuantizedCorpus, quantize_corpus
from repro_torch.kernels import ops, quant, range_scan
from repro_torch.kernels.distance import MAX_GRID_Y
from repro_torch.kernels.scan_topk import (BLOCK_SMEM, NARROW_QUERIES,
                                           scan_topk_batch_plain)

TOL = 1e-5
MODES = ["int8", "bf16"]
METRICS = ["ip", "l2", "cosine"]
# mask kind per metric, so that every kind meets every mode
MASK_OF = {"ip": "per_query", "l2": "shared", "cosine": "none"}
# (N, D, Q) per metric: ragged N, D = 16 and the ragged D = 130
SHAPE_OF = {"ip": (700, 16, 5), "l2": (333, 130, 3), "cosine": (517, 130, 4)}


def _unit(rng, shape) -> np.ndarray:
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _mask(rng, kind: str, qn: int, n: int):
    if kind == "none":
        return None
    if kind == "shared":
        return rng.random(n) < 0.5
    return rng.random((qn, n)) < 0.5


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _twins(corpus: np.ndarray, mode: str):
    return quantize_corpus(corpus, mode), ref_quantize(jnp.asarray(corpus),
                                                       mode)


def _gap_radii(keys: np.ndarray, rank: int) -> np.ndarray:
    """Per query, an order key in the middle of the widest gap between
    adjacent keys around ``rank``: no row within fp32 error of it."""
    out = []
    for row in np.sort(keys, axis=1):
        window = row[max(0, rank - 20):rank + 20]
        j = int(np.argmax(np.diff(window)))
        out.append((window[j] + window[j + 1]) / 2)
    return np.asarray(out)


def _keys64(corpus, queries, metric: str) -> np.ndarray:
    c, q = corpus.astype(np.float64), queries.astype(np.float64)
    ip = q @ c.T
    if metric == "ip":
        return -ip
    if metric == "l2":
        return ((q[:, None, :] - c[None]) ** 2).sum(-1)
    return -ip / (np.linalg.norm(q, axis=1)[:, None]
                  * np.linalg.norm(c, axis=1)[None] + 1e-12)


# ---------------------------------------------------------------------------
# quantize_corpus, _range_slack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_quantize_corpus_matches_reference(mode):
    rng = np.random.default_rng(0)
    vecs = (3.0 * rng.standard_normal((257, 130))).astype(np.float32)
    vecs[5] = 0.0                                      # all-zero row
    vecs[6, :3] = [1e-30, -2.5e-38, 0.0]               # tiny, near-denormal
    got, ref = _twins(vecs, mode)
    assert got.qvecs.dtype == (torch.int8 if mode == "int8"
                               else torch.bfloat16)
    qbits = got.qvecs.view(torch.int8 if mode == "int8" else torch.int16)
    rbits = np.asarray(ref.qvecs).view(np.int8 if mode == "int8"
                                       else np.int16)
    np.testing.assert_array_equal(qbits.numpy(), rbits)
    for name in ("scales", "half_step"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy().view(np.int32),
            np.asarray(getattr(ref, name)).view(np.int32), err_msg=name)
    for name in ("row_l1", "row_l2"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-6,
                                   err_msg=name)
    assert float(got.scales[5, 0]) == 1.0 and float(got.half_step[5]) == 0.0
    deq = got.qvecs.to(torch.float32) * got.scales
    assert bool(((torch.from_numpy(vecs) - deq).abs()
                 <= got.half_step[:, None] + 1e-7).all())


def test_quantize_corpus_validation_and_plan_arrays():
    vecs = np.ones((4, 16), np.float32)
    with pytest.raises(ValueError, match="mode"):
        quantize_corpus(vecs, "fp8")
    with pytest.raises(ValueError, match="expected"):
        quantize_corpus(vecs[0], "int8")
    qc = quantize_corpus(vecs, "int8")
    assert isinstance(qc, QuantizedCorpus)
    assert set(qc.plan_arrays("m_")) == {
        "m_qvecs", "m_qscales", "m_qhalf", "m_ql1", "m_ql2"}


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", MODES)
def test_range_slack_matches_reference(mode, metric):
    rng = np.random.default_rng(1)
    corpus = _unit(rng, (300, 130))
    corpus[7] = 0.0
    queries = (2.0 * _unit(rng, (5, 130))).astype(np.float32)
    got_q, ref_q = _twins(corpus, mode)
    got = quant._range_slack(Metric(metric), got_q.half_step, got_q.row_l1,
                             got_q.row_l2, torch.from_numpy(queries), 130)
    ref = ref_quant._range_slack(RefMetric(metric), ref_q.half_step,
                                 ref_q.row_l1, ref_q.row_l2,
                                 jnp.asarray(queries), 130)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-12)


def _ref_quant_keys(ref_q, queries, mask, qvalid, metric: str):
    """The reference's ``quant_keys_batch_pallas`` in interpret mode on its
    own padded layout, cut back to (Q, N)."""
    n, qn = ref_q.qvecs.shape[0], queries.shape[0]
    bq, bn = ref_ops._block_sizes(n, qn, 128, 1024)
    ref = ref_quant.quant_keys_batch_pallas(
        ref_ops._pad_dim(ref_ops._pad_dim(ref_q.qvecs, 128, 1), bn, 0),
        ref_ops._pad_dim(ref_q.scales, bn, 0),
        ref_ops._pad_dim(ref_ops._pad_dim(jnp.asarray(queries), 128, 1),
                         bq, 0),
        ref_ops._mask_nq_i8(_j(mask), n, qn, bn, bq),
        ref_ops._qvalid_row_i8(_j(qvalid), qn, bq), RefMetric(metric),
        block_q=bq, block_n=bn, interpret=True)
    return np.asarray(ref)[:n, :qn].T


# ---------------------------------------------------------------------------
# stage 1: the plain kernel versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", MODES)
def test_plain_quant_keys_match_reference_kernel(mode, metric):
    rng = np.random.default_rng(2)
    n, d, qn = SHAPE_OF[metric]
    corpus, queries = _unit(rng, (n, d)), _unit(rng, (qn, d))
    mask = _mask(rng, MASK_OF[metric], qn, n)
    qvalid = np.arange(qn) < qn - 1
    got_q, ref_q = _twins(corpus, mode)
    got = quant.quant_keys_batch(
        got_q.qvecs, got_q.scales, torch.from_numpy(queries),
        ops._mask_i8(_t(mask)), ops._mask_i8(_t(qvalid)), Metric(metric))
    ref = _ref_quant_keys(ref_q, queries, mask, qvalid, metric)
    assert got.shape == (qn, n)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(ref))
    live = np.isfinite(ref)
    np.testing.assert_allclose(got.numpy()[live], ref[live], atol=TOL)


# (N, D, Q) per mask kind: ragged N (N % 4 != 0), ragged D (not a whole
# 16-byte unit of either twin)
KEYS_SHAPE_OF = {"none": (701, 130, 5), "shared": (333, 17, 4),
                 "per_query": (517, 40, 6)}


@pytest.mark.parametrize("mask_kind", ["none", "shared", "per_query"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", MODES)
def test_quant_keys_replayed_matches_plain_and_reference(mode, metric,
                                                         mask_kind):
    """``quant_keys_batch_replayed`` (the card's bitwise reference:
    ``replay_keys`` of every pair over the dequantized twin, then the mask
    and the valid lane) has the plain version's dead lanes and its keys
    within 1e-5, and the reference's Pallas kernel's (interpret mode), with
    two dead lanes, on a ragged N and D."""
    rng = np.random.default_rng(11)
    n, d, qn = KEYS_SHAPE_OF[mask_kind]
    corpus, queries = _unit(rng, (n, d)), _unit(rng, (qn, d))
    mask = _mask(rng, mask_kind, qn, n)
    qvalid = np.ones(qn, bool)
    qvalid[[1, qn - 1]] = False
    got_q, ref_q = _twins(corpus, mode)
    a = (got_q.qvecs, got_q.scales, torch.from_numpy(queries),
         ops._mask_i8(_t(mask)), ops._mask_i8(_t(qvalid)), Metric(metric))
    got = quant.quant_keys_batch_replayed(*a).numpy()
    plain = quant.quant_keys_batch_plain(*a).numpy()
    ref = _ref_quant_keys(ref_q, queries, mask, qvalid, metric)
    assert got.shape == (qn, n) and got.dtype == np.float32
    assert np.isinf(got[[1, qn - 1]]).all()
    for want in (plain, ref):
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        live = np.isfinite(want)
        np.testing.assert_allclose(got[live], want[live], rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", MODES)
def test_plain_segment_topk_layout(mode):
    """Each split's list holds its best segments (minimum over 8 rows,
    global id row // 8) ascending by (key, id), (+inf, -1) in empty slots;
    the ragged tail segment is masked past N."""
    rng = np.random.default_rng(3)
    n, d, qn, count = 20_003, 16, 3, 10
    corpus, queries = _unit(rng, (n, d)), _unit(rng, (qn, d))
    qc = quantize_corpus(corpus, mode)
    keys, segs = quant.quant_scan_topk_batch(
        qc.qvecs, qc.scales, torch.from_numpy(queries), None, None, count,
        Metric.L2)
    qt, splits, rows, s_count = quant.quant_plan(n, qn, count)
    assert splits * rows >= n and s_count == min(count, rows // 8)
    assert keys.shape == (qn, splits * s_count)
    deq = (qc.qvecs.float() * qc.scales).numpy()
    full = _keys64(deq, queries, "l2")
    full = np.concatenate([full, np.full((qn, (-n) % 8), np.inf)], 1)
    seg_min = full.reshape(qn, -1, 8).min(-1)
    k2 = keys.reshape(qn, splits, s_count).numpy()
    s2 = segs.reshape(qn, splits, s_count).numpy()
    for q in range(qn):
        for sp in range(splits):
            lo = sp * rows // 8
            hi = min(lo + rows // 8, seg_min.shape[1])
            want = np.full(s_count, np.inf)
            best = np.sort(seg_min[q, lo:hi])[:s_count]
            want[:best.size] = best
            np.testing.assert_allclose(k2[q, sp], want, atol=1e-4)
            ids, found = s2[q, sp], np.isfinite(k2[q, sp])
            assert (ids[~found] == -1).all()
            assert ((ids[found] >= lo) & (ids[found] < hi)).all()
            np.testing.assert_allclose(seg_min[q, ids[found]],
                                       k2[q, sp][found], atol=1e-4)


def test_quant_plan_caps_splits():
    """Splits hold at most 8·1024 rows (1,024 segments), whole 64-row tiles;
    a split that cannot hold c·k segments emits all of them."""
    for n, qn, count in ((1_000_000, 128, 100), (1_000_000, 1, 100),
                         (1_000_000, 8, 2048), (5003, 3, 20)):
        qt, splits, rows, s_count = quant.quant_plan(n, qn, count)
        assert rows % 64 == 0 and rows <= quant.MAX_SPLIT_ROWS
        assert (splits - 1) * rows < n <= splits * rows
        assert s_count == min(count, rows // 8)
    _, _, rows, s_count = quant.quant_plan(1_000_000, 8, 2048)
    assert s_count == rows // 8 < 2048


PLAN_QS = [1, 8, 16, 17, 100, 128, 129, 540]
PLAN_NS = [1, 8, 5003, 1_000_000]
PLAN_COUNTS = [1, 20, 100, 128, 129, 512, 1024]


@pytest.mark.parametrize("n", PLAN_NS)
@pytest.mark.parametrize("qn", PLAN_QS)
def test_launch_geometry_covers_the_corpus(qn, n):
    """The quantized key kernel runs on the fp32 range tile
    (csrc/range_tile.cuh) and its launch plan, ``range_scan.batch_plan``:
    a block shape the tile defines (``BATCH_SHAPES`` against its ``using``
    lines), chosen by Q, query tiles that cover every query, and splits of
    whole row tiles that cover every row within the grid's limits and one
    block's shared memory."""
    csrc = Path(quant.__file__).with_name("csrc")
    src = (csrc / "quant_keys_batch.cu").read_text()
    assert '#include "range_tile.cuh"' in src and "launch_any<" in src
    shapes = {}
    for m in re.finditer(r"using (Wide|Mid|Narrow) = Shape<([^>]*)>;",
                         (csrc / "range_tile.cuh").read_text()):
        bq, br, _qm, _rm, _lr, bk, minb = (int(v) for v in
                                           m.group(2).split(","))
        shapes[bq] = (br, bk, minb)
    assert shapes == range_scan.BATCH_SHAPES
    qt, splits, rows = range_scan.batch_plan(n, qn)
    tile = shapes[qt][0]
    assert qt == (8 if qn <= NARROW_QUERIES else 32 if qn <= 32 else 128)
    assert -(-qn // qt) * qt >= qn > (-(-qn // qt) - 1) * qt
    assert (splits - 1) * rows < n <= splits * rows
    assert rows % tile == 0 and rows >= tile
    assert 1 <= splits <= MAX_GRID_Y
    assert range_scan.batch_smem(qt) <= BLOCK_SMEM


@pytest.mark.parametrize("count", PLAN_COUNTS)
@pytest.mark.parametrize("n", PLAN_NS)
@pytest.mark.parametrize("qn", PLAN_QS)
def test_quant_plan_covers_and_fits(qn, n, count):
    """The kernel's plan covers every query and row with splits of whole
    row tiles, at most 8·1024 rows, keeps max(1, min(count, rows // 8))
    segments per split, takes the narrow shape at Q <= 16, and the shape's
    shared memory at the list length the kernel derives from the segment
    count fits one block (232,448 bytes)."""
    qt, splits, rows, s_count = quant.quant_plan(n, qn, count)
    tile = quant.QUANT_SHAPES[qt][0]
    assert -(-qn // qt) * qt >= qn
    assert (splits - 1) * rows < n <= splits * rows
    assert rows % tile == 0 and tile <= rows <= quant.MAX_SPLIT_ROWS
    assert splits <= 65535                         # gridDim.y
    assert s_count == max(1, min(count, rows // 8))
    if qn <= NARROW_QUERIES:
        assert qt == 8
    elif qn <= 32:
        assert qt in (32, 8)
    assert quant.quant_smem(qt, quant.quant_kp(qt, s_count)) \
        <= BLOCK_SMEM


def test_quant_plan_main_shape():
    """Q1's bucket of 128 at c·K = 100 over 1M rows: the wide shape (both
    64-query tiles read each split), 131 splits of 7,680 rows, 262 blocks
    in two waves of 132 SMs at one block each; bucket 1 and 8: the narrow
    shape at two blocks per SM, 245 blocks in one wave."""
    assert quant.quant_plan(1_000_000, 128, 100) == (64, 131, 7680, 100)
    assert quant.quant_plan(1_000_000, 100, 100) == (64, 131, 7680, 100)
    for qn in (1, 8):
        assert quant.quant_plan(1_000_000, qn, 100) == (8, 245, 4096, 100)
    # 17..32 queries: the mid shape; lists of kp = 256 do not fit 64
    # queries but fit 32, and kp >= 512 only the narrow shape
    assert quant.quant_plan(1_000_000, 30, 100)[0] == 32
    assert quant.quant_plan(1_000_000, 100, 150) == (32, 131, 7680, 150)
    assert quant.quant_plan(1_000_000, 100, 300)[0] == 8


@pytest.mark.parametrize("mask_kind", ["none", "shared", "per_query"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", MODES)
def test_replayed_reference_is_the_plain_kernel(mode, metric, mask_kind):
    """``quant_scan_topk_batch_replayed`` (the card's bitwise reference:
    replay keys over the dequantized corpus, segment minima, split top)
    equals the plain kernel version bit for bit on the CPU, where both take
    the plain keys."""
    rng = np.random.default_rng(6)
    n, d, qn = 1003, 24, 5
    corpus, queries = _unit(rng, (n, d)), _unit(rng, (qn, d))
    qc = quantize_corpus(corpus, mode)
    mask = _t(_mask(rng, mask_kind, qn, n))
    mask = None if mask is None else mask.to(torch.int8)
    qvalid = torch.tensor([1, 1, 0, 1, 1], dtype=torch.int8)
    for count in (10, 126):
        a = (qc.qvecs, qc.scales, torch.from_numpy(queries), mask, qvalid,
             count, Metric(metric))
        got = quant.quant_scan_topk_batch_replayed(*a)
        want = quant.quant_scan_topk_batch_plain(*a)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])
        assert (got[1][2] == -1).all()                  # the dead query


def test_replay_plain_is_the_fp32_plain_kernel_keys():
    rng = np.random.default_rng(4)
    n, d, qn = 900, 130, 6
    corpus = torch.from_numpy(_unit(rng, (n, d)))
    queries = torch.from_numpy(_unit(rng, (qn, d)))
    rows = torch.from_numpy(rng.integers(0, n, (qn, 40)).astype(np.int32))
    rows[:, -3:] = quant.I32_MAX
    for metric in Metric:
        got = quant.replay_keys(corpus, queries, rows, metric)
        keys, ids = scan_topk_batch_plain(corpus, queries, None, None, n,
                                          metric)
        full = torch.full((qn, n), float("inf"))
        found = ids >= 0
        qidx = torch.arange(qn)[:, None].expand_as(ids)
        full[qidx[found], ids[found].long()] = keys[found]
        want = torch.take_along_dim(full, rows[:, :-3].long(), dim=1)
        assert torch.equal(got[:, :-3], want)
        assert bool(torch.isinf(got[:, -3:]).all())


# ---------------------------------------------------------------------------
# fused quantized top-k and range against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", MODES)
def test_fused_topk_matches_reference(mode, metric):
    rng = np.random.default_rng(5)
    n, d, qn, k = 2000, 16, 6, 10
    corpus, queries = _unit(rng, (n, d)), _unit(rng, (qn, d))
    corpus[1500:1508] = corpus[3]                      # duplicates
    mask = _mask(rng, MASK_OF[metric], qn, n)
    qvalid = np.arange(qn) < qn - 2
    got_q, ref_q = _twins(corpus, mode)
    got = quant.fused_scan_topk_batch_q(
        torch.from_numpy(corpus), got_q.qvecs, got_q.scales,
        torch.from_numpy(queries), k, _t(mask), Metric(metric),
        qvalid=_t(qvalid))
    ref = ref_quant.fused_scan_topk_batch_q(
        jnp.asarray(corpus), ref_q.qvecs, ref_q.scales, jnp.asarray(queries),
        k, _j(mask), RefMetric(metric), interpret=True, qvalid=_j(qvalid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=TOL)
    assert not bool(got[2][qn - 2:].any())            # pad lanes inert
    # inside the port: bitwise the fp32 kernel path
    want = ops.fused_scan_topk_batch(torch.from_numpy(corpus),
                                     torch.from_numpy(queries), k, _t(mask),
                                     Metric(metric), qvalid=_t(qvalid))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", MODES)
def test_fused_range_matches_reference(mode, metric, monkeypatch):
    rng = np.random.default_rng(6)
    n, d, qn, cap = 2500, 130, 5, 64
    corpus, queries = _unit(rng, (n, d)), _unit(rng, (qn, d))
    mask = _mask(rng, MASK_OF[metric], qn, n)
    qvalid = np.arange(qn) < qn - 1
    keys = _keys64(corpus, queries, metric)
    radius_keys = _gap_radii(keys, 40)
    radius = (-radius_keys if metric != "l2" else radius_keys
              ).astype(np.float32)
    got_q, ref_q = _twins(corpus, mode)
    full = []
    monkeypatch.setattr(quant, "fused_range_topk_batch",
                        lambda *a, **kw: full.append(1))
    got = quant.fused_range_topk_batch_q(
        torch.from_numpy(corpus), got_q.qvecs, got_q.scales, got_q.half_step,
        got_q.row_l1, got_q.row_l2, torch.from_numpy(queries),
        torch.from_numpy(radius), _t(mask), Metric(metric), cap,
        qvalid=_t(qvalid))
    assert full == []                                  # the budgeted branch
    ref = ref_quant.fused_range_topk_batch_q(
        jnp.asarray(corpus), ref_q.qvecs, ref_q.scales, ref_q.half_step,
        ref_q.row_l1, ref_q.row_l2, jnp.asarray(queries), jnp.asarray(radius),
        _j(mask), RefMetric(metric), cap, interpret=True, qvalid=_j(qvalid))
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=TOL)
    assert int(got[3][:qn - 1].min()) > 0 and int(got[3][qn - 1]) == 0
    monkeypatch.undo()
    want = ops.fused_range_topk_batch(
        torch.from_numpy(corpus), torch.from_numpy(queries),
        torch.from_numpy(radius), _t(mask), Metric(metric), cap,
        qvalid=_t(qvalid))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_range_full_branch_forced(mode, monkeypatch):
    """A radius that every row meets overflows the replay budget: the call
    runs the fp32 range kernel (plain on the CPU), and still agrees with
    the reference's full replay."""
    rng = np.random.default_rng(7)
    n, d, qn, cap = 1200, 16, 3, 16
    corpus, queries = _unit(rng, (n, d)), _unit(rng, (qn, d))
    got_q, ref_q = _twins(corpus, mode)
    radius = np.float32(-2.0)                          # every IP sim >= -1
    calls = []
    fp32 = quant.fused_range_topk_batch

    def spy(*a, **kw):
        calls.append(1)
        return fp32(*a, **kw)

    monkeypatch.setattr(quant, "fused_range_topk_batch", spy)
    got = quant.fused_range_topk_batch_q(
        torch.from_numpy(corpus), got_q.qvecs, got_q.scales, got_q.half_step,
        got_q.row_l1, got_q.row_l2, torch.from_numpy(queries), radius, None,
        Metric.INNER_PRODUCT, cap)
    assert calls == [1]
    assert got[3].tolist() == [n] * qn
    ref = ref_quant.fused_range_topk_batch_q(
        jnp.asarray(corpus), ref_q.qvecs, ref_q.scales, ref_q.half_step,
        ref_q.row_l1, ref_q.row_l2, jnp.asarray(queries), radius, None,
        RefMetric.INNER_PRODUCT, cap, interpret=True)
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=TOL)
    want = fp32(torch.from_numpy(corpus), torch.from_numpy(queries), radius,
                None, Metric.INNER_PRODUCT, cap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
