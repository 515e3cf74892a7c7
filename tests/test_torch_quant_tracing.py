"""The quantized twin's spans and counters (``kernels/quant.py``,
``tracing.py``), and the benchmark's plain twin
(``chasebench/references/quant_rescore.py``) against the port's.

* The plain twin equals ``data/quantized.py``'s bit for bit, ties of half
  a step and rows of zeros included.
* ``quant_replayed`` counts Q · 8 · c · K slots on a quantized Q1 list and
  2 · Q · c · capacity on a quantized range list; ``quant_band_rows`` is a
  plain count of the slack band; a capacity too small for the band runs
  the fp32 range kernel, counts in ``quant_fallbacks`` and answers as it.
* A quantized range list waits on the card once, as before the counters.
* Spans on and off give the same answers bit for bit.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.api import ExecutionHints, connect
from repro_torch.core.schema import Metric
from repro_torch.data import make_laion_catalog
from repro_torch.data.quantized import quantize_corpus
from repro_torch.kernels import quant
from repro_torch.kernels.ops import fused_range_topk_batch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = dict(n_rows=3000, n_queries=8, dim=16, n_modes=8, num_categories=4,
             seed=0)
Q1 = ("SELECT sample_id FROM products WHERE price < ${p} "
      "ORDER BY DISTANCE(embedding, ${qv}) LIMIT ${K}")
Q2 = ("SELECT sample_id FROM images WHERE DISTANCE(embedding, ${qv}) <= ${r} "
      "AND price < ${p}")
EXACT = ExecutionHints(exact_shape=True)
SEG = quant.SEG


def _reference():
    from chasebench.references import quant_rescore
    return quant_rescore


def _counters() -> dict:
    return dict(tracing.snapshot()["counters"])


def _moved(before: dict) -> dict:
    after = tracing.snapshot()["counters"]
    return {k: after[k] - before.get(k, 0) for k in after}


@pytest.fixture
def spans_off():
    tracing.disable()
    yield
    tracing.disable()


@pytest.fixture(scope="module")
def env():
    cat = make_laion_catalog(**SMALL, device="cpu")
    left = cat.table("queries")["embedding"].numpy()
    price = cat.table("laion")["price"].numpy()
    corpus = cat.table("laion")["embedding"].numpy().astype(np.float64)
    return {"cat": cat, "left": left, "price": price, "corpus": corpus}


def _binds(env, case: str, qn: int) -> list[dict]:
    rng = np.random.default_rng(qn)
    out = []
    for i in range(qn):
        q = (env["left"][i % env["left"].shape[0]]
             + 0.01 * rng.standard_normal(env["left"].shape[1])
             ).astype(np.float32)
        b = {"qv": q, "p": np.float32(np.quantile(env["price"], 0.6))}
        if case == "q2":
            b["r"] = np.float32(np.sort(env["corpus"] @ q)[-40])
        out.append(b)
    return out


def _bitwise(a, b) -> None:
    assert set(a) == set(b)
    for key, v in a.items():
        if isinstance(v, dict):
            _bitwise(v, b[key])
        else:
            assert torch.equal(v, b[key]), key


# ---------------------------------------------------------------------------
# the benchmark's plain twin against the port's
# ---------------------------------------------------------------------------

def _rows(kind: str) -> torch.Tensor:
    gen = torch.Generator().manual_seed(5)
    if kind == "ties":
        # s = 1: every value a whole or half step, so rounding meets ties
        x = torch.randint(-254, 255, (64, 40), generator=gen) / 2.0
        x[:, 0] = 127.0
        x[3] = 0.0
        return x.to(torch.float32)
    x = torch.randn(257, 512, generator=gen)
    x[7] = 0.0
    x[9, :] = 1e-30
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1)


@pytest.mark.parametrize("kind", ["ties", "unit"])
def test_reference_twin_is_the_ports_bit_for_bit(kind):
    ref = _reference()
    x = _rows(kind)
    port = quantize_corpus(x, "int8")
    q, s = ref.quantize(x)
    assert torch.equal(q, port.qvecs)
    assert torch.equal(s.view(torch.int32),
                       port.scales.reshape(-1).view(torch.int32))
    deq = port.qvecs.to(torch.float32) * port.scales
    assert torch.equal(ref.twin(x).view(torch.int32), deq.view(torch.int32))


def test_reference_twin_rounds_half_to_even():
    q, _ = _reference().quantize(torch.tensor([[127.0, 0.5, 1.5, -2.5,
                                                -0.5, 3.5]]))
    assert q.tolist() == [[127, 0, 2, -2, 0, 4]]


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [1, 2, 3])
@pytest.mark.parametrize("k", [5, 10])
def test_replayed_is_q_by_8ck_on_q1(env, spans_off, factor, k):
    st = connect(env["cat"], engine="brute", use_pallas=True, quant="int8",
                 rescore_factor=factor).prepare(Q1, K=k)
    binds = [{"qv": b["qv"], "p": b["p"]} for b in _binds(env, "q1", 8)]
    before = _counters()
    st.execute(binds, EXACT)
    moved = _moved(before)
    assert moved["quant_replayed"] == 8 * SEG * factor * k
    assert moved["quant_band_rows"] == 0 and moved["quant_fallbacks"] == 0


def _twin_inputs(qn: int, mask_kind: str):
    gen = torch.Generator().manual_seed(11)
    corpus = torch.randn(2000, 32, generator=gen)
    corpus /= torch.linalg.vector_norm(corpus, dim=1, keepdim=True)
    queries = corpus[:qn] + 0.2 * torch.randn(qn, 32, generator=gen)
    queries /= torch.linalg.vector_norm(queries, dim=1, keepdim=True)
    mask = {"none": None,
            "shared": torch.rand(2000, generator=gen) < 0.5,
            "per_query": torch.rand(qn, 2000, generator=gen) < 0.5}[mask_kind]
    return corpus, quantize_corpus(corpus, "int8"), queries, mask


def _plain_band(twin, queries, mask, radius: float) -> int:
    """Rows whose quantized inner-product key lies within the IP slack
    h · |q|_1 (widened as the port widens it) of the radius's key."""
    deq = twin.qvecs.to(torch.float32) * twin.scales
    keys = -(queries @ deq.T)
    if mask is not None:
        keys = torch.where(mask, keys, float("inf"))
    q_l1 = queries.abs().sum(dim=1, keepdim=True)
    slack = twin.half_step.reshape(1, -1) * q_l1 * 1.001 + 1e-6
    rk = -torch.tensor(radius, dtype=torch.float32)
    return int((keys <= rk + slack).sum())


def _call_range(corpus, twin, queries, mask, radius, capacity):
    return quant.fused_range_topk_batch_q(
        corpus, twin.qvecs, twin.scales, twin.half_step, twin.row_l1,
        twin.row_l2, queries, radius, mask, Metric.INNER_PRODUCT, capacity)


@pytest.mark.parametrize("mask_kind", ["none", "shared", "per_query"])
@pytest.mark.parametrize("radius", [0.3, 0.45])
def test_band_rows_is_a_plain_count(spans_off, mask_kind, radius):
    corpus, twin, queries, mask = _twin_inputs(6, mask_kind)
    before = _counters()
    _call_range(corpus, twin, queries, mask, radius, 512)
    moved = _moved(before)
    band = _plain_band(twin, queries, mask, radius)
    assert band > 0
    assert moved["quant_band_rows"] == band
    assert moved["quant_fallbacks"] == 0
    assert moved["quant_replayed"] == 2 * 6 * 1024
    assert moved["syncs"] == 1


@pytest.mark.parametrize("capacity", [1, 3])
def test_a_forced_fallback_counts_and_answers_as_fp32(spans_off, capacity):
    corpus, twin, queries, mask = _twin_inputs(5, "shared")
    before = _counters()
    got = _call_range(corpus, twin, queries, mask, 0.3, capacity)
    moved = _moved(before)
    assert moved["quant_fallbacks"] == 1
    assert moved["quant_replayed"] == 0
    assert moved["quant_band_rows"] == _plain_band(twin, queries, mask, 0.3)
    want = fused_range_topk_batch(corpus, queries, 0.3, mask,
                                  Metric.INNER_PRODUCT, capacity)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_a_fallback_through_connect_counts(env, spans_off):
    from repro_torch.core.physical import ProbeConfig
    st = connect(env["cat"], engine="brute", use_pallas=True, quant="int8",
                 probe=ProbeConfig(capacity=2)).prepare(Q2)
    before = _counters()
    st.execute(_binds(env, "q2", 4), EXACT)
    assert _moved(before)["quant_fallbacks"] == 1


@pytest.mark.parametrize("hints", [None, EXACT], ids=["bucketed", "exact"])
@pytest.mark.parametrize("case", ["q1", "q2"])
def test_quantized_lists_wait_as_before(env, spans_off, hints, case):
    """One wait a quantized range list (the host read that picks the
    branch, now also the band's size), none a top-k list: on the CPU the
    uploads wait for nothing."""
    db = connect(env["cat"], engine="brute", use_pallas=True, quant="int8")
    st = db.prepare(Q2) if case == "q2" else db.prepare(Q1, K=10)
    binds = _binds(env, case, 8)
    if case == "q1":
        binds = [{"qv": b["qv"], "p": b["p"]} for b in binds]
    st.execute(binds, hints)
    before = _counters()
    st.execute(binds, hints)
    moved = _moved(before)
    assert moved["syncs"] == (1 if case == "q2" else 0)
    assert moved["uploads"] == 0


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,k", [("q1", 10), ("q1", 1100), ("q2", None)])
def test_spans_on_and_off_give_the_same_bits(env, spans_off, case, k):
    db = connect(env["cat"], engine="brute", use_pallas=True, quant="int8")
    st = db.prepare(Q2) if case == "q2" else db.prepare(Q1, K=k)
    binds = _binds(env, case, 8)
    if case == "q1":
        binds = [{"qv": b["qv"], "p": b["p"]} for b in binds]
    off = st.execute(binds).data
    tracing.enable()
    before = tracing.snapshot()["spans"]
    on = st.execute(binds).data
    after = tracing.snapshot()["spans"]
    _bitwise(off, on)
    for name in (tracing.QUANT_SCAN, tracing.QUANT_REPLAY):
        calls = after[name]["calls"] - before.get(name, {}).get("calls", 0)
        assert calls == 1, name
