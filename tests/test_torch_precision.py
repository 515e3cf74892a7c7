"""The port's plain products run in full fp32 whatever matmul precision the
caller set (``repro_torch.core.expr.full_fp32``), and leave the caller's
setting as it was.

Under ``torch.set_float32_matmul_precision("medium")`` the CPU runs fp32
matmuls as bf16 passes (on the card "high" and "medium" give TF32).  The
plain paths are the card's correctness yardstick, so a Q1 answer under any
setting must equal the "highest" answer bit for bit: no tolerance.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import connect
from repro_torch.core.expr import full_fp32, pairwise_order_keys
from repro_torch.core.schema import Metric
from repro_torch.data import make_laion_catalog
from repro_torch.kernels import distance, ref

SMALL = dict(n_rows=3000, n_queries=8, dim=64, n_modes=8, num_categories=4,
             seed=0)
Q1 = ("SELECT sample_id FROM products WHERE price < ${p} "
      "ORDER BY DISTANCE(embedding, ${qv}) LIMIT ${K}")
K = 10
BACKENDS = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


def _settings():
    return (torch.get_float32_matmul_precision(),
            tuple(m.fp32_precision for m in BACKENDS))


@pytest.fixture(autouse=True)
def restore_default():
    """Leave the process at torch's defaults whatever a test did."""
    yield
    torch.set_float32_matmul_precision("highest")
    for m in BACKENDS:
        m.fp32_precision = "none"


@pytest.fixture(scope="module")
def env():
    cat = make_laion_catalog(**SMALL, device="cpu")
    rng = np.random.default_rng(1)
    qs = cat.table("queries")["embedding"].numpy()
    price = cat.table("laion")["price"].numpy()
    binds = [{"qv": (qs[i] + 0.01 * rng.standard_normal(qs.shape[1])
                     ).astype(np.float32),
              "p": np.float32(np.quantile(price, rng.uniform(0.2, 0.9)))}
             for i in range(8)]
    return cat, binds


def _inputs(seed: int = 0, qn: int = 8, n: int = 3000, d: int = 64):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((qn, d)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)))


def test_a_bare_matmul_follows_the_setting():
    """The fault the scope repairs shows on this CPU: without it, "medium"
    changes the product (else the tests below would prove nothing)."""
    q, c = _inputs()
    want = torch.matmul(q, c.T)
    torch.set_float32_matmul_precision("medium")
    assert not torch.equal(torch.matmul(q, c.T), want)


@pytest.mark.parametrize("precision", ["medium", "high"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_q1_plain_answer_ignores_the_matmul_precision(env, use_pallas,
                                                      precision):
    """Q1 plain, 8 queries x K = 10 over 3,000 x 64: bit for bit the
    "highest" answer, and the caller's setting restored afterwards."""
    cat, binds = env
    st = connect(cat, engine="brute", use_pallas=use_pallas).prepare(Q1, K=K)
    want = st.execute(binds)
    torch.set_float32_matmul_precision(precision)
    before = _settings()
    got = st.execute(binds)
    assert _settings() == before
    assert torch.get_float32_matmul_precision() == precision
    for key in ("ids", "sim", "valid"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("metric", list(Metric))
def test_plain_products_ignore_the_matmul_precision(metric):
    q, c = _inputs(2, 9, 700, 130)
    want = (pairwise_order_keys(metric, c, q),
            distance.pairwise_keys_plain(q, c, metric),
            ref.pairwise_keys_ref(q, c, metric))
    torch.set_float32_matmul_precision("medium")
    got = (pairwise_order_keys(metric, c, q),
           distance.pairwise_keys_plain(q, c, metric),
           ref.pairwise_keys_ref(q, c, metric))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.get_float32_matmul_precision() == "medium"


@pytest.mark.parametrize("setting", ["legacy", "per_backend"])
def test_full_fp32_restores_the_setting_after_an_exception(setting):
    """Both ways of setting the precision come back as they were, also
    when the scoped code raises."""
    if setting == "legacy":
        torch.set_float32_matmul_precision("medium")
    else:
        torch.backends.mkldnn.matmul.fp32_precision = "bf16"
    before = tuple(m.fp32_precision for m in BACKENDS)
    q, c = _inputs()
    want = None
    with pytest.raises(KeyError):
        with full_fp32():
            assert all(m.fp32_precision == "ieee" for m in BACKENDS)
            want = torch.matmul(q, c.T)
            raise KeyError("inside")
    assert tuple(m.fp32_precision for m in BACKENDS) == before
    if setting == "legacy":
        assert torch.get_float32_matmul_precision() == "medium"
    torch.set_float32_matmul_precision("highest")
    for m in BACKENDS:
        m.fp32_precision = "none"
    assert torch.equal(torch.matmul(q, c.T), want)
