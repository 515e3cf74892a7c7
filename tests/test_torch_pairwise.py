"""The port's pairwise order-key matrix (``repro_torch.kernels.pairwise_keys``,
its plain version on the CPU) against the reference's
``repro.kernels.ops.pairwise_keys`` (Pallas in interpret mode) and
``repro.kernels.ref.pairwise_keys_ref``, on the same numpy inputs.

Tolerance 2e-4, the reference test's own (``tests/test_kernels.py``):
unit-scale fp32 data at D <= 130, summed in another order by each side.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.schema import Metric as RefMetric
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch.core.schema import Metric
from repro_torch.kernels import pairwise_keys
from repro_torch.kernels import distance, ref

TOL = 2e-4
METRICS = ["ip", "l2", "cosine"]
# (Q, N, D, dtype): the reference test's shape, ragged Q, N and D, and bf16
CASES = {"reference_shape": (40, 300, 72, "float32"),
         "ragged": (1, 513, 130, "float32"),
         "ragged_batch": (37, 1001, 33, "float32"),
         "bf16": (40, 300, 72, "bfloat16")}


def _inputs(seed: int, qn: int, n: int, d: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((qn, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _as(x: np.ndarray, dtype: str):
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x).astype(getattr(jnp, dtype)))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_keys_matches_reference(metric, case):
    qn, n, d, dtype = CASES[case]
    q, c = _inputs(2, qn, n, d)
    (tq, jq), (tc, jc) = _as(q, dtype), _as(c, dtype)
    got = pairwise_keys(tq, tc, Metric(metric))
    assert got.shape == (qn, n) and got.dtype == torch.float32
    want = ref_ops.pairwise_keys(jq, jc, RefMetric(metric), block_q=16,
                                 block_c=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    oracle = ref_oracle.pairwise_keys_ref(jq, jc, RefMetric(metric))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("metric", METRICS)
def test_oracle_matches_reference_oracle(metric):
    q, c = _inputs(3, 40, 300, 72)
    got = ref.pairwise_keys_ref(torch.from_numpy(q), torch.from_numpy(c),
                                Metric(metric))
    want = ref_oracle.pairwise_keys_ref(jnp.asarray(q), jnp.asarray(c),
                                        RefMetric(metric))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("metric", METRICS)
def test_plain_version_is_the_kernels_epilogue(metric):
    """The plain version (what the CPU runs and the card is held to) keeps
    the reference kernel's float order, so it equals the port's oracle up
    to the summation order of the norms."""
    q, c = _inputs(4, 9, 700, 130)
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    plain = distance.pairwise_keys_plain(tq, tc, Metric(metric))
    np.testing.assert_allclose(
        plain.numpy(), ref.pairwise_keys_ref(tq, tc, Metric(metric)).numpy(),
        rtol=1e-5, atol=1e-5)
    assert torch.equal(plain, distance.pairwise_keys(tq, tc, Metric(metric)))


def test_wrapper_checks_and_refuses_other_devices():
    q, c = torch.zeros((2, 8)), torch.zeros((32, 8))
    with pytest.raises(ValueError, match="pairwise_keys runs on cuda"):
        distance.pairwise_keys(q.to("meta"), c.to("meta"), Metric.L2)
    with pytest.raises(ValueError, match="pairwise_keys runs on cuda"):
        pairwise_keys(q.to("meta"), c.to("meta"), Metric.L2)
    with pytest.raises(ValueError, match="queries"):
        distance.pairwise_keys(q.to(torch.bfloat16), c, Metric.L2)
    with pytest.raises(ValueError, match="queries"):
        distance.pairwise_keys(torch.zeros((2, 7)), c, Metric.L2)
    with pytest.raises(ValueError, match="contiguous"):
        distance.pairwise_keys(q, torch.zeros((8, 32)).T, Metric.L2)
    with pytest.raises(ValueError, match="D >= 1"):
        distance.pairwise_keys(torch.zeros((2, 0)), torch.zeros((3, 0)),
                               Metric.L2)
    assert distance.pairwise_keys.launches == 0      # the CPU launches none


# ---------------------------------------------------------------------------
# the kernel's launch plan (what the wrapper passes to the CUDA launcher)
# ---------------------------------------------------------------------------

PLAN_QS = [1, 8, 16, 17, 100, 128, 129, 540]
PLAN_NS = [1, 513, 1_000_000]
INT32_MAX = 2**31 - 1


@pytest.mark.parametrize("n", PLAN_NS)
@pytest.mark.parametrize("qn", PLAN_QS)
def test_plan_covers_every_row_and_query(qn, n):
    qt, rt, row_blocks, query_blocks = distance.pairwise_plan(n, qn)
    assert (qt, rt) in distance.PAIRWISE_SHAPES
    # every row and query in a block, and no block wholly past the end
    assert row_blocks * rt >= n > (row_blocks - 1) * rt
    assert query_blocks * qt >= qn > (query_blocks - 1) * qt
    assert query_blocks <= distance.MAX_GRID_Y
    # the narrow shapes at Q <= 16, the narrowest that holds Q; the wide one
    # past it, so that 100 queries read the corpus once
    if qn <= 16:
        assert qt <= 16 and qt >= qn and query_blocks == 1
        assert qt == min(s[0] for s in distance.PAIRWISE_SHAPES
                         if s[0] >= qn)
    else:
        assert qt == max(s[0] for s in distance.PAIRWISE_SHAPES)
    if qn <= qt:
        assert query_blocks == 1


@pytest.mark.parametrize("n", PLAN_NS)
@pytest.mark.parametrize("qn", PLAN_QS)
def test_plan_passes_no_32_bit_value_that_overflows(qn, n):
    """The launcher takes 32-bit ints: every plan value and every extent
    fits one, while the key offsets q·N + row pass 2^31 at 540 x 1M (the
    kernel forms them in 64 bits)."""
    plan = distance.pairwise_plan(n, qn)
    for v in plan + (n, qn, plan[0] * plan[3], plan[1] * plan[2]):
        assert 0 < v <= INT32_MAX
    last_offset = (plan[3] * plan[0] - 1) * n + plan[2] * plan[1] - 1
    if qn * n > INT32_MAX:
        assert last_offset > INT32_MAX


def test_plan_refuses_what_the_grid_cannot_hold():
    with pytest.raises(ValueError, match="N, Q >= 1"):
        distance.pairwise_plan(0, 4)
    with pytest.raises(ValueError, match="N, Q >= 1"):
        distance.pairwise_plan(10, 0)
    widest = max(s[0] for s in distance.PAIRWISE_SHAPES)
    distance.pairwise_plan(10, distance.MAX_GRID_Y * widest)
    with pytest.raises(ValueError, match="at most"):
        distance.pairwise_plan(10, distance.MAX_GRID_Y * widest + 1)
