"""The plain reference against a brute NumPy answer in float64, and the
TF32 rounding of the control."""
import numpy as np
import pytest
import torch

from chasebench import generator, harness
from conftest import ROOT

TINY = {"data": {"rows": 3000, "dim": 64, "modes": 8}}
MIX = {"pool": 64, "list_size": 16}


def _setup(bench, workload):
    cell = harness.by_name(bench["workloads"], workload)
    config = harness.deep_merge(harness.load_json(
        ROOT / harness.by_name(bench["configs"], cell["config"])["file"]),
        TINY)
    mix = harness.deep_merge(harness.load_json(
        harness.HERE / "traffic" / f"{cell['traffic']}.json"), MIX)
    system = harness.load_module(harness.HERE / "systems"
                                 / f"{config['system']}.py")
    reference = harness.load_module(harness.HERE / "references"
                                    / f"{config['reference']}.py")
    data = system.make_data(config, 11, torch.device("cpu"))
    traffic = generator.Traffic(mix, config, data, 11)
    return config, data, traffic, reference


def _numpy_truth(data, traffic, rows):
    corpus = data.corpus.numpy().astype(np.float64)
    qs = traffic.pool_host[rows].astype(np.float64)
    sims = qs @ corpus.T
    p = traffic.scalars["p"]
    passing = data.columns["price"].numpy() < p
    return sims, passing


def test_topk_equals_brute_numpy(bench):
    config, data, traffic, reference = _setup(bench, "laion1m-flat-q1-b100")
    binds, rows = traffic.request(0)
    sims, passing = _numpy_truth(data, traffic, rows)
    k = traffic.static["K"]
    ids = np.arange(sims.shape[1])
    want = np.stack([
        ids[passing][np.lexsort((ids[passing], -s[passing]))][:k]
        for s in sims])
    got = reference.Control(traffic, data, "fp32").execute(binds)
    np.testing.assert_array_equal(got["ids"].numpy(), want)
    np.testing.assert_allclose(got["sim"].numpy(),
                               np.take_along_axis(sims, want, 1), atol=1e-6)
    answer = {"ids": torch.as_tensor(want, dtype=torch.int32),
              "sim": torch.as_tensor(np.take_along_axis(sims, want, 1),
                                     dtype=torch.float32),
              "valid": torch.ones(want.shape, dtype=torch.bool)}
    numbers = reference.judge([(rows, answer)], traffic, data, config)
    assert numbers["bad_rows"] == 0
    assert numbers["sim_err"] <= 1e-6 and numbers["rank_gap"] <= 1e-6


def test_range_equals_brute_numpy(bench):
    config, data, traffic, reference = _setup(bench, "laion1m-flat-q2-b100")
    binds, rows = traffic.request(0)
    sims, passing = _numpy_truth(data, traffic, rows)
    r = float(traffic.scalars["r"])
    got = reference.Control(traffic, data, "fp32").execute(binds)
    for q in range(len(rows)):
        want = set(np.nonzero(passing & (sims[q] >= r))[0])
        near = set(np.nonzero(np.abs(sims[q] - r) < 1e-6)[0])
        valid = got["valid"][q].numpy()
        have = set(got["ids"][q].numpy()[valid])
        assert want - near == have - near
        assert int(got["count"][q]) == valid.sum()
    numbers = reference.judge([(rows, got)], traffic, data, config)
    assert numbers["bad_rows"] == 0 and numbers["range_gap"] <= 1e-6


def test_judge_counts_structural_faults(bench):
    config, data, traffic, reference = _setup(bench, "laion1m-flat-q1-b100")
    binds, rows = traffic.request(1)
    good = reference.Control(traffic, data, "fp32").execute(binds)
    assert reference.judge([(rows, good)], traffic, data,
                           config)["bad_rows"] == 0
    dup = {k: v.clone() for k, v in good.items()}
    dup["ids"][0, 1] = dup["ids"][0, 0]
    fails = {k: v.clone() for k, v in good.items()}
    fails["ids"][0, 0] = int(np.nonzero(~traffic.passing.numpy())[0][0])
    short = {k: v.clone() for k, v in good.items()}
    short["valid"][0, -1] = False
    for broken in (dup, fails, short):
        assert reference.judge([(rows, broken)], traffic, data,
                               config)["bad_rows"] >= 1


@pytest.mark.parametrize("x", [1.0, -3.0e-3, 0.7071068, 1e-30, -123.456])
def test_tf32_keeps_ten_mantissa_bits(x):
    from chasebench.references.hybrid_exact import tf32
    t = torch.tensor([x], dtype=torch.float32)
    r = tf32(t)
    assert int(r.view(torch.int32)) & 0x1FFF == 0
    assert abs(float(r) - x) <= abs(x) * 2.0 ** -11
