"""``CompiledQuery.lower`` / ``lower_batch`` of the port: the reference's
AOT lowering for inspection, as a counted run (``roofline.op_counter``).

Q1–Q6 over a 3,000 x 32 catalog (``engine="brute"``, ``use_pallas=True``,
the plain kernel versions on the CPU), single dicts and lists:

* each plan's kernel launches are recorded with their wrappers' work
  (2·N·D operations a live query, the bound's bytes), and nothing else
  of a flat plan is a matrix product; a single-dict Q2 and Q5 run the
  plain scan as the reference lowers them, with no kernel, and its
  rowwise distance counts by the same formula as one op
  (``distance_values``), so ``cost_analysis()["flops"]`` is 2·N·D a live
  query whichever runs the scan;
* ``as_text()`` lists the ops and one line per launch, ``compile()``
  answers the same, and a later execute's answer, the plan cache and the
  bucket executors are unchanged;
* over an IVF index the count follows the rounds the binds run.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import connect
from repro_torch.core.physical import ProbeConfig
from repro_torch.core.schema import Metric
from repro_torch.data import make_laion_catalog
from repro_torch.index import build_ivf
from repro_torch.kernels import scan_topk

SMALL = dict(n_rows=3000, n_queries=6, dim=32, n_modes=8, num_categories=4,
             seed=0)
N, D, L = SMALL["n_rows"], SMALL["dim"], SMALL["n_queries"]
Q1 = ("SELECT sample_id FROM products WHERE price < ${p} "
      "ORDER BY DISTANCE(embedding, ${qv}) LIMIT 5")
Q2 = ("SELECT sample_id FROM images WHERE DISTANCE(embedding, ${qv}) <= ${r} "
      "AND price < ${p}")
Q3 = ("SELECT queries.id AS qid, images.sample_id AS tid "
      "FROM queries JOIN images "
      "ON DISTANCE(queries.embedding, images.embedding) <= ${r} "
      "AND images.capture_date > queries.capture_date")
Q4 = ("SELECT qid, tid FROM (SELECT users.id AS qid, movies.sample_id AS tid, "
      "RANK() OVER (PARTITION BY users.id "
      "ORDER BY DISTANCE(users.embedding, movies.embedding)) AS rank "
      "FROM users JOIN movies ON users.preferred_rating = movies.rating"
      ") AS ranked WHERE ranked.rank <= 5")
Q5 = ("SELECT qid, category FROM (SELECT sample_id AS qid, "
      "calorie_level AS category, RANK() OVER (PARTITION BY calorie_level "
      "ORDER BY DISTANCE(embedding, ${qv})) AS rank FROM recipes "
      "WHERE DISTANCE(embedding, ${qv}) <= ${r} AND cuisine <> ${ex}"
      ") AS ranked WHERE ranked.rank <= 4")
Q6 = ("SELECT qid, category, tid FROM (SELECT queries.id AS qid, "
      "recipes.sample_id AS tid, recipes.calorie_level AS category, "
      "RANK() OVER (PARTITION BY queries.id, recipes.calorie_level "
      "ORDER BY DISTANCE(queries.embedding, recipes.embedding)) AS rank "
      "FROM queries JOIN recipes "
      "ON DISTANCE(queries.embedding, recipes.embedding) <= ${r} "
      "AND queries.cuisine <> recipes.cuisine) AS ranked "
      "WHERE ranked.rank <= 3")


@pytest.fixture(scope="module")
def env():
    cat = make_laion_catalog(**SMALL, device="cpu")
    qs = cat.table("queries")["embedding"].numpy()
    rng = np.random.default_rng(0)
    one = {"qv": qs[0], "p": np.float32(0.5), "r": np.float32(0.9),
           "ex": np.int32(1)}
    lst = [{**one, "qv": qs[i] + 0.01 * rng.standard_normal(D).astype(
        np.float32)} for i in range(4)]
    return cat, one, lst


def _pick(binds: dict, sql: str) -> dict:
    return {k: v for k, v in binds.items() if "${" + k + "}" in sql}


# (label, sql, connect options, list?, {kernel: (launches, live queries
# each)}, plain scans of the N rows)
CASES = [
    ("q1_single", Q1, {}, False, {"scan_topk": (1, 1)}, 0),
    ("q1_list", Q1, {}, True, {"scan_topk_batch": (1, 4)}, 0),
    ("q2_single", Q2, {}, False, {}, 1),
    ("q2_list", Q2, {}, True, {"range_topk_batch": (1, 4)}, 0),
    ("q3_batch", Q3, {}, False, {"range_topk_batch": (1, L)}, 0),
    ("q3_perleft", Q3, {"join_lowering": "perleft"}, False,
     {"range_scan": (L, 1)}, 0),
    ("q4_batch", Q4, {}, False, {"scan_topk_batch": (1, L)}, 0),
    ("q5_single", Q5, {}, False, {}, 1),
    ("q5_list", Q5, {}, True, {"range_topk_batch": (1, 4)}, 0),
    ("q6_batch", Q6, {}, False, {"range_topk_batch": (1, L)}, 0),
]


def _bitwise(a, b) -> None:
    for key, v in a.items():
        if isinstance(v, dict):
            _bitwise(v, b[key])
        else:
            assert torch.equal(v, b[key]), key


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_lowered_costs_are_the_kernels_work(env, case):
    cat, one, lst = env
    label, sql, opts, as_list, want, plain = case
    db = connect(cat, engine="brute", use_pallas=True, **opts)
    st = db.prepare(sql)
    binds = [_pick(b, sql) for b in lst] if as_list else _pick(one, sql)
    before = st.execute(binds).data
    info = db.cache_info()
    traces = dict(st.compiled.executor.trace_counts)
    lowered = (st.compiled.lower_batch(binds) if as_list
               else st.compiled.lower(**binds))
    after = st.execute(binds).data
    _bitwise(after, before)
    assert db.cache_info() == info
    assert st.compiled.executor.trace_counts == traces

    cost = lowered.cost
    assert {k: (v["launches"], v["ops"]) for k, v in cost.kernels.items()} \
        == {k: (n, n * 2.0 * N * D * live) for k, (n, live) in want.items()}
    plain_ops = plain * 2.0 * N * D
    assert cost.per_op.get("distance_values", {"flops": 0.0})["flops"] \
        == plain_ops
    assert cost.flops_total == cost.kernel_ops + plain_ops > 0
    assert lowered.cost_analysis() == {"flops": cost.flops_total,
                                       "bytes accessed": cost.bytes}
    assert lowered.compile().cost_analysis() == lowered.cost_analysis()
    text = lowered.as_text().splitlines()
    assert text[0].startswith(f"# {len(cost.events)} ops and launches")
    assert len(text) == len(cost.events) + 1
    launches = [line.split()[1] for line in text if line.startswith("kernel")]
    assert sorted(launches) == sorted(k for k, (n, _) in want.items()
                                      for _ in range(n))


def test_q1_list_bytes_are_the_formula(env):
    cat, _one, lst = env
    st = connect(cat, engine="brute", use_pallas=True).prepare(Q1)
    binds = [_pick(b, Q1) for b in lst]
    cost = st.compiled.lower_batch(binds).cost
    # the exact-shape batch: a per-query (Q, N) mask, no valid lanes
    meta = dict(device="meta")
    work = scan_topk.scan_topk_batch_work(
        torch.empty(N, D, **meta), torch.empty(4, D, **meta),
        torch.empty(4, N, dtype=torch.int8, **meta), None, 5)
    assert cost.kernels["scan_topk_batch"] == {
        "launches": 1, "ops": float(work.ops), "bytes": float(work.nbytes)}


def test_lower_validates_binds_as_execute_does(env):
    cat, one, _lst = env
    st = connect(cat, engine="brute", use_pallas=True).prepare(Q1)
    with pytest.raises(ValueError, match="ragged"):
        st.compiled.lower_batch([_pick(one, Q1), {"qv": one["qv"]}])
    with pytest.raises(ValueError, match="binds_list is empty"):
        st.compiled.lower_batch([])


def test_ivf_count_follows_the_rounds(env):
    cat, one, _lst = env
    idx = build_ivf(torch.Generator().manual_seed(0),
                    cat.table("products")["embedding"], nlist=16,
                    metric=Metric.INNER_PRODUCT, iters=4)
    cat = make_laion_catalog(**SMALL, device="cpu")
    cat.register_index("products", "embedding", idx)
    binds = _pick(one, Q1)
    events, probes = [], []
    for mp in (2, 4, 8):
        st = connect(cat, engine="chase", use_pallas=True,
                     probe=ProbeConfig(max_probes=mp, min_probes=1)
                     ).prepare(Q1)
        probes.append(int(st.execute(binds).data["stats"]["probes"]))
        first = st.compiled.lower(**binds).cost
        again = st.compiled.lower(**binds).cost
        assert (first.bytes, first.per_op) == (again.bytes, again.per_op)
        events.append(len(first.events))
    assert probes == [2, 4, 8]
    # a fixed part and the same ops every round
    per_round = (events[1] - events[0]) / 2
    assert per_round > 0 and events[2] - events[1] == 4 * per_round
