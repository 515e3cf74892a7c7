"""The port's front end against the reference: plan fingerprints, query
class and rewritten plan of the Q1 variants, the seeded LAION catalog, the
numpy catalog bridge, and predicate evaluation (single and batched)."""
import numpy as np
import pytest
import torch

from repro.core import analyze as ref_analyze
from repro.core import parse_sql as ref_parse
from repro.core import plan_fingerprint as ref_fingerprint
from repro.core import rewrite as ref_rewrite
from repro.core.expr import evaluate as ref_evaluate
from repro.data import make_laion_catalog as ref_make_catalog
from repro_torch.core import analyze, parse_sql, plan_fingerprint, rewrite
from repro_torch.core.expr import evaluate, evaluate_batch
from repro_torch.core.schema import Catalog, ColumnKind, Metric
from repro_torch.data import (catalog_from_numpy, make_laion_catalog,
                              selectivity_threshold)

Q1 = ("SELECT sample_id FROM products WHERE price < ${p} "
      "ORDER BY DISTANCE(embedding, ${qv}) LIMIT ${K}")
Q1_VARIANTS = {
    "base": Q1,
    "whitespace": ("SELECT   sample_id\nFROM products\n  WHERE price < ${p}"
                   "\nORDER BY DISTANCE(embedding,${qv})   LIMIT ${K}"),
    "renamed": ("SELECT sample_id FROM products WHERE price < ${cap} "
                "ORDER BY DISTANCE(embedding, ${vec}) LIMIT ${n}"),
    "conjuncts": ("SELECT sample_id FROM products WHERE nsfw = 0 AND "
                  "price < ${p} ORDER BY DISTANCE(embedding, ${qv}) "
                  "LIMIT 10"),
    "conjuncts_swapped": ("SELECT sample_id FROM products WHERE price < ${p} "
                          "AND nsfw = 0 ORDER BY DISTANCE(embedding, ${qv}) "
                          "LIMIT 10"),
    "no_filter": ("SELECT sample_id FROM products "
                  "ORDER BY DISTANCE(embedding, ${qv}) LIMIT 5"),
}
SMALL = dict(n_rows=1200, n_queries=6, dim=16, n_modes=8, num_categories=4,
             seed=0)


@pytest.fixture(scope="module")
def catalogs():
    return ref_make_catalog(**SMALL), make_laion_catalog(**SMALL,
                                                         device="cpu")


@pytest.mark.parametrize("variant", sorted(Q1_VARIANTS))
def test_fingerprint_class_and_rewrite_match(variant, catalogs):
    ref_cat, cat = catalogs
    sql = Q1_VARIANTS[variant]
    assert plan_fingerprint(parse_sql(sql)) == ref_fingerprint(ref_parse(sql))
    ra = ref_analyze(ref_parse(sql), ref_cat)
    a = analyze(parse_sql(sql), cat)
    assert a.query_class.value == ra.query_class.value == "vknn_sf"
    assert rewrite(a).pretty() == ref_rewrite(ra).pretty()
    assert repr(a.structured_predicate) == repr(ra.structured_predicate)


def test_variants_share_one_fingerprint():
    fps = {plan_fingerprint(parse_sql(Q1_VARIANTS[v]))[0]
           for v in ("base", "whitespace", "renamed")}
    assert len(fps) == 1
    assert (plan_fingerprint(parse_sql(Q1_VARIANTS["conjuncts"]))[0]
            == plan_fingerprint(parse_sql(
                Q1_VARIANTS["conjuncts_swapped"]))[0])


def test_laion_catalog_matches_reference(catalogs):
    ref_cat, cat = catalogs
    for name in ("laion", "products", "queries", "users"):
        ref_t, t = ref_cat.table(name), cat.table(name)
        assert list(t.schema.columns) == list(ref_t.schema.columns)
        assert t.device == torch.device("cpu")
        for col in ref_t.schema.columns:
            want = np.asarray(ref_t[col])
            got = t[col].numpy()
            assert got.dtype == want.dtype, (name, col)
            np.testing.assert_array_equal(got, want, err_msg=f"{name}.{col}")
            assert t.schema[col].kind.value == ref_t.schema[col].kind.value
            assert t.schema[col].dim == ref_t.schema[col].dim
            assert t.schema[col].metric.value == ref_t.schema[col].metric.value
    assert cat.table("laion")["vec"] is cat.table("laion")["embedding"]
    price = cat.table("laion")["price"]
    assert selectivity_threshold(price, 0.3) == pytest.approx(
        float(np.quantile(np.asarray(ref_cat.table("laion")["price"]), 0.3)))


def test_catalog_from_numpy_round_trips(catalogs):
    ref_cat, _ = catalogs
    tables = {}
    for name in ("laion", "queries"):
        t = ref_cat.table(name)
        tables[name] = {
            "columns": {c: np.asarray(t[c]) for c in t.schema.columns},
            "kinds": {c: (ct.kind.value, ct.dim, ct.metric.value)
                      for c, ct in t.schema.columns.items()},
            "primary_key": t.schema.primary_key}
    aliases = {"laion": "laion", "products": "laion", "queries": "queries"}
    cat = catalog_from_numpy(tables, aliases, device="cpu")
    assert cat.table("products") is cat.table("laion")
    for name, src in aliases.items():
        t = cat.table(name)
        assert t.schema.primary_key == ref_cat.table(src).schema.primary_key
        for col, arr in tables[src]["columns"].items():
            np.testing.assert_array_equal(t[col].numpy(), arr)
        emb = t.schema["embedding"]
        assert emb.kind == ColumnKind.VECTOR and emb.metric == Metric.INNER_PRODUCT
        assert emb.dim == SMALL["dim"]
    assert cat.version(("table", "products")) > 0


def test_predicates_match_reference_single_and_batched(catalogs):
    ref_cat, cat = catalogs
    sql = ("SELECT sample_id FROM products WHERE price < ${p} AND nsfw <> 2 "
           "AND (capture_date >= ${d} OR rating = 4) "
           "ORDER BY DISTANCE(embedding, ${qv}) LIMIT 5")
    pred = analyze(parse_sql(sql), cat).structured_predicate
    ref_pred = ref_analyze(ref_parse(sql), ref_cat).structured_predicate
    rng = np.random.default_rng(0)
    price = np.asarray(ref_cat.table("laion")["price"])
    # float64 thresholds taken from the column itself: the port narrows to
    # float32 as the reference does, so boundary rows agree
    ps = np.quantile(price, rng.uniform(0.1, 0.9, 5))
    ds = rng.integers(0, 3650, 5)
    ref_rows = [np.asarray(ref_evaluate(ref_pred, ref_cat.table("products"),
                                        {"p": p, "d": d}))
                for p, d in zip(ps, ds)]
    for i, (p, d) in enumerate(zip(ps, ds)):
        got = evaluate(pred, cat.table("products"), {"p": p, "d": int(d)})
        np.testing.assert_array_equal(got.numpy(), ref_rows[i])
    batched = evaluate_batch(pred, cat.table("products"),
                             {"p": ps, "d": ds}, qn=5)
    assert batched.shape == (5, SMALL["n_rows"])
    np.testing.assert_array_equal(batched.numpy(), np.stack(ref_rows))
    with pytest.raises(ValueError, match="leading Q"):
        evaluate_batch(pred, cat.table("products"), {"p": ps[:2], "d": ds},
                       qn=5)


def test_unported_registrations_raise(catalogs):
    _, cat = catalogs
    # ported: a sharded handle is stored under its spec, bumps its key
    from repro_torch.dist import DistSpec, ShardedCorpus, resolve_mesh
    spec = DistSpec((2,), ("data",))
    handle = ShardedCorpus.build(resolve_mesh(spec, "cpu"),
                                 cat.table("laion")["vec"], spec.axes)
    before = cat.version(("sharded", "laion", "vec"))
    cat.register_sharded("laion", "vec", handle)
    assert cat.sharded_for("laion", "vec", spec) is handle
    assert cat.sharded_for("laion", "vec", DistSpec()) is None
    assert cat.version(("sharded", "laion", "vec")) > before
    assert cat.live_for("laion", "vec") is None
    assert cat.quantized_for("laion", "vec", "int8") is None   # ported
    # ported: an index registration is stored and bumps its version key
    assert cat.index_for("laion", "vec") is None
    fresh, index = Catalog(), object()
    fresh.register_index("laion", "vec", index)
    assert fresh.index_for("laion", "vec") is index
    assert fresh.version(("index", "laion", "vec")) > 0
    assert fresh.index_for("laion", "embedding") is None
    # ported: a live registration is stored and bumps both its live key
    # and its table's key (plans on the frozen layout go stale)
    live, table = object(), fresh.version(("table", "laion"))
    fresh.register_live("laion", "vec", live)
    assert fresh.live_for("laion", "vec") is live
    assert fresh.live_columns("laion") == ["vec"]
    assert fresh.version(("live", "laion", "vec")) > 0
    assert fresh.version(("table", "laion")) > table
    assert fresh.live_for("laion", "embedding") is None


@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
def test_distance_helpers_match_reference(metric):
    import jax.numpy as jnp
    from repro.core import expr as ref_expr
    from repro.core.schema import Metric as RefMetric
    from repro_torch.core import expr

    rng = np.random.default_rng(2)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    q = rng.standard_normal(24).astype(np.float32)
    qs = rng.standard_normal((5, 24)).astype(np.float32)
    m, rm = Metric(metric), RefMetric(metric)
    raw = expr.distance_values(m, torch.from_numpy(x), torch.from_numpy(q))
    ref_raw = np.array(ref_expr.distance_values(rm, jnp.asarray(x),
                                                 jnp.asarray(q)))
    np.testing.assert_allclose(raw.numpy(), ref_raw, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        expr.order_key(m, torch.from_numpy(ref_raw)).numpy(),
        np.asarray(ref_expr.order_key(rm, jnp.asarray(ref_raw))))
    radius = float(np.median(ref_raw))
    np.testing.assert_array_equal(
        expr.in_range(m, torch.from_numpy(ref_raw), radius).numpy(),
        np.asarray(ref_expr.in_range(rm, jnp.asarray(ref_raw), radius)))
    # the kernels' matmul form against the elementwise evaluator
    pair = expr.pairwise_order_keys(m, torch.from_numpy(x),
                                    torch.from_numpy(qs))
    loop = np.stack([np.asarray(ref_expr.order_key(
        rm, ref_expr.distance_values(rm, jnp.asarray(x), jnp.asarray(v))))
        for v in qs])
    np.testing.assert_allclose(pair.numpy(), loop, rtol=1e-5, atol=1e-5)
