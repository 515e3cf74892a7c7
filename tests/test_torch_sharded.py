"""The port's sharded scans (``repro_torch.dist``, ``EngineOptions.dist``)
against the reference's (``repro.dist``), on the CPU.

Mirrors ``tests/test_dist_batch.py``.  One process drives every shard (the
reference's single controller); on the CPU every shard of a mesh is the
CPU, the analogue of the reference's fake CPU devices, so the multi-shard
cases run here in process.  Held:

* ``DistSpec`` and the option checks raise the reference's messages;
* at one shard, every class (the reference's eight cases) equals the
  port's flat bucketed path (``engine="brute", use_pallas=True``) bit for
  bit — ids, sims, valid, counts and counters — in fp32, int8 and bf16;
* the port at one shard against the reference at one shard: ids, valid,
  counts and counters exact, sims within 1e-5 (D = 16);
* 2, 4 and 2 x 2 shards over 1,201 rows (not divisible: every shard count
  pads) equal one shard bit for bit.  The plain kernel versions compute
  each row's keys on their own, so a shard's keys do not depend on the
  rows beside it (checked here at D = 16 and D = 512): ids, counts and
  sims compare exactly;
* pad queries are inert on every shard; a range buffer truncates to one
  capacity with exact counts; the mesh keys the plan cache; the handle is
  registered once, and at one shard it is a view of the corpus; a mesh
  naming more CUDA devices than the machine has raises; a live corpus
  under ``dist`` equals its flat plan bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from repro.core import EngineOptions as RefOptions
from repro.core import compile_query as ref_compile_query
from repro.data import make_laion_catalog as ref_make_catalog
from repro.dist import DistSpec as RefDistSpec
from repro_torch.api import connect
from repro_torch.core import EngineOptions, compile_query
from repro_torch.core.physical import ProbeConfig
from repro_torch.core.schema import Metric
from repro_torch.data import make_laion_catalog
from repro_torch.data.mutations import attach_live
from repro_torch.dist import (DeviceCountError, DistSpec, ShardedCorpus,
                              resolve_mesh)
from repro_torch.dist import collectives
from repro_torch.index.flat import FlatIndex

SMALL = dict(n_rows=1201, n_queries=4, dim=16, n_modes=8, num_categories=4,
             seed=0)
SPEC1 = DistSpec(mesh_shape=(1,), axes=("data",))
TOL = 1e-5

Q1 = ("SELECT sample_id FROM products WHERE price < ${p} "
      "ORDER BY DISTANCE(embedding, ${qv}) LIMIT 4")
Q2 = ("SELECT sample_id FROM images "
      "WHERE DISTANCE(embedding, ${qv}) <= ${r} AND capture_date > ${d}")
Q3 = """
SELECT queries.id AS qid, images.sample_id AS tid
FROM queries JOIN images
ON DISTANCE(queries.embedding, images.embedding) <= ${r}
AND images.capture_date > queries.capture_date
"""
Q4 = """
SELECT qid, tid FROM (
 SELECT users.id AS qid, movies.sample_id AS tid,
 RANK() OVER (PARTITION BY users.id
   ORDER BY DISTANCE(users.embedding, movies.embedding)) AS rank
 FROM users JOIN movies ON users.preferred_rating = movies.rating
 AND movies.release_year >= ${y}
) AS ranked WHERE ranked.rank <= 4
"""
Q5 = """
SELECT qid, category FROM (
 SELECT sample_id AS qid, calorie_level AS category,
 RANK() OVER (PARTITION BY calorie_level
   ORDER BY DISTANCE(embedding, ${qv})) AS rank
 FROM recipes WHERE DISTANCE(embedding, ${qv}) <= ${r}
) AS ranked WHERE ranked.rank <= 3
"""
Q6 = """
SELECT qid, category, tid FROM (
 SELECT queries.id AS qid, recipes.sample_id AS tid,
 recipes.calorie_level AS category,
 RANK() OVER (PARTITION BY queries.id, recipes.calorie_level
   ORDER BY DISTANCE(queries.embedding, recipes.embedding)) AS rank
 FROM queries JOIN recipes
 ON DISTANCE(queries.embedding, recipes.embedding) <= ${r}
 AND queries.cuisine <> recipes.cuisine
) AS ranked WHERE ranked.rank <= 3
"""
Q1_NOFILTER = ("SELECT sample_id FROM products "
               "ORDER BY DISTANCE(embedding, ${qv}) LIMIT 4")
Q2_NOFILTER = ("SELECT sample_id FROM images "
               "WHERE DISTANCE(embedding, ${qv}) <= ${r}")
CASES = {"q1": Q1, "q2": Q2, "q3": Q3, "q4": Q4, "q5": Q5, "q6": Q6,
         "q1_nofilter": Q1_NOFILTER, "q2_nofilter": Q2_NOFILTER}
FLAT = dict(engine="brute", use_pallas=True, max_pairs=64)
MODES = (None, "int8", "bf16")


@pytest.fixture(scope="module")
def env():
    cat = make_laion_catalog(**SMALL, device="cpu")
    qs = cat.table("queries")["embedding"].numpy()
    sims = qs @ cat.table("laion")["vec"].numpy().T
    radius = float(np.median(np.partition(sims, -30, axis=1)[:, -30]))
    return cat, radius


@pytest.fixture(scope="module")
def ref_cat():
    return ref_make_catalog(**SMALL)


def _qvecs(cat, qn: int) -> np.ndarray:
    base = np.asarray(cat.table("queries")["embedding"])
    rng = np.random.default_rng(3)
    reps = -(-qn // base.shape[0])
    qs = np.tile(base, (reps, 1))[:qn]
    return (qs + 0.01 * rng.standard_normal(qs.shape)).astype(np.float32)


def _binds_for(case: str, cat, radius: float, qn: int) -> dict:
    """The reference test's binds (``tests/test_dist_batch.py``)."""
    rng = np.random.default_rng(7)
    price = np.asarray(cat.table("laion")["price"])
    dates = np.asarray(cat.table("laion")["capture_date"])
    if case == "q1_nofilter":
        return {"qv": _qvecs(cat, qn)}
    if case == "q2_nofilter":
        return {"qv": _qvecs(cat, qn),
                "r": (radius * rng.uniform(0.95, 1.0, qn)).astype(np.float32)}
    if case == "q1":
        return {"qv": _qvecs(cat, qn),
                "p": np.quantile(price, rng.uniform(0.3, 1.0, qn)).astype(
                    np.float32)}
    if case == "q2":
        return {"qv": _qvecs(cat, qn),
                "r": (radius * rng.uniform(0.95, 1.0, qn)).astype(np.float32),
                "d": np.quantile(dates, rng.uniform(0.2, 0.8, qn)).astype(
                    np.int32)}
    if case in ("q3", "q6"):
        return {"r": (radius * rng.uniform(0.95, 1.0, qn)).astype(np.float32)}
    if case == "q4":
        years = np.asarray(cat.table("movies")["release_year"])
        return {"y": np.quantile(years, rng.uniform(0.1, 0.6, qn)).astype(
            np.int32)}
    if case == "q5":
        return {"qv": _qvecs(cat, qn),
                "r": (radius * rng.uniform(0.95, 1.0, qn)).astype(np.float32)}
    raise ValueError(case)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _bitwise(a: dict, b: dict, ctx: str = "") -> None:
    assert set(a) == set(b), ctx
    for key in a:
        if isinstance(a[key], dict):
            _bitwise(a[key], b[key], f"{ctx}.{key}")
        else:
            assert torch.equal(a[key], b[key]), f"{ctx}:{key}"


def _opts(mode, **kw) -> EngineOptions:
    return EngineOptions(**FLAT, quant=mode, **kw)


# ---------------------------------------------------------------------------
# spec and option validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes,match", [
    ((2, 2), ("data",), "same length"),
    ((2, 2), ("data", "data"), "duplicate"),
    ((0,), ("data",), ">= 1"),
    ((), (), "at least one"),
])
def test_dist_spec_validation(shape, axes, match):
    with pytest.raises(ValueError, match=match) as port:
        DistSpec(mesh_shape=shape, axes=axes)
    with pytest.raises(ValueError, match=match) as ref:
        RefDistSpec(mesh_shape=shape, axes=axes)
    assert str(port.value) == str(ref.value)
    # normalized to tuples, so the repr (the fingerprint) is stable
    assert repr(DistSpec(mesh_shape=[2], axes=["data"])) == \
        repr(DistSpec(mesh_shape=(2,), axes=("data",)))


@pytest.mark.parametrize("sql,kw", [
    (Q1, dict(engine="pase")),
    (Q3, dict(engine="brute", join_lowering="perleft")),
])
def test_validate_dist_messages(env, ref_cat, sql, kw):
    cat, _ = env
    with pytest.raises(ValueError) as port:
        compile_query(sql, cat, EngineOptions(**kw, dist=SPEC1))
    with pytest.raises(ValueError) as ref:
        ref_compile_query(sql, ref_cat, RefOptions(
            **kw, dist=RefDistSpec((1,), ("data",))))
    assert str(port.value) == str(ref.value)
    with pytest.raises(TypeError, match="DistSpec"):
        compile_query(sql, cat, EngineOptions(engine="brute", dist=(1,)))


# ---------------------------------------------------------------------------
# one shard = the flat bucketed path, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_shards1_bitparity_vs_bucketed(env, case, mode):
    cat, radius = env
    flat = compile_query(CASES[case], cat, _opts(mode))
    dist = compile_query(CASES[case], cat, _opts(mode, dist=SPEC1))
    binds = _binds_for(case, cat, radius, 3)
    _bitwise(flat.execute_bucketed(**binds), dist.execute_bucketed(**binds),
             f"{case}/{mode}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_shards1_against_reference(env, ref_cat, case):
    """The port's one-shard plan against the reference's: ids, valid,
    counts and counters exact, sims within 1e-5."""
    cat, radius = env
    binds = _binds_for(case, cat, radius, 3)
    got = compile_query(CASES[case], cat,
                        _opts(None, dist=SPEC1)).execute_bucketed(**binds)
    want = ref_compile_query(CASES[case], ref_cat, RefOptions(
        **FLAT, dist=RefDistSpec((1,), ("data",)))).execute_bucketed(**binds)
    assert set(got) == set(want)
    for key in got:
        if key == "stats":
            for sk in got["stats"]:
                np.testing.assert_array_equal(_np(got["stats"][sk]),
                                              np.asarray(want["stats"][sk]))
        elif key == "sim":
            np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]),
                                       rtol=0, atol=TOL)
        else:
            np.testing.assert_array_equal(_np(got[key]),
                                          np.asarray(want[key]), err_msg=key)


def test_shards1_single_dict_is_a_batch_of_one(env):
    """A single bind dict of a sharded plan runs the batched lowering at
    Q = 1 (``_single_via_batch``): it equals the exact-shape batch of one
    bit for bit (the flat single-query kernel may differ in the last bit,
    as the reference's ``test_shards1_single_query_path_matches`` shows)."""
    cat, radius = env
    q = compile_query(Q1, cat, _opts(None, dist=SPEC1))
    binds = _binds_for("q1", cat, radius, 1)
    single = q(qv=binds["qv"][0], p=binds["p"][0])
    batch = q.execute_batch(**binds)
    _bitwise(single, {k: (v[0] if not isinstance(v, dict) else
                          {sk: sv[0] for sk, sv in v.items()})
                      for k, v in batch.items()}, "single")


# ---------------------------------------------------------------------------
# several shards = one shard, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2,), (4,), (2, 2)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_shard_equals_one_shard(env, case, shape):
    cat, radius = env
    axes = ("data",) if len(shape) == 1 else ("pod", "data")
    spec = DistSpec(mesh_shape=shape, axes=axes)
    binds = _binds_for(case, cat, radius, 3)
    one = compile_query(CASES[case], cat, _opts(None, dist=SPEC1))
    many = compile_query(CASES[case], cat, _opts(None, dist=spec))
    handle = many._arrays["sharded"]
    assert handle.num_shards == spec.num_shards
    assert handle.padded_rows % spec.num_shards == 0
    assert handle.padded_rows > SMALL["n_rows"]         # 1,201 pads
    _bitwise(one.execute_bucketed(**binds), many.execute_bucketed(**binds),
             f"{case}/{shape}")


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("case", ["q1", "q2", "q4"])
def test_multi_shard_quantized_equals_flat(env, case, mode):
    """Each shard's twin rows line up with its fp32 rows: four quantized
    shards give the flat quantized answer bit for bit."""
    cat, radius = env
    binds = _binds_for(case, cat, radius, 3)
    flat = compile_query(CASES[case], cat, _opts(mode))
    many = compile_query(CASES[case], cat, _opts(mode, dist=DistSpec((4,))))
    twins = many._arrays["dquant"]
    assert len(twins) == 4
    assert all(t["qvecs"].shape[0] == s.shape[0]
               for t, s in zip(twins, many._arrays["sharded"].shards))
    _bitwise(flat.execute_bucketed(**binds), many.execute_bucketed(**binds),
             f"{case}/{mode}")


def test_shard_keys_do_not_depend_on_neighbours():
    """At D = 512 the plain batched scan's keys of a row are the same
    whichever shard holds it (checked at 2 and 3 shards)."""
    cat = make_laion_catalog(n_rows=601, n_queries=4, dim=512, n_modes=8,
                             seed=0, device="cpu")
    qv = cat.table("queries")["embedding"].numpy()
    want = compile_query(Q1_NOFILTER, cat, _opts(None)).execute_bucketed(
        qv=qv)
    for shards in (2, 3):
        got = compile_query(Q1_NOFILTER, cat, _opts(
            None, dist=DistSpec((shards,)))).execute_bucketed(qv=qv)
        _bitwise(want, got, f"d512/{shards}")


# ---------------------------------------------------------------------------
# pad queries, capacity truncation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_pad_queries_inert_on_sharded_path(env, case):
    cat, radius = env
    q = compile_query(CASES[case], cat, _opts(None, dist=DistSpec((3,))))
    qn = 3
    binds = q._stack_binds(None, _binds_for(case, cat, radius, qn))
    out, bucket, valid = q.executor.run_padded(binds, qn)
    assert bucket == 4 and not bool(np.asarray(valid)[qn:].any())
    for sk, v in out["stats"].items():
        assert (_np(v)[qn:] == 0).all(), f"pad counters: {sk}"
    assert not _np(out["valid"])[qn:].any()
    if "count" in out:
        assert (_np(out["count"])[qn:] == 0).all()


@pytest.mark.parametrize("shards", [1, 3])
def test_range_capacity_truncation_exact_counts(env, shards):
    cat, radius = env
    cap = 16
    opts = dict(engine="brute", use_pallas=True,
                probe=ProbeConfig(capacity=cap))
    flat = compile_query(Q2, cat, EngineOptions(**opts))
    dist = compile_query(Q2, cat, EngineOptions(
        **opts, dist=DistSpec((shards,))))
    qn = 3
    binds = _binds_for("q2", cat, radius, qn)
    binds["r"] = np.full((qn,), -1e6, np.float32)       # every row a hit
    binds["d"] = np.full((qn,), int(cat.table("laion")["capture_date"]
                                    .min()) - 1, np.int32)
    want, got = flat.execute_bucketed(**binds), dist.execute_bucketed(**binds)
    _bitwise(want, got, "q2-truncated")
    counts = _np(got["count"])
    assert (counts == SMALL["n_rows"]).all()            # exact past capacity
    assert _np(got["ids"]).shape[1] == cap
    assert _np(got["valid"]).sum(axis=1).tolist() == [cap] * qn


# ---------------------------------------------------------------------------
# plan cache, the handle, the mesh
# ---------------------------------------------------------------------------

def test_mesh_fingerprint_keys_plan_cache(env):
    cat, radius = env
    db = connect(cat, EngineOptions(**FLAT, dist=SPEC1))
    binds = _binds_for("q1", cat, radius, 3)
    rows = [{k: v[i] for k, v in binds.items()} for i in range(3)]

    s1 = db.prepare(Q1)
    s1.execute(rows)
    assert s1.executor.trace_counts == {4: 1}
    s2 = db.prepare(Q1)                    # same mesh: a hit, nothing built
    assert s2.cache_hit and s2.executor is s1.executor
    s2.execute(rows)
    assert s1.executor.trace_counts == {4: 1}
    assert db.cache_info().hits == 1
    other = DistSpec(mesh_shape=(1,), axes=("shard",))
    s3 = db.prepare(Q1, options=EngineOptions(**FLAT, dist=other))
    assert not s3.cache_hit and s3.executor is not s1.executor
    res = s3.execute(rows)
    assert s3.executor.trace_counts == {4: 1}
    assert s1.executor.trace_counts == {4: 1}
    rep = res.explain()
    assert rep.shards == 1 and rep.merge_depth == 1
    assert "shards=1" in rep.render()
    assert rep.batch_lowering.startswith("native sharded")


def test_sharded_corpus_registered_and_reused(env):
    cat, _ = env
    corpus = cat.table("products")["embedding"]
    compile_query(Q1, cat, EngineOptions(**FLAT, dist=SPEC1))
    handle = cat.sharded_for("products", "embedding", SPEC1)
    assert handle is not None and handle.matches(SPEC1)
    assert handle.spec == SPEC1 and handle.num_rows == SMALL["n_rows"]
    # one shard on the corpus's own device: a view, nothing copied
    assert handle.shards[0].data_ptr() == corpus.data_ptr()
    assert handle.shared_masks == (None,)
    q2 = compile_query(Q1, cat, EngineOptions(**FLAT, dist=SPEC1))
    assert q2._arrays["sharded"] is handle
    other = DistSpec(mesh_shape=(1,), axes=("shard",))
    compile_query(Q1, cat, EngineOptions(**FLAT, dist=other))
    assert cat.sharded_for("products", "embedding", SPEC1) is handle
    h2 = cat.sharded_for("products", "embedding", other)
    assert h2 is not None and h2 is not handle and h2.spec == other


def test_sharded_handle_layout():
    corpus = torch.arange(14 * 3, dtype=torch.float32).reshape(14, 3)
    mesh = resolve_mesh(DistSpec((2, 2), ("pod", "data")), "cpu")
    assert mesh.shape == {"pod": 2, "data": 2}
    h = ShardedCorpus.build(mesh, corpus, ("pod", "data"))
    assert h.padded_rows == 16 and h.num_rows == 14
    assert [s.shape[0] for s in h.shards] == [4, 4, 4, 4]
    assert torch.equal(torch.cat(h.row_ids),
                       torch.tensor(list(range(14)) + [-1, -1],
                                    dtype=torch.int32))
    assert torch.equal(torch.cat(h.shards)[:14], corpus)
    assert not bool(h.shards[3][2:].any())               # zero pad rows
    assert h.shared_masks[:3] == (None, None, None)
    assert h.shared_masks[3].tolist() == [True, True, False, False]
    with pytest.raises(ValueError, match="mesh's axes"):
        ShardedCorpus.build(mesh, corpus, ("data",))


def test_resolve_mesh_too_few_cuda_devices(env):
    have = torch.cuda.device_count()
    spec = DistSpec(mesh_shape=(have + 1,))
    with pytest.raises(DeviceCountError, match=f"have {have}"):
        resolve_mesh(spec, "cuda")
    assert resolve_mesh(spec, "cpu").flat == [torch.device("cpu")] * (
        have + 1)
    assert resolve_mesh(spec, "cpu") is resolve_mesh(spec, "cpu")


def test_table_reregistration_drops_its_handles(env):
    local = make_laion_catalog(**SMALL, device="cpu")
    compile_query(Q1, local, EngineOptions(**FLAT, dist=SPEC1))
    assert local.sharded_for("products", "embedding", SPEC1) is not None
    local.register("products", local.table("products"))
    assert local.sharded_for("products", "embedding", SPEC1) is None


# ---------------------------------------------------------------------------
# the single-query primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1,), (4,), (2, 2)])
def test_single_query_primitives(env, shape):
    cat, radius = env
    axes = ("data",) if len(shape) == 1 else ("pod", "data")
    mesh = resolve_mesh(DistSpec(shape, axes), "cpu")
    corpus = cat.table("laion")["vec"][:1200]
    q = cat.table("queries")["embedding"][0]
    mask = cat.table("laion")["price"][:1200] < 40.0
    sh_corpus, sh_ids = collectives.shard_corpus(mesh, corpus, axes)
    per = 1200 // len(sh_corpus)
    sh_mask = [mask[i * per:(i + 1) * per] for i in range(len(sh_corpus))]
    flat = FlatIndex(Metric.INNER_PRODUCT, corpus)
    ids, sims, valid = collectives.distributed_topk(
        mesh, Metric.INNER_PRODUCT, 7, axes)(sh_corpus, sh_ids, q, sh_mask)
    want = flat.topk(q, 7, mask)
    assert torch.equal(ids, want[0]) and torch.equal(valid, want[2])
    assert torch.allclose(sims, want[1], atol=TOL, rtol=0)
    ids, sims, valid, count = collectives.distributed_range(
        mesh, Metric.INNER_PRODUCT, 8, axes)(sh_corpus, sh_ids, q, radius,
                                             sh_mask)
    hit, _raw = flat.range_mask(q, radius, mask)
    assert int(count) == int(hit.sum())
    assert ids.shape[0] == 8 * len(sh_corpus)
    got = set(ids[valid].tolist())
    assert got <= set(torch.nonzero(hit).reshape(-1).tolist())
    assert len(got) == min(int(hit.sum()), int(valid.sum()))
    if len(sh_corpus) > 1:
        with pytest.raises(ValueError, match="divide"):
            collectives.shard_corpus(mesh, corpus[:1199], axes)


# ---------------------------------------------------------------------------
# the live corpus under dist
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2])
def test_live_corpus_under_dist(tmp_path, shards):
    """Q1, Q2 and Q6 under ``dist`` over a live corpus equal the live flat
    plans bit for bit at zero delta and at half delta fill, and after a
    compaction (which rebuilds the handle)."""
    small = dict(SMALL, n_rows=240)
    cat = make_laion_catalog(**small, device="cpu")
    for table in ("products", "images", "recipes"):
        attach_live(cat, table, "embedding",
                    os.fspath(tmp_path / table), delta_cap=16)
    live = cat.live_for("products", "embedding")
    qs = cat.table("queries")["embedding"].numpy()
    sims = qs @ cat.table("laion")["vec"].numpy().T
    r = np.float32(np.median(np.partition(sims, -20, axis=1)[:, -20]))
    cases = [(Q1, [{"qv": qs[i], "p": np.float32(60.0)} for i in range(4)]),
             (Q1_NOFILTER, [{"qv": qs[i]} for i in range(3)]),
             (Q2, [{"qv": qs[i], "r": r, "d": np.int32(10)}
                   for i in range(4)]),
             (Q6, [{"r": r}])]
    flat = connect(cat, **FLAT)
    dist = connect(cat, **FLAT, dist=DistSpec((shards,)))
    stmts = [(flat.prepare(sql), dist.prepare(sql), b) for sql, b in cases]

    def check(ctx):
        for f, d, b in stmts:
            _bitwise(f.execute(b).data, d.execute(b).data, ctx)

    check("zero delta")
    rng = np.random.default_rng(5)
    vec = rng.standard_normal((8, small["dim"])).astype(np.float32)
    vec[:4] = qs[:4] + 0.01 * vec[:4]
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    live.insert(np.arange(5000, 5008), vec)
    live.delete([3, 5000])
    assert live.freshness()["delta_rows"] == 7
    check("half delta")
    handle = live._dev[f"sharded:{DistSpec((shards,))!r}"]
    live.compact()
    check("compacted")
    assert live._dev[f"sharded:{DistSpec((shards,))!r}"] is not handle
