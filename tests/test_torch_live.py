"""The port's live corpus (``repro_torch.data.mutations``) against the
reference's (``tests/test_live.py``'s scenarios).

Both packages attach a live corpus to the same seeded catalog and run the
same interleaving of inserts and deletes, then a compaction, under Q1–Q6 ×
{brute, chase}.  Held: ids, valid lanes and counters exactly equal, sims
within 1e-5 (D = 16), at the user-id level before the compaction and raw
after it.  Under ``chase`` the port probes the reference's live IVF
(carried over with ``ivf_from_numpy`` after the attach and after the
compaction: the packages seed k-means differently).  Inside the port:
every mutation reaches already-prepared statements with no executor
rebuilt, a compacted corpus equals a fresh attach of its rows bit for bit
(its own IVF included), the quantized live plans equal the fp32 ones bit
for bit, a pinned IVF list capacity gives the derived one's answers bit for
bit, and a live directory the reference wrote recovers in the port.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.api import connect as ref_connect
from repro.core.physical import EngineOptions as RefOptions
from repro.core.physical import ProbeConfig as RefProbe
from repro.data import make_laion_catalog as ref_make_catalog
from repro.data.mutations import attach_live as ref_attach_live
from repro.serving.faults import FaultInjector as RefFaults
from repro.serving.faults import FaultSpec as RefFaultSpec
from repro.serving.faults import InjectedCrashError as RefCrash
from repro_torch.api import connect
from repro_torch.core.physical import EngineOptions, ProbeConfig
from repro_torch.core.schema import Metric, Table
from repro_torch.data import make_laion_catalog
from repro_torch.data.mutations import _read_wal, attach_live, recover
from repro_torch.index import build_ivf, ivf_from_numpy
from repro_torch.serving.resilience import (DeltaFullError,
                                            DuplicateIdError,
                                            InvalidVectorError,
                                            MutationError, UnknownIdError)

TOL = 1e-5
DIM = 16
N_ROWS = 240
DELTA_CAP = 16
CAP_MAIN = 304                         # fits the survivors of every scenario
NUM_CATEGORIES = 4
SMALL = dict(n_rows=N_ROWS, n_queries=4, dim=DIM, n_modes=8,
             num_categories=NUM_CATEGORIES, seed=0)
NLIST = 16
FIELDS = ("centroids", "lists", "list_sizes", "radii", "centroid_sq")
ALIASES = ("laion", "products", "images", "recipes", "movies")

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
CASES = {"q1": ("products", Q1), "q2": ("images", Q2),
         "q3": ("images", Q3), "q4": ("movies", Q4),
         "q5": ("recipes", Q5), "q6": ("recipes", Q6)}
PROBE = dict(max_probes=16, probe_batch=2, termination="counter")


def _catalogs():
    return ref_make_catalog(**SMALL), make_laion_catalog(**SMALL,
                                                         device="cpu")


def _binds(cat, case):
    qs = cat.table("queries")["embedding"].numpy().astype(np.float32)
    sims = qs @ cat.table("laion")["vec"].numpy().T
    r = np.float32(np.median(np.partition(sims, -20, axis=1)[:, -20]))
    per = {"q1": lambda i: {"qv": qs[i], "p": np.float32(1e9)},
           "q2": lambda i: {"qv": qs[i], "r": r, "d": np.int32(10)},
           "q3": lambda i: {"r": np.float32(r * (1 - 0.01 * i))},
           "q4": lambda i: {"y": np.int32(1985 + 3 * i)},
           "q5": lambda i: {"qv": qs[i], "r": r},
           "q6": lambda i: {"r": np.float32(r * (1 - 0.01 * i))}}[case]
    return [per(i) for i in range(4)]


def _unit(rng, n):
    v = rng.standard_normal((n, DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _mutations(rng):
    """One representative interleaving: two insert batches, and deletes
    that hit BOTH segments (original rows and a just-inserted row)."""
    c1 = {"price": np.full(5, 3.0, np.float32),
          "capture_date": np.full(5, 2000, np.int32),
          "calorie_level": np.arange(5, dtype=np.int32) % NUM_CATEGORIES,
          "cuisine": np.arange(5, dtype=np.int32) % NUM_CATEGORIES,
          "rating": np.arange(5, dtype=np.int32) % 5,
          "release_year": np.full(5, 2001, np.int32),
          "sample_id": np.arange(1000, 1005, dtype=np.int64)}
    return [("insert", np.arange(1000, 1005), _unit(rng, 5), c1),
            ("delete", [7, 31, 1002]),
            ("insert", np.arange(2000, 2003), _unit(rng, 3), None),
            ("delete", [2001, 100])]


def _apply(live, op):
    if op[0] == "insert":
        return live.insert(op[1], op[2], op[3])
    return live.delete(op[1])


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _tree(res, live=None):
    """Result leaves as numpy (counters flattened in); with ``live`` the
    slot ids mapped to user ids."""
    t = {k: _np(v) for k, v in res.data.items() if k != "stats"}
    t.update({f"stats.{k}": _np(v) for k, v in res.data["stats"].items()})
    if live is not None:
        key = "tid" if "tid" in t else "ids"
        t[key] = np.where(t["valid"], live.user_ids(t[key]), -1)
    return t


def _hold(got: dict, want: dict, what: str, bitwise: bool = False) -> None:
    assert got.keys() == want.keys(), (what, sorted(got), sorted(want))
    for k in want:
        if want[k].dtype.kind == "f" and not bitwise:
            np.testing.assert_allclose(
                np.where(got["valid"], got[k], 0),
                np.where(want["valid"], want[k], 0), rtol=0, atol=TOL,
                err_msg=f"{what} leaf {k}")
        else:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{what} leaf {k}")


def _carry(ref_idx):
    fields = {f: np.asarray(getattr(ref_idx, f)) for f in FIELDS}
    fields.update(nlist=ref_idx.nlist, cap=ref_idx.cap)
    return ivf_from_numpy(fields, Metric.INNER_PRODUCT, "cpu")


def _carry_index(ref_cat, cat, table):
    cat.register_index(table, "embedding",
                       _carry(ref_cat.index_for(table, "embedding")))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("engine", ["brute", "chase"])
def test_parity_interleaved(tmp_path, case, engine):
    table, sql = CASES[case]
    ref_cat, cat = _catalogs()
    kw = dict(delta_cap=DELTA_CAP, cap_main=CAP_MAIN,
              nlist=NLIST if engine == "chase" else None, iters=3)
    ref_live = ref_attach_live(ref_cat, table, "embedding",
                               os.fspath(tmp_path / "ref"), **kw)
    live = attach_live(cat, table, "embedding", os.fspath(tmp_path / "port"),
                       **kw)
    if engine == "chase":
        _carry_index(ref_cat, cat, table)
    ref_stmt = ref_connect(ref_cat, engine=engine,
                           probe=RefProbe(**PROBE)).prepare(sql)
    stmt = connect(cat, engine=engine, probe=ProbeConfig(**PROBE)).prepare(
        sql)
    binds = _binds(cat, case)
    _hold(_tree(stmt.execute(binds), live),
          _tree(ref_stmt.execute(binds), ref_live), f"{case} attach")

    for op in _mutations(np.random.default_rng(11)):
        _apply(ref_live, op)
        _apply(live, op)
    _hold(_tree(stmt.execute(binds), live),
          _tree(ref_stmt.execute(binds), ref_live), f"{case} mutated")

    ref_live.compact()
    live.compact()
    if engine == "chase":
        _carry_index(ref_cat, cat, table)
    _hold(_tree(stmt.execute(binds)), _tree(ref_stmt.execute(binds)),
          f"{case} compacted")


class _Logical:
    """Test-side logical corpus, uid -> row, kept apart from the
    LiveCorpus so the fresh-attach reference is built from first
    principles."""

    def __init__(self, cat):
        tab = cat.table("laion")
        self.schema = tab.schema
        self.col_names = [n for n in tab.schema.columns
                          if n not in ("vec", "embedding")]
        self.rows = {i: {"vec": tab["embedding"][i].numpy(),
                         **{n: tab[n][i].numpy() for n in self.col_names}}
                     for i in range(N_ROWS)}

    def apply(self, op):
        if op[0] == "delete":
            for u in op[1]:
                del self.rows[int(u)]
            return
        cols = op[3] or {}
        for j, u in enumerate(op[1]):
            self.rows[int(u)] = {
                "vec": op[2][j],
                **{n: (np.asarray(cols[n][j]) if n in cols
                       else np.zeros((), self.rows[0][n].dtype))
                   for n in self.col_names}}

    def frozen_catalog(self):
        """A fresh catalog whose tables ARE the survivors, sorted by uid
        (the canonical layout).  Returns it with the uids."""
        uids = np.array(sorted(self.rows), np.int64)
        cols = {n: torch.tensor(np.stack([self.rows[int(u)][n]
                                          for u in uids]))
                for n in ["vec"] + self.col_names}
        cols["embedding"] = cols["vec"]
        cat = make_laion_catalog(**SMALL, device="cpu")
        fresh = Table(self.schema, cols)
        for name in ALIASES:
            cat.register(name, fresh)
        return cat, uids


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("engine", ["brute", "chase"])
def test_compacted_equals_fresh_attach(tmp_path, case, engine):
    """In the port alone: a fresh attach of the survivors (sorted by user
    id, the canonical layout) answers as the mutated corpus does at the
    user-id level (the flat scan; the counters differ by the delta
    segment's scan), and after the compaction bit for bit, each side
    probing its own IVF (rebuilt from the fixed seed)."""
    table, sql = CASES[case]
    _, cat = _catalogs()
    logical = _Logical(cat)
    kw = dict(delta_cap=DELTA_CAP, cap_main=CAP_MAIN,
              nlist=NLIST if engine == "chase" else None, iters=3)
    live = attach_live(cat, table, "embedding", os.fspath(tmp_path / "a"),
                       **kw)
    stmt = connect(cat, engine=engine, probe=ProbeConfig(**PROBE)).prepare(
        sql)
    binds = _binds(cat, case)
    for op in _mutations(np.random.default_rng(11)):
        _apply(live, op)
        logical.apply(op)
    fresh_cat, uids = logical.frozen_catalog()
    fresh = attach_live(fresh_cat, table, "embedding",
                        os.fspath(tmp_path / "b"), ids=uids, **kw)
    want = connect(fresh_cat, engine=engine,
                   probe=ProbeConfig(**PROBE)).prepare(sql).execute(binds)
    if engine == "brute":
        def answers(res, lv):
            return {k: v for k, v in _tree(res, lv).items()
                    if not k.startswith("stats.")}

        _hold(answers(stmt.execute(binds), live), answers(want, fresh),
              f"{case} survivors")
    live.compact()
    _hold(_tree(stmt.execute(binds)), _tree(want), f"{case} compacted",
          bitwise=True)
    assert live.freshness()["live_rows"] == fresh.freshness()["live_rows"]


def test_mutations_rebind_with_zero_retraces(tmp_path):
    _, cat = _catalogs()
    live = attach_live(cat, "products", "embedding", os.fspath(tmp_path),
                       delta_cap=DELTA_CAP, cap_main=CAP_MAIN, nlist=NLIST,
                       iters=3)
    stmt = connect(cat, engine="chase",
                   probe=ProbeConfig(**PROBE)).prepare(Q1)
    binds = _binds(cat, "q1")
    stmt.execute(binds)
    traces = dict(stmt.executor.trace_counts)
    assert traces                        # the bucket's executor, built once
    rng = np.random.default_rng(0)
    v = _unit(rng, 2)
    live.insert([9000, 9001], v, {"price": [1.0, 1.0]})
    # a near-duplicate of query 0 is its first hit
    live.insert([9002], binds[0]["qv"][None], {"price": [1.0]})
    r1 = stmt.execute(binds)
    assert live.user_ids(r1.ids[0, :1]).tolist() == [9002]
    live.delete([9000, 9002])
    r2 = stmt.execute(binds)
    assert not np.isin(live.user_ids(r2.ids), [9000, 9002]).any()
    live.compact()
    r3 = stmt.execute(binds)
    # every mutation and the compaction seen, no executor rebuilt
    assert dict(stmt.executor.trace_counts) == traces
    assert stmt.compiled.rebinds >= 3
    assert r3.explain().freshness["delta_rows"] == 0


def test_tombstoned_rows_never_surface(tmp_path):
    _, cat = _catalogs()
    live = attach_live(cat, "products", "embedding", os.fspath(tmp_path),
                       delta_cap=DELTA_CAP, cap_main=CAP_MAIN)
    stmt = connect(cat, engine="brute").prepare(Q1)
    b = _binds(cat, "q1")[0]
    best = int(stmt.execute(b).ids[0])
    live.delete([int(live.user_ids(np.array([best]))[0])])
    after = live.user_ids(stmt.execute(b).ids)
    assert best not in after.tolist()


def test_typed_mutation_errors_leave_no_partial_state(tmp_path):
    _, cat = _catalogs()
    live = attach_live(cat, "products", "embedding", os.fspath(tmp_path),
                       delta_cap=8, cap_main=CAP_MAIN)
    rng = np.random.default_rng(0)
    ok = rng.standard_normal((1, DIM)).astype(np.float32)
    before = live.freshness()
    with pytest.raises(DuplicateIdError):
        live.insert([3], ok)             # uid 3 lives in the main segment
    with pytest.raises(UnknownIdError):
        live.delete([123456])
    with pytest.raises(InvalidVectorError):
        live.insert([5000], np.full((1, DIM), np.nan, np.float32))
    with pytest.raises(DeltaFullError) as excinfo:
        live.insert(np.arange(5000, 5009),
                    rng.standard_normal((9, DIM)).astype(np.float32))
    assert excinfo.value.capacity == 8   # the SEGMENT capacity, not free
    assert excinfo.value.free_slots == 8
    assert excinfo.value.requested == 9
    with pytest.raises(MutationError):
        live.insert([6000], ok, {"no_such_col": [1]})
    with pytest.raises(MutationError):   # dim mismatch
        live.insert([6000], np.zeros((1, DIM + 1), np.float32))
    assert live.freshness() == before    # failed mutations applied nothing
    assert live.lsn == before["lsn"]
    with open(live.wal_path, "rb") as f:
        assert f.read() == b""           # and logged nothing


def test_concurrent_mutations_serialize(tmp_path):
    """Racing inserts from a thread pool (the front door's executor shape)
    fully serialize: distinct LSNs, distinct slots with each batch's own
    vectors, and WAL order = LSN order, so replay reproduces the live
    order; a re-bind racing them sees whole mutations only."""
    from concurrent.futures import ThreadPoolExecutor

    _, cat = _catalogs()
    live = attach_live(cat, "products", "embedding", os.fspath(tmp_path),
                       delta_cap=DELTA_CAP, cap_main=CAP_MAIN)
    stmt = connect(cat, engine="brute").prepare(Q1)
    binds = _binds(cat, "q1")
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((12, DIM)).astype(np.float32)
    with ThreadPoolExecutor(max_workers=8) as ex:
        lsns = ex.map(lambda i: live.insert([4000 + i], vecs[i:i + 1]),
                      range(12))
        while not live.delta_count == 12:
            stmt.execute(binds)
        lsns = list(lsns)
    assert len(set(lsns)) == 12          # no two writers shared an LSN
    assert live.delta_count == 12        # no batch overwrote another's slot
    for i in range(12):
        seg, slot = live._uid_loc[4000 + i]
        assert seg == "d"
        np.testing.assert_array_equal(live.delta_vec[slot], vecs[i])
    records, _ = _read_wal(live.wal_path)
    wal_lsns = [r["lsn"] for r in records]
    assert wal_lsns == sorted(wal_lsns)  # WAL order == LSN order
    res = stmt.execute(binds)
    fresh = connect(cat, engine="brute").prepare(Q1)
    assert torch.equal(res.ids, fresh.execute(binds).ids)


def test_explain_surfaces_freshness(tmp_path):
    _, cat = _catalogs()
    db = connect(cat, engine="brute")
    db.attach_live("products", "embedding", os.fspath(tmp_path),
                   delta_cap=DELTA_CAP, cap_main=CAP_MAIN)
    stmt = db.prepare(Q1)
    res = stmt.execute(_binds(cat, "q1")[0])
    rng = np.random.default_rng(0)
    db.insert("products", [7000],
              rng.standard_normal((1, DIM)).astype(np.float32))
    rep = res.explain()                  # read lazily: sees the insert
    assert rep.freshness["delta_rows"] == 1
    assert rep.freshness["tombstones"] == 0
    assert "-- live:" in rep.render()
    db.delete("products", [7000, 3])
    assert db.freshness("products")["tombstones"] == 2
    lsn = db.compact("products")
    rep2 = stmt.explain()
    assert rep2.freshness["last_compact_lsn"] == lsn
    assert rep2.freshness["delta_rows"] == 0
    # statements on tables WITHOUT a live corpus report no freshness
    other = db.prepare(Q2.replace("images", "laion"))
    assert other.explain().freshness is None
    with pytest.raises(MutationError, match="no live corpus"):
        db.insert("laion", [1], np.zeros((1, DIM), np.float32))


@pytest.mark.parametrize("engine,lowering", [("pase", "batch"),
                                             ("vbase", "batch"),
                                             ("brute_sort", "batch"),
                                             ("chase", "perleft")])
def test_live_requires_exact_engines(tmp_path, engine, lowering):
    ref_cat, cat = _catalogs()
    kw = dict(delta_cap=DELTA_CAP, cap_main=CAP_MAIN)
    ref_attach_live(ref_cat, "movies", "embedding",
                    os.fspath(tmp_path / "ref"), **kw)
    attach_live(cat, "movies", "embedding", os.fspath(tmp_path / "port"),
                **kw)
    sql = Q4 if engine == "brute_sort" or lowering == "perleft" else \
        Q1.replace("products", "movies")
    with pytest.raises(ValueError, match="live corpus") as ref_err:
        ref_connect(ref_cat, RefOptions(engine=engine,
                                        join_lowering=lowering)).prepare(sql)
    with pytest.raises(ValueError, match="live corpus") as err:
        connect(cat, EngineOptions(engine=engine,
                                   join_lowering=lowering)).prepare(sql)
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("case", ["q1", "q2", "q5"])
def test_single_query_path_matches_batch(tmp_path, case):
    table, sql = CASES[case]
    _, cat = _catalogs()
    live = attach_live(cat, table, "embedding", os.fspath(tmp_path),
                       delta_cap=DELTA_CAP, cap_main=CAP_MAIN)
    rng = np.random.default_rng(5)
    live.insert([8000], _unit(rng, 1), {"price": [2.0]})
    for use_pallas in (False, True):
        stmt = connect(cat, engine="brute",
                       use_pallas=use_pallas).prepare(sql)
        binds = _binds(cat, case)
        batch = stmt.execute(binds)
        for i, b in enumerate(binds):
            single = _tree(stmt.execute(b))
            row = _tree(batch.query(i))
            # ids, lanes and counters exact; sims to 1e-5 (the CPU's plain
            # products round a batch row apart from a single query's)
            _hold(single, row, f"{case} single {i} pallas={use_pallas}")


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_live_quant_parity_and_zero_retrace(tmp_path, mode):
    """Live mutations under quant: the main segment scans its quantized
    twin, the delta stays fp32, and insert, delete and compact stay bit
    for bit equal to the identically mutated fp32 plan (and within 1e-5
    of the reference's fp32 plan), with no executor rebuilt."""
    kw = dict(delta_cap=16, cap_main=304)
    ref_cat, cat = _catalogs()
    _, fcat = _catalogs()
    ref_live = ref_attach_live(ref_cat, "products", "embedding",
                               os.fspath(tmp_path / "r"), **kw)
    lives = [attach_live(cat, "products", "embedding",
                         os.fspath(tmp_path / "a"), **kw),
             attach_live(fcat, "products", "embedding",
                         os.fspath(tmp_path / "b"), **kw)]
    stmt = connect(cat, EngineOptions(engine="brute", use_pallas=True,
                                      quant=mode)).prepare(Q1)
    fp32 = connect(fcat, EngineOptions(engine="brute",
                                       use_pallas=True)).prepare(Q1)
    ref = ref_connect(ref_cat, RefOptions(engine="brute",
                                          use_pallas=False)).prepare(Q1)
    qs = cat.table("queries")["embedding"].numpy()
    binds = [{"qv": qs[i], "p": np.float32(1e9)} for i in range(3)]

    def check(what):
        got = _tree(stmt.execute(binds))
        _hold(got, _tree(fp32.execute(binds)), f"{what}/{mode}",
              bitwise=True)
        _hold(got, _tree(ref.execute(binds)), f"{what}/{mode} reference")

    check("attach")
    traces = dict(stmt.executor.trace_counts)
    assert traces
    v = _unit(np.random.default_rng(2), 3)
    for lv in lives + [ref_live]:
        lv.insert([9000, 9001, 9002], v,
                  {"price": np.full(3, 1.0, np.float32)})
    check("insert")
    for lv in lives + [ref_live]:
        lv.delete([9001, 17])
    check("delete")
    for lv in lives + [ref_live]:
        lv.compact()                 # the canonical swap re-quantizes
    check("compact")
    assert dict(stmt.executor.trace_counts) == traces
    assert "quant:" + mode in lives[0]._dev


@pytest.mark.parametrize("case", ["q1", "q2", "q5"])
def test_pinned_cap_equals_derived_cap(tmp_path, case):
    """The port derives the live IVF's list capacity from its largest
    cluster; the reference pins it at cap_main.  The answers (ids, sims,
    hit order, counters) do not depend on it: bit for bit."""
    table, sql = CASES[case]
    _, cat = _catalogs()
    live = attach_live(cat, table, "embedding", os.fspath(tmp_path),
                       delta_cap=DELTA_CAP, cap_main=CAP_MAIN, nlist=NLIST,
                       iters=3)
    _apply(live, ("insert", [5000], _unit(np.random.default_rng(1), 1),
                  None))
    derived = cat.index_for(table, "embedding")
    stmt = connect(cat, engine="chase",
                   probe=ProbeConfig(**PROBE)).prepare(sql)
    binds = _binds(cat, case)
    want = _tree(stmt.execute(binds))
    lists = torch.full((NLIST, CAP_MAIN), -1, dtype=torch.int32)
    lists[:, :derived.cap] = derived.lists
    pinned = dataclasses.replace(derived, lists=lists, cap=CAP_MAIN)
    assert CAP_MAIN > derived.cap
    cat.register_index(table, "embedding", pinned)
    _hold(_tree(stmt.execute(binds)), want, f"{case} pinned cap",
          bitwise=True)


def test_live_ivf_clusters_filled_slots_only(tmp_path):
    """The live IVF trains on, and lists, the main segment's filled slots
    (not its zero pad slots): at attach it is the index of the frozen
    column from the same seed, list for list, and a compaction rebuilds it
    over the survivors, tombstones gone."""
    _, cat = _catalogs()
    frozen = build_ivf(torch.Generator().manual_seed(0),
                       cat.table("products")["embedding"], NLIST, iters=3)
    live = attach_live(cat, "products", "embedding", os.fspath(tmp_path),
                       delta_cap=DELTA_CAP, cap_main=CAP_MAIN, nlist=NLIST,
                       iters=3)
    index = cat.index_for("products", "embedding")
    assert index.cap == frozen.cap
    for f in ("centroids", "lists", "list_sizes", "radii"):
        assert torch.equal(getattr(index, f), getattr(frozen, f)), f
    live.delete([3, 4])
    live.insert([900], _unit(np.random.default_rng(2), 1))
    live.compact()
    index = cat.index_for("products", "embedding")
    members = index.lists[index.lists >= 0]
    assert torch.equal(torch.sort(members).values,
                       torch.arange(N_ROWS - 1, dtype=torch.int32))


def test_reference_directory_recovers_in_the_port(tmp_path):
    """The reference writes a live directory (attach, mutations, a
    snapshot, more mutations, a torn WAL tail); the port's ``recover``
    reads it into the state the reference's own recovery reaches, and its
    answers hold against the reference's."""
    from repro.data.mutations import recover as ref_recover

    path = os.fspath(tmp_path / "live")
    ref_cat, cat = _catalogs()
    faults = RefFaults(RefFaultSpec(seed=0, crash_site="wal.torn_append",
                                    crash_at=1))
    ref_live = ref_attach_live(ref_cat, "products", "embedding", path,
                               delta_cap=DELTA_CAP, cap_main=CAP_MAIN,
                               faults=None)
    ops = _mutations(np.random.default_rng(11))
    for op in ops[:2]:
        _apply(ref_live, op)
    ref_live.snapshot()
    _apply(ref_live, ops[2])
    ref_live._faults = faults
    with pytest.raises(RefCrash):
        _apply(ref_live, ops[3])

    rec = recover(cat, "products", "embedding", path)
    ref_cat2, _ = _catalogs()
    ref_rec = ref_recover(ref_cat2, "products", "embedding", path)
    want = ref_rec._state_tree()
    got = rec._state_tree()
    for key in ("lsn", "compact_lsn"):   # read off the same disk
        assert int(got.pop(key)) == int(want.pop(key))

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    g, w = dict(flat(got)), dict(flat(want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g[k].dtype == w[k].dtype, k
    binds = _binds(cat, "q1")
    _hold(_tree(connect(cat, engine="brute").prepare(Q1).execute(binds),
                rec),
          _tree(ref_connect(ref_cat2, engine="brute").prepare(Q1)
                .execute(binds), ref_rec), "recovered q1")
    # the port appends after the reference's records, and recovers again
    rec.insert([7777], _unit(np.random.default_rng(4), 1))
    _, cat3 = _catalogs()
    again = recover(cat3, "products", "embedding", path)
    assert again.lsn == rec.lsn and 7777 in again._uid_loc


def test_attach_rejections_touch_no_disk(tmp_path):
    _, cat = _catalogs()
    path = tmp_path / "x"
    with pytest.raises(ValueError, match="unique"):
        attach_live(cat, "products", "embedding", os.fspath(path),
                    ids=np.zeros(N_ROWS, np.int64))
    with pytest.raises(ValueError, match="not a vector column"):
        attach_live(cat, "products", "price", os.fspath(path))
    assert not path.exists()
    with pytest.raises(FileNotFoundError):
        recover(cat, "products", "embedding", os.fspath(path))


def test_front_door_mutations_reach_served_queries(tmp_path):
    """``QueryServer.submit_mutation`` applies inserts and deletes on the
    front door's thread pool while drains re-bind on their own threads:
    each query submitted after its near-duplicate's insert returns that
    row first, and after the delete never sees it; a compaction through
    the front door keeps the answers."""
    import asyncio

    from repro_torch.launch.serve import QueryServer, ServeConfig
    from repro_torch.serving.resilience import AdmissionConfig
    from repro_torch.serving.scheduler import SchedulerConfig

    _, cat = _catalogs()
    live = attach_live(cat, "products", "embedding", os.fspath(tmp_path),
                       delta_cap=DELTA_CAP, cap_main=CAP_MAIN, nlist=NLIST,
                       iters=3)
    stmt = connect(cat, engine="chase",
                   probe=ProbeConfig(**PROBE)).prepare(Q1)
    binds = _binds(cat, "q1")
    config = ServeConfig(admission=AdmissionConfig(max_queue_depth=64),
                         scheduler=SchedulerConfig(max_batch=4,
                                                   max_wait_ms=5.0))
    rng = np.random.default_rng(8)

    async def scenario():
        async with QueryServer(stmt, config) as server:
            for i, b in enumerate(binds):
                q = b["qv"] + 0.01 * rng.standard_normal(DIM)
                await server.submit_mutation(
                    "insert", ids=[6000 + i],
                    vectors=(q / np.linalg.norm(q))[None].astype(np.float32),
                    columns={"price": [1.0]})
            outs = await asyncio.gather(*(server.submit(b) for b in binds))
            firsts = [int(live.user_ids(o.ids[:1])[0]) for o in outs]
            await server.submit_mutation("delete", ids=[6000, 6001])
            outs = await asyncio.gather(*(server.submit(b) for b in binds))
            gone = [live.user_ids(o.ids).tolist() for o in outs]
            lsn = await server.submit_mutation("compact")
            outs = await asyncio.gather(*(server.submit(b) for b in binds))
            after = [live.user_ids(o.ids).tolist() for o in outs]
            return firsts, gone, lsn, after

    firsts, gone, lsn, after = asyncio.run(scenario())
    assert firsts == [6000, 6001, 6002, 6003]
    assert all(6000 not in g and 6001 not in g for g in gone)
    assert live.freshness()["last_compact_lsn"] == lsn
    assert [g[:2] for g in gone[2:]] == [a[:2] for a in after[2:]]
    assert [a[0] for a in after[2:]] == [6002, 6003]


def test_checkpointer_round_trip_gc_and_reference_layout(tmp_path):
    """The port's checkpointer against the reference's: a step one package
    writes restores in the other, leaf names and all; keep_last_k keeps the
    newest steps, an uncommitted (manifest-less) step is invisible, and the
    async wrapper surfaces a failed save on ``wait()``."""
    from repro.checkpoint import checkpointer as ref_ckpt
    from repro_torch.checkpoint import Checkpointer, checkpointer

    tree = {"main_vec": np.arange(12, dtype=np.float32).reshape(3, 4),
            "lsn": np.int64(7), "cols": {"price": np.ones(3, np.float32),
                                         "rating": np.arange(3, dtype=np.int32)},
            "dcols": {}}
    ref_dir, dir_ = os.fspath(tmp_path / "ref"), os.fspath(tmp_path / "port")
    ref_ckpt.save(ref_dir, 7, tree)
    checkpointer.save(dir_, 7, tree)
    for a, b in ((ref_dir, dir_), (dir_, ref_dir)):
        with np.load(os.path.join(a, "step_7", "host_0.npz")) as fa, \
                np.load(os.path.join(b, "step_7", "host_0.npz")) as fb:
            assert sorted(fa.files) == sorted(fb.files)
    got = checkpointer.restore(ref_dir, 7, tree)
    want = ref_ckpt.restore(dir_, 7, tree)
    for key in ("main_vec", "lsn"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    np.testing.assert_array_equal(got["cols"]["rating"],
                                  np.asarray(want["cols"]["rating"]))
    assert got["cols"]["rating"].dtype == np.int32
    with pytest.raises(ValueError, match="shape"):
        checkpointer.restore(dir_, 7, {**tree, "main_vec": np.zeros(3)})

    for step in (8, 9, 10):
        checkpointer.save(dir_, step, tree, keep_last_k=2)
    os.makedirs(os.path.join(dir_, "step_11"))       # never committed
    assert checkpointer.latest_steps(dir_) == [9, 10]
    assert checkpointer.latest_step(dir_) == 10

    ck = Checkpointer(os.fspath(tmp_path / "async"), keep_last_k=1)
    ck.save_async(1, {"x": torch.arange(4)})
    ck.wait()
    assert checkpointer.latest_step(ck.ckpt_dir) == 1
    blocked = tmp_path / "a_file"
    blocked.write_text("")
    ck = Checkpointer(os.fspath(blocked))   # no directory can go there
    ck.save_async(2, {"x": np.zeros(2)})
    with pytest.raises(FileExistsError):
        ck.wait()
    ck.wait()                            # the error surfaces once
