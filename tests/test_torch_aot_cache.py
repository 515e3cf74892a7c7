"""The port's on-disk plan cache (``repro_torch.core.aot``): warm restarts,
hardened — every case of the reference's ``tests/test_aot_cache.py``, plus
the port's own parts.

* **cross-process warm restart** — subprocess A prepares Q1–Q6 under
  ``aot_cache_path`` and persists; a fresh subprocess B prepares the same
  statements with ``analyze`` and ``rewrite`` replaced by functions that
  count their calls, and executes with no executor built
  (``trace_counts`` 0, ``aot_loaded`` 1 per statement, neither function
  called), bit for bit the results of an in-process plan with no cache;
* **in-process restart**, **eviction to disk**, and a **catalog bump**
  that invalidates the persisted entry itself;
* **poisoning** — a truncated entry, garbage bytes, a flipped
  torch-version header, a stale catalog token and an entry written by the
  reference each degrade to a clean cold miss with a typed
  :class:`~repro_torch.api.AOTCacheWarning` and the matching counter; no
  exception escapes prepare or execute;
* **the kernel annex** (stand-in library bytes, a temporary
  ``build.BUILD_DIR``): a library the bucket reached is stored once under
  ``kernels/<target name>`` and written back on a hit; a bad sha256 is a
  ``corrupt`` count and the normal build;
* **unserializable plans** fall back to the plain executor;
* the explain line, a shared cache directory, ``export_batch`` /
  ``deserialize_batch``, and ``catalog_token`` equal to the reference's.

This file doubles as the subprocess child script (``__main__`` guard at the
bottom): children rebuild the same seeded catalog and IVF index, so bitwise
comparison across processes is meaningful.  Nothing here imports JAX at
module level: the children run the port alone.
"""
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import AOTCacheWarning, connect
from repro_torch.core import EngineOptions, Metric
from repro_torch.core import compiler as compiler_mod
from repro_torch.core.aot import (MAGIC, AOTPlanCache, args_signature,
                                  catalog_token, export_plan)
from repro_torch.core.compiler import CompiledQuery, _catalog_dep_keys
from repro_torch.core.physical import ProbeConfig
from repro_torch.data import make_laion_catalog
from repro_torch.index import build_ivf
from repro_torch.kernels import build

PROBE = ProbeConfig(max_probes=8, capacity=64, termination="bound",
                    probe_batch=2)
DIM = 16
QN = 5                                       # bucketed: pads 5 -> 8
SMALL = dict(n_rows=500, n_queries=4, dim=DIM, n_modes=8, num_categories=4,
             seed=0)

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
ALL_SQL = {"q1": Q1, "q2": Q2, "q3": Q3, "q4": Q4, "q5": Q5, "q6": Q6}
INDEXED = ("laion", "products", "images", "recipes", "movies")


# ---------------------------------------------------------------------------
# deterministic env + binds (identical in every process)
# ---------------------------------------------------------------------------

def build_env():
    """The cross-process-deterministic env: seeded catalog, seeded IVF
    build, and the radius children and parent agree on bit for bit."""
    cat = make_laion_catalog(**SMALL, device="cpu")
    idx = build_ivf(torch.Generator().manual_seed(0),
                    cat.table("laion")["vec"], nlist=8,
                    metric=Metric.INNER_PRODUCT, iters=3)
    for name in INDEXED:
        cat.register_index(name, "vec", idx)
        cat.register_index(name, "embedding", idx)
    sims = (cat.table("queries")["embedding"].numpy()
            @ cat.table("laion")["vec"].numpy().T)
    radius = float(np.median(np.partition(sims, -30, axis=1)[:, -30]))
    return cat, radius


def _qvecs(cat, qn):
    base = cat.table("queries")["embedding"].numpy()
    rng = np.random.default_rng(3)
    reps = -(-qn // base.shape[0])
    qs = np.tile(base, (reps, 1))[:qn]
    return (qs + 0.01 * rng.standard_normal(qs.shape)).astype(np.float32)


def binds_for(case, cat, radius, qn=QN):
    """Deterministic per-case bind sets (same in every process)."""
    rng = np.random.default_rng(7)
    price = cat.table("laion")["price"].numpy()
    dates = cat.table("laion")["capture_date"].numpy()
    years = cat.table("movies")["release_year"].numpy()
    qs = _qvecs(cat, qn)
    out = []
    for i in range(qn):
        if case == "q1":
            out.append({"qv": qs[i], "p": np.float32(np.quantile(
                price, rng.uniform(0.3, 1.0)))})
        elif case == "q2":
            out.append({"qv": qs[i],
                        "r": np.float32(radius * rng.uniform(0.95, 1.0)),
                        "d": np.int32(np.quantile(
                            dates, rng.uniform(0.2, 0.8)))})
        elif case in ("q3", "q6"):
            out.append({"r": np.float32(radius * rng.uniform(0.95, 1.0))})
        elif case == "q4":
            out.append({"y": np.int32(np.quantile(
                years, rng.uniform(0.1, 0.6)))})
        elif case == "q5":
            out.append({"qv": qs[i],
                        "r": np.float32(radius * rng.uniform(0.95, 1.0))})
    return out


def _options():
    return EngineOptions(engine="chase", probe=PROBE)


def ser_tree(data, prefix: str = "") -> dict:
    """Bit-exact, JSON-safe serialization of an output tree (dtype + shape
    + raw bytes hex per leaf): equality of these dicts IS bit-parity."""
    out = {}
    for key in sorted(data):
        leaf = data[key]
        if isinstance(leaf, dict):
            out.update(ser_tree(leaf, f"{prefix}{key}."))
            continue
        arr = leaf.detach().cpu().numpy() if isinstance(
            leaf, torch.Tensor) else np.asarray(leaf)
        out[prefix + key] = {"dtype": str(arr.dtype),
                             "shape": list(arr.shape),
                             "hex": np.ascontiguousarray(arr)
                             .tobytes().hex()}
    return out


def _run_all(db, cat, radius, cases=None) -> dict:
    out = {}
    for case in sorted(cases or ALL_SQL):
        st = db.prepare(ALL_SQL[case])
        res = st.execute(binds_for(case, cat, radius))
        out[case] = {"data": ser_tree(res.data),
                     "trace_counts": {str(k): v for k, v
                                      in st.executor.trace_counts.items()},
                     "aot_loaded": {str(k): v for k, v
                                    in st.executor.aot_loaded.items()}}
    return out


def child_main(aot_dir: str, out_path: str) -> None:
    """Subprocess entry: build the deterministic env, prepare + execute
    Q1–Q6 under ``aot_cache_path`` with ``analyze`` and ``rewrite``
    counted, dump results + executor state + the counts."""
    calls = {"analyze": 0, "rewrite": 0}
    for name in calls:
        real = getattr(compiler_mod, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        setattr(compiler_mod, name, counted)
    cat, radius = build_env()
    db = connect(cat, _options(), aot_cache_path=aot_dir)
    results = _run_all(db, cat, radius)
    with open(out_path, "w") as f:
        json.dump({"results": results, "aot": db.cache_info().aot,
                   "calls": calls}, f)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def env():
    return build_env()


@pytest.fixture()
def aot_dir(tmp_path):
    return str(tmp_path / "aotcache")


def _spawn_child(aot_dir: str, out_path: str) -> None:
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = (os.path.abspath(src) + os.pathsep
                               + child_env.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child",
         aot_dir, out_path],
        env=child_env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (
        f"child failed:\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")


# ---------------------------------------------------------------------------
# cross-process warm restart
# ---------------------------------------------------------------------------

def test_cross_process_warm_restart(env, aot_dir, tmp_path):
    """Process A persists Q1–Q6; fresh process B restores every plan with
    no ``analyze`` / ``rewrite`` call and every bucket with no executor
    built, bit for bit; an in-process plan with no cache agrees with
    both."""
    out_a = str(tmp_path / "a.json")
    out_b = str(tmp_path / "b.json")
    _spawn_child(aot_dir, out_a)
    _spawn_child(aot_dir, out_b)
    with open(out_a) as f:
        a = json.load(f)
    with open(out_b) as f:
        b = json.load(f)

    # A compiled cold (one executor per case) and persisted every bucket
    for case, rep in a["results"].items():
        assert sum(rep["trace_counts"].values()) == 1, (case, rep)
        assert rep["aot_loaded"] == {}, case
    assert a["aot"]["saves"] == len(ALL_SQL)
    assert a["aot"]["hits"] == 0
    assert a["calls"] == {"analyze": len(ALL_SQL), "rewrite": len(ALL_SQL)}

    # B restored every plan and bucket from disk: nothing built or analysed
    for case, rep in b["results"].items():
        assert all(v == 0 for v in rep["trace_counts"].values()), (case, rep)
        assert sum(rep["aot_loaded"].values()) == 1, (case, rep)
    assert b["aot"]["hits"] == len(ALL_SQL)
    assert b["aot"]["corrupt"] == b["aot"]["stale"] == 0
    assert b["aot"]["saves"] == b["aot"]["misses"] == 0
    assert b["calls"] == {"analyze": 0, "rewrite": 0}

    # bit-identical across the restart ...
    for case in ALL_SQL:
        assert a["results"][case]["data"] == b["results"][case]["data"], case

    # ... and bit-identical to an in-process plan with NO cache
    cat, radius = env
    ref = _run_all(connect(cat, _options()), cat, radius)
    for case in ALL_SQL:
        assert ref[case]["data"] == a["results"][case]["data"], case


def test_in_process_restart_zero_traces(env, aot_dir, monkeypatch):
    """Two sessions over one catalog: the second restores from disk (no
    executor built, no ``analyze`` / ``rewrite``, bit-parity)."""
    cat, radius = env
    cases = ("q1", "q5")
    first = _run_all(connect(cat, _options(), aot_cache_path=aot_dir),
                     cat, radius, cases)

    def forbidden(*_a, **_k):
        raise AssertionError("front end called on a restored plan")

    monkeypatch.setattr(compiler_mod, "analyze", forbidden)
    monkeypatch.setattr(compiler_mod, "rewrite", forbidden)
    db2 = connect(cat, _options(), aot_cache_path=aot_dir)
    second = _run_all(db2, cat, radius, cases)
    for case in cases:
        assert first[case]["data"] == second[case]["data"]
        assert all(v == 0 for v in second[case]["trace_counts"].values())
        assert sum(second[case]["aot_loaded"].values()) == 1
    assert db2.cache_info().aot["hits"] == len(cases)


def test_eviction_to_disk_round_trip(env, aot_dir):
    """An LRU-evicted plan re-prepared later restores its bucket from disk:
    eviction evicts to disk, not to nothing."""
    cat, radius = env
    db = connect(cat, _options(), max_cached_plans=1,
                 aot_cache_path=aot_dir)
    st1 = db.prepare(Q1)
    want = ser_tree(st1.execute(binds_for("q1", cat, radius)).data)
    db.prepare(Q5).execute(binds_for("q5", cat, radius))   # evicts Q1
    assert db.cache_info().evictions >= 1

    st1b = db.prepare(Q1)                                  # re-prepare
    got = st1b.execute(binds_for("q1", cat, radius))
    assert ser_tree(got.data) == want
    assert all(v == 0 for v in st1b.executor.trace_counts.values()), (
        st1b.executor.trace_counts)
    assert sum(st1b.executor.aot_loaded.values()) == 1


# ---------------------------------------------------------------------------
# invalidation: catalog structural drift kills the DISK entry
# ---------------------------------------------------------------------------

def test_catalog_bump_invalidates_persisted_entry(aot_dir):
    """Re-registering a table after persisting invalidates the disk entry
    (stale counter, typed warning), and the recompiled plan sees the NEW
    data — never the old table's predicate column."""
    from repro_torch.core.schema import Table
    cat, radius = build_env()
    db = connect(cat, _options(), aot_cache_path=aot_dir)
    db.prepare(Q1).execute(binds_for("q1", cat, radius))
    assert db.cache_info().aot["saves"] == 1

    tab = cat.table("products")
    cols = {n: tab[n] for n in tab.schema.names()}
    cols["price"] = cols["price"] + 1000.0
    cat.register("products", Table(tab.schema, cols))

    db2 = connect(cat, _options(), aot_cache_path=aot_dir)
    with pytest.warns(AOTCacheWarning, match="stale"):
        st = db2.prepare(Q1)
        res = st.execute(binds_for("q1", cat, radius))
    assert db2.cache_info().aot["stale"] == 1
    # every price now exceeds the bind threshold: no rows can match
    assert not res["valid"].any()
    # the recompile re-persisted a fresh entry for the new catalog state
    assert db2.cache_info().aot["saves"] == 1
    db3 = connect(cat, _options(), aot_cache_path=aot_dir)
    st3 = db3.prepare(Q1)
    res3 = st3.execute(binds_for("q1", cat, radius))
    assert all(v == 0 for v in st3.executor.trace_counts.values())
    assert ser_tree(res3.data) == ser_tree(res.data)


# ---------------------------------------------------------------------------
# cache poisoning: every corruption degrades to a clean cold miss
# ---------------------------------------------------------------------------

def _entry_files(aot_dir):
    return sorted(os.path.join(aot_dir, f) for f in os.listdir(aot_dir)
                  if f.endswith(".aot"))


def _rewrite_header(path: str, **fields) -> None:
    """Rewrite header fields of an entry file, keeping the framing and the
    payload checksums valid — isolates the identity/token checks."""
    with open(path, "rb") as f:
        blob = f.read()
    off = len(MAGIC)
    (hlen,) = struct.unpack(">I", blob[off:off + 4])
    header = json.loads(blob[off + 4:off + 4 + hlen].decode())
    header.update(fields)
    hj = json.dumps(header, sort_keys=True).encode()
    with open(path, "wb") as f:
        f.write(MAGIC + struct.pack(">I", len(hj)) + hj
                + blob[off + 4 + hlen:])


def _reference_entry(path: str) -> None:
    """Overwrite ``path`` with an entry the reference's cache wrote for Q1
    on the same seeded catalog."""
    import tempfile

    from repro.api import connect as ref_connect
    from repro.core import EngineOptions as RefOptions
    from repro.data import make_laion_catalog as ref_make_catalog
    ref_cat = ref_make_catalog(**SMALL)
    with tempfile.TemporaryDirectory() as ref_dir:
        db = ref_connect(ref_cat, RefOptions(engine="brute"),
                         aot_cache_path=ref_dir)
        cat, radius = build_env()
        db.prepare(Q1).execute(binds_for("q1", cat, radius))
        (ref_file,) = [f for f in os.listdir(ref_dir) if f.endswith(".aot")]
        with open(os.path.join(ref_dir, ref_file), "rb") as f:
            blob = f.read()
    with open(path, "wb") as f:
        f.write(blob)


def _truncate(path: str) -> None:
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _garbage(path: str) -> None:
    with open(path, "wb") as f:
        f.write(b"\x00garbage" * 64)


POISONS = {
    "truncated": ("corrupt", _truncate),
    "garbage": ("corrupt", _garbage),
    "torch_version_skew": ("stale",
                           lambda p: _rewrite_header(
                               p, torch_version="0.0.0")),
    "catalog_token": ("stale",
                      lambda p: _rewrite_header(
                          p, catalog_token="deadbeef" * 8)),
    "reference_entry": ("corrupt", _reference_entry),
}


@pytest.mark.parametrize("poison", sorted(POISONS))
def test_poisoned_entry_is_clean_cold_miss(env, aot_dir, poison):
    cat, radius = env
    counter, mutate = POISONS[poison]
    want = ser_tree(connect(cat, _options(), aot_cache_path=aot_dir)
                    .prepare(Q1).execute(binds_for("q1", cat, radius)).data)
    (path,) = _entry_files(aot_dir)
    mutate(path)

    db = connect(cat, _options(), aot_cache_path=aot_dir)
    with pytest.warns(AOTCacheWarning, match=counter):
        st = db.prepare(Q1)
        res = st.execute(binds_for("q1", cat, radius))
    info = db.cache_info()
    assert info.aot[counter] == 1, (poison, info.aot)
    # degraded to a cold compile: one executor built, results bit-identical
    assert sum(st.executor.trace_counts.values()) == 1
    assert st.executor.aot_loaded == {}
    assert ser_tree(res.data) == want
    # the bad file was removed and a fresh entry re-persisted
    assert info.aot["saves"] == 1
    assert len(_entry_files(aot_dir)) == 1


# ---------------------------------------------------------------------------
# the kernel annex (stand-in library bytes)
# ---------------------------------------------------------------------------

FAKE_SOURCES = ("scan_topk_batch.cu", "range_scan_batch.cu")


@pytest.fixture()
def fake_build(tmp_path, monkeypatch):
    """A temporary ``build.BUILD_DIR`` holding stand-in libraries, and a
    plan whose first execute reaches them (on the CPU the wrappers run
    their plain versions and load no library)."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build_kernels")
    build.BUILD_DIR.mkdir()
    libs = {}
    for i, source in enumerate(FAKE_SOURCES):
        data = f"stand-in library {i} {source}".encode() * 50
        build.target(source).write_bytes(data)
        libs[source] = data
    real = compiler_mod.BucketedExecutor._run

    def reaching(self, *args):
        for source in FAKE_SOURCES:
            with build._recorders_lock:
                for used in build._recorders:
                    used.add(source)
        return real(self, *args)

    monkeypatch.setattr(compiler_mod.BucketedExecutor, "_run", reaching)
    return libs


def test_annex_stores_libraries_once_and_writes_them_back(env, aot_dir,
                                                           fake_build):
    cat, radius = env
    db = connect(cat, _options(), aot_cache_path=aot_dir)
    db.prepare(Q1).execute(binds_for("q1", cat, radius))
    db.prepare(Q5).execute(binds_for("q5", cat, radius))
    kdir = os.path.join(aot_dir, "kernels")
    assert sorted(os.listdir(kdir)) == sorted(
        build.target(s).name for s in FAKE_SOURCES)   # once, by target name
    # a fresh build directory: the hit writes every library back
    for source in FAKE_SOURCES:
        build.target(source).unlink()
    db2 = connect(cat, _options(), aot_cache_path=aot_dir)
    st = db2.prepare(Q1)
    st.execute(binds_for("q1", cat, radius))
    assert db2.cache_info().aot["hits"] == 1
    for source, data in fake_build.items():
        assert build.target(source).read_bytes() == data


def test_bad_annex_sha256_falls_back_to_build(env, aot_dir, fake_build):
    cat, radius = env
    db = connect(cat, _options(), aot_cache_path=aot_dir)
    want = ser_tree(db.prepare(Q1).execute(binds_for("q1", cat, radius)).data)
    bad = build.target(FAKE_SOURCES[0])
    kept = os.path.join(aot_dir, "kernels", bad.name)
    with open(kept, "ab") as f:
        f.write(b"flipped")
    for source in FAKE_SOURCES:
        build.target(source).unlink()
    db2 = connect(cat, _options(), aot_cache_path=aot_dir)
    with pytest.warns(AOTCacheWarning, match="sha256"):
        st = db2.prepare(Q1)
        res = st.execute(binds_for("q1", cat, radius))
    info = db2.cache_info().aot
    assert info["hits"] == 1 and info["corrupt"] == 1, info
    assert not os.path.exists(kept)          # the bad library is removed
    assert not bad.exists()                  # left to the normal build
    assert build.target(FAKE_SOURCES[1]).read_bytes() == \
        fake_build[FAKE_SOURCES[1]]
    assert ser_tree(res.data) == want        # the plan itself restored


def test_unserializable_plan_falls_back(env, aot_dir, monkeypatch):
    """An export failure warns, bumps ``errors``, persists nothing, and the
    plain executor (one built, as with no cache) still returns correct
    results."""
    import repro_torch.core.aot as aot_mod
    cat, radius = env
    want = ser_tree(connect(cat, _options())
                    .prepare(Q1).execute(binds_for("q1", cat, radius)).data)

    def boom(plan):
        raise TypeError("synthetic: plan not exportable")

    monkeypatch.setattr(aot_mod, "export_plan", boom)
    db = connect(cat, _options(), aot_cache_path=aot_dir)
    st = db.prepare(Q1)
    with pytest.warns(AOTCacheWarning, match="not serializable"):
        res = st.execute(binds_for("q1", cat, radius))
    assert db.cache_info().aot["errors"] == 1
    assert db.cache_info().aot["saves"] == 0
    assert sum(st.executor.trace_counts.values()) == 1   # count honest
    assert ser_tree(res.data) == want
    assert _entry_files(aot_dir) == []


def test_explain_reports_aot_line(env, aot_dir):
    cat, radius = env
    db = connect(cat, _options(), aot_cache_path=aot_dir)
    st = db.prepare(Q1)
    res = st.execute(binds_for("q1", cat, radius))
    rep = res.explain()
    assert rep.aot is not None and rep.aot["saves"] == 1
    assert rep.aot["loaded"] == {}
    assert any(line.startswith("-- aot:") for line
               in rep.render().splitlines())
    # no cache attached -> no line
    res2 = connect(cat, _options()).prepare(Q1).execute(
        binds_for("q1", cat, radius))
    assert res2.explain().aot is None


def test_cache_dir_is_created_and_shared(tmp_path):
    nested = str(tmp_path / "deep" / "aot")
    cache = AOTPlanCache(nested)
    assert os.path.isdir(nested)
    assert cache.stats() == {"hits": 0, "misses": 0, "corrupt": 0,
                             "stale": 0, "errors": 0, "saves": 0}


def test_export_batch_round_trip(env):
    """``export_batch`` bytes restore, with the catalog, a batched
    pipeline equal to ``execute_batch`` bit for bit."""
    cat, radius = env
    for case in ("q1", "q3"):
        q = connect(cat, _options()).prepare(ALL_SQL[case]).compiled
        binds = binds_for(case, cat, radius)
        data = q.export_batch(binds)
        fn = CompiledQuery.deserialize_batch(data, cat)
        got = fn(q._arrays, q._stack_binds(binds, {}))
        assert ser_tree(got) == ser_tree(q.execute_batch(binds)), case
        assert data == export_plan(q.plan)


def test_args_signature_tracks_shapes_not_values(env):
    cat, radius = env
    q = connect(cat, _options()).prepare(Q1).compiled
    binds = q._stack_binds(binds_for("q1", cat, radius), {})
    sig = args_signature((q._arrays, binds, np.ones(5, bool), None))
    shifted = {k: v + 1 for k, v in binds.items()}
    assert sig == args_signature((q._arrays, shifted, np.zeros(5, bool),
                                  None))
    assert sig != args_signature((q._arrays, binds, np.ones(8, bool), None))
    assert sig != args_signature((q._arrays, binds, np.ones(5, bool), 3))


@pytest.mark.parametrize("case", sorted(ALL_SQL))
def test_catalog_token_equals_reference(case):
    """The port's token of a plan's registrations equals the reference's
    for a catalog carried across, also after a ``valid`` change."""
    from repro.core.aot import catalog_token as ref_token
    from repro.core.compiler import _catalog_dep_keys as ref_dep_keys
    from repro.core.physical import EngineOptions as RefOptions
    from repro.core.schema import Table as RefTable
    from repro.core.semantics import analyze as ref_analyze
    from repro.core.sql import parse_sql as ref_parse
    from repro.data import make_laion_catalog as ref_make_catalog
    from repro_torch.core.semantics import analyze
    from repro_torch.core.sql import parse_sql
    from repro_torch.data import catalog_from_numpy
    ref_cat = ref_make_catalog(**SMALL)
    tables = {}
    for name in ("laion", "queries"):
        t = ref_cat.table(name)
        tables[name] = {
            "columns": {c: np.asarray(t[c]) for c in t.schema.columns},
            "kinds": {c: (ct.kind.value, ct.dim, ct.metric.value)
                      for c, ct in t.schema.columns.items()},
            "primary_key": t.schema.primary_key}
    aliases = {**{n: "laion" for n in INDEXED},
               "queries": "queries", "users": "queries"}
    cat = catalog_from_numpy(tables, aliases, device="cpu")
    sql = ALL_SQL[case]
    ref_keys = ref_dep_keys(ref_analyze(ref_parse(sql), ref_cat), ref_cat,
                            RefOptions())
    keys = _catalog_dep_keys(analyze(parse_sql(sql), cat), cat,
                             EngineOptions())
    assert keys == ref_keys
    assert catalog_token(cat, keys) == ref_token(ref_cat, ref_keys)
    valid = np.arange(SMALL["n_rows"]) % 5 != 0
    scanned = keys[0][1]
    ref_t = ref_cat.table(scanned)
    ref_cat.register(scanned, RefTable(ref_t.schema, ref_t.columns,
                                       valid=valid))
    cat.register(scanned, cat.table(scanned).with_valid(
        torch.from_numpy(valid)))
    assert catalog_token(cat, keys) == ref_token(ref_cat, ref_keys)
    assert catalog_token(cat, keys) != ref_token(
        ref_make_catalog(**SMALL), ref_keys)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        child_main(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit("usage: test_torch_aot_cache.py --child AOT_DIR "
                         "OUT_JSON")
