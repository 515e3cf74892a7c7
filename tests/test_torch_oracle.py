"""A seeded differential oracle across the two packages: random predicates
and LIMITs through the port and the reference, Q1 and Q2, on the CPU.

The reference's ``tests/test_property.py`` holds its lowerings against one
another on random binds; here each draw goes through both packages.  A draw
is an AND / OR / NOT tree of comparisons over eight ``laion`` columns (its
literals are values of the column, so both packages read the same fp32
constant), a LIMIT from 1 to N (one draw of each test below 64, one up to
the top-k kernels' 1,024, one above it) or a Q2 capacity of 48, 1,100 or
2,048, and for Q2 a radius in the widest gap between adjacent similarities
near a target hit count, so no row lies within fp32 error of it.  Every
engine (``brute``, ``chase``, ``vbase``, ``pase``, over the reference's IVF
carried into the port) runs with ``use_pallas`` on and off, on a single
dict and on a list.  Held: ids, valid lanes, counts and counters exact, sims
within 1e-5, a swap only between keys within 1e-6 (the fp32 near-ties of
two frameworks adding a dot product in different orders; VBASE's Q2 buffer,
which keeps its scan's slots, slot by slot).
"""
import jax
import numpy as np
import pytest

from repro.api import connect as ref_connect
from repro.core.physical import ProbeConfig as RefProbe
from repro.data import make_laion_catalog as ref_make_catalog
from repro.index import build_ivf as ref_build_ivf
from repro_torch.api import connect
from repro_torch.core.physical import ProbeConfig
from repro_torch.core.schema import Metric
from repro_torch.data import make_laion_catalog
from repro_torch.index import ivf_from_numpy
from repro_torch.testing import assert_range_close, assert_topk_close

TOL = 1e-5
TIE = 1e-6
N = 3000
SMALL = dict(n_rows=N, n_queries=6, dim=16, n_modes=8, num_categories=4,
             seed=0)
NLIST = 16
FIELDS = ("centroids", "lists", "list_sizes", "radii", "centroid_sq")
INDEXED = ("laion", "products", "images")
ENGINES = ("brute", "chase", "vbase", "pase")
# column -> the comparisons drawn on it
COLUMNS = {"height": "<>=", "width": "<>=", "similarity": "<>",
           "price": "<>", "capture_date": "<>=", "nsfw": "=",
           "calorie_level": "=", "cuisine": "="}
OPS = {"<": ("<", "<="), ">": (">", ">="), "=": ("=", "<>")}
PROBE = dict(max_probes=12, min_probes=3, stop_after_no_improve=3,
             out_range_stop=2)


@pytest.fixture(scope="module")
def env():
    ref_cat = ref_make_catalog(**SMALL)
    cat = make_laion_catalog(**SMALL, device="cpu")
    ref_idx = ref_build_ivf(jax.random.key(0),
                            ref_cat.table("laion")["embedding"], nlist=NLIST,
                            iters=5)
    fields = {f: np.asarray(getattr(ref_idx, f)) for f in FIELDS}
    fields.update(nlist=ref_idx.nlist, cap=ref_idx.cap)
    idx = ivf_from_numpy(fields, Metric.INNER_PRODUCT, "cpu")
    for name in INDEXED:
        ref_cat.register_index(name, "embedding", ref_idx)
        cat.register_index(name, "embedding", idx)
    return ref_cat, cat


def _literal(col: np.ndarray, rng) -> str:
    v = col[rng.integers(col.shape[0])]
    if col.dtype.kind == "f":
        return repr(float(np.float32(v)))       # the fp32 value exactly
    return str(int(v))


def _atom(cols: dict, rng) -> str:
    name = list(COLUMNS)[rng.integers(len(COLUMNS))]
    kinds = COLUMNS[name]
    op = OPS[kinds[rng.integers(len(kinds))]][rng.integers(2)]
    return f"{name} {op} {_literal(cols[name], rng)}"


def _predicate(cols: dict, rng, depth: int = 2) -> str:
    """An AND / OR / NOT tree of comparisons, at most ``depth`` deep."""
    roll = rng.random() if depth > 0 else 1.0
    if roll < 0.35:
        return (f"({_predicate(cols, rng, depth - 1)} AND "
                f"{_predicate(cols, rng, depth - 1)})")
    if roll < 0.6:
        return (f"({_predicate(cols, rng, depth - 1)} OR "
                f"{_predicate(cols, rng, depth - 1)})")
    if roll < 0.75:
        return f"(NOT {_predicate(cols, rng, depth - 1)})"
    return f"({_atom(cols, rng)})"


def _limit(rng, band: int) -> int:
    """A LIMIT below 64, up to 1,024 or above it (``band`` 0, 1, 2)."""
    lo, hi = [(1, 64), (64, 1025), (1025, N + 1)][band]
    return int(rng.integers(lo, hi))


def _queries(cat, qn: int, rng) -> np.ndarray:
    qs = cat.table("queries")["embedding"].numpy()
    picks = qs[rng.integers(qs.shape[0], size=qn)]
    return (picks + 0.01 * rng.standard_normal(picks.shape)).astype(
        np.float32)


def _gap_radius(sims: np.ndarray, rng) -> np.float32:
    """A radius in the widest gap between adjacent sims around a random
    target hit count (sims descending: a hit is sim >= radius)."""
    s = np.sort(sims)[::-1]
    t = int(rng.integers(10, N // 2))
    lo, hi = max(1, t - 40), min(N - 1, t + 40)
    gaps = s[lo - 1:hi - 1] - s[lo:hi]
    j = lo + int(np.argmax(gaps))
    return np.float32((s[j - 1] + s[j]) / 2)


def _columns(cat) -> dict:
    tab = cat.table("laion")
    return {name: tab[name].numpy() for name in COLUMNS}


def _ref_data(res, keys) -> dict:
    return {k: res[k] for k in keys}


def _vbase_equal(got: dict, want: dict, what: str) -> None:
    """VBASE's Q2 filter runs after its scan and keeps the scan's slots
    (ids on the slots it rejects, holes among the hits) in both packages,
    so its buffer is held slot by slot: ids, valid, count and counters
    exact, sims within TOL on valid slots."""
    for key in ("ids", "valid", "count"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]),
                                      err_msg=f"{what}: {key}")
    for key in got["stats"]:
        np.testing.assert_array_equal(np.asarray(got["stats"][key]),
                                      np.asarray(want["stats"][key]),
                                      err_msg=f"{what}: {key}")
    valid = np.asarray(got["valid"])
    np.testing.assert_allclose(np.asarray(got["sim"])[valid],
                               np.asarray(want["sim"])[valid], atol=TOL,
                               rtol=0, err_msg=f"{what}: sims")


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("engine", ENGINES)
def test_q1_oracle(env, engine, use_pallas):
    ref_cat, cat = env
    rng = np.random.default_rng([1, ENGINES.index(engine), use_pallas])
    cols = _columns(cat)
    for single, band in zip((True, False, True), rng.permutation(3)):
        pred, k = _predicate(cols, rng), _limit(rng, band)
        sql = (f"SELECT sample_id FROM products WHERE {pred} "
               f"ORDER BY DISTANCE(embedding, ${{qv}}) LIMIT {k}")
        qs = _queries(cat, 1 if single else 3, rng)
        binds = {"qv": qs[0]} if single else [{"qv": q} for q in qs]
        kw = dict(engine=engine, use_pallas=use_pallas)
        got = connect(cat, **kw, probe=ProbeConfig(**PROBE)).prepare(
            sql).execute(binds)
        want = ref_connect(ref_cat, **kw, probe=RefProbe(**PROBE)).prepare(
            sql).execute(binds)
        keys = ("ids", "sim", "valid", "stats")
        assert_topk_close(_ref_data(got, keys), _ref_data(want, keys),
                          atol=TOL, tie_tol=TIE, what=f"{sql} {binds}")


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("engine", ENGINES)
def test_q2_oracle(env, engine, use_pallas):
    ref_cat, cat = env
    rng = np.random.default_rng([2, ENGINES.index(engine), use_pallas])
    cols = _columns(cat)
    vecs = cat.table("laion")["embedding"].numpy()
    for single, cap in zip((True, False, False),
                           rng.permutation([48, 1100, 2048])):
        pred, cap = _predicate(cols, rng), int(cap)
        sql = ("SELECT sample_id FROM images WHERE "
               f"DISTANCE(embedding, ${{qv}}) <= ${{r}} AND {pred}")
        qs = _queries(cat, 1 if single else 3, rng)
        radii = [_gap_radius(vecs @ q, rng) for q in qs]
        rows = [{"qv": q, "r": r} for q, r in zip(qs, radii)]
        binds = rows[0] if single else rows
        kw = dict(engine=engine, use_pallas=use_pallas)
        got = connect(cat, **kw, probe=ProbeConfig(**PROBE, capacity=cap)
                      ).prepare(sql).execute(binds)
        want = ref_connect(ref_cat, **kw, probe=RefProbe(
            **PROBE, capacity=cap)).prepare(sql).execute(binds)
        keys = ("ids", "sim", "valid", "count", "stats")
        if engine == "vbase":
            _vbase_equal(got, want, f"{sql} {binds}")
            continue
        assert_range_close(_ref_data(got, keys), _ref_data(want, keys),
                           radius=np.asarray(radii[0] if single else radii),
                           atol=TOL, tie_tol=TIE, what=f"{sql} {binds}")
