"""Crash-recovery chaos for the port's live corpus (``tests/
test_live_chaos.py``'s scenarios, in the port alone).

For every injected crash site (all 9 WAL / snapshot / compaction points in
:data:`repro_torch.serving.faults.CRASH_SITES`) and 3 seeds, a scripted
mutation sequence is killed mid-flight, then
:func:`repro_torch.data.mutations.recover` rebuilds the corpus from disk
alone into a FRESH catalog.  Asserted:

* **bit-identical to the unfailed replay** — the recovered state tree
  equals, leaf for leaf, the state an uncrashed process had at the same
  LSN (the durable frontier; a torn WAL tail loses exactly the un-synced
  record, never a committed one);
* **bit-identical to a from-scratch index** — compacting the recovered
  corpus equals a fresh :func:`attach_live` on its logical corpus (same
  canonical layout, same fixed-seed IVF arrays), i.e. recovery never
  leaves behind state a rebuild would not produce;
* the recovered corpus's answers equal the unfailed one's bit for bit.

Group commit (``insert_batch``): sequential-insert semantics, one fsync,
all-or-nothing admission, and a torn group commit keeps its durable
prefix.  Every state comparison is exact.
"""
import copy
import os

import numpy as np
import pytest
import torch

from repro_torch.api import connect
from repro_torch.core.schema import (Catalog, Metric, Schema, Table,
                                     float_col, int_col, vector_col)
from repro_torch.data.mutations import attach_live, recover
from repro_torch.serving.faults import (CRASH_SITES, FaultInjector,
                                        FaultSpec, InjectedCrashError)

DIM = 8
N0 = 48
DELTA_CAP = 16
SCHEMA = Schema({"sample_id": int_col(torch.int64), "price": float_col(),
                 "vec": vector_col(DIM, Metric.L2)})
QUERY = ("SELECT sample_id FROM items WHERE price < ${p} "
         "ORDER BY DISTANCE(vec, ${qv}) LIMIT 5")


def _mk_catalog(seed: int) -> tuple[Catalog, np.ndarray]:
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((N0, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    price = rng.uniform(1, 10, size=N0).astype(np.float32)
    cat = Catalog()
    cat.register("items", Table(SCHEMA, {
        "sample_id": torch.arange(N0, dtype=torch.int64),
        "price": torch.tensor(price), "vec": torch.tensor(vecs)}))
    return cat, vecs


def _ops(seed: int) -> list[tuple]:
    """The scripted mutation sequence; hits every crash site at its first
    occurrence (inserts -> wal.*, snapshot() -> snapshot.*, compact() ->
    compact.*)."""
    rng = np.random.default_rng(1000 + seed)

    def v(n):
        x = rng.standard_normal((n, DIM)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    return [("insert", np.arange(100, 105), v(5),
             {"price": np.full(5, 2.0, np.float32)}),
            ("delete", [3, 102]),
            ("snapshot",),
            ("insert", np.arange(200, 203), v(3), None),
            ("compact",),
            ("insert", np.arange(300, 302), v(2), None),
            ("delete", [200, 10]),
            ("compact",),
            ("insert_batch",
             [(np.arange(400, 403), v(3),
               {"price": np.full(3, 4.0, np.float32)}),
              (np.arange(410, 412), v(2))])]


def _apply(live, op):
    if op[0] == "insert":
        live.insert(op[1], op[2], op[3])
    elif op[0] == "insert_batch":
        live.insert_batch(op[1])
    elif op[0] == "delete":
        live.delete(op[1])
    elif op[0] == "snapshot":
        live.snapshot()
    else:
        live.compact()


def _attach(cat, path, seed, faults=None, **kw):
    nlist = 8 if seed == 2 else None     # seed 2 exercises the IVF rebuild
    return attach_live(cat, "items", "vec", path, delta_cap=DELTA_CAP,
                       nlist=nlist, seed=0, iters=3, faults=faults, **kw)


def _tree_equal(a, b, path=""):
    assert a.keys() == b.keys(), (path, sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k], f"{path}{k}.")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]),
                                          err_msg=f"leaf {path}{k}")


def _replay_states(seed: int, path: str) -> dict[int, dict]:
    """Unfailed replay: state tree after attach and after every op, keyed
    by the LSN it left the corpus at."""
    cat, _ = _mk_catalog(seed)
    live = _attach(cat, path, seed)
    states = {live.lsn: copy.deepcopy(live._state_tree())}
    for op in _ops(seed):
        if op[0] == "insert_batch":
            # a torn group commit recovers to an INTERMEDIATE LSN (the
            # durable prefix of the group), so record every per-group
            # state — group commit is semantically sequential inserts
            for group in op[1]:
                live.insert(group[0], group[1],
                            group[2] if len(group) > 2 else None)
                states[live.lsn] = copy.deepcopy(live._state_tree())
        else:
            _apply(live, op)
            states[live.lsn] = copy.deepcopy(live._state_tree())
    return states


def _replay_to(seed: int, path: str, cat, lsn: int):
    """An unfailed corpus on ``cat`` run up to the state at ``lsn``."""
    live = _attach(cat, path, seed)
    for op in _ops(seed):
        if live.lsn == lsn:
            break
        groups = op[1] if op[0] == "insert_batch" else [None]
        for group in groups:
            if group is None:
                _apply(live, op)
            else:
                live.insert(group[0], group[1],
                            group[2] if len(group) > 2 else None)
            if live.lsn == lsn:
                break
    assert live.lsn == lsn
    return live


def _answers_equal(cat_a, cat_b, seed: int) -> None:
    """The flat and (on an index) the chase answers of both catalogs'
    live corpora, bit for bit, as single dicts and as a list."""
    rng = np.random.default_rng(50 + seed)
    qs = rng.standard_normal((3, DIM)).astype(np.float32)
    binds = [{"qv": q, "p": np.float32(8.0)} for q in qs]
    engines = ["brute"] + (["chase"] if seed == 2 else [])
    for engine in engines:
        a = connect(cat_a, engine=engine).prepare(QUERY)
        b = connect(cat_b, engine=engine).prepare(QUERY)
        for bind in (binds, binds[0]):
            ra, rb = a.execute(bind).data, b.execute(bind).data
            for key in ("ids", "sim", "valid"):
                assert torch.equal(ra[key], rb[key]), (engine, key)
            for key in ra["stats"]:
                assert torch.equal(ra["stats"][key], rb["stats"][key])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("site", CRASH_SITES)
def test_crash_recovers_bit_identical(tmp_path, seed, site):
    cat, _ = _mk_catalog(seed)
    faults = FaultInjector(FaultSpec(seed=seed, crash_site=site,
                                     crash_at=1))
    live = _attach(cat, os.fspath(tmp_path / "a"), seed, faults=faults)
    crashed = False
    try:
        for op in _ops(seed):
            _apply(live, op)
    except InjectedCrashError:
        crashed = True
    assert crashed, f"site {site} never fired"
    assert faults.counters["crashes"] == 1

    # the process is gone: recovery sees only the disk state
    cat2, _ = _mk_catalog(seed)
    rec = recover(cat2, "items", "vec", os.fspath(tmp_path / "a"))

    states = _replay_states(seed, os.fspath(tmp_path / "b"))
    assert rec.lsn in states, (site, rec.lsn, sorted(states))
    _tree_equal(rec._state_tree(), states[rec.lsn])
    # and its answers equal an unfailed corpus's at the same state
    cat3, _ = _mk_catalog(seed)
    _replay_to(seed, os.fspath(tmp_path / "c"), cat3, rec.lsn)
    _answers_equal(cat2, cat3, seed)


@pytest.mark.parametrize("seed", [0, 1])
def test_torn_tail_truncated_so_later_mutations_survive(tmp_path, seed):
    """Recovery must truncate a torn WAL tail ON DISK: an append after a
    torn-tail recovery starts a fresh record instead of merging with the
    partial bytes, so a second recovery replays it (nothing corrupt,
    nothing silently dropped)."""
    cat, _ = _mk_catalog(seed)
    faults = FaultInjector(FaultSpec(seed=seed, crash_site="wal.torn_append",
                                     crash_at=2))
    live = _attach(cat, os.fspath(tmp_path / "a"), seed, faults=faults)
    with pytest.raises(InjectedCrashError):
        for op in _ops(seed):
            _apply(live, op)

    cat2, _ = _mk_catalog(seed)
    rec = recover(cat2, "items", "vec", os.fspath(tmp_path / "a"))
    with open(rec.wal_path, "rb") as f:
        raw = f.read()
    assert raw.endswith(b"\n")           # the half-flushed tail is gone

    # mutate PAST the recovery — the review scenario: these appends landed
    # after the partial bytes before the fix, corrupting the log
    rng = np.random.default_rng(7)
    v = rng.standard_normal((2, DIM)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    rec.insert([900, 901], v, {"price": np.full(2, 1.5, np.float32)})
    rec.delete([900])

    cat3, _ = _mk_catalog(seed)
    rec2 = recover(cat3, "items", "vec", os.fspath(tmp_path / "a"))
    assert rec2.lsn == rec.lsn
    _tree_equal(rec2._state_tree(), rec._state_tree())


@pytest.mark.parametrize("seed", [0, 2])
def test_recovered_corpus_equals_from_scratch_index(tmp_path, seed):
    """Compact the recovered corpus: segments AND the rebuilt IVF must be
    bit-identical to a fresh attach on the same logical corpus."""
    site = "compact.post_log" if seed else "wal.post_append"
    cat, _ = _mk_catalog(seed)
    faults = FaultInjector(FaultSpec(seed=seed, crash_site=site,
                                     crash_at=2))
    live = _attach(cat, os.fspath(tmp_path / "a"), seed, faults=faults)
    with pytest.raises(InjectedCrashError):
        for op in _ops(seed):
            _apply(live, op)
    cat2, _ = _mk_catalog(seed)
    rec = recover(cat2, "items", "vec", os.fspath(tmp_path / "a"))
    rec.compact()

    # fresh attach on the recovered logical corpus (survivors, canonical)
    m = np.flatnonzero(rec.main_valid)
    cat3 = Catalog()
    cat3.register("items", Table(SCHEMA, {
        "sample_id": torch.tensor(rec.cols["sample_id"][m]),
        "price": torch.tensor(rec.cols["price"][m]),
        "vec": torch.tensor(rec.main_vec[m])}))
    fresh = _attach(cat3, os.fspath(tmp_path / "c"), seed,
                    ids=rec.main_uids[m], cap_main=rec.cap_main)

    a, b = rec._state_tree(), fresh._state_tree()
    for skip in ("lsn", "compact_lsn"):  # clocks differ; layout must not
        a.pop(skip), b.pop(skip)
    _tree_equal(a, b)
    if seed == 2:                        # fixed-seed IVF arrays match too
        ia = cat2.index_for("items", "vec")
        ib = cat3.index_for("items", "vec")
        assert ia.cap == ib.cap
        for f in ("centroids", "lists", "list_sizes", "radii"):
            assert torch.equal(getattr(ia, f), getattr(ib, f)), f
    _answers_equal(cat2, cat3, seed)


# -- group commit (insert_batch): one fsync, sequential-insert semantics ----

def _groups(seed: int, base: int = 500):
    rng = np.random.default_rng(2000 + seed)

    def v(n):
        x = rng.standard_normal((n, DIM)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    return [(np.arange(base, base + 3), v(3),
             {"price": np.full(3, 3.0, np.float32)}),
            (np.arange(base + 10, base + 12), v(2)),
            (np.arange(base + 20, base + 24), v(4), None)]


@pytest.mark.parametrize("seed", [0, 1])
def test_group_commit_equals_sequential_inserts(tmp_path, seed):
    """insert_batch is semantically sequential inserts (same LSNs, same
    segment layout) — it only collapses N fsyncs into one."""
    cat_a, _ = _mk_catalog(seed)
    a = _attach(cat_a, os.fspath(tmp_path / "a"), seed)
    lsns = a.insert_batch(_groups(seed))
    assert lsns == sorted(lsns) and len(lsns) == 3
    assert a.lsn == lsns[-1]

    cat_b, _ = _mk_catalog(seed)
    b = _attach(cat_b, os.fspath(tmp_path / "b"), seed)
    for g in _groups(seed):
        b.insert(g[0], g[1], g[2] if len(g) > 2 else None)
    _tree_equal(a._state_tree(), b._state_tree())


def test_group_commit_pays_one_fsync(tmp_path, monkeypatch):
    """The point of the group commit: N insert groups, ONE fsync."""
    import repro_torch.data.mutations as mut
    cat, _ = _mk_catalog(0)
    live = _attach(cat, os.fspath(tmp_path / "a"), 0)
    counts = []
    real_fsync = os.fsync
    monkeypatch.setattr(mut.os, "fsync",
                        lambda fd: (counts.append(1), real_fsync(fd))[1])
    live.insert_batch(_groups(0))
    assert len(counts) == 1


def test_group_commit_rejection_has_no_side_effects(tmp_path):
    """A duplicate id ACROSS groups rejects the whole call before anything
    is logged or applied (all-or-nothing admission)."""
    from repro_torch.serving.resilience import (DeltaFullError,
                                                DuplicateIdError)
    cat, _ = _mk_catalog(0)
    live = _attach(cat, os.fspath(tmp_path / "a"), 0)
    before = copy.deepcopy(live._state_tree())
    gs = _groups(0)
    dup = (np.asarray([500]), gs[0][1][:1])          # 500 already in group 0
    with pytest.raises(DuplicateIdError):
        live.insert_batch(gs + [dup])
    with pytest.raises(DeltaFullError):              # cumulative headroom
        live.insert_batch([_groups(0, base=600 + 10 * i)[2]
                           for i in range(5)])       # 20 rows > 16 cap
    _tree_equal(live._state_tree(), before)
    assert not os.path.exists(live.wal_path) or \
        b"600" not in open(live.wal_path, "rb").read()


@pytest.mark.parametrize("seed", [0, 1])
def test_group_commit_torn_tail_keeps_durable_prefix(tmp_path, seed):
    """A crash mid group commit (full prefix + half of the last line)
    recovers exactly the durable prefix groups, and the torn tail is
    truncated on disk so later appends start a fresh record."""
    cat, _ = _mk_catalog(seed)
    faults = FaultInjector(FaultSpec(seed=seed,
                                     crash_site="wal.group_commit",
                                     crash_at=1))
    live = _attach(cat, os.fspath(tmp_path / "a"), seed, faults=faults)
    with pytest.raises(InjectedCrashError):
        live.insert_batch(_groups(seed))

    cat2, _ = _mk_catalog(seed)
    rec = recover(cat2, "items", "vec", os.fspath(tmp_path / "a"))
    # 3 groups: the first 2 lines were complete, the 3rd was torn — the
    # recovered state must equal an unfailed twin that ran the first two
    # groups as sequential inserts (identical catalogs mint identical LSNs)
    cat_t, _ = _mk_catalog(seed)
    twin = _attach(cat_t, os.fspath(tmp_path / "t"), seed)
    for g in _groups(seed)[:2]:
        twin.insert(g[0], g[1], g[2] if len(g) > 2 else None)
    assert rec.lsn == twin.lsn
    _tree_equal(rec._state_tree(), twin._state_tree())
    live_uids = {int(u) for u in rec.delta_uids[np.flatnonzero(
        rec.delta_valid)]}
    assert {500, 501, 502, 510, 511} <= live_uids
    assert not any(520 <= u < 524 for u in live_uids)
    with open(rec.wal_path, "rb") as f:
        assert f.read().endswith(b"\n")  # torn tail shed on disk

    # appends after recovery start fresh records and replay cleanly
    rec.insert_batch(_groups(seed, base=700)[:2])
    cat3, _ = _mk_catalog(seed)
    rec2 = recover(cat3, "items", "vec", os.fspath(tmp_path / "a"))
    assert rec2.lsn == rec.lsn
    _tree_equal(rec2._state_tree(), rec._state_tree())
