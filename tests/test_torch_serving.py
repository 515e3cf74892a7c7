"""The serving tier of the port (``repro_torch.serving``) against the
reference's (``repro.serving``), on the CPU.

Both packages serve the same seeded catalog (1,500 rows, D = 16) over the
reference's own IVF index (carried into the port with ``ivf_from_numpy``)
under ``chase``, with the same fake clock and the same submit sequence.
Held equal: drain sequences, batch sizes, counters, shed rids, per-request
ids / valid lanes / probe counters (sims within 1e-5), the effort split of
``run_effort_bucketed`` at scalar, (Q,) and (Q, L) budgets, the fault
injector's decisions for one seed, the load controller's transitions, the
admission decisions, and where each typed error is raised.  Inside the
port: a served request equals its row of the direct batch bit for bit, and
effort = lock-step bit for bit, counters included.  Mirrors the cases of
``tests/test_scheduler.py``, ``tests/test_resilience.py`` (all but the
front door, which ``test_torch_serve_front_door.py`` holds) and the
serving cases of ``tests/test_api.py``.
"""
import concurrent.futures
import dataclasses
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.api import ExecutionHints as RefHints
from repro.api import connect as ref_connect
from repro.core import EngineOptions as RefOptions
from repro.core import Metric as RefMetric
from repro.core import compile_query as ref_compile_query
from repro.data import make_laion_catalog as ref_make_catalog
from repro.index import build_ivf as ref_build_ivf
from repro.index.ivf import ProbeConfig as RefProbe
from repro.serving import faults as ref_faults
from repro.serving import resilience as ref_res
from repro.serving import scheduler as ref_sched
from repro_torch.api import ExecutionHints, connect
from repro_torch.core import EngineOptions, compile_query
from repro_torch.core.expr import full_fp32
from repro_torch.core.schema import Metric
from repro_torch.data import make_laion_catalog
from repro_torch.index import ivf_from_numpy
from repro_torch.index.ivf import ProbeConfig
from repro_torch.serving import faults as port_faults
from repro_torch.serving import resilience as port_res
from repro_torch.serving import scheduler as port_sched

TOL = 1e-5
SMALL = dict(n_rows=1500, n_queries=8, dim=16, n_modes=8, seed=0)
FIELDS = ("centroids", "lists", "list_sizes", "radii", "centroid_sq")
SQL = ("SELECT sample_id FROM products WHERE price < ${p} "
       "ORDER BY DISTANCE(embedding, ${qv}) LIMIT 4")
RENAMED = ("SELECT sample_id FROM products WHERE price < ${cap} "
           "ORDER BY DISTANCE(embedding, ${vec}) LIMIT 4")
Q3 = """
SELECT queries.id AS qid, images.sample_id AS tid
FROM queries JOIN images
ON DISTANCE(queries.embedding, images.embedding) <= ${r}
AND images.capture_date > queries.capture_date
"""
PROBE = dict(max_probes=32, probe_batch=2, termination="counter")
JOIN_PROBE = dict(max_probes=12, min_probes=2, stop_after_no_improve=3,
                  out_range_stop=2, capacity=48)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _bitwise(a, b, what=""):
    """Every leaf of two port trees equal with ``torch.equal``."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys(), what
    for k in la:
        assert torch.equal(la[k], lb[k]), f"{what}: {k} differs"


def _close_to_ref(port, ref, what=""):
    """A port tree against the reference's: ints and bools equal, floats
    within TOL."""
    lp, lr = dict(_leaves(port)), dict(_leaves(ref))
    assert lp.keys() == lr.keys(), what
    for k in lp:
        p, r = _np(lp[k]), _np(lr[k])
        if np.issubdtype(p.dtype, np.floating):
            np.testing.assert_allclose(p, r, atol=TOL, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(p, r, err_msg=f"{what} {k}")


def _carry(ref_idx):
    fields = {f: np.asarray(getattr(ref_idx, f)) for f in FIELDS}
    fields.update(nlist=ref_idx.nlist, cap=ref_idx.cap)
    return ivf_from_numpy(fields, Metric.INNER_PRODUCT, "cpu")


@pytest.fixture(scope="module")
def env():
    ref_cat = ref_make_catalog(**SMALL)
    cat = make_laion_catalog(**SMALL, device="cpu")
    ref_idx = ref_build_ivf(jax.random.key(0), ref_cat.table("laion")["vec"],
                            nlist=32, metric=RefMetric.INNER_PRODUCT, iters=3)
    idx = _carry(ref_idx)
    for name in ("products", "images"):
        ref_cat.register_index(name, "embedding", ref_idx)
        cat.register_index(name, "embedding", idx)
    ref_q = ref_compile_query(SQL, ref_cat, RefOptions(
        engine="chase", probe=RefProbe(**PROBE)))
    q = compile_query(SQL, cat, EngineOptions(engine="chase",
                                              probe=ProbeConfig(**PROBE)))
    ref_db = ref_connect(ref_cat, engine="chase", probe=RefProbe(**PROBE))
    db = connect(cat, engine="chase", probe=ProbeConfig(**PROBE))
    return {"ref_cat": ref_cat, "cat": cat, "ref_idx": ref_idx, "idx": idx,
            "ref_q": ref_q, "q": q, "ref_db": ref_db, "db": db,
            "ref_stmt": ref_db.prepare(SQL), "stmt": db.prepare(SQL)}


def _requests(env, n, seed=1):
    """Heterogeneous-selectivity requests (numpy binds, shared by both
    packages): permissive filters end after few probes, selective ones
    keep probing."""
    rng = np.random.default_rng(seed)
    base = env["cat"].table("queries")["embedding"].numpy()
    price = env["cat"].table("laion")["price"].numpy()
    qs = np.tile(base, (-(-n // base.shape[0]), 1))[:n]
    qs = (qs + 0.01 * rng.standard_normal(qs.shape)).astype(np.float32)
    ps = np.quantile(price, rng.uniform(0.05, 1.0, n)).astype(np.float32)
    return [{"qv": qs[i], "p": np.float32(ps[i])} for i in range(n)]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# coalescing
# ---------------------------------------------------------------------------

def test_coalesced_results_match_direct_batch(env):
    reqs = _requests(env, 5)
    sched = port_sched.BatchScheduler(
        env["q"], port_sched.SchedulerConfig(max_batch=8, max_wait_ms=0.0))
    ref = ref_sched.BatchScheduler(
        env["ref_q"], ref_sched.SchedulerConfig(max_batch=8,
                                                max_wait_ms=0.0))
    rids = [sched.submit(**r) for r in reqs]
    ref_rids = [ref.submit(**r) for r in reqs]
    assert sorted(sched.flush()) == sorted(rids)
    assert sorted(ref.flush()) == sorted(ref_rids) == sorted(rids)
    direct = env["q"].execute_bucketed(binds_list=reqs)
    for i, rid in enumerate(rids):
        got = sched.result(rid)
        _bitwise(got, {k: (v[i] if not isinstance(v, dict) else
                           {s: x[i] for s, x in v.items()})
                       for k, v in direct.items()}, f"request {i}")
        _close_to_ref(got, jax.tree.map(np.asarray, ref.result(rid)),
                      f"request {i} vs reference")


def _script(kind: str, reqs: list):
    """A serving script: ("submit", binds, kwargs), ("clock", t),
    ("poll",), ("flush",), ("due",), ("pending",)."""
    s = []
    if kind == "window":
        s += [("submit", reqs[0], {}), ("due",), ("poll",), ("clock", 0.004),
              ("due",), ("clock", 0.0051), ("due",), ("poll",),
              ("pending",), ("clock", 1.0)]
        s += [("submit", r, {}) for r in reqs[:3]] + [("due",), ("poll",)]
    elif kind == "expired":
        s += [("submit", r, {"deadline_ms": 5.0}) for r in reqs[:3]]
        s += [("clock", 0.010), ("flush",)]
    elif kind == "deadline_tie":
        s += [("submit", reqs[0], {"deadline_ms": 10.0}), ("clock", 0.004),
              ("due",), ("clock", 0.010), ("due",), ("poll",)]
    elif kind == "margin":
        s += [("submit", reqs[0], {}),
              ("submit", reqs[1], {"deadline_ms": 10.0}), ("clock", 0.007),
              ("due",), ("clock", 0.008), ("due",), ("poll",)]
    elif kind == "priority":
        s += [("submit", reqs[0], {"priority": 0}),
              ("submit", reqs[1], {"priority": 0}),
              ("submit", reqs[2], {"priority": 5}), ("poll",), ("pending",),
              ("flush",)]
    elif kind == "staggered":
        # Poisson-ish arrivals, a deadline on every third request, a poll
        # after every submit: batches of many sizes and some shedding
        rng = np.random.default_rng(3)
        t = 0.0
        for i, r in enumerate(reqs):
            t += float(rng.exponential(0.0015))
            kw = {"deadline_ms": 4.0} if i % 3 == 2 else {}
            s += [("clock", t), ("submit", r, kw), ("poll",)]
            if i % 7 == 6:
                s += [("clock", t + 0.006), ("poll",)]
        s += [("flush",)]
    return s


CONFIGS = {"window": dict(max_batch=3, max_wait_ms=5.0),
           "expired": dict(max_batch=4, max_wait_ms=0.0),
           "deadline_tie": dict(max_batch=4, max_wait_ms=50.0),
           "margin": dict(max_batch=8, max_wait_ms=100.0,
                          deadline_margin_ms=2.0),
           "priority": dict(max_batch=2, max_wait_ms=0.0),
           "staggered": dict(max_batch=4, max_wait_ms=2.0)}


def _run_script(mod, compiled, kind, reqs):
    """Run a script on one package's scheduler; returns the observable
    trace, the executed batch sizes and each rid's outcome."""
    clock = FakeClock()
    sizes = []

    class Recording(mod.BatchScheduler):
        def execute(self, binds_list):
            sizes.append(len(binds_list))
            return super().execute(binds_list)

    sched = Recording(compiled, mod.SchedulerConfig(**CONFIGS[kind]),
                      clock=clock)
    trace, rids = [], []
    for step in _script(kind, reqs):
        op = step[0]
        if op == "clock":
            clock.t = step[1]
        elif op == "submit":
            rids.append(sched.submit_request(dict(step[1]), **step[2]))
        elif op == "poll":
            trace.append(("poll", sorted(sched.poll())))
        elif op == "flush":
            trace.append(("flush", sorted(sched.flush())))
        elif op == "due":
            trace.append(("due", sched.due()))
        elif op == "pending":
            trace.append(("pending", sched.pending()))
    outcomes = {}
    for rid in rids:
        try:
            outcomes[rid] = sched.result(rid)
        except Exception as e:  # noqa: BLE001 - the outcome is the type
            outcomes[rid] = type(e).__name__
    return trace, sizes, dict(sched.counters), outcomes


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_drain_sequence_matches_reference(env, kind):
    reqs = _requests(env, 24 if kind == "staggered" else 3)
    got = _run_script(port_sched, env["q"], kind, reqs)
    want = _run_script(ref_sched, env["ref_q"], kind, reqs)
    assert got[0] == want[0]                       # polls, flushes, due
    assert got[1] == want[1]                       # batch sizes
    assert got[2] == want[2]                       # counters
    assert got[3].keys() == want[3].keys()
    for rid, out in got[3].items():
        ref = want[3][rid]
        if isinstance(ref, str):
            assert out == ref, rid                 # the same typed error
        else:
            _close_to_ref(out, jax.tree.map(np.asarray, ref), f"rid {rid}")
    if kind == "staggered":
        assert len(set(got[1])) > 1 and got[2]["shed_deadline"] > 0


def test_deadline_semantics(env):
    clock = FakeClock()
    sched = port_sched.BatchScheduler(
        env["q"], port_sched.SchedulerConfig(max_batch=3, max_wait_ms=5.0),
        clock=clock)
    reqs = _requests(env, 3)
    sched.submit(**reqs[0])
    assert not sched.due()                 # neither full nor expired
    assert sched.poll() == []
    clock.t = 0.004
    assert not sched.due()                 # 4ms < 5ms window
    clock.t = 0.0051
    assert sched.due()                     # oldest waited out its window
    done = sched.poll()
    assert len(done) == 1 and sched.pending() == 0
    clock.t = 1.0                          # a full batch drains at once
    for r in reqs:
        sched.submit(**r)
    assert sched.due()
    assert len(sched.poll()) == 3


def test_flush_empty_and_submit_after_flush(env):
    sched = port_sched.BatchScheduler(
        env["q"], port_sched.SchedulerConfig(max_batch=4, max_wait_ms=0.0))
    assert sched.flush() == []
    assert sched.counters["batches"] == 0
    reqs = _requests(env, 3)
    rids = [sched.submit(**r) for r in reqs]
    assert sorted(sched.flush()) == sorted(rids)
    rid2 = sched.submit(**reqs[0])
    assert rid2 > max(rids)
    assert sched.flush() == [rid2]
    direct = env["q"].execute_bucketed(binds_list=[reqs[0]])
    assert torch.equal(sched.result(rid2)["ids"], direct["ids"][0])


def test_all_expired_batch_never_executes(env):
    clock = FakeClock()
    sched = port_sched.BatchScheduler(
        env["q"], port_sched.SchedulerConfig(max_batch=4, max_wait_ms=0.0),
        clock=clock)
    rids = [sched.submit_request(dict(r), deadline_ms=5.0)
            for r in _requests(env, 3)]
    clock.t = 0.010
    assert sorted(sched.flush()) == sorted(rids)
    assert sched.counters["batches"] == 0
    assert sched.counters["shed_deadline"] == 3
    for rid in rids:
        with pytest.raises(port_res.DeadlineExceededError):
            sched.result(rid)


def test_deadline_tie_still_serves(env):
    clock = FakeClock()
    sched = port_sched.BatchScheduler(
        env["q"], port_sched.SchedulerConfig(max_batch=4, max_wait_ms=50.0),
        clock=clock)
    (r0,) = _requests(env, 1)
    rid = sched.submit_request(dict(r0), deadline_ms=10.0)
    clock.t = 0.004
    assert not sched.due()
    clock.t = 0.010                        # exactly the deadline
    assert sched.due()
    assert sched.poll() == [rid]
    assert sched.result(rid)["ids"].shape == (4,)


def test_tightest_deadline_preempts_wait_window(env):
    clock = FakeClock()
    sched = port_sched.BatchScheduler(
        env["q"], port_sched.SchedulerConfig(max_batch=8, max_wait_ms=100.0,
                                             deadline_margin_ms=2.0),
        clock=clock)
    reqs = _requests(env, 2)
    sched.submit_request(dict(reqs[0]))
    sched.submit_request(dict(reqs[1]), deadline_ms=10.0)
    clock.t = 0.007
    assert not sched.due()
    clock.t = 0.008
    assert sched.due()
    assert len(sched.poll()) == 2


def test_priority_orders_drain(env):
    sched = port_sched.BatchScheduler(
        env["q"], port_sched.SchedulerConfig(max_batch=2, max_wait_ms=0.0),
        clock=FakeClock())
    reqs = _requests(env, 3)
    r_low1 = sched.submit_request(dict(reqs[0]), priority=0)
    r_low2 = sched.submit_request(dict(reqs[1]), priority=0)
    r_high = sched.submit_request(dict(reqs[2]), priority=5)
    first = sched.poll()
    assert r_high in first and r_low1 in first
    assert sched.pending() == 1
    assert sched.flush() == [r_low2]


def test_execution_failure_is_contained_per_batch(env):
    class Flaky(port_sched.BatchScheduler):
        fail_next = False

        def execute(self, binds_list):
            if self.fail_next:
                self.fail_next = False
                raise RuntimeError("injected batch failure")
            return super().execute(binds_list)

    sched = Flaky(env["q"], port_sched.SchedulerConfig(max_batch=4,
                                                       max_wait_ms=0.0))
    reqs = _requests(env, 4)
    bad = [sched.submit(**r) for r in reqs[:2]]
    sched.fail_next = True
    assert sorted(sched.flush()) == sorted(bad)
    for rid in bad:
        with pytest.raises(RuntimeError, match="injected batch failure"):
            sched.result(rid)
    assert sched.counters["failed"] == 2
    good = [sched.submit(**r) for r in reqs[2:]]
    sched.flush()
    for rid in good:
        assert sched.result(rid)["ids"].shape == (4,)


# ---------------------------------------------------------------------------
# effort bucketing
# ---------------------------------------------------------------------------

def _stacked(env, n, seed=1):
    reqs = _requests(env, n, seed)
    return env["q"]._stack_binds(reqs, {}), env["ref_q"]._stack_binds(reqs,
                                                                      {})


def test_effort_bucketed_is_bit_identical(env):
    binds, _ = _stacked(env, 12)
    lock = env["q"].executor(binds)
    nat = lock["stats"]["probes"].numpy()
    pilot = int(np.percentile(nat, 60)) + 1
    eff, info = port_sched.run_effort_bucketed(env["q"], binds,
                                               pilot_budget=pilot)
    assert info["n_light"] + info["n_heavy"] == 12
    assert info["n_light"] > 0 and info["n_heavy"] > 0
    _bitwise(eff, lock, "effort vs lock-step")


def _per_query_pilot(nat):
    # half the queries get a budget above their own count (light), half
    # one at it (heavy)
    return np.where(np.arange(nat.shape[0]) % 2 == 0, nat + 1,
                    np.maximum(nat, 1)).astype(np.int32)


@pytest.mark.parametrize("form", ["scalar", "per_query"])
@pytest.mark.parametrize("n", [5, 12])
def test_effort_info_matches_reference(env, form, n):
    binds, ref_binds = _stacked(env, n, seed=n)
    lock = env["q"].executor(binds)
    nat = lock["stats"]["probes"].numpy()
    pilot = (int(np.percentile(nat, 75)) + 1 if form == "scalar"
             else _per_query_pilot(nat))
    eff, info = port_sched.run_effort_bucketed(env["q"], binds, pilot)
    ref_eff, ref_info = ref_sched.run_effort_bucketed(env["ref_q"],
                                                      ref_binds, pilot)
    assert info == ref_info
    _bitwise(eff, lock, "effort vs lock-step")
    _close_to_ref(eff, jax.tree.map(np.asarray, ref_eff), "vs reference")


@pytest.fixture(scope="module")
def join_env(env):
    ref_db = ref_connect(env["ref_cat"], engine="chase",
                         probe=RefProbe(**JOIN_PROBE))
    db = connect(env["cat"], engine="chase", probe=ProbeConfig(**JOIN_PROBE))
    left = env["cat"].table("queries")["embedding"].numpy()
    sims = left @ env["cat"].table("laion")["embedding"].numpy().T
    srt = np.sort(sims.reshape(-1))[::-1]
    radii = [float(srt[rank]) for rank in (40, 90, 160, 300, 500)]
    bind_sets = [{"r": np.float32(x)} for x in radii]
    st, ref_st = db.prepare(Q3), ref_db.prepare(Q3)
    return {"st": st, "ref_st": ref_st,
            "binds": st._stack_binds(bind_sets, {}),
            "ref_binds": ref_st._stack_binds(bind_sets, {})}


@pytest.mark.parametrize("form", ["scalar", "per_set", "per_left"])
def test_effort_join_budgets_match_reference(join_env, form):
    """Joins report (Q, L) probes; a (Q,) budget broadcasts against them
    and a (Q, L) one caps each left row."""
    st, binds = join_env["st"], join_env["binds"]
    lock = st.executor(binds)
    nat = lock["stats"]["probes"].numpy()
    assert nat.ndim == 2
    if form == "scalar":
        pilot = int(np.percentile(nat, 75)) + 1
    elif form == "per_set":
        pilot = _per_query_pilot(nat.max(axis=1))
    else:
        pilot = np.where(np.arange(nat.shape[0])[:, None] % 2 == 0,
                         nat + 1, np.maximum(nat, 1)).astype(np.int32)
    eff, info = port_sched.run_effort_bucketed(st, binds, pilot)
    ref_eff, ref_info = ref_sched.run_effort_bucketed(
        join_env["ref_st"], join_env["ref_binds"], pilot)
    assert info == ref_info
    if form != "scalar":
        assert info["n_light"] > 0 and info["n_heavy"] > 0
    _bitwise(eff, lock, f"join effort {form}")
    _close_to_ref(eff, jax.tree.map(np.asarray, ref_eff), "vs reference")


def test_effort_bucketed_through_scheduler(env):
    reqs = _requests(env, 6)
    outs = []
    for pilot in (0, 8):
        sched = port_sched.BatchScheduler(env["q"], port_sched.SchedulerConfig(
            max_batch=8, max_wait_ms=0.0, pilot_budget=pilot))
        rids = [sched.submit(**r) for r in reqs]
        sched.flush()
        outs.append([sched.result(r) for r in rids])
    for a, b in zip(*outs):
        _bitwise(a, b, "scheduled effort vs lock-step")


def test_effort_bucketed_skips_non_native_plans():
    cat = make_laion_catalog(n_rows=800, n_queries=3, dim=16, n_modes=8,
                             seed=0, device="cpu")
    ref_cat = ref_make_catalog(n_rows=800, n_queries=3, dim=16, n_modes=8,
                               seed=0)
    ref_idx = ref_build_ivf(jax.random.key(0), ref_cat.table("laion")["vec"],
                            nlist=16, metric=RefMetric.INNER_PRODUCT, iters=2)
    idx = _carry(ref_idx)
    for name in ("laion", "images"):
        cat.register_index(name, "embedding", idx)
        ref_cat.register_index(name, "embedding", ref_idx)
    sql = ("SELECT queries.id AS qid, images.sample_id AS tid FROM queries "
           "JOIN images ON DISTANCE(queries.embedding, images.embedding) "
           "<= ${r}")
    opts = dict(engine="chase", join_lowering="perleft", max_pairs=32)
    q = compile_query(sql, cat, EngineOptions(
        **opts, probe=ProbeConfig(max_probes=8)))
    ref_q = ref_compile_query(sql, ref_cat, RefOptions(
        **opts, probe=RefProbe(max_probes=8)))
    assert not q.batch_native
    radii = {"r": np.float32([2.0, 2.5])}
    binds = q._stack_binds(None, radii)
    lock = q.executor(binds)
    out, info = port_sched.run_effort_bucketed(q, binds, pilot_budget=4)
    _, ref_info = ref_sched.run_effort_bucketed(
        ref_q, ref_q._stack_binds(None, radii), pilot_budget=4)
    assert info == ref_info
    assert info["n_heavy"] == 0 and "skipped" in info
    _bitwise(out, lock, "skipped effort")


@pytest.mark.parametrize("pilot", [0, -3])
def test_effort_bucketed_rejects_bad_pilot(env, pilot):
    binds, ref_binds = _stacked(env, 2)
    with pytest.raises(ValueError, match="pilot_budget"):
        port_sched.run_effort_bucketed(env["q"], binds, pilot_budget=pilot)
    with pytest.raises(ValueError, match="pilot_budget"):
        ref_sched.run_effort_bucketed(env["ref_q"], ref_binds,
                                      pilot_budget=pilot)


def test_advisor_is_a_later_slice(env):
    """The advisor hooks, once a later slice, are ported: advised effort
    runs decide as the reference's (equal constants, one catalog history)
    and equal lock-step bit for bit, and an advised BatchScheduler drains
    the lock-step answers."""
    from repro.opt import CostModel as RefCost
    from repro.opt import LoweringAdvisor as RefAdvisor
    from repro_torch.opt import CostModel, LoweringAdvisor

    # headroom below 1 predicts pilots under the p75, so phase 2 runs
    consts = dict(int8_speedup=1.5, bf16_speedup=1.2, ivf_gather_penalty=3.0,
                  headroom=0.5)
    adv = LoweringAdvisor(env["cat"], cost=CostModel(**consts))
    ref_adv = RefAdvisor(env["ref_cat"], cost=RefCost(**consts))
    heavy = []
    for step in range(4):
        binds, ref_binds = _stacked(env, 12, seed=step + 1)
        lock = env["q"].executor(binds)
        out, info = port_sched.run_effort_bucketed(env["q"], binds, 0,
                                                   advisor=adv)
        _, ref_info = ref_sched.run_effort_bucketed(env["ref_q"], ref_binds,
                                                    0, advisor=ref_adv)
        _bitwise(out, lock, f"advised step {step}")
        got, want = dict(info.pop("opt")), dict(ref_info.pop("opt"))
        got.pop("plan"), want.pop("plan")          # the options' reprs differ
        assert got == want and info == ref_info, step
        heavy.append(info["n_heavy"])
    assert got["source"] == "stats" and got["path"] == "effort"
    assert any(heavy), heavy          # phase 2 ran, its counters merged
    sched = port_sched.BatchScheduler(
        env["q"], port_sched.SchedulerConfig(max_batch=8, max_wait_ms=0.0),
        advisor=adv)
    reqs = _requests(env, 5)
    rids = [sched.submit(**r) for r in reqs]
    sched.flush()
    direct = env["q"].execute_bucketed(binds_list=reqs)
    for i, rid in enumerate(rids):
        _bitwise(sched.result(rid), {k: (v[i] if not isinstance(v, dict)
                                          else {s: x[i]
                                                for s, x in v.items()})
                                     for k, v in direct.items()},
                 f"advised request {i}")


def test_effort_hint_through_statement(env):
    stmt = env["stmt"]
    reqs = _requests(env, 6)
    lock = stmt.execute(reqs)
    eff = stmt.execute(reqs, hints=ExecutionHints(pilot_budget=2))
    _bitwise(eff.data, lock.data, "effort hint")
    rep = eff.explain()
    ref_rep = env["ref_stmt"].execute(
        reqs, hints=RefHints(pilot_budget=2)).explain()
    assert rep.path == ref_rep.path == "effort"
    assert rep.effort == ref_rep.effort
    assert rep.bucket == ref_rep.bucket == 8


# ---------------------------------------------------------------------------
# simulation
# ---------------------------------------------------------------------------

def test_simulation_serves_all_with_sane_timelines(env):
    n = 16
    reqs = _requests(env, n)
    sched = port_sched.BatchScheduler(
        env["q"], port_sched.SchedulerConfig(max_batch=4, max_wait_ms=2.0))
    sched.warm(reqs[0], [1, 4])
    arrivals = np.sort(np.random.default_rng(5).exponential(0.002, n)
                       .cumsum())
    records = sched.simulate(arrivals, reqs)
    assert len(records) == n
    assert [r.rid for r in records] == list(range(n))
    assert all(r.start >= r.arrival for r in records)
    assert all(r.finish > r.start for r in records)
    assert all(1 <= r.batch_size <= 4 for r in records)
    stats = port_sched.latency_stats(records)
    assert stats.keys() == {"p50_ms", "p95_ms", "mean_ms", "qps"}
    assert stats["p50_ms"] <= stats["p95_ms"]


def test_latency_stats_match_reference():
    recs = [(0.0, 0.001, 0.004, 2), (0.0005, 0.001, 0.004, 2),
            (0.002, 0.004, 0.0055, 1), (0.01, 0.012, 0.02, 1)]
    port = [port_sched.SimRecord(i, *r) for i, r in enumerate(recs)]
    ref = [ref_sched.SimRecord(i, *r) for i, r in enumerate(recs)]
    assert port_sched.latency_stats(port) == ref_sched.latency_stats(ref)
    assert port[0].latency == ref[0].latency


# ---------------------------------------------------------------------------
# admission, bind validation, typed errors
# ---------------------------------------------------------------------------

def _outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the outcome is the error
        return type(e).__name__, str(e), {
            k: v for k, v in vars(e).items() if not k.startswith("_")}
    return "ok"


def test_admission_rejects_at_watermark_with_scaled_retry_after():
    adm = port_res.AdmissionController(port_res.AdmissionConfig(
        max_queue_depth=4, retry_after_ms=10.0))
    for depth in range(4):
        adm.admit(depth)
    with pytest.raises(port_res.BackpressureError) as ei:
        adm.admit(4)
    assert ei.value.retry_after_ms == pytest.approx(10.0)
    assert ei.value.watermark == 4
    with pytest.raises(port_res.BackpressureError) as ei:
        adm.admit(8)
    assert ei.value.retry_after_ms == pytest.approx(20.0)
    assert adm.snapshot() == {"admitted": 4, "rejected": 2}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_decisions_match_reference(seed):
    rng = np.random.default_rng(seed)
    cfg = dict(max_queue_depth=int(rng.integers(1, 16)),
               retry_after_ms=float(rng.uniform(1, 20)))
    port = port_res.AdmissionController(port_res.AdmissionConfig(**cfg))
    ref = ref_res.AdmissionController(ref_res.AdmissionConfig(**cfg))
    for depth in rng.integers(0, 40, 64):
        assert _outcome(lambda: port.admit(int(depth))) == _outcome(
            lambda: ref.admit(int(depth)))
    assert port.snapshot() == ref.snapshot()


def test_admission_config_validation():
    with pytest.raises(ValueError, match="max_queue_depth"):
        port_res.AdmissionConfig(max_queue_depth=0)
    assert port_res.AdmissionConfig() == port_res.AdmissionConfig(
        **dataclasses.asdict(ref_res.AdmissionConfig()))


BINDS = {
    "finite": lambda: {"qv": np.ones(4, np.float32), "p": np.float32(2.0)},
    "nan_vector": lambda: {"qv": np.array([1, np.nan, 0, 0], np.float32)},
    "inf_scalar": lambda: {"p": np.float32(np.inf)},
    "int": lambda: {"k": np.int32(7)},
    "python_float_nan": lambda: {"p": float("nan")},
    "second_bind_bad": lambda: {"qv": np.ones(2, np.float32),
                                "p": np.float32(-np.inf)},
}


@pytest.mark.parametrize("case", sorted(BINDS))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_validate_binds_matches_reference(case, as_tensor):
    binds = BINDS[case]()
    port_binds = ({k: torch.as_tensor(v) for k, v in binds.items()}
                  if as_tensor else binds)
    assert _outcome(lambda: port_res.validate_binds(port_binds)) == \
        _outcome(lambda: ref_res.validate_binds(binds))


INSERTS = {
    "ok": (np.array([10, 11]), np.ones((2, 4), np.float32)),
    "dim": (np.array([10]), np.ones((1, 3), np.float32)),
    "rows": (np.array([10, 11]), np.ones((1, 4), np.float32)),
    "nan": (np.array([10]), np.full((1, 4), np.nan, np.float32)),
    "live_dup": (np.array([1, 12]), np.ones((2, 4), np.float32)),
    "batch_dup": (np.array([12, 12]), np.ones((2, 4), np.float32)),
    "full": (np.arange(20, 26), np.ones((6, 4), np.float32)),
}


@pytest.mark.parametrize("case", sorted(INSERTS))
def test_validate_insert_matches_reference(case):
    ids, vecs = INSERTS[case]
    args = (ids, vecs, 4, {0, 1, 2}, 5, 8)
    got = _outcome(lambda: port_res.validate_insert(*args))
    assert got == _outcome(lambda: ref_res.validate_insert(*args))
    if case == "ok":
        out_ids, out_vecs = port_res.validate_insert(*args)
        assert out_ids.dtype == np.int64 and out_vecs.dtype == np.float32


@pytest.mark.parametrize("ids", [[1], [1, 2], [5], [1, 1], list(range(12))])
def test_validate_delete_matches_reference(ids):
    live = {1, 2, 3}
    assert _outcome(lambda: port_res.validate_delete(ids, live)) == \
        _outcome(lambda: ref_res.validate_delete(ids, live))


def test_typed_errors_match_reference():
    cases = [("BackpressureError", (5, 4, 12.5)),
             ("DeadlineExceededError", (3, 1.25)),
             ("PoisonedBindError", ("qv",)),
             ("UnknownIdError", (range(12),)),
             ("DuplicateIdError", ([4, 5],)),
             ("InvalidVectorError", ("non-finite values",)),
             ("DeltaFullError", (8, 3, 1))]
    for name, args in cases:
        got, want = getattr(port_res, name)(*args), \
            getattr(ref_res, name)(*args)
        assert str(got) == str(want)
        assert isinstance(got, port_res.ServingError)
        assert vars(got) == vars(want)
    assert issubclass(port_res.DeltaFullError, port_res.MutationError)


# ---------------------------------------------------------------------------
# degradation policy + load controller
# ---------------------------------------------------------------------------

BAD_POLICIES = [dict(steps=((8, 8), (4, 2))), dict(steps=((4, 8), (4, 2))),
                dict(steps=((4, 0),)), dict(steps=((4, 2), (8, 8))),
                dict(hysteresis=-1)]


@pytest.mark.parametrize("i", range(len(BAD_POLICIES)))
def test_degrade_policy_validation_matches_reference(i):
    kw = BAD_POLICIES[i]
    got = _outcome(lambda: port_res.DegradePolicy(**kw))
    assert got != "ok" and got == _outcome(lambda: ref_res.DegradePolicy(**kw))


def test_load_controller_up_immediate_down_hysteretic():
    lc = port_res.LoadController(port_res.DegradePolicy(
        steps=((4, 8), (8, 2)), hysteresis=2))
    assert lc.observe(0) == 0 and lc.probe_budget() is None
    assert lc.observe(4) == 1 and lc.probe_budget() == 8
    assert lc.observe(9) == 2 and lc.probe_budget() == 2
    assert lc.observe(7) == 2
    assert lc.observe(6) == 1
    assert lc.observe(6) == 1
    assert lc.observe(2) == 0
    snap = lc.snapshot()
    assert snap["transitions"] == 4 and snap["degraded_batches"] == 5
    assert snap["level"] == 0 and snap["probe_budget"] is None
    lc2 = port_res.LoadController(port_res.DegradePolicy(
        steps=((4, 8), (8, 2)), hysteresis=2))
    assert lc2.observe(100) == 2 and lc2.transitions == 1


@pytest.mark.parametrize("steps,hyst", [(((4, 8), (8, 2)), 2),
                                        (((32, 16), (64, 4)), 4),
                                        (((3, 6), (6, 3), (12, 1)), 0)])
def test_load_controller_transitions_match_reference(steps, hyst):
    port = port_res.LoadController(port_res.DegradePolicy(steps, hyst))
    ref = ref_res.LoadController(ref_res.DegradePolicy(steps, hyst))
    rng = np.random.default_rng(len(steps) + hyst)
    top = 2 * steps[-1][0]
    walk = np.abs(np.cumsum(rng.integers(-top // 8, top // 8 + 1, 200))) % top
    for depth in walk:
        assert port.observe(int(depth)) == ref.observe(int(depth))
        assert port.probe_budget() == ref.probe_budget()
    assert port.snapshot() == ref.snapshot()
    assert port.snapshot()["transitions"] > 2


# ---------------------------------------------------------------------------
# fault injection: seeded, replayable, independent streams
# ---------------------------------------------------------------------------

def _drive(inj, n=32):
    errors = []
    for _ in range(n):
        try:
            inj.around_execute(lambda: "ok")
        except (port_faults.InjectedKernelError,
                ref_faults.InjectedKernelError):
            errors.append(True)
        else:
            errors.append(False)
    return errors, dict(inj.counters)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fault_injection_matches_reference(seed):
    kw = dict(seed=seed, latency_spike_p=0.3, latency_spike_ms=1.0,
              kernel_error_p=0.2, poison_bind_p=0.5, catalog_bump_p=0.25)
    runs = []
    for mod in (port_faults, ref_faults):
        sleeps, bumps = [], []
        inj = mod.FaultInjector(mod.FaultSpec(**kw), sleep_fn=sleeps.append,
                                bump_fn=lambda: bumps.append(1))
        binds = {"qv": np.ones(4, np.float32)}
        poisoned = [inj.maybe_poison(binds)[1] for _ in range(16)]
        for _ in range(16):
            inj.before_execute()
        errors, counters = _drive(inj)
        runs.append((poisoned, errors, counters, sleeps, len(bumps),
                     inj.snapshot()))
    assert runs[0] == runs[1]
    poisoned, errors, counters = runs[0][:3]
    assert any(poisoned) and any(errors) and counters["catalog_bumps"] > 0


def test_fault_injection_is_seed_deterministic():
    spec = port_faults.FaultSpec(seed=7, latency_spike_p=0.3,
                                 latency_spike_ms=1.0, kernel_error_p=0.2,
                                 poison_bind_p=0.5)
    sleeps_a, sleeps_b = [], []
    a = port_faults.FaultInjector(spec, sleep_fn=sleeps_a.append)
    b = port_faults.FaultInjector(spec, sleep_fn=sleeps_b.append)
    binds = {"qv": np.ones(4, np.float32)}
    pa = [a.maybe_poison(binds)[1] for _ in range(16)]
    pb = [b.maybe_poison(binds)[1] for _ in range(16)]
    assert pa == pb and any(pa)
    ea, ca = _drive(a)
    eb, cb = _drive(b)
    assert ea == eb and ca == cb and sleeps_a == sleeps_b
    assert ca["kernel_errors"] == sum(ea) > 0
    assert ca["latency_spikes"] == len(sleeps_a) > 0


def test_fault_streams_are_independent():
    lat_only = port_faults.FaultInjector(
        port_faults.FaultSpec(seed=3, latency_spike_p=0.4),
        sleep_fn=lambda s: None)
    both = port_faults.FaultInjector(
        port_faults.FaultSpec(seed=3, latency_spike_p=0.4,
                              kernel_error_p=0.9), sleep_fn=lambda s: None)
    _drive(lat_only)
    _drive(both)
    assert (lat_only.counters["latency_spikes"]
            == both.counters["latency_spikes"] > 0)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_maybe_poison_nans_first_float_bind_only(as_tensor):
    inj = port_faults.FaultInjector(port_faults.FaultSpec(
        seed=0, poison_bind_p=1.0))
    conv = torch.as_tensor if as_tensor else (lambda x: x)
    binds = {"qv": conv(np.ones(4, np.float32)), "p": np.float32(0.5)}
    out, poisoned = inj.maybe_poison(binds)
    assert poisoned and bool(np.isnan(_np(out["qv"])).all())
    assert out["p"] == binds["p"]
    assert np.isfinite(_np(binds["qv"])).all()     # the caller's untouched
    assert type(out["qv"]) is type(binds["qv"])
    with pytest.raises(port_res.PoisonedBindError):
        port_res.validate_binds(out)
    out2, poisoned2 = inj.maybe_poison({"k": conv(np.int32([3]))})
    assert not poisoned2
    assert inj.counters["poisoned_binds"] == 1


def test_wrap_fires_bump_before_execute():
    fired = []
    inj = port_faults.FaultInjector(
        port_faults.FaultSpec(seed=0, catalog_bump_p=1.0),
        bump_fn=lambda: fired.append(len(fired)))
    calls = []
    wrapped = inj.wrap(lambda bl: calls.append(bl) or "out")
    assert wrapped(["b"]) == "out"
    assert fired == [0] and calls == [["b"]]
    assert inj.counters["catalog_bumps"] == 1


@pytest.mark.parametrize("site", port_faults.CRASH_SITES[:4])
def test_crash_points_match_reference(site):
    assert port_faults.CRASH_SITES == ref_faults.CRASH_SITES
    hits = []
    for mod in (port_faults, ref_faults):
        inj = mod.FaultInjector(mod.FaultSpec(crash_site=site, crash_at=2))
        seq = []
        for s in list(mod.CRASH_SITES) * 3:
            try:
                inj.crash_point(s)
                seq.append(None)
            except (port_faults.InjectedCrashError,
                    ref_faults.InjectedCrashError) as e:
                seq.append(str(e))
        hits.append((seq, inj.snapshot()))
    assert hits[0] == hits[1]
    assert hits[0][1]["crashes"] == 1


@pytest.mark.parametrize("kw", [dict(kernel_error_p=1.5),
                                dict(poison_bind_p=-0.1),
                                dict(crash_site="nowhere"),
                                dict(crash_at=0)])
def test_fault_spec_validation_matches_reference(kw):
    got = _outcome(lambda: port_faults.FaultSpec(**kw))
    assert got != "ok" and got == _outcome(lambda: ref_faults.FaultSpec(**kw))


# ---------------------------------------------------------------------------
# the resilient scheduler: degradation, faults, mid-flight catalog bumps
# ---------------------------------------------------------------------------

def test_resilient_scheduler_degrades_and_reports(env):
    sched = port_sched.ResilientScheduler(
        env["stmt"], port_sched.SchedulerConfig(max_batch=8,
                                                max_wait_ms=50.0),
        policy=port_res.DegradePolicy(steps=((4, 2),), hysteresis=0))
    reqs = _requests(env, 6)
    rids = [sched.submit_request(dict(r)) for r in reqs]
    assert sorted(sched.flush()) == sorted(rids)
    for rid in rids:
        res = sched.result(rid)
        rep = res.explain()
        assert rep.degraded == {"level": 1, "probe_budget": 2}
        assert "DEGRADED" in rep.render()
        assert int(res.counters["probes"]) <= 2
    snap = sched.snapshot()
    assert snap["executed"] == 6 and snap["batches"] == 1
    assert snap["load"]["degraded_batches"] == 1
    rid = sched.submit_request(dict(reqs[0]))
    sched.flush()
    assert sched.result(rid).explain().degraded is None


def _chaos(mods, stmt, register, reqs, spec_kw):
    """A seeded chaos run: requests arrive on a fake clock, latency spikes
    advance it, kernel errors fail whole batches, catalog bumps re-register
    the index.  Returns the observable outcome."""
    sched_mod, res_mod, faults_mod = mods
    clock = FakeClock()

    def spike(s):
        clock.t += s

    inj = faults_mod.FaultInjector(faults_mod.FaultSpec(**spec_kw),
                                   bump_fn=register, sleep_fn=spike)
    sizes = []

    class Recording(sched_mod.ResilientScheduler):
        def execute(self, binds_list):
            sizes.append(len(binds_list))
            return super().execute(binds_list)

    sched = Recording(stmt, sched_mod.SchedulerConfig(
        max_batch=4, max_wait_ms=1.0, default_deadline_ms=6.0),
        clock=clock, policy=res_mod.DegradePolicy(steps=((6, 3),),
                                                  hysteresis=1),
        faults=inj)
    rids, polls = [], []
    for i, r in enumerate(reqs):
        clock.t += 0.0004
        rids.append(sched.submit_request(dict(r)))
        if i % 8 == 7:
            polls.append(sorted(sched.poll()))
    polls.append(sorted(sched.flush()))
    outcomes = {}
    for rid in rids:
        try:
            res = sched.result(rid)
        except Exception as e:  # noqa: BLE001 - the outcome is the type
            outcomes[rid] = type(e).__name__
        else:
            outcomes[rid] = (res, res.explain().degraded)
    return polls, sizes, sched.snapshot(), outcomes


def test_chaos_run_matches_reference(env):
    reqs = _requests(env, 40, seed=4)
    spec = dict(seed=11, latency_spike_p=0.3, latency_spike_ms=8.0,
                kernel_error_p=0.25, catalog_bump_p=0.3)

    def bump(cat, idx):
        return lambda: cat.register_index("products", "embedding", idx)

    got = _chaos((port_sched, port_res, port_faults), env["db"].prepare(SQL),
                 bump(env["cat"], env["idx"]), reqs, spec)
    want = _chaos((ref_sched, ref_res, ref_faults),
                  env["ref_db"].prepare(SQL),
                  bump(env["ref_cat"], env["ref_idx"]), reqs, spec)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == want[2]
    snap = got[2]
    assert snap["failed"] > 0 and snap["faults"]["catalog_bumps"] > 0
    assert snap["shed_deadline"] > 0 and snap["load"]["transitions"] > 0
    failed = 0
    for rid, out in got[3].items():
        ref = want[3][rid]
        if isinstance(out, str):
            assert out == ref
            failed += out == "InjectedKernelError"
        else:
            assert out[1] == ref[1]                      # degraded report
            _close_to_ref(out[0].data,
                          jax.tree.map(np.asarray, ref[0].data), f"rid {rid}")
    # every member of a failed batch, and nothing else, reports the error
    assert failed == snap["failed"]


def test_results_after_a_catalog_bump_equal_those_before(env):
    db = env["db"]
    stmt = db.prepare(SQL)
    reqs = _requests(env, 6, seed=9)
    before = stmt.execute(reqs)
    rebinds = stmt.compiled.rebinds
    inj = port_faults.FaultInjector(
        port_faults.FaultSpec(seed=0, catalog_bump_p=1.0),
        bump_fn=lambda: env["cat"].register_index("products", "embedding",
                                                  _carry(env["ref_idx"])))
    sched = port_sched.ResilientScheduler(
        stmt, port_sched.SchedulerConfig(max_batch=8, max_wait_ms=0.0),
        policy=port_res.DegradePolicy(steps=()), faults=inj)
    rids = [sched.submit_request(dict(r)) for r in reqs]
    sched.flush()
    assert inj.counters["catalog_bumps"] == 1
    assert stmt.compiled.rebinds == rebinds + 1       # re-bound in place
    for i, rid in enumerate(rids):
        _bitwise(sched.result(rid).data, before.query(i).data, f"rid {rid}")


# ---------------------------------------------------------------------------
# Database.serve and the Statement scheduler contract
# ---------------------------------------------------------------------------

def test_serve_roundtrip_with_renamed_params(env):
    db, ref_db = env["db"], env["ref_db"]
    stmt, ref_stmt = db.prepare(RENAMED), ref_db.prepare(RENAMED)
    renamed = [{"vec": b["qv"], "cap": b["p"]} for b in _requests(env, 5)]
    server = db.serve(stmt, max_batch=8, max_wait_ms=0.0)
    ref_server = ref_db.serve(ref_stmt, max_batch=8, max_wait_ms=0.0)
    rids = [server.submit(**b) for b in renamed]
    ref_rids = [ref_server.submit(**b) for b in renamed]
    assert sorted(server.flush()) == sorted(rids)
    ref_server.flush()
    got = torch.stack([server.result(r)["ids"] for r in rids])
    assert torch.equal(got, stmt.execute(renamed)["ids"])
    want = np.stack([np.asarray(ref_server.result(r)["ids"])
                     for r in ref_rids])
    np.testing.assert_array_equal(got.numpy(), want)


def test_statement_stack_binds_renames(env):
    stmt = env["db"].prepare(RENAMED)
    ref_stmt = env["ref_db"].prepare(RENAMED)
    renamed = [{"vec": b["qv"], "cap": b["p"]} for b in _requests(env, 3)]
    got = stmt._stack_binds(renamed, {})
    want = ref_stmt._stack_binds(renamed, {})
    assert got.keys() == want.keys() == {"qv", "p"}
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    stacked = {"vec": np.stack([b["vec"] for b in renamed]),
               "cap": np.asarray([b["cap"] for b in renamed])}
    again = stmt._stack_binds(None, stacked)
    for k in got:
        np.testing.assert_array_equal(again[k], got[k])
    with pytest.raises(ValueError, match="unknown bind"):
        stmt._stack_binds([{"qv": renamed[0]["vec"], "cap": 1.0}], {})


def test_serve_rejects_statics_on_statement(env):
    with pytest.raises(TypeError, match="already-prepared"):
        env["db"].serve(env["stmt"], K=8)


def test_serve_from_sql_string(env):
    db = env["db"]
    server = db.serve(SQL, max_batch=4, max_wait_ms=0.0)
    b = _requests(env, 1)[0]
    rid = server.submit(**b)
    server.flush()
    out = server.result(rid)
    stmt = db.prepare(SQL)
    assert stmt.cache_hit
    assert torch.equal(out["ids"], stmt.execute([b])["ids"][0])


def test_serve_upgrades_to_resilient(env):
    db = env["db"]
    plain = db.serve(env["stmt"])
    assert type(plain) is port_sched.BatchScheduler
    res = db.serve(env["stmt"], policy=port_res.DegradePolicy())
    assert isinstance(res, port_sched.ResilientScheduler)
    inj = port_faults.FaultInjector(port_faults.FaultSpec())
    assert db.serve(env["stmt"], faults=inj).faults is inj
    assert plain.config == port_sched.SchedulerConfig(max_batch=64,
                                                      max_wait_ms=2.0)


def test_scheduler_config_not_shared(env):
    s1 = port_sched.BatchScheduler(env["stmt"])
    s2 = port_sched.BatchScheduler(env["stmt"])
    assert s1.config == s2.config and s1.config is not s2.config
    with pytest.raises(dataclasses.FrozenInstanceError):
        s1.config.max_batch = 1
    assert dataclasses.asdict(s1.config) == dataclasses.asdict(
        ref_sched.SchedulerConfig())


# ---------------------------------------------------------------------------
# threads: drains on alternating worker threads, the precision scope
# ---------------------------------------------------------------------------

def test_drains_on_alternating_threads_equal_one_thread(env):
    reqs = _requests(env, 20, seed=6)

    def serve(pools):
        sched = port_sched.BatchScheduler(
            env["q"], port_sched.SchedulerConfig(max_batch=3,
                                                 max_wait_ms=0.0))
        rids = [sched.submit(**r) for r in reqs]
        threads = set()
        turn = 0
        while sched.pending():
            def drain():
                threads.add(threading.get_ident())
                return sched.poll()
            pools[turn % len(pools)].submit(drain).result(timeout=60)
            turn += 1
        return [sched.result(r) for r in rids], threads

    with concurrent.futures.ThreadPoolExecutor(1) as a, \
            concurrent.futures.ThreadPoolExecutor(1) as b:
        alternating, threads = serve([a, b])
        one, _ = serve([a])
    assert len(threads) == 2
    for x, y in zip(alternating, one):
        _bitwise(x, y, "alternating threads")


def test_concurrent_submits_and_drains_lose_nothing(env):
    """Submits on four threads race drains on a fifth, under a short switch
    interval; every request is served exactly once."""
    reqs = _requests(env, 8, seed=8)
    sched = port_sched.BatchScheduler(
        env["q"], port_sched.SchedulerConfig(max_batch=5, max_wait_ms=0.0))
    per_thread, n_threads = 10, 4
    rids, stop = [], threading.Event()
    rid_lock = threading.Lock()

    def submitter(t):
        for i in range(per_thread):
            rid = sched.submit(**reqs[(t + i) % len(reqs)])
            with rid_lock:
                rids.append(rid)

    def drainer():
        done = []
        while not stop.is_set() or sched.pending():
            done += sched.poll()
        return done

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(n_threads + 1) as pool:
            drain = pool.submit(drainer)
            subs = [pool.submit(submitter, t) for t in range(n_threads)]
            for f in subs:
                f.result(timeout=60)
            stop.set()
            done = drain.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    total = per_thread * n_threads
    assert sorted(done) == sorted(rids) == list(range(total))
    assert sched.counters["submitted"] == sched.counters["executed"] == total
    for rid in rids:
        assert sched.result(rid)["ids"].shape == (4,)


def test_precision_scope_is_not_restored_by_another_thread():
    """A thread that leaves full_fp32 cannot restore the caller's matmul
    precision while another thread is inside the scope."""
    inside, leave = threading.Event(), threading.Event()
    seen = []
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        def holder():
            with full_fp32():
                inside.set()
                leave.wait(timeout=10)
                seen.append(torch.get_float32_matmul_precision())

        def visitor():
            with full_fp32():
                pass
            seen.append("visitor done")

        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            h = pool.submit(holder)
            assert inside.wait(timeout=10)
            v = pool.submit(visitor)
            # the visitor waits at the scope's door while the holder is in
            with pytest.raises(concurrent.futures.TimeoutError):
                v.result(timeout=0.2)
            leave.set()
            h.result(timeout=10)
            v.result(timeout=10)
        assert seen == ["highest", "visitor done"]
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(old)
