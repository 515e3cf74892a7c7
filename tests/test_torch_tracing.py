"""The port's spans and counters (``repro_torch.tracing``) on the CPU:
disabled spans cost nothing and record nothing; enabled ones nest per
thread, sum their self times to the front door's, close on an exception,
sit nested in a ``torch.profiler`` trace, and name exactly the stages a
flat Q1 or Q2 list and a single dict run through; the ``uploads`` and
``syncs`` counters count where a host value moves to a device and where
the IVF probe loop reads its active lanes."""
import threading

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.api import connect
from repro_torch.core.expr import as_tensor, on_device
from repro_torch.core.physical import ProbeConfig
from repro_torch.data import make_laion_catalog
from repro_torch.index import build_ivf, ivf

Q1 = ("SELECT sample_id FROM products WHERE price < ${p} "
      "ORDER BY DISTANCE(embedding, ${qv}) LIMIT ${K}")
Q2 = ("SELECT sample_id FROM images WHERE DISTANCE(embedding, ${qv}) <= ${r} "
      "AND price < ${p}")
STAGES = {tracing.EXECUTE, tracing.EXECUTOR, tracing.PREDICATE,
          tracing.STAGE2}


@pytest.fixture
def traced():
    tracing.reset()
    tracing.enable()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def catalog():
    return make_laion_catalog(n_rows=3000, n_queries=8, dim=32, n_modes=8,
                              seed=0, device="cpu")


@pytest.fixture(scope="module")
def queries(catalog):
    return catalog.table("queries")["vec"].numpy()


def _lists(queries, n=5, **scalars):
    return [{"qv": queries[i], **scalars} for i in range(n)]


def _names() -> set:
    return set(tracing.snapshot()["spans"])


def test_disabled_spans_record_nothing_and_enter_no_profiler_range(
        monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    tracing.reset()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing, "_range", refuse)
    assert not tracing.enabled()
    with tracing.span("repro_torch.test", "cpu") as inside:
        assert inside is None
    assert tracing.span("a") is tracing.span("b") is tracing.NULL
    assert tracing.snapshot()["spans"] == {}


def test_spans_nest_and_each_thread_keeps_its_own_stack(traced):
    seen = {}

    def worker():
        with tracing.span("repro_torch.worker"):
            seen["depth"] = len(tracing._stack())

    with tracing.span("repro_torch.outer"):
        with tracing.span("repro_torch.inner"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert seen["depth"] == 1          # not nested under the main thread's
    spans = tracing.snapshot()["spans"]
    outer, inner = spans["repro_torch.outer"], spans["repro_torch.inner"]
    assert outer["calls"] == inner["calls"] == 1
    assert outer["self_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], abs=1e-9)
    assert inner["self_s"] == inner["host_s"]
    worker_row = spans["repro_torch.worker"]
    assert worker_row["self_s"] == worker_row["host_s"]
    assert tracing._stack() == []


def test_self_times_of_one_execute_sum_to_its_span(traced, catalog,
                                                   queries):
    st = connect(catalog, engine="brute", use_pallas=True).prepare(Q1, K=5)
    st.execute(_lists(queries, p=np.float32(40.0)))
    spans = tracing.snapshot()["spans"]
    assert spans[tracing.EXECUTE]["calls"] == 1
    total = sum(row["self_s"] for row in spans.values())
    assert total == pytest.approx(spans[tracing.EXECUTE]["host_s"],
                                  rel=1e-9, abs=1e-9)
    assert all(row["self_s"] >= 0 for row in spans.values())


@pytest.mark.parametrize("case", ["q1-list", "q2-list", "q1-single"])
def test_an_execute_names_exactly_its_stages(traced, catalog, queries,
                                             case):
    db = connect(catalog, engine="brute", use_pallas=True)
    if case == "q2-list":
        st = db.prepare(Q2)
        binds = _lists(queries, p=np.float32(40.0), r=np.float32(0.2))
        kernel, bind = "range_topk_batch", {tracing.BIND}
    else:
        st = db.prepare(Q1, K=5)
        binds = _lists(queries, p=np.float32(40.0))
        kernel, bind = "scan_topk_batch", {tracing.BIND}
        if case == "q1-single":
            binds, kernel, bind = binds[0], "scan_topk", set()
    st.execute(binds)                  # the bucket's first run
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        st.execute(binds)
    assert _names() == STAGES | bind | {tracing.KERNEL + kernel}
    spans = tracing.snapshot()["spans"]
    assert all(row["calls"] == 1 for row in spans.values())
    ours = [e for e in prof.events() if e.name.startswith("repro_torch.")]
    assert {e.name for e in ours} == set(spans)
    for e in ours:
        if e.name.startswith(tracing.KERNEL):
            parents = []
            p = e.cpu_parent
            while p is not None:
                parents.append(p.name)
                p = p.cpu_parent
            assert tracing.EXECUTOR in parents
            assert parents.index(tracing.EXECUTOR) < parents.index(
                tracing.EXECUTE)


def test_spans_sit_nested_in_a_profiler_trace(traced):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("repro_torch.outer"):
            with tracing.span("repro_torch.inner"):
                torch.ones(4).sum()
    events = {e.name: e for e in prof.events()
              if e.name.startswith("repro_torch.")}
    outer, inner = events["repro_torch.outer"], events["repro_torch.inner"]
    assert inner.cpu_parent is not None
    assert inner.cpu_parent.name == "repro_torch.outer"
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end


def test_an_exception_closes_its_span(traced):
    with pytest.raises(ValueError):
        with tracing.span("repro_torch.outer"):
            with tracing.span("repro_torch.failing"):
                raise ValueError("inside")
    assert tracing._stack() == []
    spans = tracing.snapshot()["spans"]
    assert spans["repro_torch.failing"]["calls"] == 1
    assert spans["repro_torch.outer"]["calls"] == 1
    with tracing.span("repro_torch.after"):
        assert len(tracing._stack()) == 1


def test_uploads_count_a_host_value_moving_to_a_device():
    meta = torch.device("meta")
    before = tracing.snapshot()["counters"]
    as_tensor(np.arange(3, dtype=np.float64), meta)       # host -> device
    on_device(np.float32(0.5), "meta", torch.float32)     # host -> device
    on_device(torch.ones(2), meta, torch.bool)            # host -> device
    as_tensor(torch.ones(2, device=meta), meta)           # already there
    as_tensor(np.arange(3), torch.device("cpu"))          # stays on the host
    on_device(torch.ones(2), "cpu", torch.float32)
    after = tracing.snapshot()["counters"]
    assert after["uploads"] - before["uploads"] == 3
    assert after["syncs"] - before["syncs"] == 3


def test_a_cpu_execute_counts_no_upload(catalog, queries):
    st = connect(catalog, engine="brute", use_pallas=True).prepare(Q1, K=5)
    binds = _lists(queries, p=np.float32(40.0))
    st.execute(binds)
    before = tracing.snapshot()["counters"]
    st.execute(binds)
    assert tracing.snapshot()["counters"] == before


def test_syncs_count_each_active_check_of_the_ivf_loop(queries):
    catalog_ivf = make_laion_catalog(n_rows=3000, n_queries=8, dim=32,
                                     n_modes=8, seed=0, device="cpu")
    index = build_ivf(torch.Generator().manual_seed(0),
                      catalog_ivf.table("products")["embedding"], 8)
    catalog_ivf.register_index("products", "embedding", index)
    st = connect(catalog_ivf, engine="chase",
                 probe=ProbeConfig(min_probes=2, max_probes=6)).prepare(
        Q1, K=5)
    binds = _lists(queries, p=np.float32(40.0))
    st.execute(binds)
    before, loop = tracing.snapshot()["counters"], dict(ivf.loop_stats)
    st.execute(binds)
    checks = ivf.loop_stats["syncs"] - loop["syncs"]
    assert checks > 0
    after = tracing.snapshot()["counters"]
    assert after["syncs"] - before["syncs"] == checks
    assert after["uploads"] == before["uploads"]


class _Event:
    """A stand-in for a CUDA timing event on the CPU."""
    made = 0

    def __init__(self):
        _Event.made += 1
        self.at = None

    def record(self, stream):
        self.at = _Event.clock
        _Event.clock += 2.5

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


def test_device_markers_fold_into_device_seconds(traced, monkeypatch):
    _Event.made, _Event.clock = 0, 0.0
    monkeypatch.setattr(tracing, "_stream", lambda device: "stream")
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: _Event())
    monkeypatch.setattr(tracing, "_FOLD_AT", 4)
    monkeypatch.setattr(tracing, "_spare", [])
    cuda = torch.device("cuda")
    for _ in range(10):
        with tracing.span(tracing.STAGE2, cuda):
            pass
    with tracing.span(tracing.PREDICATE, "cpu"):
        pass
    spans = tracing.snapshot()["spans"]
    assert spans[tracing.STAGE2]["device_calls"] == 10
    assert spans[tracing.STAGE2]["device_s"] == pytest.approx(10 * 2.5e-3)
    assert spans[tracing.PREDICATE]["device_calls"] == 0
    assert _Event.made < 20            # folded pairs are reused
