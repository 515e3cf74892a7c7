"""The readers of the program's own spans and counters: reported by a
traced run, absent from an untraced one, silent on a program without
``repro_torch.tracing``; on the card, the two counters held to the
profiler's host-to-device copies and to the sync-debug warnings, and the
device times and idle share of a traced run the same with the spans on
and off.  The
card tests skip where no CUDA device is found; on the chip::

    PYTHONPATH=src python3 -m pytest -q chasebench/tests -m card
"""
import time
import warnings

import pytest
import torch

from chasebench import harness
from chasebench import trace as trace_mod
from conftest import ROOT, run_small

CELLS = ["laion1m-flat-q1-b100", "laion1m-flat-q2-b100"]
HOST = ["frontend.host_ms", "bind.host_ms", "executor.self_host_ms",
        "launch.host_ms"]
DEVICE = ["predicate.device_ms", "stage2.device_ms"]
COUNTS = ["executor.uploads", "executor.syncs"]
SPANS = HOST + DEVICE + COUNTS
COUNTED = "chasebench.test.counted"
# device times of a traced run that program spans must leave alone
HELD = ["kernels.device_ms", "aten.device_ms"]


@pytest.fixture
def tracing():
    from repro_torch import tracing
    tracing.disable()
    yield tracing
    tracing.disable()


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_program_spans(bench, tracing, cell):
    metrics = run_small(bench, cell, trace=True)["metrics"]
    assert tracing.enabled()
    for name in HOST + COUNTS:
        assert name in metrics, name
        assert metrics[name]["unit"] == ("count" if name in COUNTS
                                         else "ms")
    for name in HOST:
        assert metrics[name]["value"] > 0
    # on the CPU nothing is uploaded, nothing waits, nothing runs on a card
    assert metrics["executor.uploads"]["value"] == 0
    assert metrics["executor.syncs"]["value"] == 0
    assert not set(DEVICE) & set(metrics)


def test_an_untraced_run_leaves_the_spans_off(bench, tracing):
    metrics = run_small(bench, CELLS[0])["metrics"]
    assert not tracing.enabled()
    assert not set(SPANS) & set(metrics)


def test_a_program_without_spans_reads_nothing(bench, monkeypatch):
    import sys

    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    ctx = harness.Context({"name": CELLS[0]}, {}, {}, window=harness.Window(
        [0.1], 3, 0, 300, 0.3))
    for name in SPANS:
        reader = harness.load_module(harness.HERE / "metrics" / f"{name}.py")
        reader.before_window(ctx)
        assert reader.read(ctx) is None, name


def _prepared(bench, name: str, device):
    """(statement, traffic) of a cell at its own size, warmed up."""
    cell = harness.by_name(bench["workloads"], name)
    config = harness.load_json(
        ROOT / harness.by_name(bench["configs"], cell["config"])["file"])
    mix = harness.load_json(harness.HERE / "traffic"
                            / f"{cell['traffic']}.json")
    system = harness.load_module(harness.HERE / "systems"
                                 / f"{config['system']}.py")
    data = system.make_data(config, 2**31 + 303, device)
    traffic = harness.generator.Traffic(mix, config, data, 2**31 + 303)
    program = system.Program(config, data, 2**31 + 303)
    statement = program.db.prepare(mix["sql"], **traffic.static)
    for i in range(mix["warmup"]):
        statement.execute(traffic.request(i)[0])
    torch.cuda.synchronize(device)
    return statement, traffic


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_uploads_are_the_profilers_host_to_device_copies(card, bench,
                                                         tracing, cell):
    statement, traffic = _prepared(bench, cell, card)
    with trace_mod.profiler() as prof:
        # the profiler's first requests, whose copies it may not see yet
        for i in range(3):
            statement.execute(traffic.request(100 + i)[0])
        torch.cuda.synchronize(card)
        before = tracing.snapshot()["counters"]["uploads"]
        with torch.profiler.record_function(COUNTED):
            for i in range(8):
                statement.execute(traffic.request(110 + i)[0])
            torch.cuda.synchronize(card)
        uploads = tracing.snapshot()["counters"]["uploads"] - before
    events = list(trace_mod.events(prof))
    (lo, hi), = [(ev[2], ev[3]) for ev in events
                 if not ev[0] and ev[1] == COUNTED]
    copies = sum(1 for ev in events if ev[0]
                 and ev[1].startswith("Memcpy HtoD") and lo <= ev[2] <= hi)
    assert uploads == 8 * (3 if "q1" in cell else 4)
    assert uploads == copies, (uploads, copies)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_syncs_are_the_sync_debug_warnings(card, bench, tracing, cell):
    statement, traffic = _prepared(bench, cell, card)
    binds = traffic.request(100)[0]
    before = tracing.snapshot()["counters"]["syncs"]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            statement.execute(binds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = tracing.snapshot()["counters"]["syncs"] - before
    warned = [w for w in caught if "synchronizing" in str(w.message)]
    assert syncs > 0
    assert syncs == len(warned), [str(w.message) for w in warned]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_device_times_hold_with_the_spans_on(card, bench, tracing, cell):
    """A traced run with the spans off, then one with them on (one seed):
    the device times of its requests agree within 3%."""
    plain = dict(bench, per_layer=[m for m in bench["per_layer"]
                                   if m["name"] not in SPANS])
    readings = {}
    for spans_on in (False, True):
        b = bench if spans_on else plain
        result = harness.run_cell(
            b, harness.by_name(b["workloads"], cell), 2**31 + 404, 4.0, True,
            device=card, started=time.perf_counter(), log=lambda msg: None)
        assert result["correct"]
        assert tracing.enabled() is spans_on
        readings[spans_on] = {k: v["value"]
                              for k, v in result["metrics"].items()}
    assert set(SPANS) <= set(readings[True])
    for name in HELD:
        off, on = readings[False][name], readings[True][name]
        assert abs(on - off) <= 0.03 * off, (name, off, on)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_idle_share_holds_with_the_spans_on(card, bench, tracing, cell):
    """One profiled window of requests with the spans on and off in turns,
    so that both sides share the host's state: the share of their spans in
    which the card ran nothing agrees within 3 points (the enabled spans'
    host time shows there)."""
    statement, traffic = _prepared(bench, cell, card)
    sides = [i % 2 == 1 for i in range(120)]
    with trace_mod.profiler() as prof:
        for i, spans_on in enumerate(sides):
            (tracing.enable if spans_on else tracing.disable)()
            with trace_mod.span():
                statement.execute(traffic.request(200 + i)[0])
                torch.cuda.synchronize(card)
    tracing.disable()
    digest = trace_mod.digest(trace_mod.events(prof))
    assert digest.executes == len(sides)
    idle = {}
    for side in (False, True):
        spans = [(e - s) / 1e9 for (s, e), on in zip(digest.spans, sides)
                 if on is side]
        busy = [b for b, on in zip(digest.busy_in_span_s, sides)
                if on is side]
        idle[side] = 100.0 * (1.0 - sum(busy) / sum(spans))
    assert abs(idle[True] - idle[False]) <= 3.0, idle
