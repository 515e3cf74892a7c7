"""The reader of the program's ``range_overflows`` counter: a traced run
reports ``stage2.overflows`` in both cells (0 where every query's hits fit
its buffer, as in the range cell's mix), an untraced one leaves it out, and
a program without the counter reports nothing; the reader turns no span
on."""
import pytest

from chasebench import harness
from conftest import ROOT, run_small

CELLS = ["laion1m-flat-q1-b100", "laion1m-flat-q2-b100"]
NAME = "stage2.overflows"


@pytest.fixture
def tracing():
    from repro_torch import tracing
    tracing.disable()
    yield tracing
    tracing.disable()


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_overflows(bench, tracing, cell):
    metrics = run_small(bench, cell, trace=True)["metrics"]
    assert metrics[NAME] == {"value": 0.0, "unit": "count"}


def test_an_untraced_run_leaves_the_overflows_out(bench, tracing):
    assert NAME not in run_small(bench, CELLS[1])["metrics"]


def test_the_reader_leaves_the_spans_off(bench, tracing):
    """A traced run whose only program reader is this one: the counter is
    read, and no span is turned on (a traced run with the span readers
    left out measures the program with its spans off)."""
    alone = dict(bench, per_layer=[m for m in bench["per_layer"]
                                   if m["name"] == NAME])
    metrics = run_small(alone, CELLS[1], trace=True)["metrics"]
    assert metrics == {NAME: {"value": 0.0, "unit": "count"}}
    assert not tracing.enabled()


def test_a_program_without_the_counter_reads_nothing(tracing, monkeypatch):
    reader = harness.load_module(ROOT / "chasebench" / "metrics"
                                 / f"{NAME}.py")
    monkeypatch.setattr(tracing, "counters",
                        {"uploads": 0, "syncs": 0})

    class Ctx:
        counters = {}

        class window:
            requests = 3

    ctx = Ctx()
    reader.before_window(ctx)
    assert reader.read(ctx) is None
    assert not tracing.enabled()
