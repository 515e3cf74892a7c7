"""The int8 twin's cells (configuration ``laion1m-int8``) and their check,
on the CPU at the size a test run holds (rows cut, the vectors' width of
512 kept): a sound run is correct, the reference at TF32 in the program's
place is not, and faults planted in the program's answers each fail the
check by the number made to catch them; the new readers report in a
traced run, read nothing on a program without their counters, and turn
no span on."""
import pytest
import torch

from chasebench import harness
from conftest import ROOT, run_small

Q1, Q2 = "laion1m-int8-q1-b100", "laion1m-int8-q2-b100"
CELLS = [Q1, Q2]
COUNTERS = {Q1: ["quant.replayed"],
            Q2: ["quant.replayed", "quant.band_rows", "quant.fallbacks"]}
READERS = ["quant.scan_device_ms", "quant.replay_device_ms",
           "quant.replayed", "quant.band_rows", "quant.fallbacks",
           "quant.roofline_share"]
INF = float("inf")


def failing(result):
    return [n for n, c in result["checks"].items()
            if (c["value"] < c["limit"] if n == "recall"
                else c["value"] > c["limit"])]


@pytest.fixture
def tracing():
    from repro_torch import tracing
    tracing.disable()
    yield tracing
    tracing.disable()


@pytest.fixture
def drawn(monkeypatch):
    """The run's data, kept as the system draws it."""
    system = harness.load_module(harness.HERE / "systems"
                                 / "laion_hybrid.py")
    real = system.make_data
    box = {}

    def make_data(config, seed, device):
        box["data"] = real(config, seed, device)
        return box["data"]

    monkeypatch.setattr(system, "make_data", make_data)
    return box


def _plant(monkeypatch, drawn, fault):
    """Break the first query of every list that ``Statement.execute``
    answers: ``dropped`` leaves out the first (best) entry, moves the
    others up and ends with the best passing row left out, with its own
    similarity, so the order holds; ``wrong_side`` puts a passing row
    well below the radius in place of the last valid entry;
    ``reversed`` turns its valid entries, ids and similarities together,
    worst first; ``altered`` moves every list's first ids by one row."""
    from repro_torch.api import database
    real = database.Statement.execute

    def broken(self, binds=None, hints=None):
        out = real(self, binds, hints)
        got, data = out.data, drawn["data"]
        n = data.corpus.shape[0]
        if fault == "altered":
            got["ids"][..., 0] = (got["ids"][..., 0] + 1) % n
            return out
        if fault == "reversed":
            v = int(got["valid"][0].sum())
            for key in ("ids", "sim"):
                got[key][0, :v] = got[key][0, :v].flip(0)
            return out
        first = binds[0]
        sims = data.corpus @ torch.as_tensor(first["qv"])
        passing = data.columns["price"] < float(first["p"])
        valid = got["valid"][0]
        taken = torch.zeros(n, dtype=torch.bool)
        taken[got["ids"][0][valid].long()] = True
        slot = int(valid.sum()) - 1
        if fault == "dropped":
            pool = passing & ~taken
            for key in ("ids", "sim"):
                got[key][0, :slot] = got[key][0, 1:slot + 1].clone()
        else:
            pool = passing & (sims < float(first["r"]) - 1e-3)
        row = int(torch.where(pool, sims, -INF).argmax())
        got["ids"][0, slot] = row
        got["sim"][0, slot] = sims[row]
        return out

    monkeypatch.setattr(database.Statement, "execute", broken)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, cell):
    result = run_small(bench, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    names = {Q1: {"bad_rows", "sim_err", "recall", "cover_miss",
                  "order_gap"},
             Q2: {"bad_rows", "sim_err", "range_gap"}}[cell]
    assert set(result["checks"]) == names


@pytest.mark.parametrize("cell", CELLS)
def test_control_at_tf32_is_not_correct(bench, cell):
    result = run_small(bench, cell, control=True)
    assert not result["correct"]
    assert "sim_err" in failing(result)


@pytest.mark.parametrize("cell,fault,number", [
    (Q1, "dropped", "cover_miss"),
    (Q1, "altered", "sim_err"),
    (Q1, "reversed", "order_gap"),
    (Q2, "altered", "sim_err"),
    (Q2, "wrong_side", "range_gap"),
])
def test_planted_faults_are_not_correct(bench, monkeypatch, drawn, cell,
                                        fault, number):
    _plant(monkeypatch, drawn, fault)
    result = run_small(bench, cell)
    assert not result["correct"], (fault, result["checks"])
    assert number in failing(result), result["checks"]


def test_a_dropped_row_passes_recall_alone(bench, monkeypatch, drawn):
    """One row of one query a list dropped keeps the mean recall above its
    limit: only ``cover_miss`` sees it."""
    _plant(monkeypatch, drawn, "dropped")
    result = run_small(bench, Q1)
    assert failing(result) == ["cover_miss"], result["checks"]


def test_a_reversed_list_fails_order_gap_alone(bench, monkeypatch, drawn):
    """The right rows with the right similarities, worst first: every
    other number reads sets or single rows, so only ``order_gap`` sees
    it."""
    _plant(monkeypatch, drawn, "reversed")
    result = run_small(bench, Q1)
    assert failing(result) == ["order_gap"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_counters(bench, tracing, cell):
    metrics = run_small(bench, cell, trace=True)["metrics"]
    assert set(COUNTERS[cell]) <= set(metrics)
    assert metrics["quant.replayed"]["value"] > 0
    if cell == Q2:
        assert metrics["quant.band_rows"]["value"] > 0
        assert metrics["quant.fallbacks"]["value"] == 0.0
    # the spans are timed only on a card, the kernel only in its trace
    assert not {"quant.scan_device_ms", "quant.replay_device_ms",
                "quant.roofline_share"} & set(metrics)


def test_the_counter_readers_leave_the_spans_off(bench, tracing):
    counters = COUNTERS[Q2]
    alone = dict(bench, per_layer=[m for m in bench["per_layer"]
                                   if m["name"] in counters])
    metrics = run_small(alone, Q2, trace=True)["metrics"]
    assert set(metrics) == set(counters)
    assert not tracing.enabled()


def test_an_untraced_run_leaves_the_readers_out(bench, tracing):
    metrics = run_small(bench, Q2)["metrics"]
    assert not set(READERS) & set(metrics)
    assert not tracing.enabled()


def test_a_program_without_the_counters_reads_nothing(tracing,
                                                      monkeypatch):
    monkeypatch.setattr(tracing, "counters",
                        {"uploads": 0, "syncs": 0, "range_overflows": 0})
    ctx = harness.Context({"name": Q2}, {}, {}, window=harness.Window(
        [0.1], 3, 0, 300, 0.3))
    for name in ("quant.replayed", "quant.band_rows", "quant.fallbacks"):
        reader = harness.load_module(ROOT / "chasebench" / "metrics"
                                     / f"{name}.py")
        reader.before_window(ctx)
        assert reader.read(ctx) is None, name
    assert not tracing.enabled()


def test_the_roofline_reader_needs_the_kernel_in_the_trace():
    reader = harness.load_module(ROOT / "chasebench" / "metrics"
                                 / "quant.roofline_share.py")
    assert reader._is_scan("void (anonymous namespace)::quant_topk_kernel<"
                           "(anonymous namespace)::Wide, 0, signed char>")
    assert reader._is_scan("void (anonymous namespace)::repro_range_tile::"
                           "range_tile_kernel<(anonymous namespace)::"
                           "repro_range_tile::Wide, 0, 4, (anonymous "
                           "namespace)::repro_range_tile::Int8Rows, 0>")
    assert not reader._is_scan("void (anonymous namespace)::"
                               "repro_range_tile::range_tile_kernel<Wide, "
                               "0, 4, Fp32Rows, 2>")
    assert not reader._is_scan("void (anonymous namespace)::"
                               "topk_batch_kernel<Wide, 0>")

    class Trace:
        executes = 4
        breakdown = {"device_ops": [["topk_batch_kernel", 0.01]]}

    ctx = harness.Context({"name": Q1}, {}, {}, trace=Trace(),
                          request_bound_s=1e-3)
    assert reader.read(ctx) is None
    Trace.breakdown = {"device_ops": [["topk_batch_kernel", 0.01],
                                      ["quant_topk_kernel<Wide>", 0.008]]}
    assert reader.read(ctx) == pytest.approx(50.0)
    assert reader.read(harness.Context({"name": Q1}, {}, {},
                                       trace=Trace())) is None
