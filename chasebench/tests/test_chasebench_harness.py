"""The harness finds every piece by name, prints the contract's line, and
loads neither JAX nor the JAX package."""
import json
import re
import subprocess
import sys

import pytest

from chasebench import harness
from conftest import IVF, ROOT, SINGLE, run_small, with_kept

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_piece_is_found_by_name(bench):
    bench = with_kept(bench)
    for cell in bench["workloads"] + [SINGLE, IVF]:
        entry = harness.by_name(bench["configs"], cell["config"])
        config = harness.load_json(ROOT / entry["file"])
        assert config["name"] == cell["config"]
        mix = harness.load_json(harness.HERE / "traffic"
                                / f"{cell['traffic']}.json")
        system = harness.load_module(harness.HERE / "systems"
                                     / f"{config['system']}.py")
        reference = harness.load_module(harness.HERE / "references"
                                        / f"{config['reference']}.py")
        loop = harness.load_module(harness.HERE / "loops"
                                   / f"{mix['loop']}.py")
        assert callable(system.make_data) and callable(system.Program)
        assert callable(reference.judge) and callable(reference.Control)
        assert callable(loop.run)
    for metric in bench["end_to_end"] + bench["per_layer"]:
        reader = harness.load_module(harness.HERE / "metrics"
                                     / f"{metric['name']}.py")
        assert callable(reader.read)


def test_benchmark_json_keeps_the_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    configs = {c["name"] for c in bench["configs"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (ROOT / "chasebench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    for m in bench["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_a_new_metric_is_one_new_file(bench, tmp_path, monkeypatch):
    """A reader dropped into metrics/ is found by its name alone."""
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "requests.count.py").write_text(
        "def read(ctx):\n    return ctx.window.requests\n")
    monkeypatch.setattr(harness, "HERE", tmp_path)
    reader = harness.load_module(metrics / "requests.count.py")
    assert reader.read(harness.Context({}, {}, {}, window=harness.Window(
        [0.1], 3, 0, 300, 0.3))) == 3


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(bench, trace):
    result = run_small(bench, "laion1m-flat-q1-b100", trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(result) == keys + ["cold_build_s", "checks"]
    assert result["cold_build_s"] == 0.0   # nothing compiles on the CPU
    assert result["correct"] is True
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    want = {m["name"] for m in bench["per_layer" if trace else "end_to_end"]
            if harness.applies(m, {"name": "laion1m-flat-q1-b100"})}
    assert set(result["metrics"]) <= want
    if not trace:
        assert set(result["metrics"]) == want
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(result)


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chasebench" / "run.py"), "--workload",
         "laion1m-flat-q1-b100", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Drive a whole small run in a fresh process, then list every
    top-level module name it holds, each compared whole."""
    code = (
        "import json, sys, time, torch\n"
        "sys.path[:0] = [sys.argv[1] + '/src', sys.argv[1],"
        " sys.argv[1] + '/chasebench/tests']\n"
        "import conftest\n"
        "from chasebench import run\n"
        "bench = json.load(open(sys.argv[1] + '/BENCHMARK.json'))\n"
        "for w in bench['workloads'] + [conftest.IVF]:\n"
        "    conftest.run_small(bench, w, seconds=0.1)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded, flagged = (json.loads(x) for x in
                       proc.stdout.strip().splitlines()[-2:])
    assert "repro_torch" in loaded and "torch" in loaded
    assert not {"jax", "jaxlib", "flax", "repro"} & set(loaded)
    assert flagged == []


def test_forbidden_names_compare_whole(monkeypatch):
    from chasebench import run
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert run.forbidden_modules() == ["repro"]
