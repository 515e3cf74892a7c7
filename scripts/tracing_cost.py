"""What the port's spans (``repro_torch.tracing``) cost.

    python3 scripts/tracing_cost.py --micro
    python3 scripts/tracing_cost.py --card [--pairs 4] [--seconds 10]

``--micro`` (the host): nanoseconds of one disabled span and of the
counter calls the execute path makes, and how many of each one flat Q1
list and one flat Q2 list of the benchmark's cells make (counted at a
small size on the CPU), so the disabled cost of a request is their
product; where a card is present, also the nanoseconds of one enabled span
without and with device markers, with the profiler off and on.

``--card`` (one NVIDIA card): each of the benchmark's flat cells run
untraced (no profiler) through ``chasebench``'s harness, in pairs of
windows with the spans disabled and enabled, the order alternating from
pair to pair, both sides of a pair on one seed; prints each window's
``qps`` and ``latency_p95_ms`` and, per cell, the medians and the
enabled-over-disabled ratio of each.

One JSON line per reading on standard output.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _path in (ROOT / "src", ROOT):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

CELLS = ("laion1m-flat-q1-b100", "laion1m-flat-q2-b100")


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def _bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def micro(n: int = 1_000_000) -> None:
    import numpy as np
    import torch

    from repro_torch import tracing
    tracing.disable()
    cpu = torch.device("cpu")
    value = np.zeros(4, np.float32)
    g = {"tracing": tracing, "cpu": cpu, "value": value}
    costs = {
        "span": timeit.timeit("with tracing.span('repro_torch.x'): pass",
                              globals=g, number=n) / n * 1e9,
        "span_device": timeit.timeit(
            "with tracing.span('repro_torch.x', cpu): pass", globals=g,
            number=n) / n * 1e9,
        "count_upload": timeit.timeit("tracing.count_upload(value, cpu)",
                                      globals=g, number=n) / n * 1e9,
        "count": timeit.timeit("tracing.count('syncs')", globals=g,
                               number=n) / n * 1e9,
    }
    emit(phase="micro", ns=costs, torch=torch.__version__)
    if torch.cuda.is_available():
        enabled_costs(n // 20)

    from chasebench import harness
    bench = _bench()
    for name in CELLS:
        cell = harness.by_name(bench["workloads"], name)
        config = harness.load_json(
            ROOT / harness.by_name(bench["configs"], cell["config"])["file"])
        config = harness.deep_merge(config, {"data": {"rows": 20000,
                                                      "modes": 16}})
        mix = harness.load_json(harness.HERE / "traffic"
                                / f"{cell['traffic']}.json")
        system = harness.load_module(harness.HERE / "systems"
                                     / f"{config['system']}.py")
        data = system.make_data(config, 7, cpu)
        traffic = harness.generator.Traffic(mix, config, data, 7)
        statement = system.Program(config, data, 7).db.prepare(
            mix["sql"], **traffic.static)
        binds = traffic.request(0)[0]
        statement.execute(binds)
        calls = {"count_upload": 0, "count": 0}
        real = {k: getattr(tracing, k) for k in calls}

        def counting(kind):
            def fn(*args):
                calls[kind] += 1
                return real[kind](*args)
            return fn

        tracing.reset()
        tracing.enable()
        for kind in calls:
            setattr(tracing, kind, counting(kind))
        try:
            statement.execute(binds)
        finally:
            for kind, fn in real.items():
                setattr(tracing, kind, fn)
            tracing.disable()
        spans = sum(r["calls"] for r in tracing.snapshot()["spans"].values())
        per_request_ns = (spans * costs["span"]
                          + calls["count_upload"] * costs["count_upload"]
                          + calls["count"] * costs["count"])
        emit(phase="per_request", cell=name, spans=spans, **calls,
             disabled_ns=per_request_ns)


def enabled_costs(n: int) -> None:
    """Nanoseconds of one enabled span on the host, alone and with device
    markers on the card's stream, without and under the profiler."""
    import torch

    from chasebench import trace as trace_mod
    from repro_torch import tracing
    cuda = torch.device("cuda")
    g = {"tracing": tracing, "cuda": cuda}
    stmts = {"span": "with tracing.span('repro_torch.x'): pass",
             "span_device":
                 "with tracing.span('repro_torch.y', cuda): pass"}
    tracing.enable()
    try:
        for profiled in (False, True):
            prof = trace_mod.profiler() if profiled else None
            if prof is not None:
                prof.start()
            ns = {}
            for key, stmt in stmts.items():
                torch.cuda.synchronize()
                ns[key] = timeit.timeit(stmt, globals=g, number=n) / n * 1e9
            tracing.snapshot()
            if prof is not None:
                prof.stop()
            emit(phase="enabled", profiler=profiled, ns=ns,
                 name=torch.cuda.get_device_name(cuda))
    finally:
        tracing.disable()
        tracing.reset()


def card(pairs: int, seconds: float) -> None:
    import torch

    from chasebench import harness
    from repro_torch import tracing
    device = torch.device("cuda")
    bench = _bench()
    emit(phase="card", name=torch.cuda.get_device_name(device),
         torch=torch.__version__)
    for name in CELLS:
        cell = harness.by_name(bench["workloads"], name)
        runs = {False: [], True: []}
        for pair in range(pairs):
            seed = 2**31 + 7_000 + 17 * pair
            order = (False, True) if pair % 2 == 0 else (True, False)
            for spans_on in order:
                (tracing.enable if spans_on else tracing.disable)()
                result = harness.run_cell(
                    bench, cell, seed, seconds, False, device=device,
                    started=time.perf_counter(), log=lambda msg: None)
                tracing.disable()
                m = {k: v["value"] for k, v in result["metrics"].items()}
                runs[spans_on].append(m)
                emit(phase="window", cell=name, pair=pair, seed=seed,
                     spans=spans_on, correct=result["correct"],
                     qps=m["qps"], latency_p95_ms=m["latency_p95_ms"])
        summary = {}
        for metric in ("qps", "latency_p95_ms"):
            off = statistics.median(r[metric] for r in runs[False])
            on = statistics.median(r[metric] for r in runs[True])
            summary[metric] = {"off": off, "on": on, "on_over_off": on / off}
        emit(phase="cell", cell=name, pairs=pairs, **summary)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--micro", action="store_true")
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    if args.micro:
        micro()
    if args.card:
        card(args.pairs, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
