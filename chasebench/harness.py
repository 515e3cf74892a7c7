"""One run of one cell of ``BENCHMARK.json``, driven by data.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name the cell or the metric gives:

* ``BENCHMARK.json``'s ``configs[].file``: the configuration (JSON),
  which names its ``system`` (``systems/<system>.py``: ``make_data``,
  ``Program`` and, where the system compiles kernels, ``build_seconds``)
  and its ``reference`` (``references/<reference>.py``: ``judge``,
  ``limits`` and ``Control``);
* ``traffic/<traffic>.json``: the mix, read by ``generator.Traffic``; its
  ``loop`` names the loop that drives the window (``loops/<loop>.py``);
* ``metrics/<metric>.py``: the reader of one metric, end-to-end or per
  layer: ``read(ctx)`` returns its value or None, and an optional
  ``before_window(ctx)`` takes what it needs before the window opens.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

from chasebench import generator, roofline
from chasebench import trace as trace_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The module in ``path``, loaded by its file (names hold dots and
    dashes)."""
    parts = path.relative_to(HERE).with_suffix("").parts
    name = "chasebench._" + re.sub(r"[^A-Za-z0-9_]", "_", "_".join(parts))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def by_name(items: list, name: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no entry named {name!r}")


def applies(metric: dict, cell: dict) -> bool:
    return "workloads" not in metric or cell["name"] in metric["workloads"]


def deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = deep_merge(out[key], value)
        else:
            out[key] = value
    return out


@dataclasses.dataclass
class Window:
    """What the window's loop measured."""
    latencies_s: list       # every request's seconds, in order
    requests: int
    failed: int
    queries: int            # queries answered
    seconds: float          # first request's start to last request's end
    raw_trace: object = None


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""
    cell: dict
    config: dict
    mix: dict
    setup_s: float = 0.0
    window: Window | None = None
    numbers: dict = dataclasses.field(default_factory=dict)
    trace: trace_mod.Digest | None = None
    request_bound_s: float | None = None
    counters: dict = dataclasses.field(default_factory=dict)


class Sampler:
    """A seeded reservoir of the window's answers: each request is kept
    with the same chance, its answer cloned when kept."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([int(seed), 3])
        self.seen = 0
        self.items = []

    def offer(self, rows, answer) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            slot = len(self.items)
            self.items.append(None)
        else:
            slot = int(self.rng.integers(self.seen))
            if slot >= self.size:
                return
        data = getattr(answer, "data", answer)
        self.items[slot] = (rows, {k: v.clone() for k, v in data.items()
                                   if isinstance(v, torch.Tensor)})


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, *, device: torch.device, started: float,
             overrides: dict | None = None, mix_overrides: dict | None = None,
             control: bool = False, log=None) -> dict:
    """Set up, measure and check one run of ``cell``; returns the result
    line's object: the contract's keys, then ``cold_build_s`` (the part
    of ``setup_s`` spent compiling kernels, 0 in a warm checkout) and, last,
    ``checks``.  ``started`` is the process's start on the host clock;
    ``control`` puts the reference at TF32 in the program's place;
    ``overrides`` and ``mix_overrides`` change the configuration and the
    traffic (tests shrink the scale)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    entry = by_name(bench["configs"], cell["config"])
    config = load_json(ROOT / entry["file"])
    if overrides:
        config = deep_merge(config, overrides)
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    if mix_overrides:
        mix = deep_merge(mix, mix_overrides)
    system = load_module(HERE / "systems" / f"{config['system']}.py")
    reference = load_module(HERE / "references" / f"{config['reference']}.py")
    loop = load_module(HERE / "loops" / f"{mix['loop']}.py")
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if applies(m, cell)]
    readers = {m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py")
               for m in metrics}

    t0 = time.perf_counter()
    data = system.make_data(config, seed, device)
    traffic = generator.Traffic(mix, config, data, seed)
    synchronize(device)
    log(f"data {time.perf_counter() - t0:.3f} s: {data.corpus.shape[0]} "
        f"rows, {traffic.n_passing} pass the filter, binds "
        f"{ {k: float(v) for k, v in traffic.scalars.items()} }")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    program = system.Program(config, data, seed)
    if control:
        target = reference.Control(traffic, data)
    else:
        target = program.db.prepare(mix["sql"], **traffic.static)
    for i in range(mix["warmup"]):
        target.execute(traffic.request(i)[0])
    synchronize(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    ctx = Context(cell, config, mix, request_bound_s=roofline.request_bound_s(
        traffic, data, kind))
    for reader in readers.values():
        if hasattr(reader, "before_window"):
            reader.before_window(ctx)
    ctx.setup_s = time.perf_counter() - started
    # the kernels' cold build, recorded apart: only a checkout's first run
    # compiles, and the check leaves that run's set-up out
    build_s = system.build_seconds() if hasattr(system, "build_seconds") \
        else 0.0
    log(f"setup {ctx.setup_s:.3f} s, of it {build_s:.3f} s compiling "
        f"({program.setup})")

    sampler = Sampler(traffic.check_requests(), seed)
    window = loop.run(target, traffic, mix["warmup"], seconds, trace,
                      sampler, lambda: synchronize(device), log)
    ctx.window = window
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del target, program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t1 = time.perf_counter()
    ctx.numbers = reference.judge(sampler.items, traffic, data, config)
    checks = reference.limits(config, ctx.numbers)
    log(f"check {time.perf_counter() - t1:.3f} s over "
        f"{ctx.numbers['queries']} queries")
    if trace:
        t2 = time.perf_counter()
        ctx.trace = trace_mod.digest(window.raw_trace)
        window.raw_trace = None
        log(f"trace {time.perf_counter() - t2:.3f} s")

    out = {}
    for m in metrics:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": kind, "count": cell["chips"],
                   "memory_peak_bytes": int(peak)}
    result = {"correct": window.failed == 0 and window.requests > 0
              and all(ok for _, ok in checks.values()),
              "attempted": window.requests, "failed": window.failed,
              "metrics": out, "device": device_info}
    if trace and ctx.trace is not None:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown
    result["cold_build_s"] = build_s
    result["checks"] = {name: {"value": ctx.numbers[name], "limit": limit}
                        for name, (limit, _) in checks.items()}
    return result
