"""Run one cell of the port's benchmark once and print its result line.

From the root of a checkout::

    python3 chasebench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

(or ``python3 -m chasebench.run ...``).  The cell, its configuration, its
traffic and its metrics come from ``BENCHMARK.json``; ``harness.py`` says
where each is found.  The last line of standard output is the result's JSON
object; the last lines of standard error give each number the check
compared beside its limit.  The run refuses, with no result, a machine with
fewer cards than the cell asks for, and a process that holds JAX or the JAX
package once the window has closed.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "chasebench" / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold, each
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare() -> None:
    """The process's settings, made before torch loads: fixed cache
    directories inside the checkout, one CPU thread (the host's work on a
    request is small, and a pool of threads only widens the spread on a
    shared host), and the program and the benchmark importable as
    packages (this directory off the path: its ``trace.py`` is not the
    standard library's)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["OMP_NUM_THREADS"] = "1"
    here = str(ROOT / "chasebench")
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def main(argv=None) -> int:
    args = parse(argv)
    prepare()
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    from chasebench import harness
    cell = harness.by_name(bench["workloads"], args.workload)

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"chasebench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    result = harness.run_cell(bench, cell, args.seed, args.seconds,
                              bool(args.trace), device=torch.device("cuda"),
                              started=STARTED)
    found = forbidden_modules()
    if found:
        print(f"chasebench: the process holds {found} after the window",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
