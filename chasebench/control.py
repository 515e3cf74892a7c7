"""The control of a cell's check: the reference, at TF32, put in the
program's place, run at the cell's own size and load on several seeds in
one process.  Each seed's check has to come out not correct; the numbers
it reads are the upper readings the limits are set below.

From the root of a checkout, on the card::

    python3 chasebench/control.py --workload <name> --seeds 1 2 3 \\
        --seconds 3

prints one JSON line a seed and exits 1 if any seed's check passed.
"""
import argparse
import json
import sys
import time

import run  # this directory is the script's first path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    run.prepare()
    import torch

    from chasebench import harness
    if not torch.cuda.is_available():
        print("chasebench control: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.by_name(bench["workloads"], args.workload)
    passed = 0
    for seed in args.seeds:
        result = harness.run_cell(bench, cell, seed, args.seconds, False,
                                  device=torch.device("cuda"),
                                  started=time.perf_counter(), control=True)
        passed += result["correct"]
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "control_correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
