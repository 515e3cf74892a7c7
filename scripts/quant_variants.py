"""Time variants of the quantized top-k CUDA kernel
(``quant_scan_topk_batch``) on one NVIDIA card, each held bit for bit
against the kernel as committed.

    python3 scripts/quant_variants.py [--out FILE]

Each variant is the committed ``csrc/quant_scan_topk_batch.cu`` with a few
lines replaced, built with the same nvcc flags into
``build/quant_variants/`` (all builds started together) and launched
through its C entry point with the committed launch plan (a variant whose
shape takes another number of queries per block is launched with that
number; rows per split and segments per split stay the plan's, so the
output layout is the same).  A variant that does not build is reported
with its compiler's last lines.  Variants:

* ``no_selection``: the candidate passes skipped, so no list is ever
  written (its output is empty; timed only): what the product, the
  staging and the barriers cost without the selection;
* ``wide_as_mid``: the 32-query mid shape (two blocks per SM) in place of
  the 64-query wide one;
* ``narrow_16x256``: pairwise_keys' 16-query × 256-row narrow shape in
  place of the 8 × 512 one;
* ``narrow_minb1`` / ``narrow_minb3``: the narrow shape with its
  registers sized for one or three blocks per SM.

At N = 1,000,000, D = 512, a per-query mask at selectivity 0.3, count
100 (Q1's c·K), inner product, int8 and bf16: every variant but
``no_selection`` must give the committed kernel's keys and ids; then each
is timed (CUDA events, median of 10 after 3 warm-ups) in two rounds
(variants forward, then reversed) at the buckets its shape serves: 1 and
8 for the narrow variants, 32 and 128 (30 and 100 live queries) for the
others.  ``-Xptxas -v``'s registers and spills are reported per variant.
Prints one JSON line per phase; ``--out`` also writes them.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N_ROWS, DIM, COUNT = 1_000_000, 512, 100
WIDE = "using Wide = Shape<64, 256, 8, 8, 4, 16, 1>;"
NARROW = "using Narrow = Shape<8, 512, 4, 4, 16, 16, 2>;"
NO_SELECTION = [
    ("    bool over = false;\n    if (__any_sync(kFull, mine)) {",
     "    bool over = false;\n    mine = false;\n"
     "    if (__any_sync(kFull, mine)) {"),
    ("    if (__any_sync(kFull, mine)) {\n      const int gl",
     "    mine = false;\n    if (__any_sync(kFull, mine)) {\n"
     "      const int gl")]
# name: (line replacements, queries per block it takes in place of the
# plan's, the buckets it is timed at)
VARIANTS = {
    "committed": ([], {}, (1, 8, 32, 128)),
    "no_selection": (NO_SELECTION, {}, (1, 8, 32, 128)),
    "wide_as_mid": ([(WIDE, "using Wide = Shape<32, 256, 4, 8, 4, 16, 2>;")],
                    {64: 32}, (128,)),
    "narrow_16x256": ([(NARROW,
                        "using Narrow = Shape<16, 256, 4, 4, 8, 16, 2>;")],
                      {8: 16}, (1, 8)),
    "narrow_minb1": ([(NARROW,
                       "using Narrow = Shape<8, 512, 4, 4, 16, 16, 1>;")],
                     {}, (1, 8)),
    "narrow_minb3": ([(NARROW,
                       "using Narrow = Shape<8, 512, 4, 4, 16, 16, 3>;")],
                     {}, (1, 8)),
}
LIVE = {1: 1, 8: 8, 32: 30, 128: 100}    # live queries per bucket


def time_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("quant_variants: no CUDA device; this script runs on the "
                 "card")

    from repro_torch.core.schema import Metric
    from repro_torch.data.quantized import quantize_corpus
    from repro_torch.kernels import build
    from repro_torch.kernels import quant as qt_mod
    from repro_torch.kernels.build import METRIC_CODES

    lines = []

    def emit(obj) -> None:
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out_dir = ROOT / "build" / "quant_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in build.HEADERS:
        (out_dir / header).write_text((build.CSRC / header).read_text())
    source = (build.CSRC / "quant_scan_topk_batch.cu").read_text()
    procs = {}
    for name, (subs, _, _) in VARIANTS.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: `{old[:40]}` not found once")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    launchers, report = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            report[name] = {"built": False, "log": log.splitlines()[-5:]}
            continue
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        fn = lib.quant_scan_topk_batch_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, P, P, I] + [P] * 3 + [I] * 9 + [P]
        fn.restype = ctypes.c_int
        launchers[name] = fn
        report[name] = {"built": True, "ptxas": sorted({
            ln.split("info    :")[-1].strip() for ln in log.splitlines()
            if "registers" in ln or ("spill stores" in ln
                                     and " 0 bytes spill stores" not in ln)})}
    emit({"phase": "build", "nvidia_smi": smi, "report": report})

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    corpus = torch.randn((N_ROWS, DIM), generator=gen, device=dev)
    corpus /= corpus.norm(dim=-1, keepdim=True)
    twins = {mode: quantize_corpus(corpus, mode) for mode in ("int8", "bf16")}
    del corpus
    metric = Metric.INNER_PRODUCT

    def call(name, qc, qs, mask, valid):
        qn = qs.shape[0]
        qt, splits, rows, s = qt_mod.quant_plan(N_ROWS, qn, COUNT)
        qt = VARIANTS[name][1].get(qt, qt)
        keys = torch.empty((qn, splits * s), dtype=torch.float32,
                           device=dev)
        ids = torch.empty((qn, splits * s), dtype=torch.int32, device=dev)
        err = launchers[name](
            qc.qvecs.data_ptr(), qc.scales.data_ptr(),
            qt_mod.MODE_CODES[qc.qvecs.dtype], qs.data_ptr(),
            mask.data_ptr(), 2, valid.data_ptr(), keys.data_ptr(),
            ids.data_ptr(), N_ROWS, DIM, qn, s, METRIC_CODES[metric], qt,
            rows, splits, 1, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed, cudaError {err}")
        return keys, ids

    for bucket, live in LIVE.items():
        names = [n for n in launchers if bucket in VARIANTS[n][2]]
        qs = torch.randn((bucket, DIM), generator=gen, device=dev)
        qs /= qs.norm(dim=-1, keepdim=True)
        mask = (torch.rand((bucket, N_ROWS), generator=gen, device=dev)
                < 0.3).to(torch.int8)
        valid = (torch.arange(bucket, device=dev) < live).to(torch.int8)
        for mode, qc in twins.items():
            want = call("committed", qc, qs, mask, valid)
            for name in names:
                if name == "no_selection":
                    continue
                got = call(name, qc, qs, mask, valid)
                if not (torch.equal(got[0].view(torch.int32),
                                    want[0].view(torch.int32))
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"{name} bucket {bucket} {mode}: "
                                         "not the committed segments")
            ms = {name: [] for name in names}
            for name in names + names[::-1]:
                ms[name].append(time_ms(lambda: call(name, qc, qs, mask,
                                                     valid)))
            emit({"phase": "times", "nvidia_smi": smi, "mode": mode,
                  "bucket": bucket, "live": live, "n": N_ROWS, "d": DIM,
                  "count": COUNT, "plan": list(qt_mod.quant_plan(
                      N_ROWS, bucket, COUNT)), "ms": ms})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
