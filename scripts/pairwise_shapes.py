"""Time block-shape variants of the ``pairwise_keys`` CUDA kernel on one
NVIDIA card, each held bit for bit against the kernel as committed.

    python3 scripts/pairwise_shapes.py [--out FILE]

Each variant is the committed ``csrc/pairwise_keys.cu`` with one ``Shape``
line replaced (the wide shape, which serves Q > 16, or the narrow one,
which serves Q <= 16), built with the same nvcc flags into
``build/pairwise_shapes/`` (all builds started together) and launched
through its C entry point with the committed launch plan.  A variant that
does not build is reported with its compiler's last lines.  At
N = 1,000,000, D = 512, every variant's keys must equal the committed
kernel's for every metric; then the narrow variants are timed at Q = 1 and
8 and the wide ones at Q = 100 (CUDA events, median of 10 after 3
warm-ups), inner product in two rounds (variants forward, then reversed)
and cosine once.  ``-Xptxas -v``'s registers and spills are reported per
variant.  Prints one JSON line per phase; ``--out`` also writes them.
"""
import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N_ROWS, DIM = 1_000_000, 512
# name: (the Shape alias replaced, its template arguments: queries, rows,
# queries and rows per thread, lanes along rows, chunk depth, blocks/SM)
VARIANTS = {
    "wide": ("Wide", None),
    "wide_bk16": ("Wide", "128, 128, 8, 8, 4, 16, 2"),
    "wide_lr8": ("Wide", "128, 128, 8, 8, 8, 8, 2"),
    "wide_minb1": ("Wide", "128, 128, 8, 8, 4, 8, 1"),
    "narrow": ("Narrow", None),
    "narrow_bk8_minb4": ("Narrow", "16, 256, 4, 4, 8, 8, 4"),
    "narrow_minb2": ("Narrow", "16, 256, 4, 4, 8, 16, 2"),
}
TIMED = {"Narrow": (1, 8), "Wide": (100,)}


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
        sys.exit("pairwise_shapes: no CUDA device; this script runs on the "
                 "card")
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core.schema import Metric
    from repro_torch.kernels import build
    from repro_torch.kernels import distance as dist_mod
    from repro_torch.kernels.build import METRIC_CODES

    lines = []

    def emit(obj) -> None:
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out_dir = ROOT / "build" / "pairwise_shapes"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in build.HEADERS:
        (out_dir / header).write_text((build.CSRC / header).read_text())
    source = (build.CSRC / "pairwise_keys.cu").read_text()
    procs = {}
    for name, (alias, shape) in VARIANTS.items():
        text = source
        if shape is not None:
            text, hits = re.subn(rf"using {alias} = Shape<[^>]*>;",
                                 f"using {alias} = Shape<{shape}>;", text)
            if hits != 1:
                raise RuntimeError(f"{name}: no `using {alias}` line")
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
        fn = lib.pairwise_keys_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launchers[name] = fn
        report[name] = {"built": True, "ptxas": sorted({
            ln.split("info    :")[-1].strip() for ln in log.splitlines()
            if "registers" in ln or ("spill stores" in ln
                                     and " 0 bytes spill stores" not in ln)})}
    emit({"phase": "build", "nvidia_smi": smi, "variants": VARIANTS,
          "report": report})

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    corpus = torch.randn((N_ROWS, DIM), generator=gen, device=dev)

    def call(fn, qs, metric):
        qn = qs.shape[0]
        out = torch.empty((qn, N_ROWS), dtype=torch.float32, device=dev)
        qt, rt, row_blocks, query_blocks = dist_mod.pairwise_plan(N_ROWS, qn)
        qq = torch.empty(query_blocks * qt, dtype=torch.float32, device=dev)
        err = fn(corpus.data_ptr(), qs.data_ptr(), qq.data_ptr(),
                 out.data_ptr(), N_ROWS, DIM, qn, METRIC_CODES[metric], qt,
                 rt, row_blocks, query_blocks, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out

    for alias, qns in TIMED.items():
        names = [n for n in launchers if VARIANTS[n][0] == alias]
        for qn in qns:
            qs = torch.randn((qn, DIM), generator=gen, device=dev)
            for metric in Metric:
                want = dist_mod.pairwise_keys(qs, corpus, metric)
                for name in names:
                    got = call(launchers[name], qs, metric)
                    if not torch.equal(got.view(torch.int32),
                                       want.view(torch.int32)):
                        raise AssertionError(f"{name} q={qn} {metric.value}:"
                                             " not the committed keys")
            ip = {name: [] for name in names}
            for name in names + names[::-1]:
                ip[name].append(time_ms(lambda: call(
                    launchers[name], qs, Metric.INNER_PRODUCT)))
            cosine = {name: time_ms(lambda: call(launchers[name], qs,
                                                 Metric.COSINE))
                      for name in names}
            emit({"phase": "times", "nvidia_smi": smi, "shape": alias,
                  "q": qn, "n": N_ROWS, "d": DIM, "ip_ms": ip,
                  "cosine_ms": cosine})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
