"""Time variants of the batched fp32 range-scan CUDA kernel
(``range_scan_batch``) on one NVIDIA card, each held bit for bit against
the kernel as committed.

    python3 scripts/range_variants.py [--out FILE]

Each variant is the committed ``csrc/range_scan_batch.cu`` with a few lines
of it or of the tile it includes (``csrc/range_tile.cuh``) replaced, built
with the same nvcc flags into ``build/range_variants/<variant>/`` (all
builds started together) and launched through its C entry point with the
committed launch plan, or with the plan of another shape or blocks per SM
where the variant says so.  A variant that does not build is reported with
its compiler's last lines.  Variants:

* ``no_stores``: the epilogue computes every key and hit but stores none
  (timed only): the product, the staging, the mask loads and the barriers;
* ``wide_minb2`` / ``wide_bk8`` / ``wide_bk8_minb2``: the wide shape with
  its registers sized for two blocks per SM (and a plan of two), staging 8
  columns per chunk, or both;
* ``mid_minb1`` / ``narrow_minb1``: the mid or narrow shape with its
  registers sized for one block per SM (and a plan of one);
* ``narrow_bk8``: the narrow shape staging 8 columns per chunk;
* ``narrow16``: a 16-query × 256-row narrow shape (micro-tile 4 × 4) in
  place of the 8 × 512 one.

At N = 1,000,000, D = 512, a per-query mask at selectivity 0.3, each
query's radius at its 120th-best key, inner product: every variant but
``no_stores`` must give the committed kernel's keys (int32 view), hits and
counts bit for bit; then each is timed (CUDA events, median of 10 after 3
warm-ups) in two rounds (variants forward, then reversed) at the buckets
its shape serves: 1 and 8 (the narrow shape), 32 (30 live queries; the mid
one) and 128 (100 live; the wide one).  ``-Xptxas -v``'s registers and
spills are reported per variant.  Prints one JSON line per phase; ``--out``
also writes them.
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

N_ROWS, DIM, RANK = 1_000_000, 512, 120
WIDE = "using Wide = Shape<128, 128, 8, 8, 4, 16, 1>;"
MID = "using Mid = Shape<32, 256, 4, 8, 4, 16, 2>;"
NARROW = "using Narrow = Shape<8, 512, 4, 4, 16, 16, 2>;"
# skip the stores, keeping every key and hit live
NO_STORES = [("        if constexpr (HITS) cnt[j] += __popc(hw);\n",
              "        if constexpr (HITS) cnt[j] += __popc(hw);\n"
              "        if (key[0] == 1234.5f && key[3] == 1.5f)\n"
              "          out_keys[o] = key[1];\n"
              "        continue;\n")]


def shape(old: str, args: str) -> list:
    """Replace the `using` line `old` by the same shape with `args`."""
    return [(old, old.split("<")[0] + "<" + args + ">;")]


# name: (line replacements, the buckets it is timed at, {the plan's
# queries per block: (queries per block this variant takes, rows per tile,
# blocks per SM its plan assumes)})
VARIANTS = {
    "committed": ([], (1, 8, 32, 128), {}),
    "no_stores": (NO_STORES, (1, 8, 32, 128), {}),
    "wide_minb2": (shape(WIDE, "128, 128, 8, 8, 4, 16, 2"), (128,),
                   {128: (128, 128, 2)}),
    "wide_bk8": (shape(WIDE, "128, 128, 8, 8, 4, 8, 1"), (128,), {}),
    "wide_bk8_minb2": (shape(WIDE, "128, 128, 8, 8, 4, 8, 2"), (128,),
                       {128: (128, 128, 2)}),
    "mid_minb1": (shape(MID, "32, 256, 4, 8, 4, 16, 1"), (32,),
                  {32: (32, 256, 1)}),
    "narrow_minb1": (shape(NARROW, "8, 512, 4, 4, 16, 16, 1"), (1, 8),
                     {8: (8, 512, 1)}),
    "narrow_bk8": (shape(NARROW, "8, 512, 4, 4, 16, 8, 2"), (1, 8), {}),
    "narrow16": (shape(NARROW, "16, 256, 4, 4, 8, 16, 2"), (1, 8),
                 {8: (16, 256, 2)}),
}
TIMED_ONLY = ("no_stores",)
LIVE = {1: 1, 8: 8, 32: 30, 128: 100}    # live queries per bucket


def build_variants(source: str, variants: dict, out_dir: Path, build,
                   entry: str, argtypes: list) -> tuple[dict, dict]:
    """Write each variant of ``csrc/<source>`` (its replacements applied
    to the source or to the headers it includes, wherever the old text
    stands once) with the headers into ``out_dir/<variant>/``, build them
    all at once, and load them.  Returns ({variant: C launcher},
    {variant: build report})."""
    files = {name: (build.CSRC / name).read_text()
             for name in (source,) + build.HEADERS}
    procs = {}
    for name, (subs, *_) in variants.items():
        texts = dict(files)
        for old, new in subs:
            where = [f for f, t in texts.items() if t.count(old) == 1]
            if len(where) != 1 or sum(t.count(old)
                                      for t in texts.values()) != 1:
                raise RuntimeError(f"{name}: `{old[:40]}` not found once")
            texts[where[0]] = texts[where[0]].replace(old, new)
        vdir = out_dir / name
        vdir.mkdir(parents=True, exist_ok=True)
        for f, t in texts.items():
            (vdir / f).write_text(t)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.FLAGS, "-o", str(vdir / "kernel.so"),
             str(vdir / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    launchers, report = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            report[name] = {"built": False, "log": log.splitlines()[-5:]}
            continue
        fn = getattr(ctypes.CDLL(str(out_dir / name / "kernel.so")), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        launchers[name] = fn
        report[name] = {"built": True, "ptxas": sorted({
            ln.split("info    :")[-1].strip() for ln in log.splitlines()
            if "registers" in ln or ("spill stores" in ln
                                     and " 0 bytes spill stores" not in ln)})}
    return launchers, report


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
        sys.exit("range_variants: no CUDA device; this script runs on the "
                 "card")
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core.schema import Metric
    from repro_torch.kernels import build
    from repro_torch.kernels import range_scan as rs_mod
    from repro_torch.kernels.build import METRIC_CODES
    from repro_torch.kernels.scan_topk import wave_splits

    lines = []

    def emit(obj) -> None:
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    launchers, report = build_variants(
        "range_scan_batch.cu", VARIANTS, ROOT / "build" / "range_variants",
        build, "range_scan_batch_launch",
        [P] * 4 + [I] + [P] * 4 + [I] * 9 + [P])
    emit({"phase": "build", "nvidia_smi": smi, "report": report})

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    corpus = torch.randn((N_ROWS, DIM), generator=gen, device=dev)
    corpus /= corpus.norm(dim=-1, keepdim=True)
    metric = Metric.INNER_PRODUCT

    def call(name, qs, rk, mask, valid):
        qn = qs.shape[0]
        qt, splits, rows = rs_mod.batch_plan(N_ROWS, qn)
        if qt in VARIANTS[name][2]:
            qt, tile, per_sm = VARIANTS[name][2][qt]
            splits, rows = wave_splits(N_ROWS, qn, qt, tile, per_sm)
        keys = torch.empty((qn, N_ROWS), dtype=torch.float32, device=dev)
        hits = torch.empty((qn, N_ROWS), dtype=torch.int8, device=dev)
        counts = torch.zeros(qn, dtype=torch.int32, device=dev)
        err = launchers[name](
            corpus.data_ptr(), qs.data_ptr(), rk.data_ptr(), mask.data_ptr(),
            2, valid.data_ptr(), keys.data_ptr(), hits.data_ptr(),
            counts.data_ptr(), N_ROWS, DIM, qn, METRIC_CODES[metric], qt,
            rows, splits, 1, 1, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed, cudaError {err}")
        return keys, hits, counts

    for bucket, live in LIVE.items():
        names = [n for n in launchers if bucket in VARIANTS[n][1]]
        qs = torch.randn((bucket, DIM), generator=gen, device=dev)
        qs /= qs.norm(dim=-1, keepdim=True)
        rk = torch.topk(qs @ corpus.T, RANK, dim=1).values[:, -1].neg()
        rk = rk.contiguous()
        mask = (torch.rand((bucket, N_ROWS), generator=gen, device=dev)
                < 0.3).to(torch.int8)
        valid = (torch.arange(bucket, device=dev) < live).to(torch.int8)
        a = (qs, rk, mask, valid)
        want = call("committed", *a)
        for name in names:
            if name in TIMED_ONLY:
                continue
            got = call(name, *a)
            if not (torch.equal(got[0].view(torch.int32),
                                want[0].view(torch.int32))
                    and torch.equal(got[1], want[1])
                    and torch.equal(got[2], want[2])):
                raise AssertionError(f"{name} bucket {bucket}: not the "
                                     "committed output")
        ms = {name: [] for name in names}
        for name in names + names[::-1]:
            ms[name].append(time_ms(lambda: call(name, *a)))
        emit({"phase": "times", "nvidia_smi": smi, "bucket": bucket,
              "live": live, "n": N_ROWS, "d": DIM,
              "plan": list(rs_mod.batch_plan(N_ROWS, bucket)), "ms": ms})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
