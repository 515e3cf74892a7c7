"""Time variants of the quantized key CUDA kernel (``quant_keys_batch``) on
one NVIDIA card, each held bit for bit against the kernel as committed.

    python3 scripts/keys_variants.py [--out FILE]

Each variant is the committed ``csrc/quant_keys_batch.cu`` with a few lines
of the tile it includes (``csrc/range_tile.cuh``) replaced, built as
``scripts/range_variants.py`` builds its variants (into
``build/keys_variants/<variant>/``) and launched through its C entry point
with the committed launch plan, or with the plan of another shape or
blocks per SM where the variant says so.  Variants:

* ``no_stores``: the epilogue computes every key but stores none (timed
  only);
* ``no_dequant``: int8 bytes staged by a shift, not widened and scaled
  (timed only): what the dequantization costs;
* ``int8_units8``: int8 rows staged in 8-byte units (8 columns), so that
  every thread of the wide shape loads one row unit per chunk (the
  committed 16-byte units leave half its threads without one);
* ``narrow_minb1``: the narrow shape with its registers sized for one
  block per SM (and a plan of one);
* ``narrow_lr32`` / ``narrow_lr32_skip``: the narrow shape with a warp of
  32 rows and one query group, so that at Q <= 4 the warps of queries 4..7
  are whole warps; with ``_skip`` they load no fragments and run no FMAs
  where their queries lie past Q;
* ``narrow4``: a 4-query × 1,024-row narrow shape (micro-tile 4 × 4, one
  block per SM) in place of the 8 × 512 one.

At N = 1,000,000, D = 512, a per-query mask at selectivity 0.3, inner
product, int8 and bf16: every variant but the timed-only ones must give
the committed kernel's keys (int32 view) bit for bit; then each is timed
(CUDA events, median of 10 after 3 warm-ups) in two rounds (variants
forward, then reversed) at the buckets its change touches: 1 and 8 (the
narrow shape), 32 (30 live queries; the mid one) and 128 (100 live; the
wide one).  ``-Xptxas -v``'s registers and spills are reported per
variant.  Prints one JSON line per phase; ``--out`` also writes them.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from range_variants import NARROW, NO_STORES, build_variants, shape, time_ms

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N_ROWS, DIM = 1_000_000, 512
MODES = ("int8", "bf16")
NO_DEQUANT = [("    dequant<int8_t>(u, s, v);\n",
               "#pragma unroll\n"
               "    for (int e = 0; e < UC; ++e)\n"
               "      v[e] = __uint_as_float((&u.x)[e / 4] << (e % 4));\n")]
UNITS8 = [
    ("  static constexpr int UC = 16;\n", "  static constexpr int UC = 8;\n"),
    ("  const float* scales;\n"
     "  __device__ __forceinline__ uint4 unit(int row, int c, int d,\n"
     "                                        int vec) const {\n"
     "    return load_unit(q + static_cast<size_t>(row) * d + c, d - c, vec);\n",
     "  const float* scales;\n"
     "  __device__ __forceinline__ uint4 unit(int row, int c, int d,\n"
     "                                        int vec) const {\n"
     "    const int8_t* p = q + static_cast<size_t>(row) * d + c;\n"
     "    if (!vec) return load_unit(p, min(d - c, UC), 0);\n"
     "    uint2 v;\n"
     "    asm(\"ld.global.nc.L2::128B.v2.u32 {%0, %1}, [%2];\"\n"
     "        : \"=r\"(v.x), \"=r\"(v.y) : \"l\"(p));\n"
     "    return make_uint4(v.x, v.y, 0u, 0u);\n"),
    ("    dequant<int8_t>(u, s, v);\n",
     "    float w16[16];\n"
     "    dequant<int8_t>(u, s, w16);\n"
     "#pragma unroll\n"
     "    for (int e = 0; e < UC; ++e) v[e] = w16[e];\n"),
]
LR32 = shape(NARROW, "8, 512, 4, 4, 32, 16, 2")
SKIP = [("        fragment<RM, BR>(a_s + kk * BR, tr, a, swz(kk));\n"
         "        fragment<QJ, BQ * QJ / QM>(b_s + kk * BQ, tq, b);\n",
         "        const bool busy = q0 + tq * 4 < qn;\n"
         "        if (busy) {\n"
         "          fragment<RM, BR>(a_s + kk * BR, tr, a, swz(kk));\n"
         "          fragment<QJ, BQ * QJ / QM>(b_s + kk * BQ, tq, b);\n"
         "        }\n"),
        ("            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);\n",
         "            if (busy) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);\n")]

# name: (line replacements, the buckets it is timed at, {the plan's
# queries per block: (queries per block this variant takes, rows per tile,
# blocks per SM its plan assumes)}, the modes it is timed in)
VARIANTS = {
    "committed": ([], (1, 8, 32, 128), {}, MODES),
    "no_stores": (NO_STORES, (1, 8, 32, 128), {}, MODES),
    "no_dequant": (NO_DEQUANT, (1, 8, 128), {}, ("int8",)),
    "int8_units8": (UNITS8, (1, 8, 32, 128), {}, ("int8",)),
    "narrow_minb1": (shape(NARROW, "8, 512, 4, 4, 16, 16, 1"), (1, 8),
                     {8: (8, 512, 1)}, MODES),
    "narrow_lr32": (LR32, (1, 8), {}, MODES),
    "narrow_lr32_skip": (LR32 + SKIP, (1, 8), {}, MODES),
    "narrow4": (shape(NARROW, "4, 1024, 4, 4, 32, 16, 1"), (1, 8),
                {8: (4, 1024, 1)}, MODES),
}
TIMED_ONLY = ("no_stores", "no_dequant")
LIVE = {1: 1, 8: 8, 32: 30, 128: 100}    # live queries per bucket


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("keys_variants: no CUDA device; this script runs on the "
                 "card")
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core.schema import Metric
    from repro_torch.data.quantized import quantize_corpus
    from repro_torch.kernels import build
    from repro_torch.kernels import range_scan as rs_mod
    from repro_torch.kernels.build import METRIC_CODES
    from repro_torch.kernels.quant import MODE_CODES
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
        "quant_keys_batch.cu", VARIANTS, ROOT / "build" / "keys_variants",
        build, "quant_keys_batch_launch",
        [P, P, I, P, P, I, P, P] + [I] * 9 + [P])
    emit({"phase": "build", "nvidia_smi": smi, "report": report})

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    corpus = torch.randn((N_ROWS, DIM), generator=gen, device=dev)
    corpus /= corpus.norm(dim=-1, keepdim=True)
    twins = {mode: quantize_corpus(corpus, mode) for mode in MODES}
    del corpus
    metric = Metric.INNER_PRODUCT

    def call(name, qc, qs, mask, valid):
        qn = qs.shape[0]
        qt, splits, rows = rs_mod.batch_plan(N_ROWS, qn)
        if qt in VARIANTS[name][2]:
            qt, tile, per_sm = VARIANTS[name][2][qt]
            splits, rows = wave_splits(N_ROWS, qn, qt, tile, per_sm)
        keys = torch.empty((qn, N_ROWS), dtype=torch.float32, device=dev)
        err = launchers[name](
            qc.qvecs.data_ptr(), qc.scales.data_ptr(),
            MODE_CODES[qc.qvecs.dtype], qs.data_ptr(), mask.data_ptr(), 2,
            valid.data_ptr(), keys.data_ptr(), N_ROWS, DIM, qn,
            METRIC_CODES[metric], qt, rows, splits, 1, 1,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed, cudaError {err}")
        return keys

    for bucket, live in LIVE.items():
        qs = torch.randn((bucket, DIM), generator=gen, device=dev)
        qs /= qs.norm(dim=-1, keepdim=True)
        mask = (torch.rand((bucket, N_ROWS), generator=gen, device=dev)
                < 0.3).to(torch.int8)
        valid = (torch.arange(bucket, device=dev) < live).to(torch.int8)
        for mode, qc in twins.items():
            names = [n for n in launchers if bucket in VARIANTS[n][1]
                     and mode in VARIANTS[n][3]]
            a = (qc, qs, mask, valid)
            want = call("committed", *a).view(torch.int32)
            for name in names:
                if name not in TIMED_ONLY and not torch.equal(
                        call(name, *a).view(torch.int32), want):
                    raise AssertionError(f"{name} {mode} bucket {bucket}: "
                                         "not the committed keys")
            ms = {name: [] for name in names}
            for name in names + names[::-1]:
                ms[name].append(time_ms(lambda: call(name, *a)))
            emit({"phase": "times", "nvidia_smi": smi, "mode": mode,
                  "bucket": bucket, "live": live, "n": N_ROWS, "d": DIM,
                  "plan": list(rs_mod.batch_plan(N_ROWS, bucket)),
                  "ms": ms})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
