"""Hold the quantized top-k CUDA kernel (``quant_scan_topk_batch``) against
its definition and, optionally, an earlier version of it on one NVIDIA
card: segment keys bit for bit, and times in turns.

    python3 scripts/quant_compare.py [--parent DIR] [--out FILE]

DIR is a checkout of an earlier commit (for example ``git archive <commit>
| tar x -C build/parent``).  Its ``csrc/quant_scan_topk_batch.cu`` (with
the headers beside it) is built with the same nvcc flags into
``build/parent_kernels/`` and launched through its own C entry point with
that version's launch plan (the fp32 batched plan for min(count, 1024)
candidates: 4, 16 or 64 queries per block, about 264 blocks of 64-row
tiles, splits of at most 8·1024 rows).

Checks, at (n, d) in {(5003, 130), (4099, 64), (3001, 512)}, Q in {1, 8,
37, 100, 130}, int8 and bf16, every metric, masks none / shared /
per-query (a valid lane with the last three queries dead), and count
(segments per query) in {ceil(n / 8), 100, 150} (which between them reach
the kernel's three block shapes):

* keys and ids equal ``quant.quant_scan_topk_batch_replayed`` bit for bit:
  each segment's key is the minimum of ``replay_keys`` over its rows of
  the dequantized corpus, and each split keeps its best segments;
* they agree with the plain version within 1e-5 (1e-4 at D = 512);
* row i of the Q-query call gives the single-query call's
  ``candidate_rows`` (count 100, one mask kind per metric);
* with ``--parent``, the earlier kernel gives the same ``candidate_rows``.

Then the kernel is timed at N = 1,000,000, D = 512 and Q in {1, 8, 30,
100} (buckets 1, 8, 32 and 128; a per-query mask at
selectivity 0.3; count 100; inner product), int8 and bf16, by CUDA events
(median of 10 after 3 warm-ups), in the order earlier, this, this, earlier,
beside the library yardstick (dequantize, ``torch.matmul``,
``masked_fill``, segment ``amin``, ``torch.topk``) and the bound.  Prints
one JSON line per phase; ``--out`` also writes them to a file.  Exits
non-zero if a check failed.
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

SMALL = ((5003, 130), (4099, 64), (3001, 512))
QS = (1, 8, 37, 100, 130)
TIMED = ((1, 1), (8, 8), (30, 32), (100, 128))   # (live queries, bucket)
N_ROWS, DIM, COUNT = 1_000_000, 512, 100
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67.0e12   # H100 SXM data sheet


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def parent_plan(n: int, qn: int, count: int) -> tuple[int, int, int, int]:
    """(queries per block, splits, rows per split, segments per split) of
    the earlier kernel."""
    k = min(count, 1024)
    kp = 1 << max(0, (max(k, 64) - 1).bit_length())
    cap = 64 if kp <= 64 else 16 if kp <= 256 else 4
    qt = next((t for t in (4, 16, 64) if qn <= t <= cap), cap)
    tiles = max(1, cdiv(n, 64))
    want = max(1, cdiv(264, cdiv(qn, qt)))
    rows = min(cdiv(tiles, min(tiles, want)) * 64, 8 * 1024)
    return qt, cdiv(n, rows), rows, max(1, min(count, rows // 8))


def build_parent(parent: Path, nvcc: str, flags) -> tuple:
    src = parent / "src/repro_torch/kernels/csrc/quant_scan_topk_batch.cu"
    out_dir = ROOT / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "quant_scan_topk_batch_parent.so"
    proc = subprocess.run([nvcc, *flags, "-o", str(lib_path), str(src)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.quant_scan_topk_batch_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, I, P, P, I] + [P] * 3 + [I] * 8 + [P]
    fn.restype = ctypes.c_int
    return fn, ptxas_lines(proc.stdout + proc.stderr)


def ptxas_lines(log: str) -> list:
    return [ln.split("info    :")[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


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
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("quant_compare: no CUDA device; this script runs on the "
                 "card")
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core.schema import Metric
    from repro_torch.data.quantized import quantize_corpus
    from repro_torch.kernels import build
    from repro_torch.kernels import quant as qt_mod
    from repro_torch.kernels.build import METRIC_CODES
    from repro_torch.testing import assert_topk_close

    lines = []

    def emit(obj) -> None:
        lines.append(obj)
        print(json.dumps(obj), flush=True)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text("".join(json.dumps(x) + "\n"
                                        for x in lines))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    built = build.build(("quant_scan_topk_batch.cu", "replay_keys.cu"))
    log = build.target("quant_scan_topk_batch.cu").with_suffix(".log")
    parent_fn, parent_ptxas = (None, None)
    if args.parent:
        parent_fn, parent_ptxas = build_parent(args.parent, build._nvcc(),
                                                build.FLAGS)
    emit({"phase": "build", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0), "seconds": built,
          "ptxas": ptxas_lines(log.read_text()),
          "parent_ptxas": parent_ptxas})

    def parent_topk(qc, qs, mask, valid, count, metric):
        n, d = qc.qvecs.shape
        qn = qs.shape[0]
        qt, splits, rows, s = parent_plan(n, qn, count)
        keys = torch.empty((qn, splits * s), dtype=torch.float32,
                           device=dev)
        ids = torch.empty((qn, splits * s), dtype=torch.int32, device=dev)
        mode = 0 if mask is None else 1 if mask.ndim == 1 else 2
        err = parent_fn(
            qc.qvecs.data_ptr(), qc.scales.data_ptr(),
            qt_mod.MODE_CODES[qc.qvecs.dtype], qs.data_ptr(),
            None if mask is None else mask.data_ptr(), mode,
            None if valid is None else valid.data_ptr(), keys.data_ptr(),
            ids.data_ptr(), n, d, qn, s, METRIC_CODES[metric], qt, rows,
            splits, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"earlier kernel launch: error {err}")
        return keys, ids

    def bits(x):
        return x.contiguous().view(torch.int32)

    gen = torch.Generator(device=dev).manual_seed(0)

    def unit(shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return x / x.norm(dim=-1, keepdim=True)

    def masks(kind: str, qn: int, n: int):
        if kind == "none":
            return None
        shape = (n,) if kind == "shared" else (qn, n)
        return (torch.rand(shape, generator=gen, device=dev)
                < 0.4).to(torch.int8)

    failures, cases, singles, max_err = [], 0, 0, 0.0
    mask_of = {Metric.INNER_PRODUCT: "per_query", Metric.L2: "shared",
               Metric.COSINE: "none"}
    for n, d in SMALL:
        tol = 1e-4 if d > 130 else 1e-5
        corpus = unit((n, d))
        corpus[n // 3: n // 3 + 40] = corpus[7]         # exact duplicates
        for mode in ("int8", "bf16"):
            qc = quantize_corpus(corpus, mode)
            for metric in Metric:
                for qn in QS:
                    qs = unit((qn, d))
                    qs[0] = corpus[7]
                    valid = (torch.arange(qn, device=dev)
                             < max(1, qn - 3)).to(torch.int8)
                    for kind in ("none", "shared", "per_query"):
                        mask = masks(kind, qn, n)
                        a = (qc.qvecs, qc.scales, qs, mask, valid)
                        for count in (cdiv(n, 8), COUNT, 150):
                            what = (f"{mode} {metric.value} n={n} d={d} "
                                    f"q={qn} {kind} count={count}")
                            got = qt_mod.quant_scan_topk_batch(*a, count,
                                                               metric)
                            want = qt_mod.quant_scan_topk_batch_replayed(
                                *a, count, metric)
                            cases += 1
                            if not (torch.equal(bits(got[0]), bits(want[0]))
                                    and torch.equal(got[1], want[1])):
                                bad = ((bits(got[0]) != bits(want[0]))
                                       | (got[1] != want[1])).nonzero()
                                q, j = (int(v) for v in bad[0])
                                failures.append(
                                    f"{what}: {len(bad)} entries differ "
                                    f"from the replayed segments, first "
                                    f"q={q} j={j}: got "
                                    f"({float(got[0][q, j])}, "
                                    f"{int(got[1][q, j])}) want "
                                    f"({float(want[0][q, j])}, "
                                    f"{int(want[1][q, j])}), plan "
                                    f"{qt_mod.quant_plan(n, qn, count)}")
                                continue
                            s = qt_mod.quant_plan(n, qn, count)[3]
                            plain = qt_mod.quant_scan_topk_batch_plain(
                                *a, count, metric)

                            def slab(keys, ids):
                                return {"ids": ids.reshape(-1, s),
                                        "sim": keys.reshape(-1, s),
                                        "valid": ids.reshape(-1, s) >= 0}
                            try:
                                max_err = max(max_err, assert_topk_close(
                                    slab(*got), slab(*plain), atol=tol,
                                    tie_tol=tol, what=what))
                            except AssertionError as e:
                                failures.append(f"plain: {e}")
                            if count != COUNT:
                                continue
                            rows = qt_mod.candidate_rows(*got, count)
                            if parent_fn is not None:
                                old = qt_mod.candidate_rows(*parent_topk(
                                    qc, qs, mask, valid, count, metric),
                                    count)
                                if not torch.equal(old, rows):
                                    failures.append(f"{what}: candidate "
                                                    "rows differ from the "
                                                    "earlier kernel's")
                            if kind != mask_of[metric]:
                                continue
                            for i in range(qn):
                                one = qt_mod.quant_scan_topk_batch(
                                    qc.qvecs, qc.scales,
                                    qs[i:i + 1].contiguous(),
                                    None if mask is None else (
                                        mask if mask.ndim == 1
                                        else mask[i:i + 1].contiguous()),
                                    valid[i:i + 1].contiguous(), count,
                                    metric)
                                if not torch.equal(
                                        qt_mod.candidate_rows(*one, count)[0],
                                        rows[i]):
                                    failures.append(f"{what}: row {i} is "
                                                    "not the single-query "
                                                    "call")
                                singles += 1
    torch.cuda.synchronize()
    emit({"phase": "check", "cases": cases, "single_query_rows": singles,
          "max_abs_err_vs_plain": max_err, "failures": len(failures),
          "first_failures": failures[:20],
          "bitwise": ["= quant_scan_topk_batch_replayed (keys and ids)",
                      "row of batch = single query (candidate_rows)"]
          + (["earlier kernel's candidate_rows"] if parent_fn else [])})

    corpus = unit((N_ROWS, DIM))
    twins = {mode: quantize_corpus(corpus, mode) for mode in ("int8", "bf16")}
    metric = Metric.INNER_PRODUCT
    timed = {}
    for live, bucket in TIMED:
        qs = unit((bucket, DIM))
        mask = (torch.rand((bucket, N_ROWS), generator=gen, device=dev)
                < 0.3).to(torch.int8)
        valid = (torch.arange(bucket, device=dev) < live).to(torch.int8)
        for mode, qc in twins.items():
            a = (qc.qvecs, qc.scales, qs, mask, valid)
            this = lambda: qt_mod.quant_scan_topk_batch(  # noqa: E731
                *a, COUNT, metric)
            row = {"plan": list(qt_mod.quant_plan(N_ROWS, bucket, COUNT))}
            if parent_fn is not None:
                old = lambda: parent_topk(  # noqa: E731
                    qc, qs, mask, valid, COUNT, metric)
                if not torch.equal(qt_mod.candidate_rows(*this(), COUNT),
                                   qt_mod.candidate_rows(*old(), COUNT)):
                    failures.append(f"full shape q={bucket} {mode}: "
                                    "candidate rows differ from earlier")
                row["earlier_ms"] = [time_ms(old)]
                row["ms"] = [time_ms(this), time_ms(this)]
                row["earlier_ms"].append(time_ms(old))
                row["parent_plan"] = list(parent_plan(N_ROWS, bucket,
                                                      COUNT))
            else:
                row["ms"] = [time_ms(this), time_ms(this)]

            def lib():
                keys = -(qs @ (qc.qvecs.to(torch.float32) * qc.scales).T)
                keys = keys.masked_fill(mask == 0, float("inf"))
                keys = keys.masked_fill((valid == 0)[:, None], float("inf"))
                seg = keys.view(bucket, -1, qt_mod.SEG).amin(-1)
                return torch.topk(seg, COUNT, dim=1, largest=False)
            row["library_ms"] = time_ms(lib, 2, 5)
            _, splits, _, s = qt_mod.quant_plan(N_ROWS, bucket, COUNT)
            nbytes = (qc.qvecs.numel() * qc.qvecs.element_size()
                      + (4 * N_ROWS if mode == "int8" else 0)
                      + live * DIM * 4 + live * N_ROWS + bucket
                      + live * splits * s * 8)
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = 2 * N_ROWS * DIM * live / PEAK_FLOPS * 1e3
            row["bound_ms"] = max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            timed[f"q{live}_{mode}"] = row
    emit({"phase": "times", "nvidia_smi": smi, "n": N_ROWS, "d": DIM,
          "count": COUNT, "metric": metric.value, "runs": timed,
          "failures": failures[:20]})
    if failures:
        sys.exit(f"quant_compare: {len(failures)} checks failed")


if __name__ == "__main__":
    main()
