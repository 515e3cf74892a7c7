"""Hold the quantized key CUDA kernel (``quant_keys_batch``) against its
definition and, optionally, an earlier version of it on one NVIDIA card:
keys bit for bit, and times in turns.

    python3 scripts/keys_compare.py [--parent DIR] [--out FILE]

DIR is a checkout of an earlier commit (for example ``git archive <commit>
| tar x -C build/parent``).  Its ``csrc/quant_keys_batch.cu`` (with the
headers beside it) is built with the same nvcc flags into
``build/parent_kernels/`` and launched through its own C entry point with
that version's launch plan (4, 16 or 64 queries per block, about 264
blocks of 64-row tiles).

Checks, in int8 and bf16, at (n, d) in {(5003, 130), (4099, 64), (3001,
512)} and Q in {1, 8, 16, 17, 37, 64, 100, 128, 130} (every block shape,
the wide shape's skipped query groups, a second query tile), every metric,
masks none / shared / per-query (a valid lane with the last three queries
dead):

* keys (int32 view) equal ``quant.quant_keys_batch_replayed`` bit for bit
  (``replay_keys`` of every pair over the dequantized twin, the mask, the
  valid lane) and ``range_scan_batch``'s keys on the dequantized twin with
  every radius at +inf;
* row i of the Q-query call equals the single-query call (one mask kind
  per metric);
* with ``--parent``, the earlier kernel gives the same keys bit for bit;

and the first two at 1,000,003 × 64 (Q in {8, 100}: splits of many
tiles, a ragged N).

Then each mode is timed at N = 1,000,000, D = 512 and Q in {1, 8, 30, 64,
100} (buckets 1, 8, 32, 64 and 128; a per-query mask at selectivity 0.3;
inner product) by CUDA events, in the order earlier, this, this, earlier:
one call between an event pair (median of 10 after 3 warm-ups), and a run
of back-to-back calls between one pair (20, or 5 for calls over 2 ms; per
call); beside ``range_scan_batch`` on the fp32 corpus at the same Q, the
library yardstick (dequantize, ``torch.matmul``, ``masked_fill``) and the
bound.  Prints one JSON line per phase; ``--out`` also writes them to a
file.  Exits non-zero if a check failed.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from range_compare import ptxas_lines, time_ms

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SMALL = ((5003, 130), (4099, 64), (3001, 512))
QS = (1, 8, 16, 17, 37, 64, 100, 128, 130)
BIG = (1_000_003, 64)        # splits of many tiles, a ragged N
TIMED = ((1, 1), (8, 8), (30, 32), (64, 64), (100, 128))  # (live, bucket)
N_ROWS, DIM = 1_000_000, 512
MODES = ("int8", "bf16")
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67.0e12   # H100 SXM data sheet


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def parent_plan(n: int, qn: int) -> tuple[int, int, int]:
    """(queries per block, splits, rows per split) of the earlier
    kernel."""
    qt = next((t for t in (4, 16, 64) if t >= qn), 64)
    tiles = max(1, cdiv(n, 64))
    want = max(1, cdiv(264, cdiv(qn, qt)))
    rows = cdiv(tiles, min(tiles, want)) * 64
    return qt, cdiv(n, rows), rows


def build_parent(parent: Path, nvcc: str, flags) -> tuple:
    src = parent / "src/repro_torch/kernels/csrc/quant_keys_batch.cu"
    out_dir = ROOT / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "quant_keys_batch_parent.so"
    proc = subprocess.run([nvcc, *flags, "-o", str(lib_path), str(src)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.quant_keys_batch_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, I, P, P, I, P, P] + [I] * 7 + [P]
    fn.restype = ctypes.c_int
    return fn, ptxas_lines(proc.stdout + proc.stderr)


def run_ms(fn, one_ms: float) -> float:
    """Device time per call over a run of back-to-back calls between one
    event pair: 20 calls, or 5 where one takes over 2 ms."""
    count = 5 if one_ms > 2.0 else 20
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(count):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / count


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("keys_compare: no CUDA device; this script runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core.schema import Metric
    from repro_torch.data.quantized import quantize_corpus
    from repro_torch.kernels import build
    from repro_torch.kernels import quant as qt_mod
    from repro_torch.kernels import range_scan as rs_mod
    from repro_torch.kernels.build import METRIC_CODES

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
    built = build.build(("quant_keys_batch.cu", "range_scan_batch.cu",
                         "replay_keys.cu"))
    ptxas = {s: ptxas_lines(build.target(s).with_suffix(".log").read_text())
             for s in ("quant_keys_batch.cu", "range_scan_batch.cu")}
    parent_fn, parent_ptxas = (None, None)
    if args.parent:
        parent_fn, parent_ptxas = build_parent(args.parent, build._nvcc(),
                                                build.FLAGS)
    emit({"phase": "build", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0), "seconds": built,
          "ptxas": ptxas, "parent_ptxas": parent_ptxas})

    def parent_keys(qvecs, scales, qs, mask, valid, metric):
        n, d = qvecs.shape
        qn = qs.shape[0]
        qt, splits, rows = parent_plan(n, qn)
        keys = torch.empty((qn, n), dtype=torch.float32, device=dev)
        mode = 0 if mask is None else 1 if mask.ndim == 1 else 2
        err = parent_fn(
            qvecs.data_ptr(), scales.data_ptr(),
            qt_mod.MODE_CODES[qvecs.dtype], qs.data_ptr(),
            None if mask is None else mask.data_ptr(), mode,
            None if valid is None else valid.data_ptr(), keys.data_ptr(),
            n, d, qn, METRIC_CODES[metric], qt, rows, splits,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"earlier kernel launch: error {err}")
        return keys

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

    failures, cases, singles = [], 0, 0

    def check_bits(qc, a, metric, what):
        """The kernel against the replayed reference, the fp32 range scan
        on the dequantized twin at +inf radii (and the earlier kernel);
        records a failure where they differ.  Returns the kernel's keys."""
        nonlocal cases
        got = qt_mod.quant_keys_batch(qc.qvecs, qc.scales, *a, metric)
        want = qt_mod.quant_keys_batch_replayed(qc.qvecs, qc.scales, *a,
                                                metric)
        deq = qc.qvecs.to(torch.float32) * qc.scales
        inf = torch.full((a[0].shape[0],), float("inf"), device=dev)
        ranged = rs_mod.range_scan_batch(deq, a[0], inf, *a[1:], metric)[0]
        cases += 1
        for name, other in (("the replayed reference", want),
                            ("range_scan_batch at +inf", ranged)):
            if not torch.equal(bits(got), bits(other)):
                bad = (bits(got) != bits(other)).nonzero()
                at = tuple(bad[0].tolist())
                failures.append(
                    f"{what}: {len(bad)} keys differ from {name}, first "
                    f"q={at[0]} row={at[1]}: {float(got[at])} vs "
                    f"{float(other[at])}, plan "
                    f"{rs_mod.batch_plan(qc.qvecs.shape[0], a[0].shape[0])}")
        if parent_fn is not None and not torch.equal(
                bits(got), bits(parent_keys(qc.qvecs, qc.scales, *a,
                                            metric))):
            failures.append(f"{what}: not the earlier kernel's keys")
        return got

    mask_of = {Metric.INNER_PRODUCT: "per_query", Metric.L2: "shared",
               Metric.COSINE: "none"}
    for n, d in SMALL:
        corpus = unit((n, d))
        corpus[n // 3: n // 3 + 40] = corpus[7]         # exact duplicates
        for mode in MODES:
            qc = quantize_corpus(corpus, mode)
            for metric in Metric:
                for qn in QS:
                    qs = unit((qn, d))
                    qs[0] = corpus[7]
                    valid = (torch.arange(qn, device=dev)
                             < max(1, qn - 3)).to(torch.int8)
                    for kind in ("none", "shared", "per_query"):
                        mask = masks(kind, qn, n)
                        what = (f"{mode} {metric.value} n={n} d={d} q={qn} "
                                f"{kind}")
                        got = check_bits(qc, (qs, mask, valid), metric, what)
                        if kind != mask_of[metric]:
                            continue
                        for i in range(qn):
                            one = qt_mod.quant_keys_batch(
                                qc.qvecs, qc.scales,
                                qs[i:i + 1].contiguous(),
                                None if mask is None else (
                                    mask if mask.ndim == 1
                                    else mask[i:i + 1].contiguous()),
                                valid[i:i + 1].contiguous(), metric)
                            if not torch.equal(bits(one[0]), bits(got[i])):
                                failures.append(f"{what}: row {i} is not "
                                                "the single-query call")
                            singles += 1
    n, d = BIG
    corpus = unit((n, d))
    for mode in MODES:
        qc = quantize_corpus(corpus, mode)
        for metric in Metric:
            for qn in (8, 100):
                valid = (torch.arange(qn, device=dev)
                         < max(1, qn - 3)).to(torch.int8)
                check_bits(qc, (unit((qn, d)), masks(mask_of[metric], qn, n),
                                valid), metric,
                           f"{mode} {metric.value} n={n} d={d} q={qn} "
                           f"{mask_of[metric]}")
        del qc
    del corpus
    torch.cuda.synchronize()
    emit({"phase": "check", "cases": cases, "single_query_rows": singles,
          "failures": len(failures), "first_failures": failures[:20],
          "bitwise": ["= quant_keys_batch_replayed (keys)",
                      "= range_scan_batch keys on the dequantized twin at "
                      "+inf radii", "row of batch = single query"]
          + (["earlier kernel's keys"] if parent_fn else [])})
    if failures:
        sys.exit(f"keys_compare: {len(failures)} checks failed")

    corpus = unit((N_ROWS, DIM))
    twins = {mode: quantize_corpus(corpus, mode) for mode in MODES}
    metric = Metric.INNER_PRODUCT
    timed = {}
    for live, bucket in TIMED:
        qs = unit((bucket, DIM))
        mask = (torch.rand((bucket, N_ROWS), generator=gen, device=dev)
                < 0.3).to(torch.int8)
        valid = (torch.arange(bucket, device=dev) < live).to(torch.int8)
        inf = torch.full((bucket,), float("inf"), device=dev)
        fp32 = lambda: rs_mod.range_scan_batch(  # noqa: E731
            corpus, qs, inf, mask, valid, metric)
        one = time_ms(fp32)
        row = {"plan": list(rs_mod.batch_plan(N_ROWS, bucket)),
               "range_scan_batch_ms": one,
               "range_scan_batch_run_ms": run_ms(fp32, one)}
        for mode, qc in twins.items():
            a = (qc.qvecs, qc.scales, qs, mask, valid)
            this = lambda: qt_mod.quant_keys_batch(*a, metric)  # noqa: E731
            cell = {}
            if parent_fn is not None:
                old = lambda: parent_keys(*a, metric)  # noqa: E731
                if not torch.equal(bits(this()), bits(old())):
                    failures.append(f"full shape {mode} q={bucket}: not the "
                                    "earlier kernel's keys")
                cell["earlier_ms"] = [time_ms(old)]
                cell["ms"] = [time_ms(this), time_ms(this)]
                cell["earlier_ms"].append(time_ms(old))
                cell["earlier_run_ms"] = run_ms(old, cell["earlier_ms"][0])
                cell["parent_plan"] = list(parent_plan(N_ROWS, bucket))
            else:
                cell["ms"] = [time_ms(this), time_ms(this)]
            cell["run_ms"] = run_ms(this, cell["ms"][0])

            def lib(qc=qc):
                keys = -(qs @ (qc.qvecs.to(torch.float32) * qc.scales).T)
                keys = keys.masked_fill(mask == 0, float("inf"))
                return keys.masked_fill((valid == 0)[:, None], float("inf"))
            cell["library_ms"] = time_ms(lib, 2, 5)
            cell["library_run_ms"] = run_ms(lib, cell["library_ms"])
            nbytes = (qc.qvecs.numel() * qc.qvecs.element_size()
                      + (N_ROWS * 4 if mode == "int8" else 0)
                      + live * DIM * 4 + live * N_ROWS + bucket
                      + live * N_ROWS * 4)
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = 2 * N_ROWS * DIM * live / PEAK_FLOPS * 1e3
            cell["bound_ms"] = max(t_bytes, t_ops)
            cell["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            row[mode] = cell
        timed[f"q{live}"] = row
    emit({"phase": "times", "nvidia_smi": smi, "n": N_ROWS, "d": DIM,
          "metric": metric.value, "runs": timed,
          "failures": failures[:20]})
    if failures:
        sys.exit(f"keys_compare: {len(failures)} checks failed")


if __name__ == "__main__":
    main()
