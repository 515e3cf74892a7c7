"""Hold the batched fp32 range-scan CUDA kernel (``range_scan_batch``)
against its definition and, optionally, an earlier version of it on one
NVIDIA card: keys, hits and counts bit for bit, and times in turns.

    python3 scripts/range_compare.py [--parent DIR] [--out FILE]

DIR is a checkout of an earlier commit (for example ``git archive <commit>
| tar x -C build/parent``) whose kernel has this one's C entry point and
launch plan (``range_scan.batch_plan``; the kernel as redesigned on the
128 × 128 tile and later).  Its ``csrc/range_scan_batch.cu`` (with the
headers beside it) is built with the same nvcc flags into
``build/parent_kernels/`` and launched through its own C entry point.

Checks, at (n, d) in {(5003, 130), (4099, 64), (3001, 512)}, Q in {1, 8,
16, 17, 37, 100, 128, 130} (every block shape and a second query tile),
every metric, masks none / shared / per-query (a valid lane with the last
three queries dead), and radii at each query's 100th-best key (the first
query's exactly on 41 duplicate rows), below every key and above every
key:

* keys (int32 view), hits and counts equal
  ``range_scan.range_scan_batch_replayed`` bit for bit: ``replay_keys`` of
  every pair, the mask, the valid lane and the radius test;
* row i of the Q-query call equals the single-query call (one mask kind
  per metric);
* with ``--parent``, the earlier kernel gives the same keys, hits and
  counts bit for bit;

and bit for bit against the replayed reference at 1,000,003 × 64 (Q in
{8, 100}: splits of many tiles, a ragged N).

Then the kernel is timed at N = 1,000,000, D = 512 and Q in {1, 8, 30,
64, 100} (buckets 1, 8, 32, 64 and 128; a per-query mask at selectivity
0.3; each query's radius at its 120th-best key; inner product) by CUDA
events
(median of 10 after 3 warm-ups), in the order earlier, this, this,
earlier, beside the library yardstick (``torch.matmul``, the radius
compare, ``masked_fill``) and the bound.  Prints one JSON line per phase;
``--out`` also writes them to a file.  Exits non-zero if a check failed.
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
QS = (1, 8, 16, 17, 37, 100, 128, 130)
TIMED = ((1, 1), (8, 8), (30, 32), (64, 64), (100, 128))  # (live, bucket)
N_ROWS, DIM, RANK = 1_000_000, 512, 120
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67.0e12   # H100 SXM data sheet


def build_parent(parent: Path, nvcc: str, flags) -> tuple:
    src = parent / "src/repro_torch/kernels/csrc/range_scan_batch.cu"
    out_dir = ROOT / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "range_scan_batch_parent.so"
    proc = subprocess.run([nvcc, *flags, "-o", str(lib_path), str(src)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.range_scan_batch_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 4 + [I] + [P] * 4 + [I] * 9 + [P]
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
        sys.exit("range_compare: no CUDA device; this script runs on the "
                 "card")
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core.expr import pairwise_order_keys
    from repro_torch.core.schema import Metric
    from repro_torch.kernels import build
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
    built = build.build(("range_scan_batch.cu", "replay_keys.cu"))
    log = build.target("range_scan_batch.cu").with_suffix(".log")
    parent_fn, parent_ptxas = (None, None)
    if args.parent:
        parent_fn, parent_ptxas = build_parent(args.parent, build._nvcc(),
                                                build.FLAGS)
    emit({"phase": "build", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0), "seconds": built,
          "ptxas": ptxas_lines(log.read_text()),
          "parent_ptxas": parent_ptxas})

    def parent_range(corpus, qs, rk, mask, valid, metric):
        n, d = corpus.shape
        qn = qs.shape[0]
        qt, splits, rows = rs_mod.batch_plan(n, qn)
        keys = torch.empty((qn, n), dtype=torch.float32, device=dev)
        hits = torch.empty((qn, n), dtype=torch.int8, device=dev)
        counts = torch.zeros(qn, dtype=torch.int32, device=dev)
        mode = 0 if mask is None else 1 if mask.ndim == 1 else 2
        err = parent_fn(
            corpus.data_ptr(), qs.data_ptr(), rk.data_ptr(),
            None if mask is None else mask.data_ptr(), mode,
            None if valid is None else valid.data_ptr(), keys.data_ptr(),
            hits.data_ptr(), counts.data_ptr(), n, d, qn,
            METRIC_CODES[metric], qt, rows, splits, int(d % 4 == 0),
            int(n % 4 == 0), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"earlier kernel launch: error {err}")
        return keys, hits, counts

    def bits(x):
        return x.contiguous().view(torch.int32)

    def same(a, b) -> bool:
        """Two (keys, hits, counts) triples equal bit for bit."""
        return (torch.equal(bits(a[0]), bits(b[0]))
                and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]))

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

    def check_bits(a, metric, what):
        """The kernel against the replayed reference (and the earlier
        kernel); records a failure where they differ.  Returns the
        kernel's output."""
        nonlocal cases
        got = rs_mod.range_scan_batch(*a, metric)
        want = rs_mod.range_scan_batch_replayed(*a, metric)
        cases += 1
        if not same(got, want):
            bad = ((bits(got[0]) != bits(want[0]))
                   | (got[1] != want[1])).nonzero()
            first = (f"first q={int(bad[0][0])} row={int(bad[0][1])}: "
                     f"got ({float(got[0][tuple(bad[0])])}, "
                     f"{int(got[1][tuple(bad[0])])}) want "
                     f"({float(want[0][tuple(bad[0])])}, "
                     f"{int(want[1][tuple(bad[0])])})" if len(bad) else
                     f"counts {got[2].tolist()} vs {want[2].tolist()}")
            failures.append(
                f"{what}: {len(bad)} entries differ from the replayed "
                f"reference, {first}, plan "
                f"{rs_mod.batch_plan(a[0].shape[0], a[1].shape[0])}")
        if parent_fn is not None and not same(got,
                                              parent_range(*a, metric)):
            failures.append(f"{what}: not the earlier kernel's output")
        return got

    mask_of = {Metric.INNER_PRODUCT: "per_query", Metric.L2: "shared",
               Metric.COSINE: "none"}
    for n, d in SMALL:
        corpus = unit((n, d))
        corpus[n // 3: n // 3 + 40] = corpus[7]         # exact duplicates
        for metric in Metric:
            for qn in QS:
                qs = unit((qn, d))
                qs[0] = corpus[7]
                keys = pairwise_order_keys(metric, corpus, qs)
                rk = torch.sort(keys, dim=1).values[:, 100].contiguous()
                rk[0] = keys[0, 7]                      # on the duplicates
                radii = {"rank100": rk,
                         "nothing": keys.min(dim=1).values - 1,
                         "everything": keys.max(dim=1).values + 1}
                valid = (torch.arange(qn, device=dev)
                         < max(1, qn - 3)).to(torch.int8)
                for kind in ("none", "shared", "per_query"):
                    mask = masks(kind, qn, n)
                    for rname, r in radii.items():
                        what = (f"{metric.value} n={n} d={d} q={qn} {kind} "
                                f"{rname}")
                        a = (corpus, qs, r.contiguous(), mask, valid)
                        got = check_bits(a, metric, what)
                        if rname != "rank100" or kind != mask_of[metric]:
                            continue
                        for i in range(qn):
                            one = rs_mod.range_scan_batch(
                                corpus, qs[i:i + 1].contiguous(),
                                r[i:i + 1].contiguous(),
                                None if mask is None else (
                                    mask if mask.ndim == 1
                                    else mask[i:i + 1].contiguous()),
                                valid[i:i + 1].contiguous(), metric)
                            if not same(one, (got[0][i:i + 1],
                                              got[1][i:i + 1],
                                              got[2][i:i + 1])):
                                failures.append(f"{what}: row {i} is not "
                                                "the single-query call")
                            singles += 1
    # splits of many tiles and a ragged N
    n, d = 1_000_003, 64
    corpus = unit((n, d))
    for metric in Metric:
        for qn in (8, 100):
            qs = unit((qn, d))
            keys = pairwise_order_keys(metric, corpus, qs)
            rk = torch.topk(keys, RANK, dim=1, largest=False).values[:, -1]
            del keys
            valid = (torch.arange(qn, device=dev)
                     < max(1, qn - 3)).to(torch.int8)
            check_bits((corpus, qs, rk.contiguous(),
                        masks(mask_of[metric], qn, n), valid), metric,
                       f"{metric.value} n={n} d={d} q={qn} "
                       f"{mask_of[metric]}")
    del corpus
    torch.cuda.synchronize()
    emit({"phase": "check", "cases": cases, "single_query_rows": singles,
          "failures": len(failures), "first_failures": failures[:20],
          "bitwise": ["= range_scan_batch_replayed (keys, hits, counts)",
                      "row of batch = single query"]
          + (["earlier kernel's keys, hits, counts"] if parent_fn else [])})
    if failures:
        sys.exit(f"range_compare: {len(failures)} checks failed")

    corpus = unit((N_ROWS, DIM))
    metric = Metric.INNER_PRODUCT
    timed = {}
    for live, bucket in TIMED:
        qs = unit((bucket, DIM))
        mask = (torch.rand((bucket, N_ROWS), generator=gen, device=dev)
                < 0.3).to(torch.int8)
        valid = (torch.arange(bucket, device=dev) < live).to(torch.int8)
        rk = torch.topk(qs @ corpus.T, RANK, dim=1).values[:, -1].neg()
        a = (corpus, qs, rk.contiguous(), mask, valid)
        this = lambda: rs_mod.range_scan_batch(*a, metric)  # noqa: E731
        row = {"plan": list(rs_mod.batch_plan(N_ROWS, bucket))}
        if parent_fn is not None:
            old = lambda: parent_range(*a, metric)  # noqa: E731
            if not same(this(), old()):
                failures.append(f"full shape q={bucket}: not the earlier "
                                "kernel's output")
            row["earlier_ms"] = [time_ms(old)]
            row["ms"] = [time_ms(this), time_ms(this)]
            row["earlier_ms"].append(time_ms(old))
        else:
            row["ms"] = [time_ms(this), time_ms(this)]

        def lib():
            keys = -(qs @ corpus.T)
            hit = ((keys <= rk[:, None]) & (mask != 0)
                   & (valid != 0)[:, None])
            return keys.masked_fill(~hit, float("inf")), hit
        row["library_ms"] = time_ms(lib, 2, 5)
        row["hits"] = int(this()[2].sum())
        nbytes = (N_ROWS * DIM * 4 + live * DIM * 4 + live * N_ROWS * 6
                  + bucket * 9)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = 2 * N_ROWS * DIM * live / PEAK_FLOPS * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        timed[f"q{live}"] = row
    emit({"phase": "times", "nvidia_smi": smi, "n": N_ROWS, "d": DIM,
          "metric": metric.value, "runs": timed,
          "failures": failures[:20]})
    if failures:
        sys.exit(f"range_compare: {len(failures)} checks failed")


if __name__ == "__main__":
    main()
