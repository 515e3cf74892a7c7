"""Hold the batched fp32 top-k CUDA kernel (``scan_topk_batch``) against its
definition and, optionally, an earlier version of it on one NVIDIA card:
keys and ids bit for bit, and times in turns.

    python3 scripts/scan_compare.py [--parent DIR] [--out FILE]

DIR is a checkout of an earlier commit (for example ``git archive <commit>
| tar x -C build/parent``).  Its ``csrc/scan_topk_batch.cu`` (with the
headers beside it) is built with the same nvcc flags into
``build/parent_kernels/`` and launched through its own C entry point with
that version's launch plan (4, 16 or 64 queries per block, about 264
blocks of 64-row tiles).

Checks, at (n, d) in {(5003, 130), (4099, 64), (3001, 512)}, Q in {1, 8,
20, 37, 100, 130}, every metric, masks none / shared / per-query (a valid
lane with the last three queries dead), and k in {1, 50, 200, 1000} (which
between them reach every block shape and list length):

* keys (int32 view) and ids equal ``scan_topk.scan_topk_batch_replayed``
  bit for bit: ``replay_keys`` of every pair, masked, each split's best k;
* they agree with the plain version within 1e-5 (1e-4 at D = 512);
* row i of the Q-query call gives the single-query call's stage-2 answer
  (k = 50, one mask kind per metric);
* with ``--parent``, the earlier kernel gives the same stage-2 answer,
  keys and ids bit for bit (its splits differ, so stage 1 does too);

and bit for bit against the replayed reference at 1,000,003 × 64 (Q in {8,
40}, k in {50, 200, 1000}: splits of many tiles) and on a corpus ordered so
that every row beats the one before it for every query (each insertion
round overflows its lists).

Then the kernel is timed at N = 1,000,000, D = 512 and Q in {1, 8, 30,
100} (buckets 1, 8, 32 and 128; a per-query mask at selectivity 0.3; k =
50; inner product) by CUDA events (median of 10 after 3 warm-ups), in the
order earlier, this, this, earlier, beside the library yardstick
(``torch.matmul``, ``masked_fill``, ``torch.topk``) and the bound.  Prints
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
QS = (1, 8, 20, 37, 100, 130)
KS = (1, 50, 200, 1000)
TIMED = ((1, 1), (8, 8), (30, 32), (100, 128))   # (live queries, bucket)
N_ROWS, DIM, K = 1_000_000, 512, 50
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67.0e12   # H100 SXM data sheet


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def parent_plan(n: int, qn: int, k: int) -> tuple[int, int, int]:
    """(queries per block, splits, rows per split) of the earlier
    kernel."""
    kp = 1 << max(0, (max(k, 64) - 1).bit_length())
    cap = 64 if kp <= 64 else 16 if kp <= 256 else 4
    qt = next((t for t in (4, 16, 64) if qn <= t <= cap), cap)
    tiles = max(1, cdiv(n, 64))
    want = max(1, cdiv(264, cdiv(qn, qt)))
    rows = cdiv(tiles, min(tiles, want)) * 64
    return qt, cdiv(n, rows), rows


def build_parent(parent: Path, nvcc: str, flags) -> tuple:
    src = parent / "src/repro_torch/kernels/csrc/scan_topk_batch.cu"
    out_dir = ROOT / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "scan_topk_batch_parent.so"
    proc = subprocess.run([nvcc, *flags, "-o", str(lib_path), str(src)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.scan_topk_batch_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 3 + [I] + [P] * 3 + [I] * 8 + [P]
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
        sys.exit("scan_compare: no CUDA device; this script runs on the "
                 "card")
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core.schema import Metric
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import scan_topk as st_mod
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
    built = build.build(("scan_topk_batch.cu", "replay_keys.cu"))
    log = build.target("scan_topk_batch.cu").with_suffix(".log")
    parent_fn, parent_ptxas = (None, None)
    if args.parent:
        parent_fn, parent_ptxas = build_parent(args.parent, build._nvcc(),
                                                build.FLAGS)
    emit({"phase": "build", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0), "seconds": built,
          "ptxas": ptxas_lines(log.read_text()),
          "parent_ptxas": parent_ptxas})

    def parent_topk(corpus, qs, mask, valid, k, metric):
        n, d = corpus.shape
        qn = qs.shape[0]
        qt, splits, rows = parent_plan(n, qn, k)
        keys = torch.empty((qn, splits * k), dtype=torch.float32,
                           device=dev)
        ids = torch.empty((qn, splits * k), dtype=torch.int32, device=dev)
        mode = 0 if mask is None else 1 if mask.ndim == 1 else 2
        err = parent_fn(
            corpus.data_ptr(), qs.data_ptr(),
            None if mask is None else mask.data_ptr(), mode,
            None if valid is None else valid.data_ptr(), keys.data_ptr(),
            ids.data_ptr(), n, d, qn, k, METRIC_CODES[metric], qt, rows,
            splits, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"earlier kernel launch: error {err}")
        return keys, ids

    def bits(x):
        return x.contiguous().view(torch.int32)

    def same(a, b) -> bool:
        """Two (keys, ids) pairs equal bit for bit."""
        return torch.equal(bits(a[0]), bits(b[0])) and torch.equal(a[1], b[1])

    def merged(out, k, metric):
        """Stage 2 of a stage-1 output: (sims, ids) of the k best."""
        ids, sims, _ = ops._merge(*out, k, metric)
        return sims, ids

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

    def check_bits(a, k, metric, what) -> bool:
        """The kernel against the replayed reference; records a failure
        and returns False where they differ."""
        nonlocal cases
        got = st_mod.scan_topk_batch(*a, k, metric)
        want = st_mod.scan_topk_batch_replayed(*a, k, metric)
        cases += 1
        if same(got, want):
            return True
        bad = ((bits(got[0]) != bits(want[0]))
               | (got[1] != want[1])).nonzero()
        q, j = (int(v) for v in bad[0])
        failures.append(
            f"{what}: {len(bad)} entries differ from the replayed "
            f"reference, first q={q} j={j}: got ({float(got[0][q, j])}, "
            f"{int(got[1][q, j])}) want ({float(want[0][q, j])}, "
            f"{int(want[1][q, j])}), plan "
            f"{st_mod.batch_plan(a[0].shape[0], a[1].shape[0], k)}")
        return False

    mask_of = {Metric.INNER_PRODUCT: "per_query", Metric.L2: "shared",
               Metric.COSINE: "none"}
    for n, d in SMALL:
        tol = 1e-4 if d > 130 else 1e-5
        corpus = unit((n, d))
        corpus[n // 3: n // 3 + 40] = corpus[7]         # exact duplicates
        for metric in Metric:
            for qn in QS:
                qs = unit((qn, d))
                qs[0] = corpus[7]
                valid = (torch.arange(qn, device=dev)
                         < max(1, qn - 3)).to(torch.int8)
                for kind in ("none", "shared", "per_query"):
                    mask = masks(kind, qn, n)
                    a = (corpus, qs, mask, valid)
                    for k in KS:
                        what = (f"{metric.value} n={n} d={d} q={qn} {kind} "
                                f"k={k}")
                        if not check_bits(a, k, metric, what):
                            continue
                        got = st_mod.scan_topk_batch(*a, k, metric)
                        plain = st_mod.scan_topk_batch_plain(*a, k, metric)

                        def slab(keys, ids):
                            return {"ids": ids.reshape(-1, k),
                                    "sim": keys.reshape(-1, k),
                                    "valid": ids.reshape(-1, k) >= 0}
                        try:
                            max_err = max(max_err, assert_topk_close(
                                slab(*got), slab(*plain), atol=tol,
                                tie_tol=tol, what=what))
                        except AssertionError as e:
                            failures.append(f"plain: {e}")
                        if k != K:
                            continue
                        top = merged(got, k, metric)
                        if parent_fn is not None and not same(
                                top, merged(parent_topk(*a, k, metric), k,
                                            metric)):
                            failures.append(f"{what}: stage 2 differs "
                                            "from the earlier kernel's")
                        if kind != mask_of[metric]:
                            continue
                        for i in range(qn):
                            one = st_mod.scan_topk_batch(
                                corpus, qs[i:i + 1].contiguous(),
                                None if mask is None else (
                                    mask if mask.ndim == 1
                                    else mask[i:i + 1].contiguous()),
                                valid[i:i + 1].contiguous(), k, metric)
                            if not same(merged(one, k, metric),
                                        (top[0][i:i + 1], top[1][i:i + 1])):
                                failures.append(f"{what}: row {i} is not "
                                                "the single-query call")
                            singles += 1
    # splits of many tiles, and every round overflowing: rows ordered so
    # that each beats the one before it for every query (t·q + s·u, u ⊥ q,
    # t rising to 1 and s falling to 0)
    n, d = 1_000_003, 64
    corpus = unit((n, d))
    for metric in Metric:
        for qn in (8, 40):
            qs = unit((qn, d))
            valid = (torch.arange(qn, device=dev)
                     < max(1, qn - 3)).to(torch.int8)
            mask = masks(mask_of[metric], qn, n)
            for k in (K, 200, 1000):
                check_bits((corpus, qs, mask, valid), k, metric,
                           f"{metric.value} n={n} d={d} q={qn} "
                           f"{mask_of[metric]} k={k}")
    del corpus
    n = 100_003
    q = unit((d,))
    u = unit((d,))
    u = u - (u @ q) * q
    u = u / u.norm()
    t = torch.linspace(0.5, 1.0, n, device=dev)[:, None]
    ordered = (t * q + (1.0 - t) * 2.0 * u).contiguous()
    for metric in Metric:
        for qn in (8, 40):
            qs = q.expand(qn, d).contiguous()
            for k in (K, 1000):
                check_bits((ordered, qs, None, None), k, metric,
                           f"ordered {metric.value} n={n} q={qn} k={k}")
    torch.cuda.synchronize()
    emit({"phase": "check", "cases": cases, "single_query_rows": singles,
          "max_abs_err_vs_plain": max_err, "failures": len(failures),
          "first_failures": failures[:20],
          "bitwise": ["= scan_topk_batch_replayed (keys and ids)",
                      "row of batch = single query (stage 2)"]
          + (["earlier kernel's stage 2"] if parent_fn else [])})
    if failures:
        sys.exit(f"scan_compare: {len(failures)} checks failed")

    corpus = unit((N_ROWS, DIM))
    metric = Metric.INNER_PRODUCT
    timed = {}
    for live, bucket in TIMED:
        qs = unit((bucket, DIM))
        mask = (torch.rand((bucket, N_ROWS), generator=gen, device=dev)
                < 0.3).to(torch.int8)
        valid = (torch.arange(bucket, device=dev) < live).to(torch.int8)
        a = (corpus, qs, mask, valid)
        this = lambda: st_mod.scan_topk_batch(*a, K, metric)  # noqa: E731
        row = {"plan": list(st_mod.batch_plan(N_ROWS, bucket, K))}
        if parent_fn is not None:
            old = lambda: parent_topk(*a, K, metric)  # noqa: E731
            if not same(merged(this(), K, metric),
                        merged(old(), K, metric)):
                failures.append(f"full shape q={bucket}: stage 2 differs "
                                "from the earlier kernel's")
            row["earlier_ms"] = [time_ms(old)]
            row["ms"] = [time_ms(this), time_ms(this)]
            row["earlier_ms"].append(time_ms(old))
            row["parent_plan"] = list(parent_plan(N_ROWS, bucket, K))
        else:
            row["ms"] = [time_ms(this), time_ms(this)]

        def lib():
            keys = -(qs @ corpus.T)
            keys = keys.masked_fill(mask == 0, float("inf"))
            keys = keys.masked_fill((valid == 0)[:, None], float("inf"))
            return torch.topk(keys, K, dim=1, largest=False)
        row["library_ms"] = time_ms(lib, 2, 5)
        splits = row["plan"][1]
        nbytes = (N_ROWS * DIM * 4 + live * DIM * 4 + live * N_ROWS + bucket
                  + live * splits * K * 8)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = 2 * N_ROWS * DIM * live / PEAK_FLOPS * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        timed[f"q{live}"] = row
    emit({"phase": "times", "nvidia_smi": smi, "n": N_ROWS, "d": DIM,
          "k": K, "metric": metric.value, "runs": timed,
          "failures": failures[:20]})
    if failures:
        sys.exit(f"scan_compare: {len(failures)} checks failed")


if __name__ == "__main__":
    main()
