"""Hold the ``pairwise_keys`` CUDA kernel against an earlier version of it
on one NVIDIA card: keys bit for bit, and times in turns.

    python3 scripts/pairwise_compare.py --parent DIR [--out FILE]

DIR is a checkout of the earlier commit (for example ``git archive <commit>
| tar x -C build/parent``).  Its ``csrc/pairwise_keys.cu`` (with the headers
beside it) is built with the same nvcc flags into ``build/parent_kernels/``
and launched through its own C entry point, with that version's launch plan
(queries per block 4, 16 or 64, and about 264 blocks of 64-row tiles).

Checks, at (n, d) in {(5003, 130), (4099, 64), (3001, 512)} and Q in
{1, 8, 37, 100, 130}, every metric: this tree's keys equal the earlier
kernel's bit for bit; for inner product and cosine they equal
``replay_keys`` over all rows; row i of the Q-query call equals the
single-query call for query i; and they agree with the plain version within
1e-5 (1e-4 at D = 512).  Then both kernels are timed at N = 1,000,000,
D = 512 and Q in {1, 8, 100}, for inner product and cosine (CUDA events,
median of 10 after 3 warm-ups), in the order earlier, this, this,
earlier, beside one ``torch.matmul``.
Prints one JSON line per phase; ``--out`` also writes them to a file.
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
TIMED_QS = (1, 8, 100)
N_ROWS, DIM = 1_000_000, 512


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def parent_plan(n: int, qn: int) -> tuple[int, int, int]:
    """(queries per block, rows per split, splits) of the earlier kernel:
    the smallest of 4, 16, 64 queries that holds Q, and about 264 blocks,
    each split a whole number of 64-row tiles."""
    qt = next((t for t in (4, 16, 64) if t >= qn), 64)
    tiles = max(1, cdiv(n, 64))
    want = max(1, cdiv(264, cdiv(qn, qt)))
    rows = cdiv(tiles, min(tiles, want)) * 64
    return qt, rows, cdiv(n, rows)


def build_parent(parent: Path, nvcc: str, flags) -> tuple:
    src = parent / "src/repro_torch/kernels/csrc/pairwise_keys.cu"
    out_dir = ROOT / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "pairwise_keys_parent.so"
    proc = subprocess.run([nvcc, *flags, "-o", str(lib_path), str(src)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.pairwise_keys_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 3 + [I] * 7 + [P]
    fn.restype = ctypes.c_int
    log = proc.stdout + proc.stderr
    return fn, [ln.split("info    :")[-1].strip() for ln in log.splitlines()
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
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("pairwise_compare: no CUDA device; this script runs on the "
                 "card")
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core.schema import Metric
    from repro_torch.kernels import build
    from repro_torch.kernels import distance as dist_mod
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
    dev = torch.device("cuda")
    built = build.build(("pairwise_keys.cu", "replay_keys.cu"))
    log = build.target("pairwise_keys.cu").with_suffix(".log").read_text()
    parent_fn, parent_ptxas = build_parent(args.parent, build._nvcc(),
                                            build.FLAGS)
    emit({"phase": "build", "nvidia_smi": smi, "seconds": built,
          "ptxas": [ln.split("info    :")[-1].strip()
                    for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln],
          "parent_ptxas": parent_ptxas})

    def parent_keys(qs, corpus, metric):
        n, d = corpus.shape
        qn = qs.shape[0]
        out = torch.empty((qn, n), dtype=torch.float32, device=dev)
        qt, rows, splits = parent_plan(n, qn)
        err = parent_fn(corpus.data_ptr(), qs.data_ptr(), out.data_ptr(), n,
                        d, qn, METRIC_CODES[metric], qt, rows, splits,
                        torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent pairwise_keys launch: error {err}")
        return out

    def bits(x):
        return x.contiguous().view(torch.int32)

    gen = torch.Generator(device=dev).manual_seed(0)

    def unit(shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return x / x.norm(dim=-1, keepdim=True)

    checked = 0
    max_err = 0.0
    for n, d in SMALL:
        tol = 1e-4 if d > 130 else 1e-5
        corpus = unit((n, d))
        all_rows = torch.arange(n, dtype=torch.int32, device=dev)
        for metric in Metric:
            for qn in QS:
                what = f"{metric.value} n={n} d={d} q={qn}"
                qs = unit((qn, d))
                got = dist_mod.pairwise_keys(qs, corpus, metric)
                old = parent_keys(qs, corpus, metric)
                if not torch.equal(bits(got), bits(old)):
                    raise AssertionError(f"{what}: not the earlier kernel's "
                                         "keys")
                if metric != Metric.L2:
                    rep = qt_mod.replay_keys(
                        corpus, qs, all_rows.expand(qn, n).contiguous(),
                        metric)
                    if not torch.equal(bits(got), bits(rep)):
                        raise AssertionError(f"{what}: not replay_keys' keys")
                for i in range(qn):
                    one = dist_mod.pairwise_keys(qs[i:i + 1].contiguous(),
                                                 corpus, metric)
                    if not torch.equal(bits(one[0]), bits(got[i])):
                        raise AssertionError(f"{what}: row {i} is not the "
                                             "single-query call")
                want = dist_mod.pairwise_keys_plain(qs, corpus, metric)
                err = float((got - want).abs().max())
                if not err <= tol:
                    raise AssertionError(f"{what}: {err} > {tol} vs plain")
                max_err = max(max_err, err)
                checked += 1
    emit({"phase": "check", "cases": checked, "max_abs_err_vs_plain": max_err,
          "bitwise": ["earlier kernel, every metric",
                      "replay_keys, ip and cosine",
                      "row of batch = single query, every metric"]})

    corpus = unit((N_ROWS, DIM))
    for metric in (Metric.INNER_PRODUCT, Metric.COSINE):
        times = {}
        for qn in TIMED_QS:
            qs = unit((qn, DIM))
            new = lambda: dist_mod.pairwise_keys(qs, corpus,  # noqa: E731
                                                 metric)
            old = lambda: parent_keys(qs, corpus, metric)  # noqa: E731
            if not torch.equal(bits(new()), bits(old())):
                raise AssertionError(f"q={qn}: full shape differs from "
                                     "earlier")
            got = {"earlier": [], "this": []}
            for label, fn in (("earlier", old), ("this", new),
                              ("this", new), ("earlier", old)):
                got[label].append(time_ms(fn))
            times[qn] = {"earlier_ms": got["earlier"],
                         "this_ms": got["this"],
                         "matmul_ms": time_ms(
                             lambda: torch.matmul(qs, corpus.T)),
                         "plan": list(dist_mod.pairwise_plan(N_ROWS, qn)),
                         "parent_plan": list(parent_plan(N_ROWS, qn))}
        emit({"phase": "times", "nvidia_smi": smi, "n": N_ROWS, "d": DIM,
              "metric": metric.value, "by_q": times})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
