"""Time variants of the batched fp32 top-k CUDA kernel
(``scan_topk_batch``) on one NVIDIA card, each held bit for bit against
the kernel as committed.

    python3 scripts/scan_variants.py [--out FILE]

Each variant is the committed ``csrc/scan_topk_batch.cu`` with a few lines
replaced, built with the same nvcc flags into ``build/scan_variants/`` (all
builds started together) and launched through its C entry point with the
committed launch plan, or with the plan of another shape or blocks per SM
where the variant says so.  A variant that does not build is reported
with its compiler's last lines.  Variants:

* ``no_selection``: every round's candidate bits read as none, so no list
  is ever written (its output is empty; timed only): the product, the
  keys, the staging and the barriers without the selection passes;
* ``no_product``: the products skipped (every key is the same; timed
  only): the staging, the barriers and a selection that admits almost
  nothing;
* ``ldg`` / ``ld_l2_256``: the corpus loads without an L2 prefetch size,
  or asking for 256 bytes instead of the committed 128;
* ``merge_flagged_only``: only the lists that overflow merge, not every
  half-full list with them;
* ``merge_smem``: every merge in shared memory (warp_merge), none in
  registers; ``narrow_merge_regs``: the narrow shape's too in registers;
* ``narrow_bk8``: the narrow shape staging 8 columns per chunk (half the
  staging registers, twice the barriers);
* ``mid_minb1``: the mid shape with its registers sized for one block per
  SM (no spills), and a plan of one block per SM.

At N = 1,000,000, D = 512, a per-query mask at selectivity 0.3, k = 50
(Q1's K), inner product: every variant but ``no_selection`` and
``no_product`` must give the committed kernel's answer after stage 2, bit
for bit; then each is timed (CUDA events, median of 10 after 3 warm-ups)
in two rounds (variants forward, then reversed) at the buckets its shape
serves: 1 and 8 (the narrow shape), 32 (30 live queries; the mid one) and
128 (100 live; the wide one).  ``-Xptxas -v``'s registers and spills are
reported per variant.  Prints one JSON line per phase; ``--out`` also
writes them.
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

N_ROWS, DIM, K = 1_000_000, 512, 50
MID = "using Mid = Shape<32, 256, 4, 8, 4, 16, 2>;"
NARROW = "using Narrow = Shape<8, 512, 4, 4, 16, 16, 2>;"
# the candidate bits of every round read as none (k is never that large,
# but the compiler cannot know it, so the keys stay live)
NO_SELECTION = [("      return bits;\n",
                 "      return k > (1 << 30) ? bits : 0u;\n")]
NO_PRODUCT = [("      product(buf0);\n", ""), ("      product(buf1);\n", "")]
LD_ROWS = (
    '  asm("ld.global.nc.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"\n')
ROW_LOAD = "        pre[s] = ld_rows(p);\n"
MERGE_ALSO = "          if (s_flag[qi] || 2 * s_cnt[qi] >= kp)\n"
REG_MERGE = "  if (S::BQ >= 32 && kp == 128)\n"


def prefetch(ahead: int) -> list:
    """An L2 prefetch of the same row `ahead` chunks on with each row
    unit's load."""
    return [(ROW_LOAD, ROW_LOAD + f"        if (c + {ahead} * BK < d)\n"
             '          asm volatile("prefetch.global.L2 [%0];" :: "l"'
             f"(p + {ahead} * BK));\n")]


def shape(old: str, args: str) -> list:
    """Replace the `using` line `old` by the same shape with `args`."""
    return [(old, old.split("<")[0] + "<" + args + ">;")]


# name: (line replacements, the buckets it is timed at, {the plan's
# queries per block: (queries per block this variant takes, blocks per SM
# its plan assumes)})
VARIANTS = {
    "committed": ([], (1, 8, 32, 128), {}),
    "no_selection": (NO_SELECTION, (1, 8, 32, 128), {}),
    "no_product": (NO_PRODUCT, (1, 8, 32, 128), {}),
    "ldg": ([(LD_ROWS, '  asm("ld.global.nc.v4.u32 {%0, %1, %2, %3}, '
              '[%4];"\n')], (1, 8, 32, 128), {}),
    "ld_l2_256": ([(LD_ROWS, LD_ROWS.replace("128B", "256B"))],
                  (1, 8, 32, 128), {}),
    "merge_flagged_only": ([(MERGE_ALSO, "          if (s_flag[qi])\n")],
                           (1, 8, 32, 128), {}),
    "merge_smem": ([(REG_MERGE, "  if (false)\n")], (1, 8, 32, 128), {}),
    "narrow_merge_regs": ([(REG_MERGE, "  if (kp == 128)\n")], (1, 8), {}),
    "narrow_bk8": (shape(NARROW, "8, 512, 4, 4, 16, 8, 2"), (1, 8), {}),
    "mid_minb1": (shape(MID, "32, 256, 4, 8, 4, 16, 1"), (32,),
                  {32: (32, 1)}),
}
TIMED_ONLY = ("no_selection", "no_product")
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
        sys.exit("scan_variants: no CUDA device; this script runs on the "
                 "card")

    from repro_torch.core.schema import Metric
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import scan_topk as st_mod
    from repro_torch.kernels.build import METRIC_CODES

    lines = []

    def emit(obj) -> None:
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out_dir = ROOT / "build" / "scan_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in build.HEADERS:
        (out_dir / header).write_text((build.CSRC / header).read_text())
    source = (build.CSRC / "scan_topk_batch.cu").read_text()
    procs = {}
    for name, (subs, *_) in VARIANTS.items():
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
        fn = lib.scan_topk_batch_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 3 + [I] + [P] * 3 + [I] * 9 + [P]
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
    metric = Metric.INNER_PRODUCT

    def call(name, qs, mask, valid):
        qn = qs.shape[0]
        qt, splits, rows = st_mod.batch_plan(N_ROWS, qn, K)
        if qt in VARIANTS[name][2]:
            qt, per_sm = VARIANTS[name][2][qt]
            splits, rows = st_mod.wave_splits(
                N_ROWS, qn, qt, st_mod.BATCH_SHAPES[qt][0], per_sm)
        keys = torch.empty((qn, splits * K), dtype=torch.float32,
                           device=dev)
        ids = torch.empty((qn, splits * K), dtype=torch.int32, device=dev)
        err = launchers[name](
            corpus.data_ptr(), qs.data_ptr(), mask.data_ptr(), 2,
            valid.data_ptr(), keys.data_ptr(), ids.data_ptr(), N_ROWS, DIM,
            qn, K, METRIC_CODES[metric], qt, rows, splits, 1,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed, cudaError {err}")
        return keys, ids

    def stage2(out):
        """The merged top-k (sims, ids) of a stage-1 output: variants
        with other splits give the same answer, bit for bit."""
        ids, sims, _ = ops._merge(*out, K, metric)
        return sims, ids

    for bucket, live in LIVE.items():
        names = [n for n in launchers if bucket in VARIANTS[n][1]]
        qs = torch.randn((bucket, DIM), generator=gen, device=dev)
        qs /= qs.norm(dim=-1, keepdim=True)
        mask = (torch.rand((bucket, N_ROWS), generator=gen, device=dev)
                < 0.3).to(torch.int8)
        valid = (torch.arange(bucket, device=dev) < live).to(torch.int8)
        want = stage2(call("committed", qs, mask, valid))
        for name in names:
            if name in TIMED_ONLY:
                continue
            got = stage2(call(name, qs, mask, valid))
            if not (torch.equal(got[0].view(torch.int32),
                                want[0].view(torch.int32))
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name} bucket {bucket}: not the "
                                     "committed answer")
        ms = {name: [] for name in names}
        for name in names + names[::-1]:
            ms[name].append(time_ms(lambda: call(name, qs, mask, valid)))
        emit({"phase": "times", "nvidia_smi": smi, "bucket": bucket,
              "live": live, "n": N_ROWS, "d": DIM, "k": K,
              "plan": list(st_mod.batch_plan(N_ROWS, bucket, K)), "ms": ms})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
