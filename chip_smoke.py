"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

The main path is Q1 VKNN-SF, the paper's filtered vector top-k, from SQL
text through ``connect -> prepare -> execute`` under
``engine="brute", use_pallas=True``, on the laion1m shape (1,000,000 rows of
512-d fp32 vectors, 100 queries, K = 50; configs/chase_laion.py).  Phases,
one JSON line each:

  env      the card (the nvidia-smi line is also printed as it is), torch
           and CUDA versions, TF32 flags (both off)
  build    nvcc build of every kernel source, all started together
  sweep    each kernel against its plain PyTorch version on small inputs:
           metrics, mask kinds, pad queries, ragged N and D, k in
           {1, 10, 50, 200, 1000}, k beyond the live rows, duplicate rows
  full     each kernel against its plain version at the main path's shapes
  slice    Q1 through the session API: single dicts, lists of 1/8/64/100
           (buckets 1/8/64/128), a stacked dict, exact_shape (and the Q = 1
           fast path); every answer held against use_pallas=False, and both
           kernels' launch counters must advance
  times    per kernel: its time, its plain version's, the library yardstick
           (torch.matmul + torch.topk, timed only), the bound
  e2e      execute latency and QPS per batch size
then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failure raises and exits non-zero without the last line.

Tolerance: 1e-5 at D <= 130 and 1e-4 at D = 512 on sims and on the key gap
that may reorder a near-tie (fp32 sums of up to 512 unit-scale products
taken in a different order).
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

N_ROWS, N_QUERIES, DIM, N_MODES, K = 1_000_000, 100, 512, 256, 50
SELECTIVITY = 0.3
BATCHES = (1, 8, 64, 100)
Q1 = ("SELECT sample_id FROM products WHERE price < ${p} "
      "ORDER BY DISTANCE(embedding, ${qv}) LIMIT ${K}")
Q1_NOFILTER = ("SELECT sample_id FROM products "
               "ORDER BY DISTANCE(embedding, ${qv}) LIMIT ${K}")
# published dense peaks (NVIDIA data sheets): bytes/s, fp32 CUDA-core FLOP/s
PEAKS = {"PCIe": (2.0e12, 51.2e12), "NVL": (3.9e12, 60.0e12),
         "SXM": (3.35e12, 67.0e12)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks_for(name: str) -> tuple[float, float]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def time_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Median device time of one call, by CUDA events."""
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


def slab(keys, ids, k: int) -> dict:
    """A stage-1 output as one top-k row per (query, split): the tie rule
    applies within each split's list."""
    keys, ids = keys.reshape(-1, k), ids.reshape(-1, k)
    return {"ids": ids, "sim": keys, "valid": torch.isfinite(keys)}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.api import ExecutionHints, connect
    from repro_torch.core.expr import evaluate, evaluate_batch
    from repro_torch.core.schema import Metric
    from repro_torch.data import make_laion_catalog, selectivity_threshold
    from repro_torch.kernels import build
    from repro_torch.kernels import scan_topk as st_mod
    from repro_torch.testing import assert_topk_close

    # -- env ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    bw, flops = peaks_for(name)
    emit({"phase": "env", "nvidia_smi": smi, "device": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
          "peak_bytes_per_s": bw, "peak_fp32_flops": flops})
    dev = torch.device("cuda")

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    ptxas = []
    for src in build.SOURCES:
        log = build.target(src).with_suffix(".log")
        if log.exists():
            ptxas += [f"{src}: {ln.split('info    :')[-1].strip()}"
                      for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": built, "ptxas": ptxas})

    # -- sweep: each kernel against its plain version ------------------------
    max_err = {"scan_topk": 0.0, "scan_topk_batch": 0.0}
    cases = {"scan_topk": 0, "scan_topk_batch": 0}
    rng = np.random.default_rng(0)

    def unit(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        return torch.from_numpy(x).to(dev)

    def check_single(corpus, q, mask, k, metric, tol, what):
        got = st_mod.scan_topk(corpus, q, mask, k, metric)
        want = st_mod.scan_topk_plain(corpus, q, mask, k, metric)
        torch.cuda.synchronize()
        err = assert_topk_close(slab(*got, k), slab(*want, k), atol=tol,
                                tie_tol=tol, what=what)
        max_err["scan_topk"] = max(max_err["scan_topk"], err)
        cases["scan_topk"] += 1

    def check_batch(corpus, qs, mask, qvalid, k, metric, tol, what):
        got = st_mod.scan_topk_batch(corpus, qs, mask, qvalid, k, metric)
        want = st_mod.scan_topk_batch_plain(corpus, qs, mask, qvalid, k,
                                            metric)
        torch.cuda.synchronize()
        err = assert_topk_close(slab(*got, k), slab(*want, k), atol=tol,
                                tie_tol=tol, what=what)
        max_err["scan_topk_batch"] = max(max_err["scan_topk_batch"], err)
        cases["scan_topk_batch"] += 1

    for n, d in ((5003, 130), (4099, 64), (3001, 512)):
        tol = 1e-4 if d > 130 else 1e-5
        corpus = unit((n, d))
        corpus[n // 3: n // 3 + 40] = corpus[7]          # exact duplicates
        for metric in Metric:
            for k in (1, 10, 50):
                q = corpus[7].clone() if k == 50 else unit((d,))
                for mname, mask in (("none", None),
                                    ("shared", torch.rand(n, device=dev)
                                     < 0.5)):
                    m8 = None if mask is None else mask.to(torch.int8)
                    check_single(corpus, q, m8, k, metric, tol,
                                 f"single {metric.value} n={n} d={d} k={k} "
                                 f"{mname}")
                for qn in (1, 8, 37):
                    qs = unit((qn, d))
                    qs[0] = corpus[7]                    # hits the duplicates
                    qv = (torch.arange(qn, device=dev) < max(1, qn - 3))
                    for mname in ("none", "shared", "per_query"):
                        mask = {"none": None,
                                "shared": torch.rand(n, device=dev) < 0.5,
                                "per_query": torch.rand((qn, n), device=dev)
                                < 0.3}[mname]
                        m8 = None if mask is None else mask.to(torch.int8)
                        check_batch(corpus, qs, m8, qv.to(torch.int8), k,
                                    metric, tol,
                                    f"batch {metric.value} n={n} d={d} k={k} "
                                    f"q={qn} {mname}")
    # k beyond the live rows, and the large-k block shapes (16 and 4 queries)
    corpus = unit((2500, 96))
    sparse = torch.zeros(2500, dtype=torch.int8, device=dev)
    sparse[[0, 999, 1000, 2499]] = 1
    check_single(corpus, unit((96,)), sparse, 10, Metric.L2, 1e-5,
                 "single k > live rows")
    check_batch(corpus, unit((5, 96)), sparse, None, 10, Metric.L2, 1e-5,
                "batch k > live rows")
    for k, qn in ((200, 20), (1000, 6), (1024, 3)):
        check_batch(corpus, unit((qn, 96)), None, None, k, Metric.COSINE,
                    1e-5, f"batch k={k}")
        check_single(corpus, unit((96,)), None, k, Metric.COSINE, 1e-5,
                     f"single k={k}")
    emit({"phase": "sweep", "cases": cases, "max_abs_err": max_err})

    # -- the catalog at full width -------------------------------------------
    t0 = time.perf_counter()
    cat = make_laion_catalog(n_rows=N_ROWS, n_queries=N_QUERIES, dim=DIM,
                             n_modes=N_MODES, seed=0, device="cuda")
    torch.cuda.synchronize()
    table = cat.table("products")
    corpus = table["embedding"]
    price = table["price"]
    p = np.float32(selectivity_threshold(price, SELECTIVITY))
    qv = cat.table("queries")["embedding"].cpu().numpy()
    setup_s = time.perf_counter() - t0

    # -- full: each kernel at the main path's shapes ---------------------------
    db = connect(cat, engine="brute", use_pallas=True)
    stmt = db.prepare(Q1, K=K)
    pred = stmt.compiled.analysis.structured_predicate
    single_mask = evaluate(pred, table, {"p": p}).view(torch.int8)
    single_q = torch.from_numpy(qv[0]).to(dev)
    bucket = 128
    batch_binds = {"qv": np.concatenate([qv, np.repeat(qv[-1:], 28, 0)]),
                   "p": np.full(bucket, p, np.float32)}
    batch_q = torch.from_numpy(batch_binds["qv"]).to(dev)
    batch_mask = evaluate_batch(pred, table, batch_binds,
                                bucket).contiguous().view(torch.int8)
    batch_qvalid = (torch.arange(bucket, device=dev)
                    < N_QUERIES).to(torch.int8)
    metric = Metric.INNER_PRODUCT
    check_single(corpus, single_q, single_mask, K, metric, 1e-4,
                 "single full shape")
    check_batch(corpus, batch_q, batch_mask, batch_qvalid, K, metric, 1e-4,
                "batch full shape")
    emit({"phase": "full", "n": N_ROWS, "d": DIM, "k": K,
          "catalog_setup_s": setup_s,
          "single_blocks": st_mod.single_plan(N_ROWS)[0],
          "batch_plan": list(st_mod.batch_plan(N_ROWS, bucket, K)),
          "max_abs_err": max_err})

    # -- slice: Q1 through the session API -----------------------------------
    nofilter = db.prepare(Q1_NOFILTER, K=K)
    binds = [{"qv": qv[i], "p": p} for i in range(N_QUERIES)]
    stacked = {"qv": qv, "p": np.full(N_QUERIES, p, np.float32)}
    exact = ExecutionHints(exact_shape=True)
    runs = []
    st_mod.scan_topk.launches = 0
    st_mod.scan_topk_batch.launches = 0
    for i in range(3):
        runs.append(("single", binds[i], None, stmt))
    for qn in BATCHES:
        runs.append((f"list{qn}", binds[:qn], None, stmt))
    runs.append(("stacked", stacked, None, stmt))
    runs.append(("exact_shape", stacked, exact, stmt))
    runs.append(("fast_path", {"qv": qv[:1]}, exact, nofilter))
    results = [(label, b, h, s, s.execute(b, hints=h))
               for label, b, h, s in runs]
    torch.cuda.synchronize()
    launches = {"scan_topk": st_mod.scan_topk.launches,
                "scan_topk_batch": st_mod.scan_topk_batch.launches}
    for kname, count in launches.items():
        if count < 1:
            raise AssertionError(f"main path never launched {kname}")
    plain_db = connect(cat, engine="brute", use_pallas=False)
    checked = {}
    price_np = price.cpu().numpy()
    for label, b, h, s, res in results:
        want = plain_db.prepare(s.sql, K=K).execute(b, hints=h)
        torch.cuda.synchronize()
        err = assert_topk_close(res.data, want.data, atol=1e-4, tie_tol=1e-4,
                                what=f"slice {label}")
        ids = res["ids"].cpu().numpy().reshape(-1, K)
        valid = res["valid"].cpu().numpy().reshape(-1, K)
        sims = res["sim"].cpu().numpy().reshape(-1, K)
        if not np.isfinite(sims).all() or not valid.all():
            raise AssertionError(f"slice {label}: non-finite or short result")
        if s is stmt and not (price_np[ids[valid]] < p).all():
            raise AssertionError(f"slice {label}: a row fails price < p")
        if (np.diff(sims, axis=1) > 0).any():
            raise AssertionError(f"slice {label}: sims not descending")
        checked[label] = {"shape": list(res["ids"].shape),
                          "max_abs_err": err,
                          "path": res.explain().path,
                          "bucket": res.explain().bucket}
    emit({"phase": "slice", "launches": launches, "runs": checked,
          "trace_counts": {str(b): c for b, c in
                           stmt.explain().trace_counts.items()},
          "cache": list(map(int, (db.cache_info().hits,
                                  db.cache_info().misses)))})

    # -- times ----------------------------------------------------------------
    nb, _rows = st_mod.single_plan(N_ROWS)
    qt, splits, _ = st_mod.batch_plan(N_ROWS, bucket, K)
    live_q = int(batch_qvalid.sum())
    single_bytes = N_ROWS * DIM * 4 + DIM * 4 + N_ROWS + nb * K * 8
    single_ops = 2 * N_ROWS * DIM
    batch_bytes = (N_ROWS * DIM * 4 + live_q * DIM * 4 + live_q * N_ROWS
                   + bucket + live_q * splits * K * 8)
    batch_ops = 2 * N_ROWS * DIM * live_q

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
            "operations"

    def lib_single():
        keys = -(corpus @ single_q)
        keys = keys.masked_fill(single_mask == 0, float("inf"))
        return torch.topk(keys, K, largest=False)

    def lib_batch():
        keys = -(batch_q @ corpus.T)
        keys = keys.masked_fill(batch_mask == 0, float("inf"))
        keys = keys.masked_fill((batch_qvalid == 0)[:, None], float("inf"))
        return torch.topk(keys, K, dim=1, largest=False)

    times = {}
    t_single = time_ms(lambda: st_mod.scan_topk(corpus, single_q,
                                                single_mask, K, metric))
    t_batch = time_ms(lambda: st_mod.scan_topk_batch(
        corpus, batch_q, batch_mask, batch_qvalid, K, metric))
    b_single, by_single = bound(single_bytes, single_ops)
    b_batch, by_batch = bound(batch_bytes, batch_ops)
    times["scan_topk"] = {
        "ms": t_single,
        "plain_ms": time_ms(lambda: st_mod.scan_topk_plain(
            corpus, single_q, single_mask, K, metric)),
        "library_ms": time_ms(lib_single),
        "bound_ms": b_single, "bound_by": by_single}
    times["scan_topk_batch"] = {
        "ms": t_batch,
        "plain_ms": time_ms(lambda: st_mod.scan_topk_batch_plain(
            corpus, batch_q, batch_mask, batch_qvalid, K, metric), 2, 5),
        "library_ms": time_ms(lib_batch, 2, 5),
        "bound_ms": b_batch, "bound_by": by_batch}
    emit({"phase": "times", "device": name, "nvidia_smi": smi,
          "shapes": {"n": N_ROWS, "d": DIM, "k": K, "bucket": bucket,
                     "live_queries": live_q, "qt": qt, "splits": splits,
                     "single_blocks": nb},
          "kernels": times})

    # -- e2e -------------------------------------------------------------------
    def latency_ms(b, iters: int = 10) -> float:
        for _ in range(2):
            stmt.execute(b)
        torch.cuda.synchronize()
        out = []
        for _ in range(iters):
            t = time.perf_counter()
            stmt.execute(b)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return statistics.median(out)

    e2e = {"single": latency_ms(binds[0])}
    for qn in BATCHES:
        e2e[f"batch{qn}"] = latency_ms(binds[:qn])
    emit({"phase": "e2e", "device": name, "nvidia_smi": smi,
          "latency_ms": e2e,
          "qps": {key: (1 if key == "single" else int(key[5:])) * 1e3 / v
                  for key, v in e2e.items()}})

    sources = {"scan_topk": "src/repro_torch/kernels/csrc/scan_topk.cu",
               "scan_topk_batch":
                   "src/repro_torch/kernels/csrc/scan_topk_batch.cu"}
    replaces = {"scan_topk": "src/repro/kernels/scan_topk.py:241",
                "scan_topk_batch": "src/repro/kernels/scan_topk.py:189"}
    emit({"kernels": [
        {"name": kname, "route": "cuda", "source": sources[kname],
         "replaces": replaces[kname], "launches": launches[kname],
         "max_abs_err": max_err[kname], **times[kname]}
        for kname in ("scan_topk_batch", "scan_topk")]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
