"""Drive the PyTorch/CUDA port's paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Six query paths, each from SQL text through ``connect -> prepare ->
execute`` under ``engine="brute", use_pallas=True``, and the public
``repro_torch.kernels.pairwise_keys``, on the laion1m shape (1,000,000 rows
of 512-d fp32 vectors, 100 queries; configs/chase_laion.py's
``bench_config()`` at the paper's scale):

  Q1  VKNN-SF, the filtered vector top-k, K = 50, ``price < p`` at
      selectivity 0.3 (kernels scan_topk, scan_topk_batch);
  Q2  DR-SF, the filtered range scan ``DISTANCE <= r AND price < p``,
      result buffer 4096 (the EngineOptions default) (range_topk_batch,
      the range tile compacting each query's hits on the card; the
      single-dict plan is the reference's kernel-less lowering);
  Q3  the distance join of the 100 queries with the corpus on
      ``DISTANCE <= r AND images.capture_date > queries.capture_date``,
      max_pairs 512 (benchmarks/q3_distjoin.py), under the batch lowering
      (range_topk_batch) and the perleft one (range_scan, one launch per
      left row);
  Q4  the KNN join of 100 users with the 1M movies on
      ``users.preferred_rating = movies.rating``, K = 50
      (benchmarks/q4_knnjoin.py), under the batch lowering
      (scan_topk_batch), the perleft one (scan_topk, one launch per left
      row) and ``engine="brute_sort"`` (pairwise_keys and a full sort), and
      with a ``release_year >= y`` bind as a list of two bind sets;
  Q5  the category partition ``DISTANCE <= r AND cuisine <> 3``, top 10 per
      calorie level (8 levels; benchmarks/q5q6_category.py), result buffer
      4096: single dicts (the reference's kernel-less lowering), lists of
      1, 8, 64 and 100, stacked, exact_shape (range_topk_batch);
  Q6  the category join of the 100 queries with the corpus on
      ``DISTANCE <= r AND queries.cuisine <> recipes.cuisine``, top 10 per
      (query, level): batch lowering and a list of 4 radii
      (range_topk_batch), perleft (kernel-less, as in the reference);
  pairwise_keys  the (100, 1M) order-key matrix;

and Q1–Q3 again under ``EngineOptions(quant="int8")`` and ``quant="bf16"``:
the batched scans stream the corpus's int8 or bf16 twin and re-rank their
candidates with exact fp32 keys (quant_scan_topk_batch for Q1,
quant_keys_batch for Q2 and Q3, replay_keys for both; a Q2 band wider than
the replay budget runs range_topk_batch itself).  Every quantized answer
must equal the fp32 ``use_pallas=True`` answer of the same call bit for bit.
Q4, Q5 and Q6's batched lowerings run under both modes too, held the same
way.  Then Q1–Q6 run over the IVF index under the paper's own engines
(``ivf`` and ``ivf_joins`` below).

The radius is the paper's: the median over the 100 queries of each query's
120th-best similarity (benchmarks/common.py, range_match_target).  Phases,
one JSON line each:

  env      the card (the nvidia-smi line is also printed as it is), torch
           and CUDA versions, TF32 flags (both off)
  build    nvcc build of every kernel source, all started together
  sweep    each kernel against its plain PyTorch version on small inputs:
           metrics, mask kinds, pad queries, ragged N and D, D = 512; top-k
           k in {1, 10, 50, 200, 1000}, k beyond the live rows, duplicate
           rows; range radii that hit nothing, everything, or lie exactly
           on duplicate rows, and the compaction below and beyond the count;
           the quantized kernels in int8 and bf16, N % 8 != 0, segment
           counts c·k for k in {1, 10, 50, 512} and c in {1, 2};
           pairwise_keys at 3 metrics, Q in {1, 37, 130}, N in {1, 513,
           5003}, D in {1, 64, 130, 512}, and bf16 inputs
  replay   replay_keys against the fp32 batched kernels' own keys, bit for
           bit, at each block shape of scan_topk_batch (8, 32 and 64
           queries per block) and every metric
  pairwise_bits  pairwise_keys bit for bit: against replay_keys over all
           rows (inner product, cosine) and row i of a Q-query call against
           the single-query call (every metric), at (n, d) in {(5003, 130),
           (4099, 64), (3001, 512)} and Q in {1, 8, 37, 100, 130}
  topk_bits  scan_topk_batch bit for bit: its keys (int32 view) and ids
           equal scan_topk_batch_replayed (replay_keys over all rows,
           masked; each split's best k), every metric, masks none, shared
           and per-query with dead valid lanes, k in {1, 50, 200, 1000}
           (every block shape and list length), at the pairwise_bits
           shapes with Q in {1, 8, 20, 37, 100, 130}, at 1,000,003 x 64
           with Q in {8, 40} (splits of many tiles), and on a corpus whose
           every row beats the one before it (each insertion round
           overflows); row i of a Q-query call gives the single-query
           call's stage-2 answer
  quant_bits  quant_scan_topk_batch bit for bit: its keys (int32 view) and
           ids equal quant_scan_topk_batch_replayed (replay_keys over the
           dequantized rows, masked; each 8-row segment's minimum; each
           split's best), int8 and bf16, every metric, masks none, shared
           and per-query, count ceil(N / 8) (every segment emitted), 100
           and 150, at the pairwise_bits shapes, and at 1,000,003 x 64 with
           Q in {8, 40} and count in {150, 600, 1024} (lists of 256 and
           1,024 entries); row i of a Q-query call gives the single-query
           call's candidate_rows
  range_bits  range_scan_batch bit for bit: its keys (int32 view), hits and
           counts equal range_scan_batch_replayed (replay_keys over all
           rows, then the mask, the valid lane and the radius), every
           metric, masks none, shared and per-query with dead valid lanes,
           radii at the 100th-best key (one on duplicate rows), below and
           above every key, at the pairwise_bits shapes with Q in {1, 8,
           16, 17, 37, 100, 128, 130} (every block shape, a second query
           tile) and at 1,000,003 x 64 with Q in {8, 100}; row i of a
           Q-query call equals the single-query call.  Line
           range_append_bits: the append mode (range_topk_batch: the
           tile's APPEND epilogue and the per-query sort) and
           ops.fused_range_topk_batch equal compact_range of the dense
           keys bit for bit (ids, sims, valid, counts), every metric, mask
           kind and dead lanes, capacities 16 (the dense fallback), 4,096
           and 6,000, Q in {1, 8, 17, 100, 128, 130} and at 1,000,003 x 64;
           the sort kernel alone on crafted words (±0.0 ties, ±inf hits,
           shuffled slots)
  keys_bits  quant_keys_batch bit for bit: its keys (int32 view) equal
           quant_keys_batch_replayed (replay_keys over the dequantized
           rows, then the mask and the valid lane) and range_scan_batch's
           keys on the dequantized twin with every radius at +inf, int8 and
           bf16, every metric, masks none, shared and per-query with dead
           valid lanes, at the pairwise_bits shapes with Q in {1, 8, 16,
           17, 37, 64, 100, 128, 130} and at 1,000,003 x 64 with Q in {8,
           100}; row i of a Q-query call equals the single-query call
  full     each kernel against its plain version at the paths' shapes
           (pairwise_keys at 100 x 1M x 512, every metric)
  slice    Q1–Q6 through the session API: single dicts, lists,
           stacked dicts, exact_shape; every answer held against
           use_pallas=False on the card; each path's kernels' launch
           counters must advance (counters set to 0 before each path);
           Q5's single dicts and Q6's perleft lowering must launch none
  slice_quant  Q1–Q3 and the batched Q4–Q6 under int8 and bf16, every
           answer equal bit
           for bit to the fp32 use_pallas=True answer; a Q2 call forced
           into the full branch; Q1's coverage (queries whose fp32 top-K
           has a row outside the quantized candidates)
  ivf      the IVF index built on the card (256 lists, 10 k-means
           iterations; the repo's laion settings) and registered on the
           tables Q1 and Q2 scan, then Q1 and Q2 under engine chase, vbase
           and pase (single dicts, lists of 1, 8, 64, 100), held to five
           gates: at probe_batch 1 each row of chase's list of 100 equals
           its single dict (probes, evals, count and valid exactly);
           termination "bound" returns the flat fp32 kernels' answers (Q2
           as a set); termination "counter" returns rows that pass the
           predicate with their flat sims (recall@50 and mean probes
           reported); chase under int8 and bf16 equals fp32 chase with
           torch.equal; ExecutionHints(probe_budget=4) and a per-query
           tuple cap every query's probes.  The probes launch no kernel;
           pase Q2 is the flat range scan.  Lines ``ivf_build`` (k-means,
           assign and list times, cap, list sizes), ``e2e_ivf`` (latency,
           QPS, peak memory, probe rounds and host syncs per execute, per
           engine and list size, beside the flat path; latency at each
           active-check cadence) and ``ivf_profile`` (chase at the list of
           100: gather, product, merge and host shares by CUDA events,
           device time per operator by torch.profiler)
  ivf_joins  the same index registered on the tables Q4, Q5 and Q6 scan;
           Q3, Q4 and Q6 over the 100 query rows in the batch and perleft
           lowerings under chase, vbase and pase (Q6 also
           chase_no_updatestate), a list of 4 bind sets (400 left rows;
           Q4 with its release_year bind) under chase, and Q5 as single
           dicts and lists of 1, 8, 64, 100 under the four engines, held to
           six gates: batch = perleft row for row (Q3, Q6 under chase and
           vbase, Q4 under chase; Q5: row q of the list of 100 = query q's
           single dict), counters included; termination "bound" (every
           cluster allowed) returns the flat answers (Q4 top-k; Q3 hit sets
           where the flat buffer holds every hit; Q5 and Q6 each category
           list chase returns, where no buffer overflowed; the categories
           chase never saw are counted; chase_no_updatestate too, with
           chase's probes and latency beside its own: Algorithm 2's
           effect); termination "counter" returns rows
           that pass the predicate and the radius with their flat sims
           (recall and mean probes reported, chase beside
           chase_no_updatestate); chase under int8 and bf16 equals fp32
           chase with torch.equal; ExecutionHints(probe_budget=4) and a
           per-bind-set tuple cap every left row's probes; the probes
           launch no kernel and each flat fallback (pase Q3, Q5, Q6, vbase
           and pase Q4) launches the kernels its path launches with no
           index.  Lines ``e2e_ivf_joins`` (latency, left rows per second,
           peak memory, probe rounds and host syncs per execute, per query,
           engine, lowering and list, beside the flat path) and
           ``ivf_category_profile`` (chase Q6 at 100 left rows: cluster
           order, gather, product, one-hot, per-category key merge, append
           and host shares by CUDA events)
  serve    Q1 served through the serving tier (db.serve's BatchScheduler
           and ResilientScheduler, and the QueryServer front door), flat
           (brute, use_pallas=True: the drains launch scan_topk_batch) and
           under chase over the ivf phase's index; requests are single
           bind dicts over the 100 queries, 7 of every 8 at selectivity 0.3
           and the 8th at about 0.002 (so probe counts vary).  Four gates:
           every request coalesced by the BatchScheduler (max_batch 32,
           max_wait_ms 5, a virtual clock) equals its row of a direct
           execute of the same drained list bit for bit and its own single
           dict under the tie rule; run_effort_bucketed at a pilot of p75 +
           1 of a lock-step run's probes equals the lock-step run bit for
           bit with a real light/heavy split (chase Q1, a list of 64), and
           so do the chase Q3 list of 4 bind sets under
           ExecutionHints(pilot_budget=...) and at a per-bind-set budget
           (the (Q, L) branch); under seeded faults (kernel errors, latency
           spikes, poisoned binds, catalog bumps re-registering the index)
           the failed count equals the members of the failed batches, shed
           requests never reach an execute, and served answers equal a
           direct execute after the bumps; a burst past the DegradePolicy
           watermarks reports degraded answers within their level's probe
           budget, undegraded drains equal lock-step (recall@50 of the
           degraded answers against the flat one reported).  Line
           ``e2e_serve``: the naive per-request loop and the scheduler's
           virtual-clock simulation (real synchronised service times) at
           Poisson arrivals of 0.3, 1 and 3 x the measured batch capacity
           (512 requests flat, 256 chase): p50, p95, mean latency and QPS;
           per drain at batches of 1, 8 and 32, the drain's host time beside
           the CUDA-event time of its execute and the device's busy time
           by torch.profiler (the host share); QueryServer wall clock and
           outcomes over a staggered-then-burst run, plus one under faults
  times    per kernel: its time, its plain version's, the library
           yardstick (timed only), the bound; scan_topk_batch and
           range_scan_batch also at buckets 1, 8, 32 and 128,
           quant_keys_batch at buckets 1, 8, 32, 64 and 128 and
           quant_scan_topk_batch at Q in {1, 8, 100}, each beside its
           yardstick, and pairwise_keys at Q in {1, 8, 100} beside one
           torch.matmul; every kernel and yardstick both as one call
           between an event pair and per call over a back-to-back run
  e2e      execute latency and QPS per batch size (Q1, Q2, Q5) and per
           join lowering (Q3, Q4, Q6); beside each the kernel's and the
           stage-2 time at the same shapes (compaction, merge, full sort,
           category rank), and the peak memory; the quantized Q1–Q6 paths'
           beside the fp32 ones (Q4: one bind set and the list of two)
  live     (after serve) a live corpus (``db.attach_live``) on
           products.embedding of a catalog sharing the frozen tables:
           delta_cap 4,096, so cap_main = ceil8(N + 4 x 4,096) = 1,016,384,
           and an IVF of 256 lists over its filled slots; Q1–Q6 over it
           (Q2–Q6's texts naming products) flat (brute, use_pallas=True),
           plain, under chase and under int8 / bf16 (Q1, Q2), every
           statement prepared before any mutation.  Five gates: at zero
           delta, live Q1 (a single dict, lists of 1, 8, 64, 100) equals
           the frozen plan bit for bit with cap_main evals a query, and
           chase recall@50 against live flat >= 0.99 (the reference's
           padded-segment index's recall reported beside); after 2,048
           inserts in 4 batches (64 near-duplicates of queries), 10
           insert -> visible and delete -> invisible samples, a fill to
           4,096 and 1,016 deletes (1,000 from the top-50 lists), every
           flat Q1–Q6 answer holds against use_pallas=False (1e-4) and,
           at the user-id level, a frozen catalog of the survivors; no
           deleted row anywhere, each near-duplicate its query's first
           hit (flat and chase), quantized Q1 and Q2 equal fp32 bit for
           bit, no executor rebuilt; after compact(), flat and chase equal
           a fresh attach of the survivors bit for bit; a crash at
           wal.torn_append and at compact.post_log recovers from disk
           alone to the unfailed state's answers bit for bit; through
           QueryServer, submit_mutation's near-duplicates of 8 queries are
           their first hits.  The kernels each flat path launches are
           counted (the chase paths launch none).  Line ``e2e_live``:
           zero-delta live and frozen Q1 latency, Q1 at delta fill 0, 50,
           100%, insert -> visible and delete -> invisible (median of 10),
           the compaction pause by part (canonical state, WAL, snapshot
           write, swap + upload, IVF rebuild), snapshot and recovery
           times, chase live Q1 at 1, 8, 64, 100 with the IVF caps, peak
           device memory; all under one temporary directory (free space
           checked first, removed at the end).  Also: Q1 under
           ``EngineOptions(dist=DistSpec())`` over the live corpus equals
           the live flat plan bit for bit (lists of 1, 8, 64, 100) at zero
           delta and at 50% delta fill
  sharded  (after live) every class under ``EngineOptions(dist=DistSpec((1,),
           ("data",)))``, flat (brute, use_pallas=True): the one shard is a
           view of the corpus and runs the batched kernels, then the
           hierarchical merge.  Four gates: Q1, Q2 and Q5 at lists of 1, 8,
           64, 100, Q3, Q4 and Q6 over the 100 left rows, predicate-free Q1
           and Q2, in fp32 and (Q1, Q2) under int8 and bf16, equal the flat
           bucketed path bit for bit, counters included; at a list of 100
           (bucket 128) the 28 pad lanes emit and count nothing; a
           same-spec re-prepare builds no executor, another axis name
           misses the plan cache, the ShardedCorpus is registered once and
           reused; DistSpec((2,)) on a one-card machine raises
           DeviceCountError naming the count (on two cards it runs, bit for
           bit).  Line ``e2e_sharded``: latency beside the flat path (Q1,
           Q2, Q5 at each list length, in turns), the merge's time and
           share at a list of 100, peak memory
  large_k  (after sharded) LIMIT and rank above the top-k kernels'
           1,024-entry lists, routed by the ops wrappers to the range
           kernels at an infinite radius (fp32) or the quantized key kernel
           (int8 / bf16) and a stable smallest-k: Q1 ``price < p`` at K in
           {1,025, 2,000, 10,000} (and 1,024), single dicts, lists of 1, 8,
           100, stacked, exact_shape, a no-predicate single dict and the
           exact-shape Q = 1 fast path; Q4 at ``rank <= 2000`` in both
           lowerings; Q1 at one shard.  Gates: fp32 against
           use_pallas=False (1e-4, the tie rule), the predicate and the
           order; int8 and bf16 equal to fp32 with ``torch.equal`` (each
           K's smallest covering rescore factor); the first 1,024 entries
           of K = 2,000 equal K = 1,024 bit for bit (sims as int32); a
           list's rows = the lists of 1 and 8 bit for bit; a single dict =
           its row bit for bit under int8 / bf16 (the batched kernels at
           Q = 1) and under the tie rule in fp32 (the single-query kernels
           add a dot product in another order, at K = 1,024 too; the bits
           that differ are counted), Q4 batch against perleft likewise; one
           shard = flat; above 1,024 only range_scan(_batch),
           quant_keys_batch and replay_keys launch.  Line ``e2e_large_k``: Q1 at K = 2,000 and
           10,000, single dict and list of 100: ms, QPS, peak memory, the
           range kernel's and the sort's share
  adaptive (after large_k) ``connect(cat, adaptive=True)`` (the card's
           CostModel) over the ivf phase's index under chase: Q1 at a list
           of 100 with the serve phase's selectivity mix, Q3 over 100 left
           rows, and brute Q1 (which must decide lock-step, ``flat``).
           Each workload warmed 3 times, then lock-step, the static p75
           pilot and adaptive, 10 each in turns.  Four gates: the three
           policies bit for bit, counters included; a second advisor fed
           the same observations emits the same decisions; no executor
           built after the warm-up; ExecutionHints beat the advisor.  Line
           ``e2e_adaptive``: each policy's ms, the decision sources, the
           host copies per adaptive execute, ``CostModel.describe()``, and
           this run's own measure of the card's constants (quantized Q1
           against fp32 at a list of 64, and the per-row gather penalty
           from chase's distance evals)
  interp   (after adaptive) the Volcano interpreter runs Q1 over 20,000
           rows of the corpus taken on the card with ``Table.take``; one
           gate: its ids hold against the compiled flat Q1 on the same rows
           (scan_topk) under the tie rule.  Line ``e2e_interp``: the
           interpreted ms, the same ``scaled`` to 1M rows, the compiled Q1
           on the full corpus (a single dict and a list of 100), the
           ratios and the interpreter's counters
  aot      (after interp) the on-disk plan cache over flat Q1 (a single
           dict, lists of 1, 8, 100), Q2 (a list of 100) and Q3 (one bind
           set): no cache, a cold cache, a new Database on the same path
           and a plan-cache hit, then two child processes
           (``--aot-child``) with empty kernel build directories: A on an
           empty cache (started after the catalog is built, joined before
           the ivf phase) pays nvcc, B on A's cache restores the library
           from its annex.  Gates: every result equal with torch.equal,
           exact counters, trace_counts 0 on restored buckets, no nvcc in
           B, a truncated entry and a stale token each one typed cold
           miss.  Line ``e2e_aot``: prepare and first-execute ms per
           session, each child's seconds from spawn to first result and
           its nvcc seconds
  lm_gates (after slice_quant, while the aot phase's child A builds its
           kernels: it times nothing) the LM side's model gates: the ten
           smoke configs in fp32 on the card (forward = prefill to 2e-3,
           card = CPU to 1e-4), qwen2-1.5b (28 layers) in fp32 at full
           width (forward = prefill to 2e-3) and mamba2-370m (48 layers)
           in fp64 at full width (forward = prefill to 1e-6; the fp32
           forward's distance from it reported).  Line ``lm_gates``
  lm       (after aot) the LM side and the RAG tier:
           ``launch.serve.serve_arch`` (the ``--arch`` CLI's code) for
           qwen2-1.5b at full width in bf16 with ``--rag`` over 1,000,000 x
           1,536 docs, B = 8, 128 prompt tokens, 64 generated, and the
           flat Q1 on the same catalog (scan_topk, scan_topk_batch at
           D = 1,536).  Five gates: the filters; chase under termination
           "bound" = flat as sets; flat use_pallas=True = use_pallas=False
           (1e-4); the scheduled retrieve_for_decode = retrieve_batch; two
           greedy generates equal, inside the vocabulary.  Line ``e2e_lm``:
           retrieval ms, recall@4, the two kernels' ms beside their plain,
           library and bound ms, prefill ms, decode ms a token, tokens/s
           beside the weight-bytes bound of a decode step, peak memory,
           worst errors
  train_gates  (after lm_gates, while child A still builds: it times
           nothing) the training path's smoke gates in fp32: the loss falls
           by 0.3 over 40 steps on the bigram data, a 1e-6 clip norm moves
           no leaf by 1e-2, ``launch/train.py``'s CLI relaunched on a copy
           of a 6-step run's step-3 checkpoint equals that run at step 6
           (rtol 1e-5, atol 1e-6), the compressed DP step on a mesh of the one card
           trains, one train step of each of the ten smoke configs on
           the card equals the port's CPU step (loss, grad norm, moments,
           params) with the caller's fp32 matmuls at "high", and qwen2's
           bf16 gradient with remat on the card lies as close to the fp32
           one as the CPU's (mean 1.25x, largest 2.5x).  Line
           ``train_gates``
  train    (after lm) ``launch/train.py``'s ``train`` for qwen2-1.5b as
           published (bf16, remat "block") at global batch 2 x 4,096
           positions (train_4k's global batch of 256 cut to 2), AdamW with
           fp32 moments, 1 warm-up and 8 timed steps.  Gates: finite losses
           and grad norms above 0, step 0's loss = ``lm_loss`` of the same
           initial params, the first update = AdamW's step-1 closed form on
           two sampled leaves to half a bf16 ulp, no custom kernel
           launched.  Line ``e2e_train``: per-step loss, grad norm, lr, ms;
           median step ms, tokens/s end to end (data time included), model
           FLOPs and their share of the dense bf16 peak, peak memory, the
           pipeline's host ms a batch
  mesh     (last) meshes of more than one device.  On the card: a 2 x 2
           mesh, ``launch.train --mesh tiny`` and ``--mesh single`` on
           ``cuda`` raise ``DeviceCountError`` naming the card count before
           any work, and ``restore(..., shardings)`` under a mesh of the
           one card puts every leaf of a saved smoke ``TrainState`` on
           ``cuda:0`` bit for bit.  On the host (child processes started
           after ``roofline``, counting on ``meta`` while the card times
           its kernels): the dry-run of qwen2-1.5b ``train_4k`` at the
           published 256 x 4,096 under ``tiny`` and ``single`` and of
           moonshot-v1-16b-a3b ``train_4k`` under ``single``, each beside
           its mesh-``one`` record: per-device FLOPs x chips at least the
           mesh-``one`` count (qwen2 ``tiny``: exactly that count),
           argument bytes = ``device_bytes``, the peak below the
           mesh-``one`` peak, a nonzero collective term; and every arch x
           shape at --smoke-config under ``tiny`` (one more child) counts
           the reference's FLOPs per device and argument bytes, pinned in
           ``MESH_TINY_REF`` (the SSM training steps less the SSD's
           documented backward reductions).  Line ``mesh``
then the ``script`` line (seconds since the script's imports), the
``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}`` line.  Any failure raises and exits non-zero without the last line.

Tolerance: 1e-5 at D <= 130 and 1e-4 at D = 512 on sims and keys, on the
key gap that may reorder a near-tie, and on the distance from the radius
within which a row may be a hit on one side only (fp32 sums of up to 512
unit-scale products taken in a different order).  A Q5/Q6 answer is held
list by list, each (query, category) list as a range buffer of its hits.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
T_START = time.perf_counter()

from repro_torch.configs.chase_laion import bench_config  # noqa: E402
from repro_torch.roofline import bound_ms, spec_for  # noqa: E402

# the paper's laion1m scale (configs/chase_laion.py gives it in comments)
LAION1M = dataclasses.replace(bench_config(), n_rows=1_000_000, n_queries=100)
N_ROWS, N_QUERIES, DIM, N_MODES, K = (LAION1M.n_rows, LAION1M.n_queries,
                                      LAION1M.dim, LAION1M.n_modes,
                                      LAION1M.k_top)
SELECTIVITY = 0.3
RANGE_TARGET = LAION1M.range_match_target  # the radius's hit count (§7.1)
BATCHES = (1, 8, 64, 100)
CAPACITY = 4096               # Q2 result buffer (ProbeConfig.capacity)
MAX_PAIRS = 512               # Q3 per-left-row buffer
Q1 = ("SELECT sample_id FROM products WHERE price < ${p} "
      "ORDER BY DISTANCE(embedding, ${qv}) LIMIT ${K}")
Q1_NOFILTER = ("SELECT sample_id FROM products "
               "ORDER BY DISTANCE(embedding, ${qv}) LIMIT ${K}")
Q2 = ("SELECT sample_id FROM images WHERE DISTANCE(embedding, ${qv}) <= ${r} "
      "AND price < ${p}")
Q2_NOFILTER = ("SELECT sample_id FROM images "
               "WHERE DISTANCE(embedding, ${qv}) <= ${r}")
Q3 = ("SELECT queries.id AS qid, images.sample_id AS tid "
      "FROM queries JOIN images "
      "ON DISTANCE(queries.embedding, images.embedding) <= ${r} "
      "AND images.capture_date > queries.capture_date")
K_CATEGORY, EX = LAION1M.k_category, 3   # Q5/Q6: top 10 per level; Q5
                                         # excludes cuisine 3
Q4 = ("SELECT qid, tid FROM (SELECT users.id AS qid, movies.sample_id AS tid, "
      "RANK() OVER (PARTITION BY users.id "
      "ORDER BY DISTANCE(users.embedding, movies.embedding)) AS rank "
      "FROM users JOIN movies ON users.preferred_rating = movies.rating"
      "{extra}) AS ranked WHERE ranked.rank <= 50")
Q4Y = Q4.format(extra=" AND movies.release_year >= ${y}")
Q4 = Q4.format(extra="")
Q5 = ("SELECT qid, category FROM (SELECT sample_id AS qid, "
      "calorie_level AS category, RANK() OVER (PARTITION BY calorie_level "
      "ORDER BY DISTANCE(embedding, ${qv})) AS rank FROM recipes "
      "WHERE DISTANCE(embedding, ${qv}) <= ${r} AND cuisine <> ${ex}"
      ") AS ranked WHERE ranked.rank <= 10")
Q6 = ("SELECT qid, category, tid FROM (SELECT queries.id AS qid, "
      "recipes.sample_id AS tid, recipes.calorie_level AS category, "
      "RANK() OVER (PARTITION BY queries.id, recipes.calorie_level "
      "ORDER BY DISTANCE(queries.embedding, recipes.embedding)) AS rank "
      "FROM queries JOIN recipes "
      "ON DISTANCE(queries.embedding, recipes.embedding) <= ${r} "
      "AND queries.cuisine <> recipes.cuisine) AS ranked "
      "WHERE ranked.rank <= 10")
KERNELS = ("scan_topk_batch", "scan_topk", "range_scan_batch", "range_scan",
           "quant_scan_topk_batch", "quant_keys_batch", "replay_keys",
           "pairwise_keys")
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu" for name in KERNELS}
REPLACES = {"scan_topk": "src/repro/kernels/scan_topk.py:241",
            "scan_topk_batch": "src/repro/kernels/scan_topk.py:189",
            "range_scan": "src/repro/kernels/range_scan.py:50",
            "range_scan_batch": "src/repro/kernels/range_scan.py:118",
            "quant_scan_topk_batch": "src/repro/kernels/quant.py:132",
            "quant_keys_batch": "src/repro/kernels/quant.py:187",
            "replay_keys": "src/repro/kernels/quant.py:208",
            "pairwise_keys": "src/repro/kernels/distance.py:48"}
MODES = ("int8", "bf16")
# the large_k phase: LIMITs above the top-k kernels' 1,024-entry lists
LARGE_K, LARGE_K_LISTS = (1025, 2000, 10_000), (1, 8, 100)
# the IVF index of this workload (configs/chase_laion.py)
NLIST, KMEANS_ITERS = bench_config().nlist, bench_config().kmeans_iters
IVF_PROBE = {name: getattr(bench_config().probe, name)
             for name in ("max_probes", "capacity", "stop_after_no_improve",
                          "out_range_stop", "min_probes")}
IVF_ENGINES = ("chase", "vbase", "pase")
RESCORE = (2, 3, 4, 6, 8)     # Q1 candidate multiples tried, smallest first
SERVE_BATCH, SERVE_WAIT_MS = 32, 5.0
SERVE_REQUESTS = {"brute": 512, "chase": 256}
SERVE_RATES = (0.3, 1.0, 3.0)  # x the measured batch capacity (q8's sweep)
NEEDLE = 0.002                # every 8th request's predicate selectivity
# the live phase: a delta segment of 4096 rows (cap_main = ceil8(N + 4 x
# 4096), the reference's rule); 2048 rows inserted in 4 batches, 64 of them
# near-duplicates of queries; 1000 deletes from the top-50 lists and 16 of
# the inserted rows; 10 insert -> visible samples; 512 rows after the
# compaction
LIVE_DELTA_CAP, LIVE_INSERTS, LIVE_BATCHES, LIVE_NEAR = 4096, 2048, 4, 64
LIVE_DELETES, LIVE_DELETE_INSERTED, LIVE_TOUCH, LIVE_POST = 1000, 16, 10, 512
LIVE_RECALL = 0.99            # chase over the live IVF against live flat
# the interp phase: Q1 interpreted over a subsample of the products table
INTERP_ROWS, INTERP_QUERIES = 20_000, 3
# the aot phase's children run Q1 at these list lengths
AOT_CHILD_BATCHES = (1, 8, 100)
# the lm phase: smoke configs at (B, S); full-width forward = decode gates
# (arch, B, S, dtype), each at its dtype's tolerance: qwen2-1.5b in fp32 at
# its 28 layers, mamba2-370m in fp64 at its 48 layers.  In fp32 a random
# full-width mamba2's rounding grows from layer to layer until its forward
# and decode replay part by about 1.9 at 48 layers; the reference's own
# pair parts beyond 2e-3 at 48 layers of smoke width, and in fp64 the
# port's pair agrees to 1e-11 (tests/test_torch_decode.py).  The mamba2
# gate also reports how far the fp32 forward lies from the fp64 one
LM_SMOKE_SHAPE = (2, 64)
LM_FULL_GATES = (("qwen2-1.5b", 2, 64, "float32"),
                 ("mamba2-370m", 2, 256, "float64"))
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "qwen2-1.5b", 8, 128, 64
LM_DOCS, LM_NLIST = 1_000_000, 64   # HybridRetriever.build's default lists
LM_TOL_DECODE = {"float32": 2e-3, "float64": 1e-6}
LM_TOL_DEVICE = 1e-4
# the train phase: qwen2-1.5b as published (bf16, remat "block") through
# launch/train.py's train(), the global batch cut from train_4k's 256 to 2
# at its sequence length (8,192 tokens a step); 1 warm-up step and 8 timed
TRAIN_ARCH, TRAIN_BATCH, TRAIN_WARMUP, TRAIN_TIMED = "qwen2-1.5b", 2, 1, 8
TRAIN_LOSS_TOL = 2.0**-8     # step 0's loss against lm_loss: a bf16 ulp
# the train phase's smoke gates (fp32 smoke configs): one step of each on
# the card against the port's CPU step at (B, S), the gradient held through
# the moments to TRAIN_TOL_G of each leaf's largest entry (the SSM configs'
# card = CPU forward already parts by 4-8e-5)
TRAIN_SMOKE_SHAPE = (2, 64)
TRAIN_TOL_G = {"mamba2-370m": 1e-3, "zamba2-1.2b": 5e-3}
TRAIN_TOL_G_DEFAULT = 2e-5
# the roofline phase: the dry-run's predicted peak above the step's
# arguments against the card's own in that step (they read 4 KB apart of
# 24.7 GB on the H100 at 700 W; a lost checkpoint recompute would be
# hundreds of MB)
ROOFLINE_PEAK_TOL = 0.01
# a bf16 gradient's distance from the fp32 one on the card, as a multiple
# of the CPU's (tests/test_torch_bf16.py's rule)
BF16_MEAN_RATIO, BF16_MAX_RATIO = 1.25, 2.5
# the mesh phase: the dry-run's per-device cells at full width on meta,
# each beside its mesh-``one`` record (train_4k at the published 256 x
# 4,096); moonshot under ``single`` is 64 experts over 16 model shards
MESH_CELLS = (("qwen2-1.5b", "train_4k", "tiny"),
              ("qwen2-1.5b", "train_4k", "single"),
              ("moonshot-v1-16b-a3b", "train_4k", "single"))
# the mesh phase's smoke grid: every arch x shape at --smoke-config under
# ``tiny`` (2 x 2), each held to the reference's per-device count
# (``cost.flops_per_device``, ``memory.argument_bytes``; None where the
# reference skips the cell), copied from the reference's records that
# tests/dryrun_mesh_grid.py reads in its subprocess
# (``repro.launch.dryrun.run_cell(arch, shape, "tiny", smoke_config=True)``
# on 8 fake CPU devices, jax 0.9.0); the script imports nothing of the
# reference
MESH_TINY_REF = {
    ("gemma3-12b", "train_4k"): (58195968, 1534228),
    ("gemma3-12b", "prefill_32k"): (27918336, 511616),
    ("gemma3-12b", "decode_32k"): (272384, 530248),
    ("gemma3-12b", "long_500k"): (267264, 524968),
    ("h2o-danube-3-4b", "train_4k"): (40894464, 1285396),
    ("h2o-danube-3-4b", "prefill_32k"): (19660800, 428672),
    ("h2o-danube-3-4b", "decode_32k"): (188416, 436744),
    ("h2o-danube-3-4b", "long_500k"): (184320, 432520),
    ("gemma2-27b", "train_4k"): (40894464, 1088788),
    ("gemma2-27b", "prefill_32k"): (19660800, 363136),
    ("gemma2-27b", "decode_32k"): (200704, 383880),
    ("gemma2-27b", "long_500k"): (198656, 381768),
    ("qwen2-1.5b", "train_4k"): (40894464, 1091860),
    ("qwen2-1.5b", "prefill_32k"): (19660800, 364160),
    ("qwen2-1.5b", "decode_32k"): (212992, 397576),
    ("qwen2-1.5b", "long_500k"): None,
    ("mamba2-370m", "train_4k"): (32178176, 933268),
    ("mamba2-370m", "prefill_32k"): (14450688, 311296),
    ("mamba2-370m", "decode_32k"): (159744, 330376),
    ("mamba2-370m", "long_500k"): (159744, 330376),
    ("zamba2-1.2b", "train_4k"): (67502080, 1915924),
    ("zamba2-1.2b", "prefill_32k"): (30277632, 638848),
    ("zamba2-1.2b", "decode_32k"): (335872, 694024),
    ("zamba2-1.2b", "long_500k"): (335872, 694024),
    ("grok-1-314b", "train_4k"): (97910784, 1101076),
    ("grok-1-314b", "prefill_32k"): (49741824, 367232),
    ("grok-1-314b", "decode_32k"): (903168, 400648),
    ("grok-1-314b", "long_500k"): None,
    ("moonshot-v1-16b-a3b", "train_4k"): (106168320, 1948948),
    ("moonshot-v1-16b-a3b", "prefill_32k"): (53870592, 649856),
    ("moonshot-v1-16b-a3b", "decode_32k"): (1732608, 716040),
    ("moonshot-v1-16b-a3b", "long_500k"): None,
    ("musicgen-medium", "train_4k"): (34603008, 1006612),
    ("musicgen-medium", "prefill_32k"): (16515072, 321792),
    ("musicgen-medium", "decode_32k"): (180224, 364036),
    ("musicgen-medium", "long_500k"): None,
    ("chameleon-34b", "train_4k"): (40894464, 1286932),
    ("chameleon-34b", "prefill_32k"): (19660800, 429184),
    ("chameleon-34b", "decode_32k"): (212992, 462600),
    ("chameleon-34b", "long_500k"): None,
}
# what a MESH_CELLS record's per-device FLOPs x chips over its mesh-``one``
# count must read: every product of qwen2-1.5b under ``tiny`` splits four
# ways; the ``single`` ratios are this phase's own first readings on an
# H100's host (torch 2.11.0+cu128), where its 12 heads do not divide the
# 16-way ``model`` axis and moonshot's 64 experts do
MESH_FULL_RATIO = {("qwen2-1.5b", "train_4k", "tiny"): 1.0,
                   ("qwen2-1.5b", "train_4k", "single"): 4.03514467184192,
                   ("moonshot-v1-16b-a3b", "train_4k", "single"):
                       1.0162337662337662}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks_for(name: str) -> tuple[float, float]:
    """The card's HBM bytes/s and fp32 CUDA-core FLOP/s, from its part's
    published dense rates (``repro_torch.roofline.hw``)."""
    hw = spec_for(name)
    return hw.hbm_bw, hw.peak_flops_fp32


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


def run_ms(fn, one_ms: float) -> float:
    """Device time per call over a run of back-to-back calls between one
    pair of CUDA events (20 calls, or 5 where one takes over 2 ms): the
    host's work before each launch overlaps the device's work on the one
    before, as in a caller's loop."""
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


def timed(table: dict) -> dict:
    """The kernel table's times: per kernel (its wrapper, its plain
    version, its library yardstick, (bound ms, bound by)), one call of
    each between an event pair and the wrapper and the yardstick per call
    over a back-to-back run."""
    out = {}
    for kname, (kernel, plain, lib, (b_ms, b_by)) in table.items():
        reps = (2, 5) if kname.endswith("batch") else (3, 10)
        row = out[kname] = {"ms": time_ms(kernel),
                            "plain_ms": time_ms(plain, *reps),
                            "library_ms": time_ms(lib, *reps),
                            "bound_ms": b_ms, "bound_by": b_by}
        row["run_ms"] = run_ms(kernel, row["ms"])
        row["library_run_ms"] = run_ms(lib, row["library_ms"])
    return out


def latency_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median host time of one call that ends in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def peak_mb(fn) -> float:
    """Device memory one call needs above what is resident before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def slab(keys, ids, k: int) -> dict:
    """A stage-1 output as one top-k row per (query, split): the tie rule
    applies within each split's list."""
    keys, ids = keys.reshape(-1, k), ids.reshape(-1, k)
    return {"ids": ids, "sim": keys, "valid": torch.isfinite(keys)}


def range_err(got, want, radius_keys, tol: float, what: str) -> float:
    """Hold a range kernel's (keys, hits, counts) against its plain
    version's: hits equal except on rows whose key lies within ``tol`` of
    the radius key, counts off by at most those rows and equal to the
    kernel's own hits, keys +inf off the hits and within ``tol`` on the
    hits both sides hold.  Returns the largest key difference."""
    gk, gh, gc = got
    wk, wh, wc = want
    gh, wh = gh.bool(), wh.bool()
    rk = radius_keys.reshape(-1, 1) if gk.ndim == 2 else radius_keys.reshape(())
    flip = gh != wh
    key = torch.where(gh, gk, wk)
    if bool((flip & ((key - rk).abs() > tol)).any()):
        raise AssertionError(f"{what}: a hit on one side only, off the radius")
    if bool(((gc - wc).abs() > flip.sum(-1)).any()):
        raise AssertionError(f"{what}: counts {gc.tolist()} vs {wc.tolist()}")
    if not torch.equal(gc, gh.sum(-1, dtype=torch.int32)):
        raise AssertionError(f"{what}: the kernel's count is not its hits")
    if not bool(torch.isinf(gk[~gh]).all()):
        raise AssertionError(f"{what}: a finite key off the hits")
    both = gh & wh
    err = float((gk[both] - wk[both]).abs().max()) if bool(both.any()) else 0.
    if not err <= tol:
        raise AssertionError(f"{what}: keys differ by {err} > {tol}")
    return err



def bitwise(a: dict, b: dict, what: str) -> None:
    """Every leaf of ``a`` equal to ``b``'s with ``torch.equal``."""
    for key, v in a.items():
        if isinstance(v, dict):
            bitwise(v, b[key], what)
        elif not torch.equal(v, b[key]):
            raise AssertionError(f"{what}: {key} differs")


def without_stats(data: dict) -> dict:
    return {key: v for key, v in data.items() if key != "stats"}


def best_first(data: dict) -> dict:
    """An IVF range answer (hits in probe discovery order) as a best-first
    buffer: each row's hits sorted by descending sim, ties by position."""
    keys = torch.where(data["valid"], -data["sim"], float("inf"))
    order = torch.sort(keys, dim=-1, stable=True).indices
    out = {key: torch.take_along_dim(data[key], order, -1)
           for key in ("ids", "sim", "valid")}
    return {**out, "count": data["count"]}


def ivf_phase(cat, qv, p, r, sims, near_q, drive, launches, smi: str,
              name: str) -> None:
    """The ``ivf`` phase: build the IVF index on the card, register it on
    the tables Q1 and Q2 scan, and drive Q1 and Q2 under ``chase``,
    ``vbase`` and ``pase`` through the session API (a single dict and
    lists of 1, 8, 64 and 100), held to five gates; then print the
    ``ivf_build``, ``e2e_ivf`` and ``ivf_profile`` lines.  Returns the
    index."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.api import ExecutionHints, connect
    from repro_torch.core.expr import distance_values, evaluate_batch
    from repro_torch.core.physical import ProbeConfig
    from repro_torch.core.schema import Metric
    from repro_torch.index import assign, build_ivf, kmeans
    from repro_torch.index import ivf as ivf_mod
    from repro_torch.testing import assert_range_close, assert_topk_close

    metric = Metric.INNER_PRODUCT
    table = cat.table("products")
    corpus = table["embedding"]
    price_np = table["price"].cpu().numpy()
    sims_np = sims.cpu().numpy()
    exact = ExecutionHints(exact_shape=True)

    # -- build --------------------------------------------------------------
    def clock(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    gen = torch.Generator().manual_seed(0)
    cents, kmeans_ms = clock(lambda: kmeans(gen, corpus, NLIST,
                                            iters=KMEANS_ITERS))
    _, assign_ms = clock(lambda: assign(corpus, cents))
    index, build_ms = clock(lambda: build_ivf(None, corpus, NLIST, metric,
                                              centroids=cents))
    members = index.lists[index.lists >= 0].long()
    if not torch.equal(torch.sort(members).values,
                       torch.arange(N_ROWS, device=corpus.device)):
        raise AssertionError("ivf: the lists do not partition the corpus")
    sizes = index.list_sizes.float()
    emit({"phase": "ivf_build", "device": name, "nvidia_smi": smi,
          "nlist": NLIST, "kmeans_iters": KMEANS_ITERS,
          "kmeans_ms": kmeans_ms, "assign_ms": assign_ms,
          "lists_ms": build_ms - assign_ms, "cap": index.cap,
          "max_list": int(sizes.max()), "mean_list": float(sizes.mean()),
          "empty_lists": int((sizes == 0).sum())})
    for tname in ("products", "images"):
        cat.register_index(tname, "embedding", index)

    # -- drive every engine ---------------------------------------------------
    probe = ProbeConfig(**IVF_PROBE)
    binds = [{"qv": qv[i], "p": p} for i in range(N_QUERIES)]
    q2_binds = [{"qv": qv[i], "r": r, "p": p} for i in range(N_QUERIES)]
    stmts, res = {}, {}
    for engine in IVF_ENGINES:
        db_e = connect(cat, engine=engine, use_pallas=True, probe=probe)
        stmts[engine] = (db_e.prepare(Q1, K=K), db_e.prepare(Q2))
        singles = N_QUERIES if engine == "chase" else 1
        for qname, st, bl in (("q1", stmts[engine][0], binds),
                              ("q2", stmts[engine][1], q2_binds)):
            runs = [(f"single{i}", st, bl[i], None) for i in range(singles)]
            runs += [(f"list{qn}", st, bl[:qn], None) for qn in BATCHES]
            res[qname, engine] = {
                label: out for label, _s, _b, _h, out in
                drive(f"ivf_{qname}_{engine}", runs)}
    for path in launches:
        if path.startswith("ivf_") and path != "ivf_q2_pase" \
                and any(launches[path].values()):
            raise AssertionError(f"{path} launched {launches[path]}: the "
                                 f"IVF probes run no kernel")
    if launches["ivf_q2_pase"]["range_topk_batch"] < 1:
        raise AssertionError("pase Q2 did not run the flat range kernel")
    for (qname, engine), by_label in res.items():
        for label, out in by_label.items():
            if (qname, engine) != ("q2", "pase") and not bool(
                    (out["stats"]["probes"] > 0).all()):
                raise AssertionError(f"ivf {qname} {engine} {label}: a query "
                                     f"probed no cluster")

    # gate 1: at probe_batch 1, row q of the list of 100 = query q's single
    for qname in ("q1", "q2"):
        batch = res[qname, "chase"][f"list{N_QUERIES}"]
        for q in range(N_QUERIES):
            one, row = res[qname, "chase"][f"single{q}"].data, \
                batch.query(q).data
            what = f"ivf gate 1 {qname} query {q}"
            if qname == "q1":
                assert_topk_close(one, row, atol=1e-4, tie_tol=1e-4,
                                  what=what)
            else:
                assert_range_close(one, row, radius=r, atol=1e-4,
                                   tie_tol=1e-4, what=what)
                for key in ("count", "valid"):
                    if not torch.equal(one[key], row[key]):
                        raise AssertionError(f"{what}: {key} differs")

    # gate 2: bound termination returns the flat fp32 kernel's answer
    bound_db = connect(cat, engine="chase", use_pallas=True,
                       probe=ProbeConfig(**IVF_PROBE, termination="bound"))
    flat_db = connect(cat, engine="brute", use_pallas=True, probe=probe)
    flat = {"q1": flat_db.prepare(Q1, K=K).execute(binds),
            "q2": flat_db.prepare(Q2).execute(q2_binds)}
    got = bound_db.prepare(Q1, K=K).execute(binds)
    assert_topk_close(without_stats(got.data), without_stats(flat["q1"].data),
                      atol=1e-4, tie_tol=1e-4, what="ivf gate 2 q1")
    got2 = bound_db.prepare(Q2).execute(q2_binds)
    assert_range_close(best_first(got2.data), without_stats(flat["q2"].data),
                       radius=r, atol=1e-4, tie_tol=1e-4, near=near_q,
                       what="ivf gate 2 q2")
    bound_probes = {"q1": float(got["stats"]["probes"].float().mean()),
                    "q2": float(got2["stats"]["probes"].float().mean())}

    # gate 3: counter termination returns real answers
    flat_ids = flat["q1"]["ids"].cpu().numpy()
    flat_count = flat["q2"]["count"].cpu().numpy()
    quality = {}
    for (qname, engine), by_label in res.items():
        out = by_label[f"list{N_QUERIES}"]
        ids = out["ids"].cpu().numpy()
        valid = out["valid"].cpu().numpy()
        got_sims = out["sim"].cpu().numpy()
        rows = np.nonzero(valid)
        hit_ids = ids[rows]
        what = f"ivf gate 3 {qname} {engine}"
        if not (price_np[hit_ids] < p).all():
            raise AssertionError(f"{what}: a row fails price < p")
        err = float(np.abs(got_sims[rows] - sims_np[rows[0], hit_ids]).max())
        if not err <= 1e-4:
            raise AssertionError(f"{what}: sims {err} off the flat sims")
        if qname == "q2" and (got_sims[rows] < r - 1e-4).any():
            raise AssertionError(f"{what}: a hit below the radius")
        if qname == "q1":
            recall = np.mean([len(np.intersect1d(ids[q][valid[q]],
                                                 flat_ids[q])) / K
                              for q in range(N_QUERIES)])
        else:
            recall = float(valid.sum() / flat_count.sum())
        quality[f"{qname}_{engine}"] = {
            "recall": float(recall), "max_abs_err": err,
            "probes_mean": float(out["stats"]["probes"].float().mean()),
            "evals_mean": float(
                out["stats"]["distance_evals"].float().mean())}

    # gate 4: quantization composes: chase probes in fp32 under quant
    for mode in MODES:
        qdb = connect(cat, engine="chase", use_pallas=True, quant=mode,
                      probe=probe)
        for qname, sql, bl, fp32 in (
                ("q1", Q1, binds, stmts["chase"][0]),
                ("q2", Q2, q2_binds, stmts["chase"][1])):
            st = qdb.prepare(sql, K=K) if qname == "q1" else qdb.prepare(sql)
            bitwise(st.execute(bl).data,
                    res[qname, "chase"][f"list{N_QUERIES}"].data,
                    f"ivf gate 4 {qname} {mode} list{N_QUERIES}")
            want = fp32.execute([bl[0]], hints=exact).query(0).data
            bitwise(st.execute(bl[0]).data, want,
                    f"ivf gate 4 {qname} {mode} single")

    # gate 5: the straggler valve caps every query's probes
    per_query = tuple(1 + q % 6 for q in range(N_QUERIES))
    for qname, st, bl in (("q1", stmts["chase"][0], binds),
                          ("q2", stmts["chase"][1], q2_binds)):
        for budget in (4, per_query):
            out = st.execute(bl, hints=ExecutionHints(probe_budget=budget))
            cap_ = torch.as_tensor(budget, device=corpus.device)
            probes = out["stats"]["probes"]
            if not bool(((probes <= cap_) & (probes >= 1)).all()):
                raise AssertionError(f"ivf gate 5 {qname} budget "
                                     f"{budget}: probes {probes.tolist()}")
    emit({"phase": "ivf", "radius": float(r), "cap": index.cap,
          "bound_probes_mean": bound_probes, "counter": quality,
          "gates": ["batch = single", "bound = flat", "counter answers real",
                    "quantized = fp32", "probe budget"]})

    # -- e2e_ivf: each engine beside the flat path --------------------------
    flat_stmts = (flat_db.prepare(Q1, K=K), flat_db.prepare(Q2))
    calls = [("single", 0)] + [(f"list{qn}", qn) for qn in BATCHES]
    e2e = {}
    for engine, (s1, s2) in list(stmts.items()) + [("brute", flat_stmts)]:
        for qname, st, bl in (("q1", s1, binds), ("q2", s2, q2_binds)):
            for label, qn in calls:
                b = bl[0] if qn == 0 else bl[:qn]
                iters = 3 if qn >= 64 else 10
                ms = latency_ms(lambda: st.execute(b), iters=iters)
                ivf_mod.loop_stats.update(rounds=0, syncs=0)
                st.execute(b)
                torch.cuda.synchronize()
                loops = dict(ivf_mod.loop_stats)
                e2e[f"{qname}_{engine}_{label}"] = {
                    "latency_ms": ms, "qps": max(qn, 1) * 1e3 / ms,
                    "peak_mb": peak_mb(lambda: st.execute(b)), **loops}
    # the host's read of active.any(): every round against every few
    cadence, every = {}, ivf_mod.ACTIVE_CHECK_EVERY
    for n in (1, 2, 4, 8):
        ivf_mod.ACTIVE_CHECK_EVERY = n
        for qname, st, bl in (("q1", stmts["chase"][0], binds),
                              ("q2", stmts["chase"][1], q2_binds)):
            for label, b in (("single", bl[0]), (f"list{N_QUERIES}", bl)):
                cadence[f"{qname}_{label}_every{n}"] = latency_ms(
                    lambda: st.execute(b), iters=10 if label == "single"
                    else 5)
    ivf_mod.ACTIVE_CHECK_EVERY = every
    emit({"phase": "e2e_ivf", "device": name, "nvidia_smi": smi,
          "check_every": every, "runs": e2e,
          "latency_ms_by_check_every": cadence})

    # -- ivf_profile: where one execute's time goes, chase list of 100 --------
    bucket = 1 << (N_QUERIES - 1).bit_length()
    qs = torch.from_numpy(qv[np.minimum(np.arange(bucket),
                                        N_QUERIES - 1)]).to(corpus.device)
    order = ivf_mod._cluster_order(index, qs)[0]
    pred = stmts["chase"][0].compiled.analysis.structured_predicate
    mask = evaluate_batch(pred, table, {"p": np.full(bucket, p, np.float32)},
                          bucket)
    ids = index.lists[order[:, 0].long()]                     # (Q, cap)
    safe = ids.clamp_min(0).long()
    vecs = corpus[safe]
    keys = -distance_values(metric, vecs, qs[:, None, :])
    best_k = torch.full((bucket, K), float("inf"), device=corpus.device)
    best_i = torch.full((bucket, K), -1, dtype=torch.int32,
                        device=corpus.device)
    part = {"order": time_ms(lambda: ivf_mod._cluster_order(index, qs)),
            "gather": time_ms(lambda: (corpus[safe], torch.take_along_dim(
                mask, safe, dim=1))),
            "product": time_ms(lambda: distance_values(metric, vecs,
                                                       qs[:, None, :])),
            "merge": time_ms(lambda: ivf_mod._merge_topk(
                best_k, best_i, keys, ids, ids >= 0, K))}
    del vecs, keys
    profile = {}
    for qname, st, bl in (("q1", stmts["chase"][0], binds),
                          ("q2", stmts["chase"][1], q2_binds)):
        b = bl[:N_QUERIES]
        lat = latency_ms(lambda: st.execute(b), iters=3)
        ivf_mod.loop_stats.update(rounds=0, syncs=0)
        st.execute(b)
        torch.cuda.synchronize()
        rounds = ivf_mod.loop_stats["rounds"]
        ms = {"order": part["order"],
              **{key: rounds * part[key]
                 for key in ("gather", "product", "merge")}}
        ms["host_and_other"] = lat - sum(ms.values())
        # the same execute under torch.profiler: device time by operator
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            st.execute(b)
            torch.cuda.synchronize()
        by_op = {ev.key: ev.self_device_time_total / 1e3
                 for ev in prof.key_averages()
                 if ev.key.startswith("aten::") and ev.self_device_time_total}
        top = dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:12])
        profile[qname] = {
            "latency_ms": lat, "rounds": rounds,
            "events_ms": ms, "events_share": {key: v / lat
                                              for key, v in ms.items()},
            "round_ms": {key: part[key]
                         for key in ("gather", "product", "merge")},
            "profiler_device_ms": sum(by_op.values()),
            "profiler_top_ops_ms": top}
    emit({"phase": "ivf_profile", "device": name, "nvidia_smi": smi,
          "bucket": bucket, "cap": index.cap, "runs": profile})
    # hand the probes' cached blocks back: the later phases time other paths
    torch.cuda.empty_cache()
    return index


def same_rows(a: dict, b: dict, what: str) -> float:
    """Every integer and bool leaf of ``a`` equal to ``b``'s, the float
    leaves (sims) within 1e-4; returns the largest sim difference."""
    err = 0.0
    for key, v in a.items():
        if isinstance(v, dict):
            err = max(err, same_rows(v, b[key], f"{what} {key}"))
        elif v.is_floating_point():
            d = float((v - b[key]).abs().max()) if v.numel() else 0.0
            if not d <= 1e-4:
                raise AssertionError(f"{what}: {key} differs by {d}")
            err = max(err, d)
        elif not torch.equal(v, b[key]):
            raise AssertionError(f"{what}: {key} differs")
    return err


def ivf_joins_phase(cat, qv, r, sims, index, drive, launches, smi: str,
                    name: str) -> None:
    """The ``ivf_joins`` phase: the ``ivf`` phase's index registered also
    on the tables Q4, Q5 and Q6 scan, and Q3, Q4 and Q6 over the 100 query
    rows in the batch and perleft lowerings (and a list of 4 bind sets
    under ``chase``), Q5 as single dicts and lists of 1, 8, 64 and 100,
    under ``chase``, ``vbase``, ``pase`` and (Q5, Q6)
    ``chase_no_updatestate``, held to six gates; then print the
    ``e2e_ivf_joins`` and ``ivf_category_profile`` lines."""
    from repro_torch.api import ExecutionHints, connect
    from repro_torch.core.expr import distance_values
    from repro_torch.core.physical import ProbeConfig
    from repro_torch.core.schema import Metric
    from repro_torch.index import ivf as ivf_mod
    from repro_torch.testing import assert_topk_close

    for tname in ("recipes", "movies"):
        cat.register_index(tname, "embedding", index)
    dev = sims.device
    qtab, laion = cat.table("queries"), cat.table("laion")
    left = qtab["embedding"]
    cuisine, level = laion["cuisine"], laion["calorie_level"]
    qcuisine = qtab["cuisine"]
    q3_mask = laion["capture_date"][None, :] > qtab["capture_date"][:, None]
    q4_mask = laion["rating"][None, :] == qtab["preferred_rating"][:, None]
    q5_mask = (cuisine != EX)[None, :].expand(N_QUERIES, -1)
    q6_mask = cuisine[None, :] != qcuisine[:, None]
    probe = ProbeConfig(**IVF_PROBE)
    perleft = ExecutionHints(join_lowering="perleft")
    radii = np.array([r - 0.01, r, r + 0.01, r + 0.02], np.float32)
    years = (1980, 1990, 2000, 2010)
    join_binds = {"q3": {"r": r}, "q4": {}, "q6": {"r": r}}
    list4 = {"q3": [{"r": x} for x in radii],
             "q4": [{"y": np.int32(y)} for y in years],
             "q6": [{"r": x} for x in radii]}
    q5_binds = [{"qv": qv[i], "r": r, "ex": np.int32(EX)}
                for i in range(N_QUERIES)]
    sql = {"q3": Q3, "q4": Q4, "q5": Q5, "q6": Q6}
    engines = {"q3": IVF_ENGINES, "q4": IVF_ENGINES,
               "q5": IVF_ENGINES + ("chase_no_updatestate",),
               "q6": IVF_ENGINES + ("chase_no_updatestate",)}
    dbs = {e: connect(cat, engine=e, use_pallas=True, probe=probe)
           for e in engines["q6"]}
    stmts, res = {}, {}

    # -- drive every engine and lowering ------------------------------------
    for q in ("q3", "q4", "q6"):
        for e in engines[q]:
            for low, hints in (("batch", None), ("perleft", perleft)):
                st = dbs[e].prepare(sql[q], hints=hints)
                stmts[q, e, low] = st
                (_l, _s, _b, _h, out), = drive(
                    f"ivfj_{q}_{e}_{low}", [(low, st, join_binds[q], None)])
                res[q, e, low] = out
        st = dbs["chase"].prepare(Q4Y if q == "q4" else sql[q])
        stmts[q, "chase", "list4"] = st
        (_l, _s, _b, _h, out), = drive(f"ivfj_{q}_chase_list4",
                                       [("list4", st, list4[q], None)])
        res[q, "chase", "list4"] = out
    for e in engines["q5"]:
        st = dbs[e].prepare(Q5)
        stmts["q5", e] = st
        singles = N_QUERIES if e == "chase" else 1
        for label, out in [(lbl, o) for lbl, _s, _b, _h, o in drive(
                f"ivfj_q5_{e}_single",
                [(f"single{i}", st, q5_binds[i], None)
                 for i in range(singles)])]:
            res["q5", e, label] = out
        for label, out in [(lbl, o) for lbl, _s, _b, _h, o in drive(
                f"ivfj_q5_{e}_lists",
                [(f"list{qn}", st, q5_binds[:qn], None) for qn in BATCHES])]:
            res["q5", e, label] = out

    # gate 6: the probes launch no kernel; each flat fallback launches the
    # kernels its path launches with no index
    flat_kernels = {("q3", "pase", "batch"): {"range_topk_batch"},
                    ("q3", "pase", "perleft"): {"range_scan"},
                    ("q4", "vbase", "batch"): {"scan_topk_batch"},
                    ("q4", "pase", "batch"): {"scan_topk_batch"},
                    ("q4", "vbase", "perleft"): {"scan_topk"},
                    ("q4", "pase", "perleft"): {"scan_topk"},
                    ("q5", "pase", "lists"): {"range_topk_batch"},
                    ("q6", "pase", "batch"): {"range_topk_batch"}}
    for path, counts in launches.items():
        if not path.startswith("ivfj_"):
            continue
        q, rest = path[5:7], path[8:]
        e, low = rest.rsplit("_", 1)
        want = flat_kernels.get((q, e, low), set())
        got = {k for k, n in counts.items() if n}
        if got != want:
            raise AssertionError(f"{path} launched {counts}, not {want}")
    for key, out in res.items():
        probed = key[1] == "chase" or (
            key[1] == "vbase" and key[0] != "q4") or (
            key[1] == "chase_no_updatestate" and key[0] in ("q5", "q6"))
        p_ = out["stats"]["probes"]
        if probed != bool((p_ > 0).all()) or (not probed and bool(p_.any())):
            raise AssertionError(f"ivf_joins {key}: probes {p_.tolist()}")

    # gate 1: batch = perleft row for row; Q5's list row = its single dict
    gate1 = {}
    for q, e in (("q3", "chase"), ("q3", "vbase"), ("q4", "chase"),
                 ("q6", "chase"), ("q6", "vbase")):
        gate1[f"{q}_{e}"] = same_rows(res[q, e, "batch"].data,
                                      res[q, e, "perleft"].data,
                                      f"ivf_joins gate 1 {q} {e}")
    batch = res["q5", "chase", f"list{N_QUERIES}"]
    gate1["q5_chase"] = max(
        same_rows(res["q5", "chase", f"single{i}"].data, batch.query(i).data,
                  f"ivf_joins gate 1 q5 query {i}")
        for i in range(N_QUERIES))

    # gate 2: bound termination returns the flat answers (every cluster
    # may be probed, so the bound alone decides where a probe stops)
    bound_db = connect(cat, engine="chase", use_pallas=True, probe=ProbeConfig(
        **dict(IVF_PROBE, termination="bound", max_probes=NLIST)))
    flat_db = connect(cat, engine="brute", use_pallas=True, probe=probe)
    flat, bound = {}, {}
    for q in ("q3", "q4", "q5", "q6"):
        b = q5_binds if q == "q5" else join_binds[q]
        flat[q] = flat_db.prepare(sql[q]).execute(b)
        bound[q] = bound_db.prepare(sql[q]).execute(b)
    torch.cuda.synchronize()

    def topk_view(d: dict) -> dict:
        return {"ids": d["tid"], "sim": d["sim"], "valid": d["valid"]}

    assert_topk_close(topk_view(bound["q4"].data), topk_view(flat["q4"].data),
                      atol=1e-4, tie_tol=1e-4, what="ivf_joins gate 2 q4")
    near_r = ((sims - float(r)).abs() <= 1e-4)

    def hit_sets(got, want, what: str, strict: bool) -> dict:
        """Per left row, the hit set of a Q3 answer against the flat one's
        where the flat buffer holds every hit: equal but for rows within
        1e-4 of the radius (``strict``), or a subset (counter)."""
        gi, gv = got["tid"].cpu().numpy(), got["valid"].cpu().numpy()
        wi, wv = want["tid"].cpu().numpy(), want["valid"].cpu().numpy()
        wc, gc = want["count"].cpu().numpy(), got["count"].cpu().numpy()
        near_np = near_r.cpu().numpy()
        held = found = flips = 0
        for i in range(N_QUERIES):
            if wc[i] > MAX_PAIRS:
                continue
            a, b_ = set(gi[i][gv[i]].tolist()), set(wi[i][wv[i]].tolist())
            diff = (a ^ b_) if strict else (a - b_)
            if any(not near_np[i, j] for j in diff):
                raise AssertionError(f"{what}: row {i} hit sets differ off "
                                     f"the radius")
            if strict and abs(int(gc[i]) - int(wc[i])) > len(diff):
                raise AssertionError(f"{what}: row {i} counts {gc[i]} vs "
                                     f"{wc[i]}")
            held += len(b_)
            found += len(a & b_)
            flips += len(diff)
        return {"recall": found / max(held, 1), "boundary_flips": flips,
                "rows_held": int((wc <= MAX_PAIRS).sum())}

    gate2 = {"q3": hit_sets(bound["q3"].data, flat["q3"].data,
                            "ivf_joins gate 2 q3", True)}
    fits = {"q5": ((sims >= r - 1e-4) & q5_mask).sum(1) <= CAPACITY,
            "q6": ((sims >= r - 1e-4) & q6_mask).sum(1) <= CAPACITY}

    def category_lists(got, want, q: str, what: str, exact: bool) -> dict:
        """Per (row, category) list that ``got`` returns on a row whose
        buffer held every hit: equal to ``want``'s (``exact``) or, under
        'counter', its ids among ``want``'s hits.  Returns the recall and
        the categories ``want`` holds and ``got`` lacks."""
        key = "ids" if q == "q5" else "tid"
        gv, wv = got["valid"], want["valid"]
        rows = fits[q][:, None].expand(gv.shape[:2])
        chosen = gv[..., 0] & rows
        lacks = int((wv[..., 0] & ~gv[..., 0] & rows).sum())
        if exact:
            assert_topk_close(
                {"ids": got[key][chosen], "sim": got["sim"][chosen],
                 "valid": gv[chosen]},
                {"ids": want[key][chosen], "sim": want["sim"][chosen],
                 "valid": wv[chosen]}, atol=1e-4, tie_tol=1e-4, what=what)
        w_ids = torch.where(wv, want[key], -2)[..., None, :]
        inside = (got[key][..., :, None] == w_ids).any(-1) & gv
        return {"recall": float((inside & rows[..., None]).sum()
                                / wv[rows].sum()),
                "categories_lacking": lacks,
                "lists_compared": int(chosen.sum())}

    for q in ("q5", "q6"):
        gate2[q] = category_lists(bound[q].data, flat[q].data, q,
                                  f"ivf_joins gate 2 {q}", True)
    gate2["probes_mean"] = {q: float(bound[q]["stats"]["probes"].float()
                                     .mean()) for q in bound}
    # Algorithm 2's effect under the bound: chase beside the plain range
    # probe of chase_no_updatestate (exact too), in probes and latency
    plain_db = connect(cat, engine="chase_no_updatestate", use_pallas=True,
                       probe=bound_db.options.probe)
    alg2 = {}
    for q in ("q5", "q6"):
        b = q5_binds if q == "q5" else join_binds[q]
        st_c, st_n = bound_db.prepare(sql[q]), plain_db.prepare(sql[q])
        plain = st_n.execute(b)
        category_lists(plain.data, flat[q].data, q,
                       f"ivf_joins gate 2 {q} chase_no_updatestate", True)
        pc, pn = bound[q]["stats"]["probes"], plain["stats"]["probes"]
        if not bool((pc <= pn).all()):
            raise AssertionError(f"ivf_joins gate 2 {q}: updateState "
                                 f"probed more than the range probe")
        alg2[q] = {"chase_probes_mean": float(pc.float().mean()),
                   "no_updatestate_probes_mean": float(pn.float().mean()),
                   "rows_stopped_earlier": int((pc < pn).sum()),
                   "chase_ms": latency_ms(lambda: st_c.execute(b), iters=3),
                   "no_updatestate_ms": latency_ms(lambda: st_n.execute(b),
                                                   iters=3)}
    gate2["updatestate"] = alg2

    # gate 3: counter answers are real
    preds = {"q3": q3_mask, "q4": q4_mask, "q5": q5_mask, "q6": q6_mask}
    gate3 = {}
    for key, out in res.items():
        q, e, label = key
        if label.startswith("single") or label == "list4" or not bool(
                (out["stats"]["probes"] > 0).all()):
            continue
        if q == "q5" and label != f"list{N_QUERIES}":
            continue
        ids = out["ids" if q == "q5" else "tid"]
        valid = out["valid"]
        rows = torch.arange(N_QUERIES, device=dev).reshape(
            (-1,) + (1,) * (ids.ndim - 1)).expand(ids.shape)[valid]
        hit = ids[valid].long()
        what = f"ivf_joins gate 3 {q} {e} {label}"
        if not bool(preds[q][rows, hit].all()):
            raise AssertionError(f"{what}: a row fails the predicate")
        err = float((out["sim"][valid] - sims[rows, hit]).abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"{what}: sims {err} off the flat sims")
        if q != "q4" and bool((out["sim"][valid] < r - 1e-4).any()):
            raise AssertionError(f"{what}: a hit below the radius")
        if q in ("q5", "q6"):
            cat_of = out["category"][valid]
            if not torch.equal(level[hit].to(cat_of.dtype), cat_of):
                raise AssertionError(f"{what}: a row in another level")
        if q == "q3":
            quality = hit_sets(out.data, flat["q3"].data, what, False)
        elif q == "q4":
            inside = (out["tid"][..., :, None]
                      == flat["q4"]["tid"][..., None, :]).any(-1) & valid
            quality = {"recall": float(inside.sum()
                                       / flat["q4"]["valid"].sum())}
        else:
            quality = category_lists(out.data, flat[q].data, q, what, False)
        gate3[f"{q}_{e}_{label}"] = {
            **quality, "max_abs_err": err,
            "probes_mean": float(out["stats"]["probes"].float().mean()),
            "evals_mean": float(out["stats"]["distance_evals"].float()
                                .mean())}

    # gate 4: chase under int8 and bf16 = fp32 chase, bit for bit
    exact = ExecutionHints(exact_shape=True)
    for mode in MODES:
        qdb = connect(cat, engine="chase", use_pallas=True, quant=mode,
                      probe=probe)
        for q, bl in (("q3", [{"r": r}]), ("q4", list4["q4"][:1]),
                      ("q5", q5_binds), ("q6", [{"r": r}])):
            text = Q4Y if q == "q4" else sql[q]
            st, fp32 = qdb.prepare(text), dbs["chase"].prepare(text)
            bitwise(st.execute(bl).data, fp32.execute(bl).data,
                    f"ivf_joins gate 4 {q} {mode} list")
            bitwise(st.execute(bl[0]).data,
                    fp32.execute(bl[:1], hints=exact).query(0).data,
                    f"ivf_joins gate 4 {q} {mode} single")

    # gate 5: the straggler valve caps every left row's probes
    per_set = (1, 2, 3, 4)
    for q in ("q3", "q4", "q5", "q6"):
        text = Q4Y if q == "q4" else sql[q]
        st = dbs["chase"].prepare(text)
        calls = ((4, q5_binds if q == "q5" else list4[q][:1]),
                 (tuple(1 + i % 6 for i in range(N_QUERIES)) if q == "q5"
                  else per_set, q5_binds if q == "q5" else list4[q]))
        for budget, bl in calls:
            out = st.execute(bl, hints=ExecutionHints(probe_budget=budget))
            probes = out["stats"]["probes"]
            cap_ = torch.as_tensor(budget, device=dev).reshape(
                (-1,) + (1,) * (probes.ndim - 1))
            if not bool(((probes <= cap_) & (probes >= 1)).all()):
                raise AssertionError(f"ivf_joins gate 5 {q} budget {budget}:"
                                     f" probes {probes.tolist()}")
    peak = {q: peak_mb(lambda: stmts[q, "chase", "list4"].execute(list4[q]))
            for q in ("q3", "q4", "q6")}
    emit({"phase": "ivf_joins", "radius": float(r), "cap": index.cap,
          "gate1_max_sim_diff": gate1, "bound": gate2, "counter": gate3,
          "list4_peak_mb": peak,
          "gates": ["batch = perleft", "bound = flat", "counter answers real",
                    "quantized = fp32", "probe budget", "launches"]})

    # -- e2e_ivf_joins: each engine and lowering beside the flat path -------
    flat_st = {(q, low): flat_db.prepare(sql[q], hints=hints)
               for q in ("q3", "q4", "q6")
               for low, hints in (("batch", None), ("perleft", perleft))}
    flat_st["q4y"] = flat_db.prepare(Q4Y)
    flat_st["q5"] = flat_db.prepare(Q5)
    calls = []
    for q in ("q3", "q4", "q6"):
        for e in engines[q] + ("brute",):
            for low in ("batch", "perleft"):
                st = flat_st[q, low] if e == "brute" else stmts[q, e, low]
                calls.append((f"{q}_{e}_{low}", st, join_binds[q],
                              N_QUERIES))
        for e in ("chase", "brute"):
            st = (stmts[q, "chase", "list4"] if e == "chase" else
                  flat_st["q4y"] if q == "q4" else flat_st[q, "batch"])
            calls.append((f"{q}_{e}_list4", st, list4[q], 4 * N_QUERIES))
    for e in engines["q5"] + ("brute",):
        st = flat_st["q5"] if e == "brute" else stmts["q5", e]
        calls.append((f"q5_{e}_single", st, q5_binds[0], 1))
        calls += [(f"q5_{e}_list{qn}", st, q5_binds[:qn], qn)
                  for qn in BATCHES]
    e2e = {}
    for label, st, b, rows in calls:
        # the probed perleft loops and the 400-row lists take 0.5-3 s a call
        slow = label.endswith("list4") or (
            "perleft" in label and "pase" not in label
            and "brute" not in label)
        iters, warmup = (2, 1) if slow else (3, 2)
        for _ in range(warmup):
            st.execute(b)
        # the peak above what the warm-up left resident and the loop
        # counters of one execute come from the timed executes themselves
        # (each execute of the same binds does the same rounds): no execute
        # of its own for them, which the script's time can spare
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ivf_mod.loop_stats.update(rounds=0, syncs=0)
        ms = latency_ms(lambda: st.execute(b), iters=iters, warmup=0)
        mb = (torch.cuda.max_memory_allocated() - base) / 2**20
        loops = {k: v // iters if v % iters == 0 else v / iters
                 for k, v in ivf_mod.loop_stats.items()}
        e2e[label] = {"latency_ms": ms, "left_rows_per_s": rows * 1e3 / ms,
                      "peak_mb": mb, **loops}
    emit({"phase": "e2e_ivf_joins", "device": name, "nvidia_smi": smi,
          "runs": e2e})

    # -- ivf_category_profile: where chase Q6's time goes at 100 left rows ---
    st = stmts["q6", "chase", "batch"]
    order = ivf_mod._cluster_order(index, left)[0]
    ids = index.lists[order[:, 0].long()]                     # (100, cap)
    safe = ids.clamp_min(0).long()
    vecs = laion["embedding"][safe]
    keys = -distance_values(Metric.INNER_PRODUCT, vecs, left[:, None, :])
    hit = (ids >= 0) & (keys <= -float(r)) & torch.take_along_dim(
        q6_mask, safe, dim=1)
    C, Kc = laion.schema["calorie_level"].num_categories, K_CATEGORY
    state = {"seen": torch.zeros((N_QUERIES, C), dtype=torch.bool,
                                 device=dev),
             "counts": torch.zeros((N_QUERIES, C), dtype=torch.int32,
                                   device=dev),
             "kth": torch.full((N_QUERIES, C, Kc), float("inf"), device=dev),
             "no_new": torch.zeros(N_QUERIES, dtype=torch.int32, device=dev)}
    cat_ids = torch.arange(C, dtype=level.dtype, device=dev)
    buf_i = torch.full((N_QUERIES, CAPACITY + 1), -1, dtype=torch.int32,
                       device=dev)
    buf_k = torch.full((N_QUERIES, CAPACITY + 1), float("inf"), device=dev)
    count0 = torch.zeros(N_QUERIES, dtype=torch.int32, device=dev)

    def onehot():
        cats = torch.where(hit, level[safe], -1)
        oh = cats[..., None] == cat_ids
        return oh, oh.sum(1, dtype=torch.int32)

    oh, _ = onehot()

    def merge():
        cand = torch.where(oh, keys[..., None], float("inf")).transpose(1, 2)
        return torch.topk(torch.cat([state["kth"], cand], dim=2), Kc, dim=2,
                          largest=False).values

    def append():
        pos = count0[:, None] + torch.cumsum(hit, 1) - 1
        ok = hit & (pos < CAPACITY)
        slot = torch.where(ok, pos, CAPACITY)
        buf_i.scatter_(1, slot, torch.where(ok, ids, -1))
        buf_k.scatter_(1, slot, torch.where(ok, keys, float("inf")))

    part = {"order": time_ms(lambda: ivf_mod._cluster_order(index, left)),
            "gather": time_ms(lambda: (laion["embedding"][safe],
                                       torch.take_along_dim(q6_mask, safe,
                                                            dim=1))),
            "product": time_ms(lambda: distance_values(
                Metric.INNER_PRODUCT, vecs, left[:, None, :])),
            "one_hot": time_ms(onehot), "category_merge": time_ms(merge),
            "append": time_ms(append)}
    del vecs, keys, oh
    lat = latency_ms(lambda: st.execute(join_binds["q6"]), iters=3)
    ivf_mod.loop_stats.update(rounds=0, syncs=0)
    st.execute(join_binds["q6"])
    torch.cuda.synchronize()
    rounds = ivf_mod.loop_stats["rounds"]
    ms = {"order": part["order"],
          **{key: rounds * v for key, v in part.items() if key != "order"}}
    ms["host_and_other"] = lat - sum(ms.values())
    emit({"phase": "ivf_category_profile", "device": name, "nvidia_smi": smi,
          "left_rows": N_QUERIES, "cap": index.cap, "latency_ms": lat,
          "rounds": rounds, "round_ms": {key: v for key, v in part.items()
                                          if key != "order"},
          "events_ms": ms, "events_share": {key: v / lat
                                            for key, v in ms.items()}})
    torch.cuda.empty_cache()


def serve_phase(cat, qv, r, index, reset_counts, counts, launches, record,
                smi: str, name: str) -> None:
    """The ``serve`` phase: Q1 served through ``db.serve`` (the
    BatchScheduler and the ResilientScheduler) and ``QueryServer``, flat
    (``brute``, ``use_pallas=True``: its drains launch scan_topk_batch) and
    over the ``ivf`` phase's index (``chase``), with 7 of every 8 requests
    at selectivity 0.3 and the 8th at about 0.002 so probe counts vary;
    held to four gates, then the ``e2e_serve`` line."""
    import asyncio

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.api import ExecutionHints, connect
    from repro_torch.core.physical import ProbeConfig
    from repro_torch.data import selectivity_threshold
    from repro_torch.launch.serve import QueryServer, ServeConfig
    from repro_torch.serving import (AdmissionConfig, BackpressureError,
                                     DeadlineExceededError, DegradePolicy,
                                     FaultInjector, FaultSpec,
                                     InjectedKernelError, PoisonedBindError,
                                     ResilientScheduler, SchedulerConfig,
                                     SimRecord, latency_stats,
                                     run_effort_bucketed, validate_binds)
    from repro_torch.testing import assert_topk_close

    price = cat.table("products")["price"]
    p_bulk = np.float32(selectivity_threshold(price, SELECTIVITY))
    p_needle = np.float32(selectivity_threshold(price, NEEDLE))

    def requests(n: int, start: int = 0) -> list:
        return [{"qv": qv[i % N_QUERIES],
                 "p": p_needle if i % 8 == 7 else p_bulk}
                for i in range(start, start + n)]

    probe = ProbeConfig(**IVF_PROBE)
    engines = ("brute", "chase")
    dbs = {e: connect(cat, engine=e, use_pallas=True, probe=probe)
           for e in engines}
    stmts = {e: dbs[e].prepare(Q1, K=K) for e in engines}
    config = SchedulerConfig(max_batch=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS)
    buckets = [1 << b for b in range(SERVE_BATCH.bit_length())]

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    def recording(sched, drains: list):
        """Record each drain's binds list and its execute's host and
        CUDA-event times (the execute ends in a synchronize)."""
        inner = sched.execute

        def execute(binds_list):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            start.record()
            try:
                out = inner(binds_list)
            except Exception:
                drains.append({"binds": binds_list, "failed": True})
                raise
            end.record()
            end.synchronize()
            drains.append({"binds": binds_list, "failed": False,
                           "host_ms": (time.perf_counter() - t) * 1e3,
                           "event_ms": start.elapsed_time(end)})
            return out

        sched.execute = execute
        return sched

    def poisson(n: int, rate: float, seed: int) -> np.ndarray:
        return np.random.default_rng(seed).exponential(1.0 / rate,
                                                       n).cumsum()

    # gate 1: coalescing is exact.  100 requests on a virtual clock (60
    # staggered, 40 in a burst); every served request equals its row of a
    # direct execute of the same drained list, bit for bit, and its own
    # single dict under the tie rule.  Flat, every drained list, and a list
    # of each length that fills or pads every bucket the phase reaches
    # (max_batch 32: buckets 1 to 32), also match use_pallas=False on the
    # card, the kernels' plain versions
    plain = connect(cat, engine="brute", use_pallas=False).prepare(Q1, K=K)

    def held_plain(got, bl: list, what: str) -> float:
        want = plain.execute(bl)
        torch.cuda.synchronize()
        return assert_topk_close(got.data, want.data, atol=1e-4,
                                 tie_tol=1e-4, what=what)

    gate1, served = {}, {}
    arrivals = np.concatenate([poisson(60, 2000.0, 1),
                               np.full(40, 0.0)])
    arrivals[60:] = arrivals[59] + 0.001
    for e in engines:
        clock, drains = Clock(), []
        sched = recording(dbs[e].serve(stmts[e], max_batch=SERVE_BATCH,
                                       max_wait_ms=SERVE_WAIT_MS), drains)
        sched.clock = clock
        bl = requests(100)
        reset_counts()
        rids = []
        for t, b in zip(arrivals, bl):
            clock.t = float(t)
            rids.append(sched.submit_request(b))
            sched.poll()
        clock.t += 1.0
        sched.flush()
        torch.cuda.synchronize()
        launches[f"serve_{e}"] = counts()
        if sched.counters["failed"] or sched.counters["executed"] != 100:
            raise AssertionError(f"serve gate 1 {e}: {sched.counters}")
        out = {rid: sched.result(rid) for rid in rids}
        served[e] = out
        by_binds = {id(b): rid for rid, b in zip(rids, bl)}
        err = plain_err = 0.0
        for d in drains:
            direct = stmts[e].execute(d["binds"])
            if e == "brute":
                got = held_plain(direct, d["binds"],
                                 f"serve gate 1 drain of {len(d['binds'])}")
                record("scan_topk_batch", got)
                plain_err = max(plain_err, got)
            for i, b in enumerate(d["binds"]):
                rid = by_binds[id(b)]
                bitwise(out[rid], direct.query(i).data,
                        f"serve gate 1 {e} rid {rid}")
                one = stmts[e].execute(b)
                err = max(err, assert_topk_close(
                    out[rid], one.data, atol=1e-4, tie_tol=1e-4,
                    what=f"serve gate 1 {e} rid {rid} single"))
        gate1[e] = {"drains": [len(d["binds"]) for d in drains],
                    "max_single_sim_diff": err,
                    "max_plain_err": plain_err,
                    "probes_mean": float(np.mean(
                        [float(o["stats"]["probes"]) for o in out.values()]))}
    if launches["serve_brute"]["scan_topk_batch"] < 1:
        raise AssertionError("serve: brute drains launched no "
                             "scan_topk_batch")
    by_size = {}
    for size in (1, 2, 3, 4, 7, 8, 13, 16, 29, 32):
        bl = requests(size, start=size)
        reset_counts()
        got = stmts["brute"].execute(bl)
        torch.cuda.synchronize()
        ran = [kname for kname, v in counts().items() if v]
        err = held_plain(got, bl, f"serve gate 1 list of {size}")
        for kname in ran:
            record(kname, err)
        by_size[size] = {"bucket": got.explain().bucket, "kernels": ran,
                         "max_abs_err": err}
    gate1["brute"]["plain_by_size"] = by_size
    if any(launches["serve_chase"].values()):
        raise AssertionError(f"serve: chase drains launched "
                             f"{launches['serve_chase']}")

    # gate 2: effort = lock-step, bit for bit, counters included
    st = stmts["chase"]
    bl = requests(64, start=100)
    binds = st._stack_binds(bl, {})
    lock = st.executor(binds)
    nat = lock["stats"]["probes"].cpu().numpy()
    pilot = int(np.percentile(nat, 75)) + 1
    eff, info = run_effort_bucketed(st, binds, pilot)
    torch.cuda.synchronize()
    bitwise(eff, lock, "serve gate 2 chase q1")
    if info["n_heavy"] < 1 or info["n_light"] < 1:
        raise AssertionError(f"serve gate 2: the pilot split nothing {info}")
    gate2 = {"q1": {**info, "probes": np.bincount(nat).tolist(),
                    "lockstep_ms": latency_ms(lambda: st.executor(binds),
                                              iters=3),
                    "effort_ms": latency_ms(
                        lambda: run_effort_bucketed(st, binds, pilot),
                        iters=3)}}
    q3 = dbs["chase"].prepare(Q3)
    radii = np.array([r - 0.01, r, r + 0.01, r + 0.02], np.float32)
    list4 = [{"r": x} for x in radii]
    lock = q3.execute(list4)
    nat = lock["stats"]["probes"].cpu().numpy()
    pilot = int(np.percentile(nat, 75)) + 1
    eff = q3.execute(list4, hints=ExecutionHints(pilot_budget=pilot))
    bitwise(eff.data, lock.data, "serve gate 2 chase q3 list4")
    # half the bind sets under a budget above their own probes (light),
    # half at it (heavy)
    per_set = np.where(np.arange(4) % 2 == 0, nat.max(1) + 1,
                       np.maximum(nat.max(1), 1)).astype(np.int32)
    eff2, info2 = run_effort_bucketed(q3, q3._stack_binds(list4, {}),
                                      per_set)
    bitwise(eff2, lock.data, "serve gate 2 chase q3 list4 per set")
    if info2["n_heavy"] < 1 or info2["n_light"] < 1:
        raise AssertionError(f"serve gate 2 q3: no split {info2}")
    gate2["q3_list4"] = {"scalar": eff.explain().effort, "per_set": info2,
                         "probes_max_per_set": nat.max(1).tolist()}
    torch.cuda.synchronize()

    # gate 3: deadlines and containment under seeded faults (kernel
    # errors, latency spikes, poisoned binds, catalog bumps re-registering
    # the index), on a virtual clock
    gate3 = {}
    for e in engines:
        clock, drains = Clock(), []
        inj = FaultInjector(
            FaultSpec(seed=0, latency_spike_p=0.2, latency_spike_ms=6.0,
                      kernel_error_p=0.2, poison_bind_p=0.05,
                      catalog_bump_p=0.3),
            bump_fn=lambda: cat.register_index("products", "embedding",
                                               index),
            sleep_fn=lambda s: setattr(clock, "t", clock.t + s))
        sched = recording(ResilientScheduler(
            stmts[e], SchedulerConfig(max_batch=SERVE_BATCH,
                                      max_wait_ms=SERVE_WAIT_MS,
                                      default_deadline_ms=8.0),
            clock=clock, policy=DegradePolicy(steps=()), faults=inj), drains)
        rebinds = stmts[e].compiled.rebinds
        rids, poisoned = {}, 0
        for i, b in enumerate(requests(160, start=200)):
            clock.t += 0.0004
            b, _poisoned = inj.maybe_poison(b)
            try:
                validate_binds(b)
            except PoisonedBindError:
                poisoned += 1
                continue
            rids[sched.submit_request(b)] = b
            if i % 12 == 11:
                sched.poll()
        sched.flush()
        torch.cuda.synchronize()
        shed, failed, ok = [], 0, {}
        for rid in rids:
            try:
                ok[rid] = sched.result(rid)
            except DeadlineExceededError:
                shed.append(rid)
            except InjectedKernelError:
                failed += 1
        executed = {id(b) for d in drains for b in d["binds"]}
        if any(id(rids[rid]) in executed for rid in shed):
            raise AssertionError(f"serve gate 3 {e}: a shed request reached "
                                 f"an execute")
        want_failed = sum(len(d["binds"]) for d in drains if d["failed"])
        snap = sched.snapshot()
        if not failed == snap["failed"] == want_failed:
            raise AssertionError(f"serve gate 3 {e}: failed {failed}, "
                                 f"counted {snap['failed']}, members of "
                                 f"failed drains {want_failed}")
        if poisoned != inj.counters["poisoned_binds"]:
            raise AssertionError(f"serve gate 3 {e}: poison not all caught")
        # results after a bump equal those before it: each served drain
        # again, now, and a fixed list around one more bump
        by_binds = {id(b): rid for rid, b in rids.items()}
        for d in drains:
            if d["failed"]:
                continue
            again = stmts[e].execute(d["binds"])
            for i, b in enumerate(d["binds"]):
                bitwise(ok[by_binds[id(b)]].data, again.query(i).data,
                        f"serve gate 3 {e} after bumps")
        fixed = requests(32)
        before = stmts[e].execute(fixed)
        cat.register_index("products", "embedding", index)
        bitwise(stmts[e].execute(fixed).data, before.data,
                f"serve gate 3 {e} across a bump")
        gate3[e] = {**{k: snap[k] for k in ("submitted", "executed",
                                            "batches", "shed_deadline",
                                            "failed")},
                    "faults": snap["faults"], "poisoned_at_door": poisoned,
                    "rebinds": stmts[e].compiled.rebinds - rebinds}
        if not (snap["shed_deadline"] and snap["failed"]
                and snap["faults"]["catalog_bumps"]):
            raise AssertionError(f"serve gate 3 {e}: a fault never fired "
                                 f"{gate3[e]}")

    # gate 4: degradation under a burst past the watermarks: degraded
    # answers report it and stay within the level's budget; undegraded
    # drains equal lock-step
    clock, drains = Clock(), []
    policy = DegradePolicy(steps=((96, 8), (192, 4)), hysteresis=16)
    sched = recording(ResilientScheduler(st, config, clock=clock,
                                         policy=policy), drains)
    bl = requests(256, start=400)
    pos = {id(b): i for i, b in enumerate(bl)}
    rids = [sched.submit_request(b) for b in bl]
    sched.flush()
    flat = stmts["brute"].execute(bl)
    torch.cuda.synchronize()
    flat_ids = flat["ids"].cpu().numpy()
    levels, recall = {}, {}
    for d_i, d in enumerate(drains):
        idx = [pos[id(b)] for b in d["binds"]]
        res = [sched.result(rids[i]) for i in idx]
        deg = res[0].explain().degraded
        if any(x.explain().degraded != deg for x in res):
            raise AssertionError("serve gate 4: a drain reported two levels")
        level = 0 if deg is None else deg["level"]
        levels[d_i] = level
        if deg is None:
            direct = st.execute(d["binds"])
            for i, x in enumerate(res):
                bitwise(x.data, direct.query(i).data,
                        f"serve gate 4 drain {d_i}")
            continue
        for i, x in zip(idx, res):
            if int(x["stats"]["probes"]) > deg["probe_budget"]:
                raise AssertionError(f"serve gate 4: query {i} probed "
                                     f"{int(x['stats']['probes'])} over "
                                     f"{deg['probe_budget']}")
            got = x["ids"][x["valid"]].cpu().numpy()
            recall.setdefault(level, []).append(
                len(np.intersect1d(got, flat_ids[i])) / K)
    if set(levels.values()) != {0, 1, 2}:
        raise AssertionError(f"serve gate 4: levels {levels}")
    gate4 = {"levels_by_drain": list(levels.values()),
             "load": sched.snapshot()["load"],
             "recall_at_50": {f"level{k}": float(np.mean(v))
                              for k, v in recall.items()},
             "budgets": dict(policy.steps)}
    emit({"phase": "serve", "device": name, "nvidia_smi": smi,
          "needle_selectivity": NEEDLE, "p_bulk": float(p_bulk),
          "p_needle": float(p_needle), "coalescing": gate1,
          "effort": gate2, "faults": gate3, "degradation": gate4,
          "gates": ["coalescing exact", "effort = lock-step",
                    "deadlines and containment", "degradation"]})

    # -- e2e_serve: naive per-request loop and the scheduler under Poisson
    # arrivals at 0.3, 1 and 3 x the batch capacity; per-drain host and
    # device time; the front door
    sims, drain_times = {}, {}
    for e in engines:
        st = stmts[e]
        n = SERVE_REQUESTS[e]
        bl = requests(n)
        sched = dbs[e].serve(st, config)
        sched.warm(bl[0], buckets)
        for b in bl[:2]:
            st.execute(b)
        t32 = min(latency_ms(lambda: st.execute(bl[:SERVE_BATCH]), iters=1,
                             warmup=0) for _ in range(3))
        capacity = SERVE_BATCH * 1e3 / t32
        sims[e] = {"batch_ms": t32, "capacity_qps": capacity, "requests": n}
        reset_counts()
        for mult in SERVE_RATES:
            arrivals = poisson(n, capacity * mult, 7)
            free, recs = 0.0, []
            for i, (t, b) in enumerate(zip(arrivals, bl)):
                start = max(free, float(t))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st.execute(b)
                torch.cuda.synchronize()
                free = start + time.perf_counter() - t0
                recs.append(SimRecord(i, float(t), start, free, 1))
            sched_recs = sched.simulate(arrivals, bl)
            sims[e][f"x{mult}"] = {
                "rate_qps": capacity * mult, "naive": latency_stats(recs),
                "sched": latency_stats(sched_recs),
                "sched_mean_batch": float(np.mean(
                    [rec.batch_size for rec in sched_recs]))}
        torch.cuda.synchronize()
        launches[f"serve_{e}_sim"] = counts()
        # per drain: the drain's host time (poll to synchronize) beside the
        # CUDA-event time of the execute inside it, and the device's busy
        # time (torch.profiler, kernels and copies) over the same drains
        drain_times[e] = {}
        for size in (1, 8, SERVE_BATCH):
            drains = []
            sched = recording(dbs[e].serve(st, max_batch=size,
                                           max_wait_ms=0.0), drains)
            host = []
            for rep in range(8):
                for b in requests(size, start=rep * size):
                    sched.submit(**b)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sched.poll()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
            with tprofile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                for rep in range(4):
                    for b in requests(size, start=rep * size):
                        sched.submit(**b)
                    sched.poll()
                torch.cuda.synchronize()
            busy = sum(ev.self_device_time_total
                       for ev in prof.key_averages()
                       if ev.device_type == DeviceType.CUDA) / 1e3 / 4
            drain_ms = statistics.median(host[2:])
            drain_times[e][f"batch{size}"] = {
                "drain_host_ms": drain_ms,
                "execute_host_ms": statistics.median(
                    d["host_ms"] for d in drains[2:8]),
                "execute_event_ms": statistics.median(
                    d["event_ms"] for d in drains[2:8]),
                "device_busy_ms": busy,
                "host_share": (1.0 - busy / drain_ms) if busy else None}

    # the front door: a staggered-then-burst run through QueryServer (the
    # reference demo's shape), and one under seeded faults
    async def front_door(st, n: int, faults=None) -> dict:
        cfg = ServeConfig(
            admission=AdmissionConfig(max_queue_depth=64),
            scheduler=SchedulerConfig(max_batch=SERVE_BATCH,
                                      max_wait_ms=SERVE_WAIT_MS,
                                      default_deadline_ms=200.0),
            policy=DegradePolicy(steps=((16, 8), (48, 4)), hysteresis=4),
            idle_tick_ms=5.0)
        outcomes = {"ok": 0, "degraded": 0, "backpressure": 0,
                    "deadline": 0, "kernel_error": 0, "poisoned": 0}
        bl = requests(n)

        async def one(i: int) -> None:
            try:
                await asyncio.sleep(i * 0.001 if i < n // 2 else 0)
                res = await server.submit(bl[i])
            except BackpressureError:
                outcomes["backpressure"] += 1
            except DeadlineExceededError:
                outcomes["deadline"] += 1
            except InjectedKernelError:
                outcomes["kernel_error"] += 1
            except PoisonedBindError:
                outcomes["poisoned"] += 1
            else:
                outcomes["degraded" if res.explain().degraded
                         else "ok"] += 1

        server = QueryServer(st, cfg, faults=faults)
        server.scheduler.warm(bl[0], buckets)
        t0 = time.perf_counter()
        async with server:
            await asyncio.wait_for(asyncio.gather(*(one(i)
                                                    for i in range(n))),
                                   timeout=300)
            snap = server.snapshot()
        wall = time.perf_counter() - t0
        if sum(outcomes.values()) != n or snap["in_flight"]:
            raise AssertionError(f"serve front door: unresolved requests "
                                 f"{outcomes} {snap}")
        if outcomes["kernel_error"] != snap["failed"]:
            raise AssertionError(f"serve front door: failed {snap['failed']}"
                                 f" vs {outcomes}")
        return {"requests": n, "wall_s": wall, "outcomes": outcomes,
                "snapshot": snap}

    doors = {}
    for e in engines:
        reset_counts()
        doors[e] = asyncio.run(front_door(stmts[e], 128))
        torch.cuda.synchronize()
        launches[f"serve_{e}_front_door"] = counts()
    # seed 1's first kernel-error draw (0.332) is under 0.35, so the first
    # drain fails however the wall clock groups the requests
    doors["chase_faults"] = asyncio.run(front_door(
        stmts["chase"], 128, FaultInjector(
            FaultSpec(seed=1, latency_spike_p=0.1, latency_spike_ms=5.0,
                      kernel_error_p=0.35, poison_bind_p=0.05,
                      catalog_bump_p=0.1),
            bump_fn=lambda: cat.register_index("products", "embedding",
                                               index))))
    snap = doors["chase_faults"]["snapshot"]
    if not (snap["faults"]["kernel_errors"] and snap["failed"]):
        raise AssertionError(f"serve front door: no injected error fired "
                             f"{doors['chase_faults']}")
    for path in ("serve_brute_sim", "serve_brute_front_door"):
        if launches[path]["scan_topk_batch"] < 1:
            raise AssertionError(f"{path} launched no scan_topk_batch")
    if launches["serve_brute_sim"]["scan_topk"] < 1:
        raise AssertionError("the naive loop launched no scan_topk")
    for path in ("serve_chase_sim", "serve_chase_front_door"):
        if any(launches[path].values()):
            raise AssertionError(f"{path} launched {launches[path]}")
    emit({"phase": "e2e_serve", "device": name, "nvidia_smi": smi,
          "max_batch": SERVE_BATCH, "max_wait_ms": SERVE_WAIT_MS,
          "simulated": sims, "per_drain": drain_times,
          "front_door": doors})
    torch.cuda.empty_cache()


def sharded_phase(cat, qv, p, r, drive, launches, smi: str,
                  name: str) -> None:
    """The ``sharded`` phase: every class under ``EngineOptions(dist=
    DistSpec((1,), ("data",)))`` on the card against the flat bucketed path
    (``brute``, ``use_pallas=True``), held to four gates (bit for bit, pad
    lanes inert, the mesh keys the plan cache and the handle is registered
    once as a view of the corpus, a mesh of more devices than the machine
    has raises), then the ``e2e_sharded`` line: latency beside the flat
    path at each list length, peak device memory, the merge's share."""
    from repro_torch.api import ExecutionHints, connect
    from repro_torch.core.expr import order_key
    from repro_torch.core.physical import EngineOptions
    from repro_torch.dist import DeviceCountError, DistSpec
    from repro_torch.dist.collectives import _merge_topk

    t_phase = time.perf_counter()
    spec = DistSpec((1,), ("data",))
    flat_opts = dict(engine="brute", use_pallas=True)
    dbs = {mode: (connect(cat, quant=mode, **flat_opts),
                  connect(cat, quant=mode, dist=spec, **flat_opts))
           for mode in (None,) + MODES}
    q1b = [{"qv": qv[i], "p": p} for i in range(N_QUERIES)]
    q1n = [{"qv": qv[i]} for i in range(N_QUERIES)]
    q2b = [{"qv": qv[i], "r": r, "p": p} for i in range(N_QUERIES)]
    q2n = [{"qv": qv[i], "r": r} for i in range(N_QUERIES)]
    q5b = [{"qv": qv[i], "r": r, "ex": np.int32(EX)}
           for i in range(N_QUERIES)]
    lists = {"q1": (Q1, q1b), "q1_nofilter": (Q1_NOFILTER, q1n),
             "q2": (Q2, q2b), "q2_nofilter": (Q2_NOFILTER, q2n),
             "q5": (Q5, q5b)}
    joins = {"q3": (Q3, [{"r": r}]), "q4": (Q4Y, [{"y": np.int32(1980)}]),
             "q6": (Q6, [{"r": r}])}
    need = {"q1": "scan_topk_batch", "q1_nofilter": "scan_topk_batch",
            "q4": "scan_topk_batch", "q2": "range_topk_batch",
            "q2_nofilter": "range_topk_batch", "q3": "range_topk_batch",
            "q5": "range_topk_batch", "q6": "range_topk_batch"}
    qneed = {"q1": ("quant_scan_topk_batch", "replay_keys"),
             "q1_nofilter": ("quant_scan_topk_batch", "replay_keys"),
             "q2": ("quant_keys_batch",), "q2_nofilter": ("quant_keys_batch",)}

    def prep(db_, sql):
        return db_.prepare(sql, K=K) if "${K}" in sql else db_.prepare(sql)

    # -- gate 1: bit for bit the flat bucketed path ------------------------
    held = {}
    for mode in (None,) + MODES:
        flat_db, dist_db = dbs[mode]
        cases = dict(lists, **joins) if mode is None else {
            q: lists[q] for q in ("q1", "q1_nofilter", "q2", "q2_nofilter")}
        for q, (sql, binds) in cases.items():
            st = prep(dist_db, sql)
            want_st = prep(flat_db, sql)
            runs = ([(f"list{qn}", st, binds[:qn], None) for qn in BATCHES]
                    if q in lists else [("left100", st, binds, None)])
            path = f"sharded_{q}" + (f"_{mode}" if mode else "")
            for label, _s, b, _h, res in drive(path, runs):
                want = want_st.execute(b)
                torch.cuda.synchronize()
                bitwise(res.data, want.data, f"sharded gate 1 {path} {label}")
                rep = res.explain()
                if rep.shards != 1 or rep.merge_depth != 1 or \
                        not rep.batch_lowering.startswith("native sharded"):
                    raise AssertionError(f"sharded {path}: {rep.render()}")
            for kname in ((need[q],) if mode is None else qneed[q]):
                if launches[path][kname] < 1:
                    raise AssertionError(f"sharded {path}: no {kname} launch")
            held[path] = len(runs)
    gates = {"bitwise_flat": held}

    # -- gate 2: the 28 pad lanes of bucket 128 ----------------------------
    pads = {}
    for q in ("q1", "q2", "q5"):
        sql, binds = lists[q]
        st = prep(dbs[None][1], sql)
        stacked = st._stack_binds(binds, {})
        out, bucket, valid = st.compiled.executor.run_padded(stacked,
                                                             N_QUERIES)
        torch.cuda.synchronize()
        if bucket != 128 or bool(out["valid"][N_QUERIES:].any()):
            raise AssertionError(f"sharded gate 2 {q}: a pad lane emitted")
        for key, v in out["stats"].items():
            if bool(v[N_QUERIES:].any()):
                raise AssertionError(f"sharded gate 2 {q}: pad {key}")
        if "count" in out and bool(out["count"][N_QUERIES:].any()):
            raise AssertionError(f"sharded gate 2 {q}: a pad lane counted")
        pads[q] = {"bucket": bucket, "pad_lanes": bucket - N_QUERIES}
    gates["pad_lanes_inert"] = pads

    # -- gate 3: the plan cache and the handle -----------------------------
    dist_db = dbs[None][1]
    s1 = prep(dist_db, Q1)
    s1.execute(q1b)
    traces = dict(s1.executor.trace_counts)
    s2 = prep(dist_db, Q1)
    s2.execute(q1b)
    if not s2.cache_hit or s2.executor is not s1.executor or \
            dict(s1.executor.trace_counts) != traces:
        raise AssertionError("sharded gate 3: a same-spec re-prepare built")
    other = DistSpec((1,), ("shard",))
    s3 = dist_db.prepare(Q1, K=K, options=EngineOptions(**flat_opts,
                                                         dist=other))
    if s3.cache_hit or s3.executor is s1.executor:
        raise AssertionError("sharded gate 3: another axis name hit")
    handle = cat.sharded_for("products", "embedding", spec)
    corpus = cat.table("products")["embedding"]
    if handle is None or s1.compiled._arrays["sharded"] is not handle or \
            prep(dist_db, Q1_NOFILTER).compiled._arrays["sharded"] \
            is not handle:
        raise AssertionError("sharded gate 3: the handle is not reused")
    if handle.shards[0].data_ptr() != corpus.data_ptr():
        raise AssertionError("sharded gate 3: one shard copied the corpus")
    gates["plan_cache"] = {"same_spec_hit": True, "other_axis_miss": True,
                           "trace_counts": traces, "handle_is_view": True}

    # -- gate 4: two shards on this machine --------------------------------
    two = DistSpec((2,), ("data",))
    have = torch.cuda.device_count()
    if have < 2:
        try:
            prep(connect(cat, dist=two, **flat_opts), Q1)
        except DeviceCountError as e:
            if f"have {have}" not in str(e):
                raise AssertionError(f"sharded gate 4: {e}") from e
            gates["too_few_devices"] = {"devices": have, "error": str(e)}
        else:
            raise AssertionError("sharded gate 4: two shards ran on one card")
    else:
        res = prep(connect(cat, dist=two, **flat_opts), Q1).execute(q1b)
        bitwise(res.data, prep(dbs[None][0], Q1).execute(q1b).data,
                "sharded gate 4 two cards")
        gates["two_cards_bitwise"] = {"devices": have}

    # -- e2e_sharded ---------------------------------------------------------
    lat = {}
    for q in ("q1", "q2", "q5"):
        sql, binds = lists[q]
        fs, ds = prep(dbs[None][0], sql), prep(dbs[None][1], sql)
        lat[q] = {}
        for qn in BATCHES:
            b = binds[:qn]
            f_ms, d_ms = [], []
            for _ in range(5):                  # in turns
                f_ms.append(latency_ms(lambda: fs.execute(b)))
                d_ms.append(latency_ms(lambda: ds.execute(b)))
            f_ms, d_ms = statistics.median(f_ms), statistics.median(d_ms)
            lat[q][f"list{qn}"] = {"flat_ms": f_ms, "sharded_ms": d_ms,
                                   "ratio": d_ms / f_ms}
    # the merge alone at the shapes of a list of 100 (bucket 128)
    metric = cat.table("products").schema["embedding"].metric
    res = prep(dbs[None][1], Q1).execute(q1b)
    keys = torch.where(res["valid"], order_key(metric, res["sim"]),
                       float("inf"))
    keys = torch.cat([keys, keys[-28:]])
    gids = torch.cat([res["ids"], res["ids"][-28:]])
    merge_q1 = time_ms(lambda: _merge_topk(metric, [keys], [gids], K, (1,),
                                           keys.device))
    res = prep(dbs[None][1], Q2).execute(q2b)
    keys = torch.where(res["valid"], order_key(metric, res["sim"]),
                       float("inf"))
    keys = torch.cat([keys, keys[-28:]])
    gids = torch.cat([res["ids"], res["ids"][-28:]])
    merge_q2 = time_ms(lambda: _merge_topk(metric, [keys], [gids], CAPACITY,
                                           (1,), keys.device))
    peak = {q: {"flat_mb": peak_mb(lambda: prep(dbs[None][0], lists[q][0])
                                   .execute(lists[q][1])),
                "sharded_mb": peak_mb(lambda: prep(dbs[None][1], lists[q][0])
                                      .execute(lists[q][1]))}
            for q in ("q1", "q2")}
    emit({"phase": "sharded", "spec": repr(spec), "gates": gates,
          "launches": {k: v for k, v in launches.items()
                       if k.startswith("sharded_")}})
    emit({"phase": "e2e_sharded", "device": name, "nvidia_smi": smi,
          "latency_ms": lat,
          "merge_ms": {"q1_list100": merge_q1, "q2_list100": merge_q2},
          "merge_share": {
              "q1_list100": merge_q1 / lat["q1"][f"list{N_QUERIES}"][
                  "sharded_ms"],
              "q2_list100": merge_q2 / lat["q2"][f"list{N_QUERIES}"][
                  "sharded_ms"]},
          "peak_mb_list100": peak,
          "resident_mb": torch.cuda.memory_allocated() / 2**20,
          "phase_s": time.perf_counter() - t_phase})


def _same_bits(a: dict, b: dict, what: str, width: int | None = None) -> None:
    """ids, valid and sims (as an int32 view) equal bit for bit, over the
    first ``width`` entries of the last axis when it is given."""
    for key in ("ids", "valid", "sim"):
        x, y = a[key], b[key]
        if width is not None:
            x, y = x[..., :width], y[..., :width]
        if key == "sim":
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {key} differs")


def large_k_phase(cat, qv, p, twins: dict, drive, launches, smi: str,
                  name: str) -> None:
    """The ``large_k`` phase: LIMIT and rank above the top-k kernels' lists
    (``scan_topk.MAX_K`` = 1,024), which the ops-level wrappers route to the
    range kernels at an infinite radius (fp32) or the quantized key kernel
    (int8 / bf16) and a stable smallest-k.  Q1 ``price < p`` at K in
    ``LARGE_K``: single dicts, lists of 1, 8 and 100, stacked and
    exact_shape, a no-predicate single dict and the exact-shape Q = 1 fast
    path; Q4 at ``rank <= 2000`` in both lowerings; Q1 at one shard.
    Gates: fp32 against ``use_pallas=False`` on the card (1e-4, the tie
    rule), the predicate and the order; int8 and bf16 equal to fp32 with
    ``torch.equal`` (at each K the smallest rescore factor whose candidates
    hold every fp32 row; a single dict against the fp32 batched answer of
    one, as the slice_quant phase holds it); the first 1,024 entries of K = 2,000 equal the
    K = 1,024 answer bit for bit (single and list, fp32 and quantized); a
    list's rows equal the lists of 1 and 8 bit for bit, and a single dict
    its row (bit for bit where it runs the batched kernels, quantized;
    under the tie rule where it runs a single-query kernel, fp32, whose
    dot product adds in another order); Q4 batch against perleft likewise;
    one shard = flat; the counters: above 1,024 only the routed kernels
    launch.  Line
    ``e2e_large_k``: e2e ms and peak memory of Q1 at K = 2,000 (and
    10,000) for a single dict and a list of 100, the range kernel's and the
    stage-2 sort's share."""
    from repro_torch.api import ExecutionHints, connect
    from repro_torch.core.expr import evaluate_batch
    from repro_torch.dist import DistSpec
    from repro_torch.index.flat import compact_range
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant as qt_mod
    from repro_torch.kernels import range_scan as rs_mod
    from repro_torch.kernels.scan_topk import MAX_K
    from repro_torch.testing import assert_topk_close

    t_phase = time.perf_counter()
    table = cat.table("products")
    corpus = table["embedding"]
    metric = table.schema["embedding"].metric
    price = table["price"].cpu().numpy()
    exact = ExecutionHints(exact_shape=True)
    flat = connect(cat, engine="brute", use_pallas=True)
    plain = connect(cat, engine="brute", use_pallas=False)
    binds = [{"qv": qv[i], "p": p} for i in range(N_QUERIES)]
    stacked = {"qv": qv, "p": np.full(N_QUERIES, p, np.float32)}
    singles = 3

    def runs_of(st, nst) -> list:
        runs = [(f"single{i}", st, binds[i], None) for i in range(singles)]
        runs += [(f"list{qn}", st, binds[:qn], None) for qn in LARGE_K_LISTS]
        runs += [("stacked", st, stacked, None),
                 ("exact_shape", st, stacked, exact),
                 ("nofilter_single", nst, {"qv": qv[0]}, None),
                 ("fast_path", nst, {"qv": qv[:1]}, exact)]
        return runs

    def answers(db_, k: int, path: str) -> dict:
        st, nst = db_.prepare(Q1, K=k), db_.prepare(Q1_NOFILTER, K=k)
        return {label: res for label, _s, _b, _h, res in
                drive(path, runs_of(st, nst))}

    # -- gate 1: fp32 against use_pallas=False; the K = 1,024 answers --------
    fp32, held = {}, {}
    for k in (MAX_K,) + LARGE_K:
        fp32[k] = answers(flat, k, f"large_k{k}")
        if k == MAX_K:
            continue
        st, nst = plain.prepare(Q1, K=k), plain.prepare(Q1_NOFILTER, K=k)
        for label, s, b, h in runs_of(st, nst):
            res = fp32[k][label]
            want = s.execute(b, hints=h)
            torch.cuda.synchronize()
            err = assert_topk_close(res.data, want.data, atol=1e-4,
                                    tie_tol=1e-4,
                                    what=f"large_k K={k} {label}")
            ids = res["ids"].cpu().numpy().reshape(-1, k)
            sims_k = res["sim"].cpu().numpy().reshape(-1, k)
            # 300,000 rows pass the predicate: every list is full
            if not bool(res["valid"].all()) or not np.isfinite(sims_k).all():
                raise AssertionError(f"large_k K={k} {label}: short result")
            if s is st and not (price[ids] < p).all():
                raise AssertionError(f"large_k K={k} {label}: price >= p")
            if (np.diff(sims_k, axis=1) > 0).any():
                raise AssertionError(f"large_k K={k} {label}: not sorted")
            held[f"{k}/{label}"] = {"shape": list(res["ids"].shape),
                                    "max_abs_err": err}
    gates = {"fp32_vs_plain": held}

    # -- gate 2: the K = 2,000 prefix; a list's rows ------------------------
    def row(res, i: int) -> dict:
        return {key: res[key][i] for key in ("ids", "valid", "sim")}

    def prefix_and_rows(ans: dict, what: str, single_bits: bool) -> dict:
        """The K = 2,000 prefix and the rows of a list bit for bit; a
        single dict against its row bit for bit where it runs the batched
        kernels (``single_bits``), else under the tie rule: the
        single-query kernels add a row's dot product in another order than
        the batched tiles (K = 1,024 as well)."""
        for label in ans[MAX_K]:
            _same_bits(ans[2000][label].data, ans[MAX_K][label].data,
                       f"large_k prefix {what} {label}", MAX_K)
        single = {}
        for k in (MAX_K,) + LARGE_K:
            lst = ans[k][f"list{N_QUERIES}"]
            _same_bits(row(lst, 0), row(ans[k]["list1"], 0),
                       f"large_k K={k} {what} row 0 = list1")
            _same_bits(row(lst, slice(8)), ans[k]["list8"].data,
                       f"large_k K={k} {what} rows = list8")
            err, differ = 0.0, 0
            for i in range(singles):
                one = ans[k][f"single{i}"]
                if single_bits:
                    _same_bits(row(lst, i), one.data,
                               f"large_k K={k} {what} row {i} = single")
                    continue
                err = max(err, assert_topk_close(
                    row(lst, i), {key: one[key] for key in
                                  ("ids", "valid", "sim")},
                    atol=1e-4, tie_tol=1e-4,
                    what=f"large_k K={k} {what} row {i} vs single"))
                differ += int((row(lst, i)["sim"].view(torch.int32)
                               != one["sim"].view(torch.int32)).sum())
            single[k] = ({"bitwise": True} if single_bits else
                         {"max_abs_err": err, "sims_bits_differ": differ,
                          "of": singles * k})
        return single

    gates["prefix_1024"] = True
    gates["single_vs_row"] = {"fp32": prefix_and_rows(fp32, "fp32", False)}

    # -- gate 3: quantized = fp32, bit for bit -------------------------------
    live = (table["price"] < p).view(torch.int8)
    qs = torch.from_numpy(qv).to(corpus.device)

    def missing(qkeys, k: int, c: int, top) -> int:
        """Queries whose fp32 top-k ``top`` holds a row outside the rows of
        the quantized top-(c·k) segments (ranked by their minima over the
        whole corpus, as the routed quantized path ranks them)."""
        segs = torch.arange(qkeys.shape[1], dtype=torch.int32,
                            device=qkeys.device).expand_as(qkeys)
        rows = qt_mod.candidate_rows(qkeys, segs, c * k).long()
        inside = torch.zeros((qkeys.shape[0], N_ROWS + 8), dtype=torch.bool,
                             device=qkeys.device)
        inside.scatter_(1, rows.clamp(max=N_ROWS + 7), True)
        return int((~inside.gather(1, top.long()).all(1)).sum())

    # a quantized single dict runs the batched kernels at Q = 1, so its
    # fp32 counterpart is the batched answer of one: a row of the list of
    # 100 (rows do not depend on Q), or the batched wrapper on the
    # no-predicate query (the fp32 fast path runs the single-query kernel)
    batched = {}
    for k in (MAX_K,) + LARGE_K:
        lst = fp32[k][f"list{N_QUERIES}"]
        ids_, sims_, valid_ = ops.fused_scan_topk_batch(corpus, qs[:1], k,
                                                        None, metric)
        nof = {"ids": ids_, "sim": sims_, "valid": valid_}
        batched[k] = {label: (row(lst, int(label[6:]))
                              if label.startswith("single") else
                              row(nof, 0) if label == "nofilter_single" else
                              nof if label == "fast_path" else res)
                      for label, res in fp32[k].items()}
    coverage = {}
    for mode in MODES:
        qc = twins[mode]
        # the predicate's 100 queries and the no-predicate query
        qkeys = [qt_mod.segment_minima(qt_mod.quant_keys_batch(
            qc.qvecs, qc.scales, q_, m_, None, metric))
            for q_, m_ in ((qs, live), (qs[:1], None))]
        coverage[mode], quant = {}, {}
        for k in (MAX_K,) + LARGE_K:
            tops = (fp32[k][f"list{N_QUERIES}"]["ids"],
                    batched[k]["fast_path"]["ids"])
            miss = {}
            for c in RESCORE:
                miss[c] = sum(missing(qk, k, c, top)
                              for qk, top in zip(qkeys, tops))
                if miss[c] == 0:
                    break
            else:
                raise AssertionError(f"large_k {mode} K={k}: no rescore "
                                     f"factor in {RESCORE} covers fp32")
            coverage[mode][k] = {"missing_queries": miss,
                                 "rescore_factor": c}
            quant[k] = answers(connect(cat, engine="brute", use_pallas=True,
                                       quant=mode, rescore_factor=c),
                               k, f"large_k{k}_{mode}")
            for label, res in quant[k].items():
                for key in ("ids", "sim", "valid"):
                    if not torch.equal(res[key], batched[k][label][key]):
                        raise AssertionError(f"large_k {mode} K={k} {label}: "
                                             f"{key} differs from fp32")
        gates["single_vs_row"][mode] = prefix_and_rows(quant, mode, True)
        del qkeys, quant
    gates["quant_equals_fp32"] = coverage

    # -- gate 4: Q4 at rank <= 2,000, batch = perleft ------------------------
    q4_sql = Q4.replace("ranked.rank <= 50", "ranked.rank <= 2000")
    q4_runs = [("batch", flat.prepare(q4_sql), {}, None),
               ("perleft", flat.prepare(q4_sql, hints=ExecutionHints(
                   join_lowering="perleft")), {}, None)]
    q4 = {}
    for label, s, b, h, res in drive("large_k_q4", q4_runs):
        want = plain.prepare(s.sql, hints=s.hints).execute(b, hints=h)
        torch.cuda.synchronize()
        as_topk = [{"ids": d["tid"], "sim": d["sim"], "valid": d["valid"],
                    "stats": d["stats"]} for d in (res.data, want.data)]
        err = assert_topk_close(*as_topk, atol=1e-4, tie_tol=1e-4,
                                what=f"large_k q4 {label}")
        if not bool(res["valid"].all()):
            raise AssertionError(f"large_k q4 {label}: short lists")
        q4[label] = {"shape": list(res["tid"].shape), "max_abs_err": err}
        q4[f"_{label}"] = res
    # perleft runs the single-query kernel: the tie rule, as above
    q4["batch_vs_perleft_err"] = assert_topk_close(
        *[{"ids": q4[f"_{lw}"]["tid"], "valid": q4[f"_{lw}"]["valid"],
           "sim": q4[f"_{lw}"]["sim"]} for lw in ("batch", "perleft")],
        atol=1e-4, tie_tol=1e-4, what="large_k q4 batch vs perleft")
    del q4["_batch"], q4["_perleft"]
    gates["q4"] = q4

    # -- gate 5: one shard = flat --------------------------------------------
    sharded = connect(cat, engine="brute", use_pallas=True,
                      dist=DistSpec((1,), ("data",))).prepare(Q1, K=2000)
    for label, _s, _b, _h, res in drive("large_k_sharded", [
            (f"list{N_QUERIES}", sharded, binds, None),
            ("single0", sharded, binds[0], None)]):
        want = fp32[2000][f"list{N_QUERIES}"]
        _same_bits(res, row(want, 0) if label == "single0" else want,
                   f"large_k sharded {label}")
    gates["sharded_equals_flat"] = True

    # -- gate 6: the counters -------------------------------------------------
    stage1 = ("scan_topk", "scan_topk_batch", "quant_scan_topk_batch")
    need = {"": ("range_scan_batch", "range_scan")}
    need.update({f"_{m}": ("quant_keys_batch", "replay_keys") for m in MODES})
    for k in LARGE_K:
        for suffix, kernels_ in need.items():
            got = launches[f"large_k{k}{suffix}"]
            if any(got[kname] for kname in stage1) or \
                    not all(got[kname] for kname in kernels_):
                raise AssertionError(f"large_k{k}{suffix}: launches {got}")
    for path, kernels_ in (("large_k_q4", ("range_scan_batch",
                                           "range_scan")),
                           ("large_k_sharded", ("range_scan_batch",))):
        got = launches[path]
        if any(got[kname] for kname in stage1) or \
                not all(got[kname] for kname in kernels_):
            raise AssertionError(f"{path}: launches {got}")
    if not launches[f"large_k{MAX_K}"]["scan_topk_batch"]:
        raise AssertionError("large_k at K = 1,024 left the top-k kernels")
    emit({"phase": "large_k", "k": list(LARGE_K), "gates": gates,
          "launches": {key: v for key, v in launches.items()
                       if key.startswith("large_k")}})

    # -- e2e_large_k ----------------------------------------------------------
    runs = {}
    bucket = 128
    mask = evaluate_batch(flat.prepare(Q1, K=2000).compiled.analysis
                          .structured_predicate, table,
                          {"qv": np.concatenate([qv, qv[-28:]]),
                           "p": np.full(bucket, p, np.float32)},
                          bucket).contiguous().view(torch.int8)
    qvalid = (torch.arange(bucket, device=corpus.device)
              < N_QUERIES).to(torch.int8)
    q128 = torch.cat([qs, qs[-28:]]).contiguous()
    inf128 = torch.full((bucket,), float("inf"), device=corpus.device)
    for k in (2000, LARGE_K[-1]):
        st = flat.prepare(Q1, K=k)
        for key, b in (("single", binds[0]), (f"list{N_QUERIES}", binds)):
            ms = latency_ms(lambda: st.execute(b))
            runs[f"{k}/{key}"] = {
                "latency_ms": ms,
                "qps": (1 if key == "single" else N_QUERIES) * 1e3 / ms,
                "peak_mb": peak_mb(lambda: st.execute(b))}
        keys = rs_mod.range_scan_batch(corpus, q128, inf128, mask, qvalid,
                                       metric)[0]
        k_ms = time_ms(lambda: rs_mod.range_scan_batch(
            corpus, q128, inf128, mask, qvalid, metric), 2, 5)
        s_ms = time_ms(lambda: compact_range(keys, k, metric), 2, 5)
        row_ = runs[f"{k}/list{N_QUERIES}"]
        row_.update(kernel_ms=k_ms, stage2_ms=s_ms,
                    kernel_share=k_ms / row_["latency_ms"],
                    stage2_share=s_ms / row_["latency_ms"])
        del keys
    emit({"phase": "e2e_large_k", "device": name, "nvidia_smi": smi,
          "runs": runs,
          "phase_s": time.perf_counter() - t_phase})


def adaptive_phase(cat, qv, r, drive, launches, smi: str, name: str) -> None:
    """The ``adaptive`` phase (shaped after benchmarks/q14_adaptive.py):
    ``connect(cat, adaptive=True)`` with the card's ``CostModel`` over the
    ``ivf`` phase's index under ``chase``.  Workloads: ``single`` (Q1, a
    list of 100 at the serve phase's selectivity mix), ``join`` (Q3 over
    100 left rows, one bind set) and ``flat`` (brute Q1, which must decide
    lock-step for want of a probe lane).  Each is warmed 3 times, then runs
    lock-step, under the static p75 pilot and adaptive, 10 each, in turns.
    Four gates: the three policies bit for bit, a second advisor fed the
    same observations decides the same, no executor built after the
    warm-up, hints beat the advisor.  Line ``e2e_adaptive``: the policies'
    ms, decision sources, host copies per adaptive execute, the cost
    model's constants and this run's own measurements of them."""
    from repro_torch.api import ExecutionHints, connect
    from repro_torch.core.physical import ProbeConfig
    from repro_torch.data import selectivity_threshold
    from repro_torch.opt import CostModel, LoweringAdvisor
    from repro_torch.serving import scheduler as sched_mod

    t_phase = time.perf_counter()
    probe = ProbeConfig(**IVF_PROBE)
    price = cat.table("products")["price"]
    p_bulk = np.float32(selectivity_threshold(price, SELECTIVITY))
    p_needle = np.float32(selectivity_threshold(price, NEEDLE))
    single = [{"qv": qv[i], "p": p_needle if i % 8 == 7 else p_bulk}
              for i in range(N_QUERIES)]
    adb = connect(cat, adaptive=True, engine="chase", use_pallas=True,
                  probe=probe)
    pdb = connect(cat, engine="chase", use_pallas=True, probe=probe)
    advisor = adb.advisor
    if advisor.cost.describe() != CostModel().describe():
        raise AssertionError("adaptive: the session's advisor is not on the "
                             "card's cost model")
    # record what the advisor sees, to replay it into a second one (gate 2)
    seen, copies = [], {"counters": 0}
    real_advise, real_observe = advisor.advise_batch, advisor.observe
    real_counters = sched_mod.host_counters

    def advise(compiled, binds):
        d = real_advise(compiled, binds)
        seen.append([compiled, binds, d, None])
        return d

    def observe(compiled, decision, counters, latency_ms=0.0):
        seen[-1][3] = {k: np.copy(v) for k, v in counters.items()}
        return real_observe(compiled, decision, counters, latency_ms)

    def counted(out):
        copies["counters"] += 1
        return real_counters(out)

    advisor.advise_batch, advisor.observe = advise, observe
    sched_mod.host_counters = counted
    try:
        work = {"single": (Q1, single, K), "join": (Q3, [{"r": r}], None)}
        out, decisions = {}, {}
        for wname, (sql, binds, k) in work.items():
            kw = {"K": k} if k else {}
            ast, pst = adb.prepare(sql, **kw), pdb.prepare(sql, **kw)
            lock = pst.execute(binds)
            nat = lock["stats"]["probes"].cpu().numpy()
            pilot = int(np.percentile(nat, 75)) + 1
            policies = {
                "lockstep": lambda: pst.execute(binds),
                "pilot_p75": lambda: pst.execute(
                    binds, hints=ExecutionHints(pilot_budget=pilot)),
                "adaptive": lambda: ast.execute(binds)}
            for _ in range(3):                          # warm-up
                for fn in policies.values():
                    fn()
            torch.cuda.synchronize()
            traces = {pol: dict((ast if pol == "adaptive" else pst)
                                .executor.trace_counts) for pol in policies}
            ms = {pol: [] for pol in policies}
            last, adaptive_copies = {}, []
            for _ in range(10):
                for pol, fn in policies.items():
                    c0 = copies["counters"]
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    last[pol] = fn()
                    torch.cuda.synchronize()
                    ms[pol].append((time.perf_counter() - t) * 1e3)
                    if pol == "adaptive":
                        adaptive_copies.append(copies["counters"] - c0)
            # gate 1: the three policies bit for bit, counters included
            for pol in ("pilot_p75", "adaptive"):
                bitwise(last[pol].data, last["lockstep"].data,
                        f"adaptive gate 1 {wname} {pol}")
            # gate 3: nothing built after the warm-up
            for pol in policies:
                now = dict((ast if pol == "adaptive" else pst)
                           .executor.trace_counts)
                if now != traces[pol]:
                    raise AssertionError(f"adaptive gate 3 {wname} {pol}: "
                                         f"{traces[pol]} -> {now}")
            opt = last["adaptive"].explain().opt
            decisions[wname] = opt
            out[wname] = {
                "ms": {pol: statistics.median(v) for pol, v in ms.items()},
                "pilot_p75": pilot, "probes_mean": float(nat.mean()),
                "decision": opt,
                "effort": last["adaptive"].explain().effort,
                "host_copies_per_execute": adaptive_copies,
                "trace_counts": traces["adaptive"]}
        # the flat lane: brute Q1 has no probe lane
        fdb = connect(cat, adaptive=True, engine="brute", use_pallas=True)
        fst = fdb.prepare(Q1, K=K)
        res = drive("adaptive_flat", [("list100", fst, single, None)])[0][4]
        opt = res.explain().opt
        if opt["path"] != "lockstep" or opt["source"] != "flat":
            raise AssertionError(f"adaptive flat: {opt}")
        if launches["adaptive_flat"]["scan_topk_batch"] < 1:
            raise AssertionError("adaptive flat: no scan_topk_batch launch")
        bitwise(res.data, connect(cat, engine="brute", use_pallas=True)
                .prepare(Q1, K=K).execute(single).data, "adaptive flat")
        out["flat"] = {"decision": opt,
                       "ms": latency_ms(lambda: fst.execute(single))}
    finally:
        advisor.advise_batch, advisor.observe = real_advise, real_observe
        sched_mod.host_counters = real_counters
    # gate 2: a second advisor fed the same observations decides the same
    twin = LoweringAdvisor(cat)
    stream, replay = [], []
    for compiled, binds, d, counters in seen:
        d2 = twin.advise_batch(compiled, binds)
        stream.append(d.summary())
        replay.append(d2.summary())
        twin.observe(compiled, d2, counters)
    if stream != replay:
        raise AssertionError("adaptive gate 2: the decision streams differ")
    sources = {}
    for s in stream:
        sources[s["source"]] = sources.get(s["source"], 0) + 1
    # gate 4: hints beat the advisor
    ast = adb.prepare(Q1, K=K)
    for hints in (ExecutionHints(exact_shape=True),
                  ExecutionHints(pilot_budget=4),
                  ExecutionHints(probe_budget=6),
                  ExecutionHints(no_opt=True)):
        rep = ast.execute(single, hints=hints).explain()
        if rep.path == "opt" or rep.opt is not None:
            raise AssertionError(f"adaptive gate 4: {hints} lost")
    # this run's own measure of the card's constants: quantized Q1 against
    # fp32 at a list of 64, and a probed row against a streamed flat row
    flat_st = connect(cat, engine="brute", use_pallas=True).prepare(Q1, K=K)
    q_st = {m: connect(cat, engine="brute", use_pallas=True, quant=m)
            .prepare(Q1, K=K) for m in MODES}
    b64 = single[:64]
    f64, m64 = [], {m: [] for m in MODES}
    for _ in range(3):
        f64.append(latency_ms(lambda: flat_st.execute(b64), iters=5))
        for m in MODES:
            m64[m].append(latency_ms(lambda: q_st[m].execute(b64), iters=5))
    f64 = statistics.median(f64)
    chase_st = pdb.prepare(Q1, K=K)
    evals = float(chase_st.execute(single)["stats"]["distance_evals"]
                  .double().mean())
    chase_ms = out["single"]["ms"]["lockstep"]
    flat_ms = latency_ms(lambda: flat_st.execute(single))
    measured = {f"{m}_speedup": f64 / statistics.median(m64[m])
                for m in MODES}
    measured["ivf_gather_penalty"] = ((chase_ms / N_QUERIES / evals)
                                      / (flat_ms / N_QUERIES / N_ROWS))
    measured.update(fp32_list64_ms=f64, chase_list100_ms=chase_ms,
                    flat_list100_ms=flat_ms, chase_evals_per_query=evals)
    emit({"phase": "adaptive", "gates": {
        "bitwise_policies": ["single", "join"],
        "decision_stream_replayed": len(stream),
        "no_new_executors": True, "hints_win": True,
        "flat_lockstep": True},
        "launches": {k: v for k, v in launches.items()
                     if k.startswith("adaptive_")}})
    emit({"phase": "e2e_adaptive", "device": name, "nvidia_smi": smi,
          "workloads": out, "decision_sources": sources,
          "cost_model": CostModel().describe(),
          "measured_constants": measured,
          "phase_s": time.perf_counter() - t_phase})


def interp_phase(cat, qv, p, drive, launches, reset_counts, counts,
                 smi: str, name: str) -> None:
    """The ``interp`` phase: the Volcano interpreter
    (``repro_torch.core.interpreter.run_interpreted``) runs Q1 (K = 50,
    ``price < p`` at selectivity 0.3) over a subsample of ``INTERP_ROWS``
    rows of the products table, built on the card with ``Table.take``
    (sorted seeded row indices), for ``INTERP_QUERIES`` queries bound as
    tensors on the card.  One gate: the interpreted sample ids hold against
    the compiled flat Q1 on the same subsample (``brute``,
    ``use_pallas=True``: ``scan_topk``) by ``assert_topk_close``'s rule,
    the interpreted rows' sims taken as the interpreter takes them (one
    float32 numpy dot per row); the interpreter launches no kernel.  Line
    ``e2e_interp``: the interpreted ms (host copies of the columns
    included), the same scaled to the corpus's rows (labelled ``scaled``,
    as benchmarks/q1_vknn.py does), the compiled Q1 on the subsample and on
    the full corpus (a single dict and a list of 100), the ratios and the
    four counters."""
    from repro_torch.api import connect
    from repro_torch.core.interpreter import run_interpreted
    from repro_torch.core.schema import Catalog
    from repro_torch.testing import assert_topk_close

    t_phase = time.perf_counter()
    products = cat.table("products")
    dev = products.device
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randperm(products.num_rows, generator=gen,
                         device=dev)[:INTERP_ROWS].sort().values
    sub = products.take(idx)
    sub_cat = Catalog()
    sub_cat.register("products", sub)
    sub_ids = sub["sample_id"].cpu().numpy()
    sub_vecs = sub["embedding"].cpu().numpy()
    sub_price = sub["price"].cpu().numpy()
    pos_of = {int(s): i for i, s in enumerate(sub_ids)}
    qv_dev = torch.from_numpy(qv).to(dev)
    stmt = connect(sub_cat, engine="brute", use_pallas=True).prepare(Q1, K=K)

    interp_ms, counters, interp = [], [], []
    for i in range(INTERP_QUERIES):
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        rows, ctr = run_interpreted(Q1, sub_cat, {"qv": qv_dev[i], "p": p,
                                                  "K": K})
        interp_ms.append((time.perf_counter() - t) * 1e3)
        if any(counts().values()):
            raise AssertionError(f"the interpreter launched {counts()}")
        ids = np.array([int(r["sample_id"]) for r in rows], np.int64)
        pos = np.array([pos_of[s] for s in ids], np.int64)
        sims = np.array([float(np.dot(sub_vecs[j], qv[i])) for j in pos],
                        np.float32)
        if len(ids) != K or not (sub_price[pos] < p).all():
            raise AssertionError(f"interp query {i}: {len(ids)} rows, or a "
                                 f"row fails price < p")
        interp.append({"ids": ids, "sim": sims,
                       "valid": np.ones(len(ids), bool)})
        counters.append(dataclasses.asdict(ctr))
    results = drive("interp_compiled", [
        (f"single{i}", stmt, {"qv": qv[i], "p": p}, None)
        for i in range(INTERP_QUERIES)])
    if launches["interp_compiled"]["scan_topk"] < INTERP_QUERIES:
        raise AssertionError(f"compiled Q1 on the subsample launched "
                             f"{launches['interp_compiled']}")
    errs = []
    for i, (label, _s, _b, _h, res) in enumerate(results):
        valid = res["valid"].cpu().numpy()
        compiled = {"ids": np.where(valid, sub_ids[res["ids"].cpu().numpy()
                                                   .clip(0)], -1),
                    "sim": res["sim"].cpu().numpy(), "valid": valid}
        errs.append(assert_topk_close(interp[i], compiled, atol=1e-4,
                                      tie_tol=1e-4,
                                      what=f"interp q1 {label}"))
    full = connect(cat, engine="brute", use_pallas=True).prepare(Q1, K=K)
    binds = [{"qv": qv[i], "p": p} for i in range(N_QUERIES)]
    sub_single = latency_ms(lambda: stmt.execute(binds[0]))
    single = latency_ms(lambda: full.execute(binds[0]))
    list100 = latency_ms(lambda: full.execute(binds))
    interp_med = statistics.median(interp_ms)
    scaled = interp_med * products.num_rows / INTERP_ROWS
    emit({"phase": "interp", "rows": INTERP_ROWS, "queries": INTERP_QUERIES,
          "max_abs_err": max(errs), "launches": launches["interp_compiled"]})
    emit({"phase": "e2e_interp", "device": name, "nvidia_smi": smi,
          "subsample_rows": INTERP_ROWS, "corpus_rows": products.num_rows,
          "interpreted_ms": interp_ms, "interpreted_ms_median": interp_med,
          "scaled": True, "interpreted_ms_scaled": scaled,
          "compiled_subsample_single_ms": sub_single,
          "compiled_single_ms": single, "compiled_list100_ms": list100,
          "ratio_scaled_over_single": scaled / single,
          "ratio_scaled_over_list100_per_query": scaled / (list100
                                                           / N_QUERIES),
          "ratio_subsample_single": interp_med / sub_single,
          "counters": counters,
          "phase_s": time.perf_counter() - t_phase})


def _tree_equal(a: dict, b: dict, what: str) -> None:
    """Two result trees equal leaf for leaf with ``torch.equal``."""
    if set(a) != set(b):
        raise AssertionError(f"{what}: keys {sorted(a)} != {sorted(b)}")
    for key in a:
        if isinstance(a[key], dict):
            _tree_equal(a[key], b[key], f"{what}.{key}")
        elif not torch.equal(a[key].to(b[key].device), b[key]):
            raise AssertionError(f"{what}.{key}: not bit for bit")


def _rewrite_header(path: str, **fields) -> None:
    """Rewrite header fields of an on-disk plan-cache entry, keeping its
    framing and checksums valid."""
    import struct

    from repro_torch.core.aot import MAGIC
    with open(path, "rb") as f:
        blob = f.read()
    off = len(MAGIC)
    (hlen,) = struct.unpack(">I", blob[off:off + 4])
    header = json.loads(blob[off + 4:off + 4 + hlen].decode())
    header.update(fields)
    hj = json.dumps(header, sort_keys=True).encode()
    with open(path, "wb") as f:
        f.write(MAGIC + struct.pack(">I", len(hj)) + hj
                + blob[off + 4 + hlen:])


def aot_child(data_path: str, cache_dir: str, build_dir: str,
              out_path: str, device: str) -> None:
    """A child of the ``aot`` phase (``chip_smoke.py --aot-child ...``):
    with ``build.BUILD_DIR`` set to an empty directory before any kernel
    loads, it rebuilds the products table from the parent's ``torch.save``,
    connects with ``aot_cache_path``, prepares Q1 and runs it at lists of
    ``AOT_CHILD_BATCHES``, then saves the outputs and prints one JSON line:
    the wall-clock time of the first result, the ``nvcc`` runs, the cache
    counters and the executor's state."""
    from pathlib import Path

    from repro_torch.kernels import build
    build.BUILD_DIR = Path(build_dir)
    from repro_torch.api import connect
    from repro_torch.core.schema import Catalog, Table

    blob = torch.load(data_path, map_location=device, weights_only=False)
    cat = Catalog()
    cat.register("products", Table(blob["schema"], blob["columns"]))
    db = connect(cat, engine="brute", use_pallas=True,
                 aot_cache_path=cache_dir)
    t = time.perf_counter()
    stmt = db.prepare(Q1, K=K)
    prepare_ms = (time.perf_counter() - t) * 1e3
    qv, p = blob["qv"], blob["p"]
    outs, first_ms, first_result_at = {}, {}, None
    for qn in AOT_CHILD_BATCHES:
        t = time.perf_counter()
        res = stmt.execute([{"qv": qv[i], "p": p} for i in range(qn)])
        if device != "cpu":
            torch.cuda.synchronize()
        first_ms[qn] = (time.perf_counter() - t) * 1e3
        if first_result_at is None:
            first_result_at = time.time()
        outs[f"q1_list{qn}"] = {k: v.cpu() for k, v in res.data.items()
                                if isinstance(v, torch.Tensor)}
    torch.save(outs, out_path)
    ex = stmt.executor
    print(json.dumps({"first_result_at": first_result_at,
                      "finished_at": time.time(),
                      "prepare_ms": prepare_ms, "first_execute_ms": first_ms,
                      "nvcc": build.BUILDS,
                      "nvcc_s": sum(b["seconds"] for b in build.BUILDS),
                      "aot": db.cache_info().aot,
                      "trace_counts": ex.trace_counts,
                      "aot_loaded": ex.aot_loaded,
                      "libraries": sorted(os.listdir(build_dir))}),
          flush=True)


class AotChildren:
    """The ``aot`` phase's child processes (:func:`aot_child`) and their
    scratch directory.  ``start`` writes the products table and the binds
    with one ``torch.save`` and spawns child A on an empty cache right
    after the catalog is built, so its cold ``nvcc`` runs beside the
    ``full``, ``slice``, ``slice_quant`` and ``lm_gates`` phases, which
    time nothing;
    ``join_a`` waits for it before the ``ivf`` phase, the first that
    times anything; ``aot_phase`` runs child B on A's cache.  ``close``
    (also at exit) stops every child still running and removes the
    directory."""

    def __init__(self, cat, qv, p):
        import atexit
        import tempfile
        self.work = tempfile.mkdtemp(prefix="chip_smoke_aot_")
        self.procs = []
        atexit.register(self.close)
        products = cat.table("products")
        self.device = products.device
        self.data_path = os.path.join(self.work, "products.pt")
        t = time.perf_counter()
        torch.save({"schema": products.schema,
                    "columns": dict(products.columns),
                    "qv": qv[:N_QUERIES], "p": p}, self.data_path)
        self.save_s = time.perf_counter() - t
        self.cache_a = os.path.join(self.work, "cache_a")
        self.a = self.spawn("a", self.cache_a)
        self.rep_a = None

    def spawn(self, tag: str, cache_dir: str):
        build_dir = os.path.join(self.work, f"build_{tag}")
        os.makedirs(build_dir)
        out = os.path.join(self.work, f"out_{tag}.pt")
        log = open(os.path.join(self.work, f"log_{tag}.txt"), "w+")
        started = time.time()
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--aot-child",
             self.data_path, cache_dir, build_dir, out, self.device.type],
            stdout=log, stderr=subprocess.STDOUT, text=True)
        self.procs.append((proc, log))
        return proc, log, started, out

    def finish(self, tag: str, child) -> dict:
        proc, log, started, out = child
        rc = proc.wait(timeout=600)
        log.seek(0)
        text = log.read()
        if rc != 0:
            raise AssertionError(f"aot child {tag} exited {rc}:\n{text}")
        rep = json.loads(text.strip().splitlines()[-1])
        rep["first_result_s"] = rep.pop("first_result_at") - started
        rep["wall_s"] = rep.pop("finished_at") - started
        rep["outputs"] = torch.load(out, map_location=self.device)
        return rep

    def join_a(self) -> dict:
        """Child A's report, waiting for it the first time (the seconds
        waited are ``join_wait_s``)."""
        if self.rep_a is None:
            t = time.perf_counter()
            self.rep_a = self.finish("a", self.a)
            self.rep_a["join_wait_s"] = time.perf_counter() - t
        return self.rep_a

    def close(self) -> None:
        import shutil
        for proc, log in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(self.work, ignore_errors=True)


def aot_phase(cat, qv, p, r, children: AotChildren, reset_counts, counts,
              launches, smi: str, name: str) -> None:
    """The ``aot`` phase: the on-disk plan cache (``connect(...,
    aot_cache_path=...)``, ``repro_torch.core.aot``) over Q1 (a single dict
    and lists of 1, 8, 100), Q2 (a list of 100) and Q3 (the batch
    lowering, one bind set), ``brute`` with ``use_pallas=True``.

    In process, four sessions each prepare the three statements and run
    the six executions once: no cache, a cold cache (entries saved), a new
    ``Database`` on the same path (disk hits), and the same ``Database``
    again (plan-cache hits).  Across processes, two children
    (:class:`AotChildren`), each with an empty ``build.BUILD_DIR``: child A
    on an empty cache pays ``nvcc`` (started after the catalog was built);
    child B on A's cache restores the library from its annex.

    Gates: every result of every session and child equals the uncached
    session's with ``torch.equal``; the cache counters are exact (cold: 5
    misses and 5 saves; disk: 5 hits; plan-cache hits add none); restored
    buckets have ``trace_counts`` 0 and count in ``aot_loaded``; child B
    runs no ``nvcc``; a truncated entry and a stale catalog token each give
    one typed cold miss, then equal results.  Line ``e2e_aot``: prepare and
    first-execute ms per session, the children's wall time from spawn to
    first result and their ``nvcc`` seconds, entry and library sizes."""
    import shutil
    import warnings

    from repro_torch.api import AOTCacheWarning, connect

    t_phase = time.perf_counter()
    work = children.work
    try:
        stmts = {"q1": (Q1, {"K": K}), "q2": (Q2, {}), "q3": (Q3, {})}
        q1b = [{"qv": qv[i], "p": p} for i in range(N_QUERIES)]
        q2b = [{"qv": qv[i], "r": r, "p": p} for i in range(N_QUERIES)]
        runs = {"q1_single": ("q1", q1b[0]), "q1_list1": ("q1", q1b[:1]),
                "q1_list8": ("q1", q1b[:8]), "q1_list100": ("q1", q1b),
                "q2_list100": ("q2", q2b), "q3_batch": ("q3", [{"r": r}])}
        opts = dict(engine="brute", use_pallas=True)

        def session(db, label: str) -> dict:
            prep, first, data, sts = {}, {}, {}, {}
            for key, (sql, static) in stmts.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                sts[key] = db.prepare(sql, **static)
                prep[key] = (time.perf_counter() - t) * 1e3
            reset_counts()
            for run, (key, binds) in runs.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = sts[key].execute(binds)
                torch.cuda.synchronize()
                first[run] = (time.perf_counter() - t) * 1e3
                data[run] = res.data
            launches[f"aot_{label}"] = counts()
            for kname in ("scan_topk", "scan_topk_batch",
                          "range_topk_batch"):
                if launches[f"aot_{label}"][kname] < 1:
                    raise AssertionError(f"aot {label}: {kname} not "
                                         f"launched")
            return {"statements": sts, "data": data, "prepare_ms": prep,
                    "first_execute_ms": first,
                    "prepare_ms_total": sum(prep.values()),
                    "first_execute_ms_total": sum(first.values()),
                    "aot": db.cache_info().aot,
                    "plan_cache": dataclasses.asdict(db.cache_info())}

        cache_dir = os.path.join(work, "cache")
        sessions = {"uncached": session(connect(cat, **opts), "uncached")}
        sessions["cold"] = session(
            connect(cat, aot_cache_path=cache_dir, **opts), "cold")
        disk_db = connect(cat, aot_cache_path=cache_dir, **opts)
        sessions["disk"] = session(disk_db, "disk")
        sessions["memory"] = session(disk_db, "memory")
        want = sessions["uncached"]["data"]
        for label in ("cold", "disk", "memory"):
            for run in runs:
                _tree_equal(sessions[label]["data"][run], want[run],
                            f"aot {label} {run}")
        entries = len(runs) - 1            # the single dict rides no bucket
        zero = {"hits": 0, "misses": 0, "corrupt": 0, "stale": 0,
                "errors": 0, "saves": 0}
        expect = {"cold": dict(zero, misses=entries, saves=entries),
                  "disk": dict(zero, hits=entries),
                  "memory": dict(zero, hits=entries)}
        for label, want_aot in expect.items():
            if sessions[label]["aot"] != want_aot:
                raise AssertionError(f"aot {label}: counters "
                                     f"{sessions[label]['aot']} != "
                                     f"{want_aot}")
        if sessions["memory"]["plan_cache"]["hits"] != len(stmts):
            raise AssertionError("aot memory: the plan cache missed")
        for key, st in sessions["disk"]["statements"].items():
            ex = st.executor
            if any(ex.trace_counts.values()) or not ex.aot_loaded \
                    or set(ex.aot_loaded) != set(ex.trace_counts):
                raise AssertionError(f"aot disk {key}: trace_counts "
                                     f"{ex.trace_counts}, aot_loaded "
                                     f"{ex.aot_loaded}")
        files = sorted(f for f in os.listdir(cache_dir) if f.endswith(".aot"))
        kdir = os.path.join(cache_dir, "kernels")
        libs = sorted(os.listdir(kdir)) if os.path.isdir(kdir) else []

        # poisons: a truncated entry and a stale token, on copies
        ex = sessions["cold"]["statements"]["q1"].executor
        (sig8,) = [sig for (b, sig) in ex._aot_exec if b == 8]
        entry = os.path.basename(ex._aot.cache.entry_path(ex._aot, 8, sig8))
        poisons = {}
        for poison, counter in (("truncated", "corrupt"),
                                ("catalog_token", "stale")):
            pdir = os.path.join(work, f"poison_{poison}")
            shutil.copytree(cache_dir, pdir)
            path = os.path.join(pdir, entry)
            if poison == "truncated":
                with open(path, "r+b") as f:
                    f.truncate(os.path.getsize(path) // 2)
            else:
                _rewrite_header(path, catalog_token="deadbeef" * 8)
            pdb = connect(cat, aot_cache_path=pdir, **opts)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = pdb.prepare(Q1, K=K).execute(q1b[:8])
            typed = [str(w.message) for w in caught
                     if issubclass(w.category, AOTCacheWarning)]
            info = pdb.cache_info().aot
            if (info[counter] != 1 or info["saves"] != 1 or len(typed) != 1
                    or counter not in typed[0]):
                raise AssertionError(f"aot poison {poison}: {info} {typed}")
            _tree_equal(res.data, want["q1_list8"], f"aot poison {poison}")
            poisons[poison] = {"aot": info, "warning": typed[0]}

        rep_a = children.join_a()
        rep_b = children.finish("b", children.spawn("b", children.cache_a))
        for tag, rep in (("a", rep_a), ("b", rep_b)):
            for run, out in rep.pop("outputs").items():
                _tree_equal(out, {k: v for k, v in want[run].items()
                                  if isinstance(v, torch.Tensor)},
                            f"aot child {tag} {run}")
        n_child = len(AOT_CHILD_BATCHES)
        if rep_a["aot"]["saves"] != n_child or rep_b["aot"] != dict(
                zero, hits=n_child):
            raise AssertionError(f"aot children: {rep_a['aot']} / "
                                 f"{rep_b['aot']}")
        if rep_b["nvcc"] or any(rep_b["trace_counts"].values()):
            raise AssertionError(f"aot child b built {rep_b['nvcc']} "
                                 f"{rep_b['trace_counts']}")
        if children.device.type == "cuda" and (not rep_a["nvcc"]
                                   or not rep_b["libraries"]):
            raise AssertionError("aot child a built nothing, or child b "
                                 "restored no library")
        summary = {label: {k: v for k, v in s.items()
                           if k not in ("statements", "data")}
                   for label, s in sessions.items()}
        emit({"phase": "aot", "entries": files, "libraries": libs,
              "poisons": poisons,
              "launches": {k: v for k, v in launches.items()
                           if k.startswith("aot_")}})
        emit({"phase": "e2e_aot", "device": name, "nvidia_smi": smi,
              "sessions": summary,
              "prepare_saved_ms_disk": (summary["uncached"]
                                        ["prepare_ms_total"]
                                        - summary["disk"]["prepare_ms_total"]),
              "entry_bytes": sum(os.path.getsize(os.path.join(cache_dir, f))
                                 for f in files),
              "library_bytes": sum(os.path.getsize(os.path.join(kdir, f))
                                   for f in libs),
              "children": {"a": rep_a, "b": rep_b},
              "nvcc_saved_s": rep_a["nvcc_s"] - rep_b["nvcc_s"],
              "data_save_s": children.save_s,
              "phase_s": time.perf_counter() - t_phase})
    finally:
        children.close()


def live_phase(cat, qv, p, r, drive, launches, reset_counts, counts,
               smi: str, name: str) -> None:
    """The ``live`` phase: a live corpus attached to products.embedding of
    a catalog sharing the frozen tables, Q1–Q6 over it flat (``brute``,
    ``use_pallas=True``), plain (``use_pallas=False``), under ``chase``
    over its own IVF and under int8 / bf16 (Q1, Q2), held to five gates
    (zero delta, mutations through prepared plans, compaction = fresh
    attach, recovery from disk alone, the front door), then the
    ``e2e_live`` line.  Every directory it writes lies under one temporary
    directory, removed at the end."""
    import asyncio
    import gc
    import shutil
    import tempfile

    from repro_torch.api import ExecutionHints, connect
    from repro_torch.checkpoint import checkpointer as ckpt_mod
    from repro_torch.core.physical import ProbeConfig
    from repro_torch.core.schema import Catalog, ColumnKind, Table
    from repro_torch.data import mutations as mut
    from repro_torch.data.laion import CORPUS_ALIASES, QUERY_ALIASES
    from repro_torch.data.mutations import attach_live, recover
    from repro_torch.dist import DistSpec
    from repro_torch.index import build_ivf
    from repro_torch.kernels import quant as qt_mod
    from repro_torch.launch.serve import QueryServer, ServeConfig
    from repro_torch.serving import (AdmissionConfig, FaultInjector,
                                     FaultSpec, InjectedCrashError,
                                     SchedulerConfig)
    from repro_torch.testing import assert_range_close, assert_topk_close

    t_phase = time.perf_counter()
    metric = cat.table("products").schema["embedding"].metric
    products = cat.table("products")
    dev = products["embedding"].device
    scalar = [n for n, t in products.schema.columns.items()
              if t.kind != ColumnKind.VECTOR]
    live_sql = {"q1": Q1, "q2": Q2.replace("FROM images", "FROM products"),
                "q3": Q3.replace("images", "products"),
                "q4": Q4Y.replace("movies", "products"),
                "q5": Q5.replace("recipes", "products"),
                "q6": Q6.replace("recipes", "products")}
    frozen_sql = {"q1": Q1.replace("products", "images"), "q2": Q2,
                  "q3": Q3, "q4": Q4Y, "q5": Q5, "q6": Q6}
    q1_binds = [{"qv": qv[i], "p": p} for i in range(N_QUERIES)]
    binds = {"q1": q1_binds,
             "q2": [{"qv": qv[i], "r": r, "p": p} for i in range(N_QUERIES)],
             "q3": {"r": r},
             "q4": [{"y": np.int32(1980)}, {"y": np.int32(2000)}],
             "q5": [{"qv": qv[i], "r": r, "ex": np.int32(EX)}
                    for i in range(N_QUERIES)],
             "q6": {"r": r}}
    kinds = {"q1": "topk", "q2": "range", "q3": "range", "q4": "topk",
             "q5": "category", "q6": "category"}
    probe = ProbeConfig(**IVF_PROBE)

    def clock(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def catalog_of(corpus_table) -> Catalog:
        """A catalog with ``corpus_table`` under every corpus alias and the
        frozen query tables (no tensor is copied)."""
        c = Catalog()
        for alias in CORPUS_ALIASES:
            c.register(alias, corpus_table)
        for alias in QUERY_ALIASES:
            c.register(alias, cat.table(alias))
        return c

    def statements(c, qs_=tuple(live_sql), **opts) -> dict:
        db_ = connect(c, **opts)
        return {q: db_.prepare(live_sql[q], K=K) if q == "q1"
                else db_.prepare(live_sql[q]) for q in qs_}

    def uid_view(data: dict, to_uid) -> dict:
        """A result with its row ids mapped to user ids (and no
        counters: a live scan counts its padded segments)."""
        key = "ids" if "ids" in data else "tid"
        out = {k: v for k, v in data.items() if k != "stats"}
        ids = data[key]
        out[key] = torch.where(data["valid"], torch.as_tensor(
            to_uid(ids.cpu().numpy()), device=ids.device), -1)
        return out

    def held(got: dict, want: dict, q: str, what: str) -> float:
        """One answer against another within 1e-4: top-k under the tie
        rule, range buffers and each category list as range buffers."""
        if kinds[q] == "topk":
            if "tid" in want:
                got, want = ({"ids": d["tid"], **{k: v for k, v in d.items()
                                                  if k != "tid"}}
                             for d in (got, want))
            return assert_topk_close(got, want, atol=1e-4, tie_tol=1e-4,
                                     what=what)
        if kinds[q] == "range":
            return assert_range_close(got, want, radius=r, atol=1e-4,
                                      tie_tol=1e-4, what=what)
        for key in ("category", "qid"):
            if key in want and not torch.equal(got[key], want[key]):
                raise AssertionError(f"{what}: {key} differs")
        key = "ids" if "ids" in want else "tid"

        def view(d):
            return {key: d[key], "sim": d["sim"], "valid": d["valid"],
                    "count": d["valid"].sum(-1)}

        return assert_range_close(view(got), view(want), radius=r,
                                  atol=1e-4, tie_tol=1e-4, what=what)

    def unit(x):
        x = x.astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    def near_dups(rng, rows):
        """Each query moved 0.01 in a random direction, normalised: its
        nearest neighbour by far (sim about 0.99995)."""
        return unit(qv[rows] + 0.01 * unit(rng.standard_normal(
            (len(rows), DIM))))

    root = tempfile.mkdtemp(prefix="chase_live_")
    try:
        disk = shutil.disk_usage(root)
        need = 6 * (N_ROWS + 4 * LIVE_DELTA_CAP) * (DIM * 4 + 64)
        if disk.free < need:
            raise AssertionError(
                f"live: {disk.free / 1e9:.1f} GB free under {root}; the "
                f"snapshots and WAL need {need / 1e9:.1f} GB")
        gates, times, out = {}, {}, {"disk_free_gb": disk.free / 1e9,
                                     "disk_need_gb": need / 1e9}
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2**20

        # -- attach ----------------------------------------------------------
        lcat = catalog_of(products)
        live, times["attach_ms"] = clock(lambda: attach_live(
            lcat, "products", "embedding", os.path.join(root, "a"),
            delta_cap=LIVE_DELTA_CAP, nlist=NLIST, iters=KMEANS_ITERS,
            seed=0))
        cap_main = live.cap_main
        out.update(cap_main=cap_main, delta_cap=LIVE_DELTA_CAP,
                   ivf_cap=lcat.index_for("products", "embedding").cap,
                   frozen_ivf_cap=cat.index_for("products", "embedding").cap)
        ldb = connect(lcat, engine="brute", use_pallas=True)
        flat = statements(lcat, engine="brute", use_pallas=True)
        plain = statements(lcat, engine="brute", use_pallas=False)
        chase = statements(lcat, engine="chase", use_pallas=True,
                           probe=probe)
        quant = {(mode, c): connect(
            lcat, engine="brute", use_pallas=True, quant=mode,
            rescore_factor=c).prepare(live_sql["q1"], K=K)
            for mode in MODES for c in RESCORE}
        quant.update({(mode, "q2"): connect(
            lcat, engine="brute", use_pallas=True,
            quant=mode).prepare(live_sql["q2"]) for mode in MODES})
        frozen = connect(cat, engine="brute", use_pallas=True).prepare(
            frozen_sql["q1"], K=K)
        sharded_q1 = connect(lcat, engine="brute", use_pallas=True,
                             dist=DistSpec()).prepare(live_sql["q1"], K=K)

        def dist_held(label: str) -> None:
            """Q1 under dist at one shard over the live corpus against the
            live flat plan, bit for bit (counters included)."""
            path = f"live_q1_dist_{label}"
            runs = [(f"list{qn}", sharded_q1, q1_binds[:qn], None)
                    for qn in BATCHES]
            for lab, _s, b, _h, res in drive(path, runs):
                want = flat["q1"].execute(b).data
                torch.cuda.synchronize()
                bitwise(res.data, want, f"live dist {label} {lab}")
            if launches[path]["scan_topk_batch"] < 1:
                raise AssertionError(f"live {path}: no scan_topk_batch")

        # -- gate 1: zero delta ----------------------------------------------
        runs = [("single", flat["q1"], q1_binds[0], None)]
        runs += [(f"list{qn}", flat["q1"], q1_binds[:qn], None)
                 for qn in BATCHES]
        for label, _s, b, _h, res in drive("live_q1_zero", runs):
            # a live single dict runs the batched lowering at Q = 1: it is
            # held bitwise against the frozen batch of one, and its ids and
            # lanes against the frozen single dict (the single-query
            # kernel's sums may differ in the last bit)
            want = frozen.execute(b).data
            if label == "single":
                for key in ("ids", "valid"):
                    if not torch.equal(res[key], want[key]):
                        raise AssertionError(f"live gate 1 single: {key} "
                                             f"is not the frozen plan's")
                want = {key: v[0] for key, v in frozen.execute(
                    [b], hints=ExecutionHints(exact_shape=True)).data.items()
                    if key != "stats"}
            torch.cuda.synchronize()
            for key in ("ids", "sim", "valid"):
                if not torch.equal(res[key], want[key]):
                    raise AssertionError(f"live gate 1 {label}: {key} is not "
                                         f"the frozen plan's")
            if not bool((res["stats"]["distance_evals"] == cap_main).all()):
                raise AssertionError(f"live gate 1 {label}: evals "
                                     f"{res['stats']['distance_evals']}")
        if launches["live_q1_zero"]["scan_topk_batch"] < 1:
            raise AssertionError("live gate 1: no scan_topk_batch launch")
        dist_held("zero")
        flat_top = flat["q1"].execute(q1_binds).data["ids"]
        chased = drive("live_q1_chase_zero", [
            ("list100", chase["q1"], q1_binds, None)])[0][4].data["ids"]
        recall = float(np.mean([
            np.isin(flat_top[i].cpu().numpy(), chased[i].cpu().numpy()).mean()
            for i in range(N_QUERIES)]))
        if recall < LIVE_RECALL:
            raise AssertionError(f"live gate 1: chase recall@{K} {recall}")
        # the reference clusters the whole padded segment, its pad slots
        # included: that index's recall beside (reported, not a gate; its
        # catch-all list is large, so 8 queries at a time)
        own = lcat.index_for("products", "embedding")
        padded = build_ivf(torch.Generator().manual_seed(0),
                           flat["q1"].compiled._arrays["corpus"], NLIST,
                           metric, iters=KMEANS_ITERS)
        lcat.register_index("products", "embedding", padded)
        padded_ids = torch.cat([chase["q1"].execute(q1_binds[i:i + 8])["ids"]
                                for i in range(0, N_QUERIES, 8)])
        lcat.register_index("products", "embedding", own)
        gates["zero_delta"] = {
            "bitwise_frozen": True, "recall": recall,
            "recall_padded_ivf": float(np.mean([
                np.isin(flat_top[i].cpu().numpy(),
                        padded_ids[i].cpu().numpy()).mean()
                for i in range(N_QUERIES)])),
            "padded_ivf_cap": padded.cap}
        del padded, padded_ids
        frozen_chase = connect(cat, engine="chase", use_pallas=True,
                               probe=probe).prepare(frozen_sql["q1"], K=K)
        lat = {"live": {}, "frozen": {}, "chase": {}, "chase_frozen": {}}
        for qn in BATCHES:
            for key, st in (("live", flat["q1"]), ("frozen", frozen),
                            ("chase", chase["q1"]),
                            ("chase_frozen", frozen_chase)):
                lat[key][f"list{qn}"] = latency_ms(
                    lambda: st.execute(q1_binds[:qn]), iters=5)
        lat["fill0"] = {"list1": lat["live"]["list1"],
                        "list100": lat["live"][f"list{N_QUERIES}"]}
        for group in (flat, plain, chase):
            for q, s in group.items():
                s.execute(binds[q])
        traces = {(id(s), q): dict(s.executor.trace_counts)
                  for group in (flat, plain, chase) for q, s in group.items()}
        rebinds0 = {(id(s), q): s.compiled.rebinds
                    for group in (flat, plain, chase) for q, s in group.items()}

        # -- gate 2: mutations through the prepared plans ---------------------
        # seed 0's first spawned stream: the catalog draws its modes from
        # seed 0 itself, and rows equal to the modes are no random rows
        rng = np.random.default_rng(np.random.SeedSequence(0).spawn(1)[0])
        host_cols = {n: products[n].cpu().numpy() for n in scalar}
        ins = {"uids": [], "vecs": [], "cols": {n: [] for n in scalar}}

        def rows_like(n: int, uids) -> dict:
            src = rng.integers(0, N_ROWS, n)
            cols = {c: host_cols[c][src].copy() for c in scalar}
            cols["sample_id"] = np.asarray(uids).astype(
                host_cols["sample_id"].dtype)
            return cols

        def insert(uids, vecs, cols):
            lsn = ldb.insert("products", uids, vecs, cols)
            ins["uids"].append(np.asarray(uids, np.int64))
            ins["vecs"].append(vecs)
            for c in scalar:
                ins["cols"][c].append(cols[c])
            return lsn

        first = np.arange(N_ROWS, N_ROWS + LIVE_INSERTS)
        vecs = unit(rng.standard_normal((LIVE_INSERTS, DIM)))
        vecs[:LIVE_NEAR] = near_dups(rng, np.arange(LIVE_NEAR))
        cols = rows_like(LIVE_INSERTS, first)
        cols["price"][:LIVE_NEAR] = 0
        per = LIVE_INSERTS // LIVE_BATCHES
        t = time.perf_counter()
        for j in range(LIVE_BATCHES):
            sl = slice(j * per, (j + 1) * per)
            insert(first[sl], vecs[sl], {c: v[sl] for c, v in cols.items()})
        times["insert_batch_ms"] = (time.perf_counter() - t) * 1e3 / \
            LIVE_BATCHES
        dist_held("fill50")
        gates["dist_one_shard"] = {"bitwise_flat": ["zero", "fill50"],
                                   "delta_rows": int(live.delta_count)}
        lat["fill50"] = {"list1": latency_ms(
            lambda: flat["q1"].execute(q1_binds[:1]), iters=5),
            f"list{N_QUERIES}": latency_ms(
                lambda: flat["q1"].execute(q1_binds), iters=5)}
        # insert -> visible and delete -> invisible through the prepared
        # single-dict plan, queries with no near-duplicate yet
        touch = {"insert_visible_ms": [], "delete_invisible_ms": []}
        nxt = N_ROWS + LIVE_INSERTS
        for i in range(LIVE_TOUCH):
            q = LIVE_NEAR + i
            uid = nxt + i
            v = near_dups(rng, [q])
            c = rows_like(1, [uid])
            c["price"][:] = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            insert([uid], v, c)
            res = flat["q1"].execute(q1_binds[q])
            top = int(live.user_ids(res["ids"][:1])[0])
            touch["insert_visible_ms"].append((time.perf_counter() - t) * 1e3)
            if top != uid:
                raise AssertionError(f"live: insert of {uid} not visible "
                                     f"({top} first)")
        for i in range(LIVE_TOUCH):
            uid = nxt + i
            torch.cuda.synchronize()
            t = time.perf_counter()
            ldb.delete("products", [uid])
            res = flat["q1"].execute(q1_binds[LIVE_NEAR + i])
            seen = uid in live.user_ids(res["ids"]).tolist()
            touch["delete_invisible_ms"].append((time.perf_counter() - t)
                                                * 1e3)
            if seen:
                raise AssertionError(f"live: delete of {uid} not visible")
        times.update({k: statistics.median(v) for k, v in touch.items()})
        nxt += LIVE_TOUCH
        fill = LIVE_DELTA_CAP - live.delta_count
        filler = np.arange(nxt, nxt + fill)
        fvecs = unit(rng.standard_normal((fill, DIM)))
        fcols = rows_like(fill, filler)
        per = -(-fill // LIVE_BATCHES)
        for j in range(LIVE_BATCHES):
            sl = slice(j * per, (j + 1) * per)
            insert(filler[sl], fvecs[sl],
                   {c: v[sl] for c, v in fcols.items()})
        if live.delta_count != LIVE_DELTA_CAP:
            raise AssertionError(f"live: delta holds {live.delta_count}")
        lat["fill100"] = {"list1": latency_ms(
            lambda: flat["q1"].execute(q1_binds[:1]), iters=5),
            f"list{N_QUERIES}": latency_ms(
                lambda: flat["q1"].execute(q1_binds), iters=5)}
        # deletes: rows of the current top-50 lists, and inserted rows
        top = live.user_ids(flat["q1"].execute(q1_binds)["ids"])
        cand = np.unique(top[(top >= 0) & (top < N_ROWS)])
        gone = np.concatenate([
            rng.choice(cand, min(LIVE_DELETES, len(cand)), replace=False),
            rng.choice(filler, LIVE_DELETE_INSERTED, replace=False)])
        _, times["delete_ms"] = clock(lambda: ldb.delete("products", gone))
        gone_set = set(gone.tolist()) | set(range(N_ROWS + LIVE_INSERTS,
                                                  nxt))

        # every flat answer: held against use_pallas=False, and at the
        # user-id level against a frozen catalog of the survivors
        ins_uids = np.concatenate(ins["uids"])
        ins_vecs = np.concatenate(ins["vecs"])
        keep_orig = np.ones(N_ROWS, bool)
        keep_orig[gone[gone < N_ROWS]] = False
        keep_ins = ~np.isin(ins_uids, list(gone_set))
        surv_uids = np.concatenate([np.flatnonzero(keep_orig),
                                    ins_uids[keep_ins]])
        idx = torch.from_numpy(np.flatnonzero(keep_orig)).to(dev)
        scols = {c: torch.cat([products[c][idx], torch.from_numpy(
            np.concatenate(ins["cols"][c])[keep_ins]).to(
                device=dev, dtype=products[c].dtype)]) for c in scalar}
        scols["embedding"] = scols["vec"] = torch.cat([
            products["embedding"][idx],
            torch.from_numpy(ins_vecs[keep_ins]).to(dev)])
        fcat = catalog_of(Table(products.schema, scols))
        fdb = connect(fcat, engine="brute", use_pallas=True)
        err = {"plain": 0.0, "survivors": 0.0}
        results = {}
        for q in live_sql:
            res = drive(f"live_{q}", [(q, flat[q], binds[q], None)])[0][4]
            results[q] = res
            want = plain[q].execute(binds[q]).data
            torch.cuda.synchronize()
            err["plain"] = max(err["plain"], held(
                res.data, want, q, f"live gate 2 {q} plain"))
            st = fdb.prepare(frozen_sql[q], K=K) if q == "q1" else \
                fdb.prepare(frozen_sql[q])
            frz = st.execute(binds[q]).data
            err["survivors"] = max(err["survivors"], held(
                uid_view(res.data, live.user_ids),
                uid_view(frz, lambda i: surv_uids[np.maximum(i, 0)]), q,
                f"live gate 2 {q} survivors"))
        for q in ("q1", "q2", "q3", "q5", "q6"):
            kname = "scan_topk_batch" if q == "q1" else "range_topk_batch"
            if launches[f"live_{q}"][kname] < 1:
                raise AssertionError(f"live_{q} launched no {kname}")
        chased = {q: drive(f"live_{q}_chase", [
            (q, chase[q], binds[q], None)])[0][4] for q in live_sql}
        for q in live_sql:
            if any(launches[f"live_{q}_chase"].values()):
                raise AssertionError(f"live_{q}_chase launched "
                                     f"{launches[f'live_{q}_chase']}: the "
                                     f"probes and the delta merge run none")
        for q, res in list(results.items()) + [
                (f"{q}_chase", v) for q, v in chased.items()]:
            key = "ids" if "ids" in res.data else "tid"
            uids = live.user_ids(res.data[key])
            if set(uids[uids >= 0].tolist()) & gone_set:
                raise AssertionError(f"live gate 2 {q}: a deleted row")
        for key, res in (("flat", results["q1"]), ("chase", chased["q1"])):
            firsts = live.user_ids(res["ids"][:LIVE_NEAR, 0])
            if not (firsts == first[:LIVE_NEAR]).all():
                raise AssertionError(f"live gate 2 {key}: a near-duplicate "
                                     f"is not its query's first hit")
        # quantized Q1 (rescore factor: the smallest whose candidates hold
        # the fp32 main-segment top-K, as slice_quant picks it) and Q2
        arr = flat["q1"].compiled._arrays
        qmask = ((arr["live_cols"]["price"] < p)[None, :]
                 & arr["live_main_valid"][None, :]).expand(N_QUERIES, -1)
        fp32_top = results["q1"]["ids"]
        qs = torch.from_numpy(qv).to(dev)
        cover = {}
        for mode in MODES:
            qc = live._dev[f"quant:{mode}"]
            cover[mode] = {}
            for c in RESCORE:
                got = qt_mod.quant_scan_topk_batch(
                    qc.qvecs, qc.scales, qs, qmask.contiguous().view(
                        torch.int8), None, c * K, metric)
                rows = qt_mod.candidate_rows(*got, c * K)
                inside = ((fp32_top[:, :, None] == rows[:, None, :]).any(-1)
                          | (fp32_top < 0) | (fp32_top >= cap_main))
                cover[mode][c] = int((~inside.all(1)).sum())
                if cover[mode][c] == 0:
                    break
            c = next(c for c, m in cover[mode].items() if m == 0)
            for q, st in (("q1", quant[mode, c]), ("q2", quant[mode, "q2"])):
                res = drive(f"live_{q}_{mode}", [
                    (q, st, binds[q], None)])[0][4]
                bitwise(res.data, results[q].data, f"live gate 2 {q} {mode}")
        for kname, path in (("quant_scan_topk_batch", "q1"),
                            ("replay_keys", "q1"),
                            ("quant_keys_batch", "q2")):
            if not any(launches[f"live_{path}_{m}"][kname] for m in MODES):
                raise AssertionError(f"live gate 2: no {kname} launch")
        for group in (flat, plain, chase):
            for q, s in group.items():
                if dict(s.executor.trace_counts) != traces[id(s), q]:
                    raise AssertionError(f"live gate 2 {q}: an executor was "
                                         f"rebuilt")
        rebinds = {q: flat[q].compiled.rebinds - rebinds0[id(flat[q]), q]
                   for q in flat}
        if min(rebinds.values()) < 1:
            raise AssertionError(f"live gate 2: rebinds {rebinds}")
        gates["mutations"] = {"max_abs_err": err, "rebinds": rebinds,
                              "rescore_cover": cover,
                              "deleted": int(len(gone_set)),
                              "inserted": int(len(ins_uids))}

        # -- gate 3: compaction = a fresh attach of the survivors -------------
        split = {}

        def timed(fn, key):
            def wrapped(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    split[key] = split.get(key, 0.0) + \
                        (time.perf_counter() - t) * 1e3
            return wrapped

        saved = (ckpt_mod.save, mut.build_ivf)
        ckpt_mod.save = timed(saved[0], "snapshot_write_ms")
        mut.build_ivf = timed(saved[1], "ivf_rebuild_ms")
        live._canonical_state = timed(live._canonical_state, "canonical_ms")
        live._wal_append = timed(live._wal_append, "wal_ms")
        live._swap_compacted = timed(live._swap_compacted, "swap_ms")
        try:
            _, split["total_ms"] = clock(lambda: ldb.compact("products"))
        finally:
            ckpt_mod.save, mut.build_ivf = saved
            for attr in ("_canonical_state", "_wal_append",
                         "_swap_compacted"):
                delattr(live, attr)
        split["swap_upload_ms"] = split.pop("swap_ms") - split[
            "ivf_rebuild_ms"]
        times["compaction"] = split
        fresh, times["fresh_attach_ms"] = clock(lambda: attach_live(
            fcat, "products", "embedding", os.path.join(root, "f"),
            delta_cap=LIVE_DELTA_CAP, nlist=NLIST, iters=KMEANS_ITERS,
            seed=0, ids=surv_uids, cap_main=cap_main))
        ffl = statements(fcat, engine="brute", use_pallas=True)
        fch = statements(fcat, engine="chase", use_pallas=True, probe=probe)

        def same(a: dict, b: dict, qs_=live_sql) -> None:
            for q in qs_:
                bitwise(a[q].execute(binds[q]).data,
                        b[q].execute(binds[q]).data, f"live {q}")

        same(flat, ffl)
        same(chase, fch)
        for group in (flat, chase):
            for q, s in group.items():
                if dict(s.executor.trace_counts) != traces[id(s), q]:
                    raise AssertionError(f"live gate 3 {q}: an executor was "
                                         f"rebuilt")
        gates["compaction"] = {"bitwise_fresh_attach": True,
                               "live_rows": live.freshness()["live_rows"],
                               "ivf_cap": lcat.index_for(
                                   "products", "embedding").cap}
        del fresh, ffl, fch, fcat, fdb, scols, idx, st, frz
        gc.collect()
        torch.cuda.empty_cache()

        # -- gate 4: recovery from disk alone ---------------------------------
        _, times["snapshot_ms"] = clock(live.snapshot)
        post = np.arange(nxt + fill, nxt + fill + LIVE_POST)
        insert(post, unit(rng.standard_normal((LIVE_POST, DIM))),
               rows_like(LIVE_POST, post))
        ldb.delete("products", np.concatenate([post[:LIVE_POST // 4],
                                               surv_uids[:LIVE_POST // 4]]))
        few = ["q1", "q2"]

        def recovered_equal(site: str, crash) -> float:
            live._faults = FaultInjector(FaultSpec(crash_site=site))
            try:
                crash()
            except InjectedCrashError:
                pass
            else:
                raise AssertionError(f"live gate 4: {site} never fired")
            finally:
                live._faults = None
            rcat = catalog_of(products)
            rec, ms = clock(lambda: recover(rcat, "products", "embedding",
                                            os.path.join(root, "a")))
            if site == "compact.post_log":
                ldb.compact("products")      # the unfailed run's compaction
            if rec._uid_loc != live._uid_loc:
                raise AssertionError(f"live gate 4 {site}: rows differ")
            same(flat, statements(rcat, few, engine="brute",
                                  use_pallas=True), few)
            same(chase, statements(rcat, few, engine="chase",
                                   use_pallas=True, probe=probe), few)
            return ms

        extra = np.arange(post[-1] + 1, post[-1] + 9)
        times["recover_torn_ms"] = recovered_equal(
            "wal.torn_append", lambda: ldb.insert(
                "products", extra, unit(rng.standard_normal((8, DIM)))))
        gc.collect()
        torch.cuda.empty_cache()
        times["recover_compact_ms"] = recovered_equal(
            "compact.post_log", lambda: ldb.compact("products"))
        gates["recovery"] = {"sites": ["wal.torn_append",
                                       "compact.post_log"],
                             "bitwise_unfailed": True}
        gc.collect()
        torch.cuda.empty_cache()

        # -- gate 5: the front door ------------------------------------------
        door = np.arange(extra[-1] + 1, extra[-1] + 9)
        dq = np.arange(N_QUERIES - 8, N_QUERIES)

        async def front_door():
            cfg = ServeConfig(
                admission=AdmissionConfig(max_queue_depth=64),
                scheduler=SchedulerConfig(max_batch=SERVE_BATCH,
                                          max_wait_ms=SERVE_WAIT_MS))
            async with QueryServer(flat["q1"], cfg) as server:
                await server.submit_mutation(
                    "insert", ids=door, vectors=near_dups(rng, dq),
                    columns={"price": np.zeros(8, np.float32)})
                return await asyncio.gather(*(server.submit(q1_binds[q])
                                              for q in dq))

        reset_counts()
        served = asyncio.run(front_door())
        torch.cuda.synchronize()
        launches["live_front_door"] = counts()
        firsts = [int(live.user_ids(res["ids"][:1])[0]) for res in served]
        if firsts != door.tolist():
            raise AssertionError(f"live gate 5: first hits {firsts}")
        if launches["live_front_door"]["scan_topk_batch"] < 1:
            raise AssertionError("live gate 5: no scan_topk_batch launch")
        gates["front_door"] = {"first_hits": firsts}

        out.update(peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
                   resident_before_mb=base_mb, freshness=live.freshness())
        emit({"phase": "live", "gates": gates, "cap_main": cap_main,
              "launches": {k: v for k, v in launches.items()
                           if k.startswith("live_")}})
        emit({"phase": "e2e_live", "device": name, "nvidia_smi": smi,
              "q1_latency_ms": lat, "times": times, **out,
              "phase_s": time.perf_counter() - t_phase})
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def _close_err(got: torch.Tensor, want: torch.Tensor, tol: float,
               what: str) -> float:
    """Max abs difference; raises unless |got - want| <= tol + tol·|want|
    everywhere (numpy's allclose rule at rtol = atol = tol)."""
    dt = torch.promote_types(got.dtype, torch.float32)
    got, want = got.to(dt), want.to(device=got.device, dtype=dt)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    diff = (got - want).abs()
    if (diff > tol + tol * want.abs()).any():
        raise AssertionError(f"{what}: max abs diff {float(diff.max())} "
                             f"beyond {tol}")
    return float(diff.max())


def lm_gates_phase(smi: str, name: str) -> dict:
    """The ``lm`` phase's model gates, which time nothing; they run while
    the ``aot`` phase's child A builds its kernels.

    1. Every family at smoke size in fp32 (the ten ``smoke_config()``s,
       params made by ``init_params`` on the CPU and carried to the card),
       B = 2, S = 64 (so the SSM configs take the chunked path): on the card
       ``forward`` agrees with ``prefill`` (the decode replay) to 2e-3 and
       with the CPU's ``forward`` to 1e-4.
    2. ``forward`` = ``prefill`` at full width (``LM_FULL_GATES``:
       qwen2-1.5b, 28 layers, at B = 2, S = 64 in fp32 to 2e-3;
       mamba2-370m, 48 layers, at B = 2, S = 256, two SSD chunks of 128, in
       fp64 to 1e-6, beside the fp32 forward's distance from the fp64
       one), params drawn on the card.  Line ``lm_gates``."""
    import dataclasses as dc

    from repro_torch import configs
    from repro_torch.models import forward, init_params, tree_leaves, tree_map
    from repro_torch.serving import prefill

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    tol32 = LM_TOL_DECODE["float32"]

    # -- 1. every family at smoke size, fp32 -------------------------------
    smoke = {}
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch, smoke=True)
        p_cpu = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        p = tree_map(lambda v: v.to(dev), p_cpu)
        g = torch.Generator().manual_seed(1)
        b, s = LM_SMOKE_SHAPE
        if cfg.input_mode == "tokens":
            inp = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                           generator=g, dtype=torch.int32)}
        else:
            inp = {"embeds": torch.randn((b, s, cfg.d_model), generator=g)}
        dinp = {key: v.to(dev) for key, v in inp.items()}
        with torch.inference_mode():
            cpu_logits, cpu_aux = forward(p_cpu, cfg, **inp)
            logits, aux = forward(p, cfg, **dinp)
        _cache, dec = prefill(p, cfg, max_seq=s, **dinp)
        torch.cuda.synchronize()
        smoke[arch] = {
            "decode_err": _close_err(dec, logits, tol32,
                                     f"lm smoke {arch} prefill = forward"),
            "device_err": _close_err(logits.cpu(), cpu_logits, LM_TOL_DEVICE,
                                     f"lm smoke {arch} card = cpu"),
            "aux_err": abs(float(aux) - float(cpu_aux))}
        if smoke[arch]["device_err"] > LM_TOL_DEVICE \
                or smoke[arch]["aux_err"] > LM_TOL_DEVICE:
            raise AssertionError(f"lm smoke {arch}: {smoke[arch]}")

    # -- 2. full width forward = decode --------------------------------------
    full = {}
    for arch, b, s, dtype in LM_FULL_GATES:
        cfg32 = dc.replace(configs.get_config(arch), param_dtype="float32",
                           compute_dtype="float32")
        cfg = dc.replace(cfg32, param_dtype=dtype, compute_dtype=dtype)
        g = torch.Generator(dev).manual_seed(0)
        # fp32 draws either way: an fp64 model holds the fp32 one's values
        p32 = init_params(g, cfg32, dev)
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                             device=dev, dtype=torch.int32)
        p = p32 if dtype == "float32" else tree_map(
            lambda v: v.to(cfg.pdtype()) if v.is_floating_point() else v,
            p32)
        with torch.inference_mode():
            logits, _ = forward(p, cfg, tokens=toks)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _cache, dec = prefill(p, cfg, tokens=toks, max_seq=s)
        torch.cuda.synchronize()
        full[arch] = {"batch": b, "seq": s, "layers": cfg.num_layers,
                      "dtype": dtype, "tol": LM_TOL_DECODE[dtype],
                      "param_bytes": sum(v.numel() * v.element_size()
                                         for v in tree_leaves(p)),
                      "prefill_s": time.perf_counter() - t,
                      "decode_err": _close_err(dec, logits,
                                               LM_TOL_DECODE[dtype],
                                               f"lm full {arch} prefill = "
                                               f"forward ({dtype})")}
        if p is not p32:
            with torch.inference_mode():
                logits32, _ = forward(p32, cfg32, tokens=toks)
            full[arch]["fp32_forward_vs_fp64"] = float(
                (logits32.to(logits.dtype) - logits).abs().max())
            full[arch]["fp64_logit_absmax"] = float(logits.abs().max())
            del logits32
        del p, p32, logits, dec, _cache
        torch.cuda.empty_cache()
    out = {"smoke": smoke, "full": full}
    emit({"phase": "lm_gates", "device": name, "nvidia_smi": smi, **out,
          "tols": {"decode": LM_TOL_DECODE, "device": LM_TOL_DEVICE},
          "phase_s": time.perf_counter() - t_phase})
    return out


def lm_phase(gates: dict, record, reset_counts, counts, launches, smi: str,
             name: str) -> None:
    """The ``lm`` phase: the slice on the card, after ``lm_gates_phase``'s
    model gates (``gates``).

    ``launch.serve.serve_arch`` (the ``--arch`` CLI's code) for qwen2-1.5b
    at full width in bf16 with ``--rag`` over ``LM_DOCS`` x 1,536 fp32 docs
    (64 IVF lists), then the flat Q1 on the same catalog (``brute``,
    ``use_pallas=True``: ``scan_topk`` for a single dict,
    ``scan_topk_batch`` for the list of 8), counters set to 0 before and
    read after.  Gates: every valid retrieved doc passes the filters; under
    ``termination="bound"`` the retriever's ids are the flat Q1's as sets;
    the flat Q1 holds against ``use_pallas=False`` (``assert_topk_close``,
    1e-4); ``retrieve_for_decode`` through ``make_scheduler()`` gives
    ``retrieve_batch``'s ids; two greedy ``generate`` calls give equal
    tokens inside the vocabulary.  Line ``e2e_lm``: retrieval ms (chase
    and flat, a single query and the batch), recall@4 of chase's
    ``counter`` termination against flat, ``scan_topk`` and
    ``scan_topk_batch`` at D = 1,536 (``timed``: ms, plain and library
    ms, bound), prefill ms, decode ms a token, tokens/s beside the
    weight-bytes bound of a decode step, peak memory, each gate's worst
    error."""
    from repro_torch.api import connect
    from repro_torch.core import EngineOptions, Metric
    from repro_torch.index.ivf import ProbeConfig
    from repro_torch.kernels import scan_topk as st_mod
    from repro_torch.launch.serve import serve_arch
    from repro_torch.models import tree_leaves
    from repro_torch.serving import RAG_SQL, generate
    from repro_torch.testing import assert_topk_close

    t_phase = time.perf_counter()
    hw = spec_for(name)
    smoke, full = gates["smoke"], gates["full"]

    # -- the slice: serve --arch qwen2-1.5b --rag at full width -------------
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = serve_arch(LM_ARCH, batch=LM_BATCH, prompt_len=LM_PROMPT,
                     gen=LM_GEN, rag=True, rag_docs=LM_DOCS, seed=0,
                     device="cuda")
    cat = run.retriever.catalog
    qemb = run.query_embeddings
    filters = {"min_freshness": 0.25, "safety_class": 0}
    singles = [{"query_embedding": qemb[i], **filters}
               for i in range(LM_BATCH)]
    flat = connect(cat, engine="brute", use_pallas=True).prepare(RAG_SQL,
                                                                  K=4)
    flat_single = [flat.execute(b) for b in singles]
    flat_list = flat.execute(singles)
    torch.cuda.synchronize()
    launches["lm"] = counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    if not (launches["lm"]["scan_topk"] >= LM_BATCH
            and launches["lm"]["scan_topk_batch"] >= 1):
        raise AssertionError(f"lm: the flat Q1 launched {launches['lm']}")

    docs, fresh, safety = run.docs
    cfg = run.cfg
    checks = {}
    # gate: the filters
    ids, valid = run.ids.long(), run.valid
    hit = ids[valid]
    if not valid.any() or not ((fresh[hit] >= 0.25).all()
                               and (safety[hit] == 0).all()):
        raise AssertionError("lm: a retrieved doc fails the filters or none "
                             "was retrieved")
    # gate: flat under use_pallas=True against use_pallas=False
    plain = connect(cat, engine="brute", use_pallas=False).prepare(RAG_SQL,
                                                                   K=4)
    errs = [assert_topk_close(r.data, plain.execute(b).data, atol=1e-4,
                              tie_tol=1e-4, what=f"lm flat single {i}")
            for i, (b, r) in enumerate(zip(singles, flat_single))]
    record("scan_topk", max(errs))
    err_list = assert_topk_close(flat_list.data, plain.execute(singles).data,
                                 atol=1e-4, tie_tol=1e-4,
                                 what="lm flat list of 8")
    record("scan_topk_batch", err_list)
    checks["flat_pallas_vs_plain_err"] = max(errs + [err_list])
    flat_ids = flat_list["ids"].cpu().numpy()
    flat_valid = flat_list["valid"].cpu().numpy()

    def as_sets(i_, v_):
        return [set(r[m].tolist()) for r, m in zip(i_, v_)]

    # gate: exact chase (termination "bound") = flat, as sets
    bound_probe = ProbeConfig(max_probes=LM_NLIST, termination="bound")
    exact = run.retriever.db.prepare(
        RAG_SQL, K=4, options=EngineOptions(engine="chase",
                                            probe=bound_probe))
    exact_res = exact.execute({"query_embedding": qemb, **filters})
    if as_sets(exact_res["ids"].cpu().numpy(),
               exact_res["valid"].cpu().numpy()) != as_sets(flat_ids,
                                                            flat_valid):
        raise AssertionError("lm: chase under termination bound is not the "
                             "flat answer")
    # recall@4 of the retriever's counter termination against flat
    got_sets = as_sets(ids.cpu().numpy(), valid.cpu().numpy())
    want_sets = as_sets(flat_ids, flat_valid)
    recall = float(np.mean([len(g_ & w_) / max(1, len(w_))
                            for g_, w_ in zip(got_sets, want_sets)]))
    # gate: retrieve_for_decode through the scheduler = retrieve_batch
    sched = run.retriever.make_scheduler()
    prefix, s_ids, s_valid = run.retriever.retrieve_for_decode(
        qemb, docs, scheduler=sched, **filters)
    if not (torch.equal(s_ids, run.ids) and torch.equal(s_valid, run.valid)):
        raise AssertionError("lm: the scheduled retrieval differs from "
                             "retrieve_batch")
    want_prefix = torch.where(run.valid[..., None],
                              docs[run.ids.clamp(min=0).long()], 0.0)
    if prefix.shape != (LM_BATCH, 4, cfg.d_model) \
            or not torch.equal(prefix, want_prefix):
        raise AssertionError("lm: retrieve_for_decode's prefix")
    # gate: greedy generate twice, tokens inside the vocabulary; the second,
    # warm, call gives the prefill and decode times
    gen_t = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    again = generate(run.params, cfg, run.prefix, LM_GEN, timings=gen_t)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    if not torch.equal(again, run.tokens) or again.shape != (LM_BATCH,
                                                             LM_GEN):
        raise AssertionError("lm: two greedy generate calls differ")
    if not ((again >= 0) & (again < cfg.vocab_size)).all():
        raise AssertionError("lm: a token outside the vocabulary")

    # -- timings -------------------------------------------------------------
    stacked = {"query_embedding": qemb, **filters}
    chase_single_ms = latency_ms(lambda: run.retriever.statement.execute(
        singles[0]))
    chase_batch_ms = latency_ms(lambda: run.retriever.statement.execute(
        stacked))
    flat_single_ms = latency_ms(lambda: flat.execute(singles[0]))
    flat_batch_ms = latency_ms(lambda: flat.execute(stacked))
    # the kernels at D = 1,536, at the flat path's shapes
    mask = ((fresh >= 0.25) & (safety == 0)).to(torch.int8)
    qmask = mask[None].expand(LM_BATCH, -1).contiguous()
    metric = Metric.INNER_PRODUCT
    n_docs, dim = docs.shape

    def lib_single():
        keys = -(docs @ qemb[0])
        keys = keys.masked_fill(mask == 0, float("inf"))
        return torch.topk(keys, 4, largest=False)

    def lib_batch():
        keys = -(qemb @ docs.T)
        keys = keys.masked_fill(qmask == 0, float("inf"))
        return torch.topk(keys, 4, dim=1, largest=False)

    kernels = timed({
        "scan_topk": (
            lambda: st_mod.scan_topk(docs, qemb[0], mask, 4, metric),
            lambda: st_mod.scan_topk_plain(docs, qemb[0], mask, 4, metric),
            lib_single,
            bound_ms(st_mod.scan_topk_work(docs, qemb[0], mask, 4), hw)),
        "scan_topk_batch": (
            lambda: st_mod.scan_topk_batch(docs, qemb, qmask, None, 4,
                                           metric),
            lambda: st_mod.scan_topk_batch_plain(docs, qemb, qmask, None, 4,
                                                 metric),
            lib_batch,
            bound_ms(st_mod.scan_topk_batch_work(docs, qemb, qmask, None, 4),
                     hw))})
    param_bytes = sum(v.numel() * v.element_size()
                      for v in tree_leaves(run.params))
    emit({"phase": "lm", "device": name, "nvidia_smi": smi,
          "launches": launches["lm"], "gates": checks})
    emit({"phase": "e2e_lm", "device": name, "nvidia_smi": smi,
          "arch": LM_ARCH, "param_dtype": cfg.param_dtype,
          "batch": LM_BATCH, "prompt_len": LM_PROMPT, "gen": LM_GEN,
          "prefix_len": int(run.prefix.shape[1]), "docs": n_docs,
          "dim": dim, "nlist": LM_NLIST, "timings_s": run.timings,
          "retrieval_ms": {"chase_single": chase_single_ms,
                           "chase_batch": chase_batch_ms,
                           "flat_single": flat_single_ms,
                           "flat_batch": flat_batch_ms},
          "recall_at_4_counter": recall, "kernels_d1536": kernels,
          "prefill_ms": gen_t["prefill_s"] * 1e3,
          "generate_ms": gen_s * 1e3,
          "decode_ms_per_token": gen_t["decode_s"] * 1e3 / LM_GEN,
          "tokens_per_s": LM_BATCH * LM_GEN / gen_s,
          "param_bytes": param_bytes,
          "decode_step_bound_ms": param_bytes / hw.hbm_bw * 1e3,
          "peak_mb": peak,
          "worst_err": {"smoke_decode": max(v["decode_err"]
                                            for v in smoke.values()),
                        "smoke_device": max(v["device_err"]
                                            for v in smoke.values()),
                        "full_decode": max(v["decode_err"]
                                           for v in full.values()),
                        "flat_pallas_vs_plain":
                            checks["flat_pallas_vs_plain_err"]},
          "phase_s": time.perf_counter() - t_phase})
    del run, docs, fresh, safety, prefix, want_prefix, again, cat
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _matmul_precision(precision: str):
    """A caller's ``torch.set_float32_matmul_precision`` around a call,
    restored afterwards (torch refuses to read the legacy setting once the
    per-backend ones were set; it is then at its default, "highest")."""
    try:
        saved = torch.get_float32_matmul_precision()
    except RuntimeError:
        saved = "highest"
    torch.set_float32_matmul_precision(precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _step_close(got, want, lr: float, tol: float, what: str) -> dict:
    """One AdamW step of the same params and batch on two devices: the
    gradient held through the moments (after one step m = (1 - b1) ĝ, so
    per leaf |m - m_want| <= tol · max |m_want|, and v to twice that), the
    params to the bound that follows (a gradient error δ moves the step-1
    update lr · ĝ / (|ĝ| + eps) by at most lr · min(2, 2δ / (|ĝ| + eps)),
    δ = tol · max |ĝ| of the leaf) plus fp32 rounding.  Returns the worst
    moment error so relative and the largest param difference."""
    from repro_torch.models import tree_leaves

    worst_m, worst_p = 0.0, 0.0
    for key, k in (("m", 1.0), ("v", 2.0)):
        for a, b in zip(tree_leaves(got.opt[key]), tree_leaves(want.opt[key])):
            a, b = a.double().cpu(), b.double().cpu()
            scale = float(b.abs().max())
            err = float((a - b).abs().max()) / (scale or 1.0)
            if err > k * tol:
                raise AssertionError(f"{what}: {key} {err} beyond {k * tol}")
            if key == "m":
                worst_m = max(worst_m, err)
    for a, b, m in zip(tree_leaves(got.params), tree_leaves(want.params),
                       tree_leaves(want.opt["m"])):
        a, b = a.double().cpu(), b.double().cpu()
        ghat = m.double().cpu().abs() / 0.1
        delta = tol * float(ghat.max())
        allowed = (2e-7 * b.abs() + 1e-8
                   + lr * torch.clamp(2 * delta / (ghat + 1e-8), max=2.0))
        diff = (a - b).abs()
        if (diff > allowed).any():
            raise AssertionError(f"{what}: params beyond the step-1 bound "
                                 f"({int((diff > allowed).sum())} entries)")
        worst_p = max(worst_p, float(diff.max()))
    return {"moment_err": worst_m, "param_max_diff": worst_p}


def train_gates_phase(smi: str, name: str) -> dict:
    """The ``train`` phase's smoke gates, the reference's training tests
    on the card; they time nothing and run while the ``aot`` phase's child
    A builds its kernels.  fp32 smoke configs throughout.

    1. qwen2 smoke, 40 steps on the bigram data (B = 4, S = 32, lr 3e-3,
       3 warm-up steps, no weight decay): the mean of the last 5 losses is
       at least 0.3 below the first 5 (``tests/test_training.py``).
    2. A clip norm of 1e-6 moves no leaf by more than 1e-2.
    3. Resume = straight through, by ``launch/train.py``'s CLI on the card,
       as a crash and a relaunch: ``--steps 6 --ckpt-every 3 --ckpt-dir
       A``, A's ``step_3`` copied into a fresh B, then the same flags on
       B; the step-6 checkpoints agree to rtol 1e-5, atol 1e-6
       (``tests/test_checkpoint.py``); whether they are equal bit for bit
       is reported.
    4. The compressed DP step on a mesh of the one card, 30 steps (B = 8,
       S = 32): the last 5 losses' mean 0.3 below the first 5's
       (``tests/test_distributed.py``).
    5. One train step of each of the ten smoke configs (B = 2, S = 64,
       params drawn on the CPU and carried over): the card against the
       port's CPU step, the loss to 1e-5 relative (1e-4 for the SSM
       configs), the grad norm and the moments to ``TRAIN_TOL_G`` and the
       params to the step-1 bound (:func:`_step_close`).  The card's step
       runs with the caller's fp32 matmul precision at "high" (TF32
       allowed), so only the step's own ``full_fp32`` scope keeps its
       forward, backward and recompute in full fp32.
    6. qwen2 smoke in bf16 params and compute with remat "block" (the
       published settings), B = 2, S = 64, under the same "high"
       precision: the card's bf16 gradient against the fp32 gradient at
       the same bf16 values (on the CPU) is held to the port's CPU bf16
       gradient's distance from it, per leaf, by ``tests/test_torch_bf16``'s
       rule: mean error at most ``BF16_MEAN_RATIO`` times the CPU's, the
       largest at most ``BF16_MAX_RATIO`` times (each floored at half a
       bf16 ulp of the leaf's largest entry); the loss within 2**-8 of the
       fp32 loss.
    Line ``train_gates``."""
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.checkpoint import checkpointer
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import init_params, tree_leaves, tree_map
    from repro_torch.training import (AdamWConfig, TrainState, adamw_init,
                                      build_train_step)
    from repro_torch.training.step import (build_compressed_dp_step,
                                           value_and_grad)
    from repro_torch.training.train_state import prng_key

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    qwen = configs.get_config("qwen2-1.5b", smoke=True)
    out = {}

    def fresh(cfg, opt_cfg, device):
        p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        p = tree_map(lambda v: v.to(device), p)
        return TrainState.create(p, adamw_init(opt_cfg, p),
                                 prng_key(0, device))

    # -- 1. the loss falls on the bigram data ------------------------------
    opt_cfg = AdamWConfig(lr_peak=3e-3, warmup_steps=3, total_steps=40,
                          weight_decay=0.0)
    data = SyntheticLM(DataConfig(global_batch=4, seq_len=32,
                                  vocab_size=qwen.vocab_size))
    state, step = fresh(qwen, opt_cfg, dev), build_train_step(qwen, opt_cfg)
    losses = []
    for i in range(40):
        state, m = step(state, data.batch_at(i, device=dev))
        losses.append(float(m["loss"]))
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first - 0.3:
        raise AssertionError(f"train gate 1: loss {first} -> {last}")
    out["bigram"] = {"first5": first, "last5": last}

    # -- 2. clipping ---------------------------------------------------------
    opt_cfg = AdamWConfig(lr_peak=1e-3, clip_norm=1e-6, warmup_steps=1,
                          total_steps=5)
    data = SyntheticLM(DataConfig(global_batch=2, seq_len=16,
                                  vocab_size=qwen.vocab_size))
    state = fresh(qwen, opt_cfg, dev)
    s1, _m = build_train_step(qwen, opt_cfg)(state,
                                             data.batch_at(0, device=dev))
    delta = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(state.params),
                                tree_leaves(s1.params)))
    if not delta < 1e-2:
        raise AssertionError(f"train gate 2: clipped step moved {delta}")
    out["clip_max_move"] = delta

    # -- 3. resume = straight through, by the launcher -----------------------
    def resume_pair() -> tuple[float, bool, bool]:
        """(max |resumed - straight|, equal bit for bit, within rtol 1e-5,
        atol 1e-6) of the two runs' step-6 params."""
        root = tempfile.mkdtemp(prefix="chip_smoke_train_")
        try:
            args = ["--arch", "qwen2-1.5b", "--smoke", "--global-batch",
                    "2", "--seq-len", "16", "--lr", "1e-3", "--device",
                    "cuda", "--log-every", "3", "--steps", "6",
                    "--ckpt-every", "3"]
            a, b = os.path.join(root, "a"), os.path.join(root, "b")
            train_mod.main(args + ["--ckpt-dir", a])
            shutil.copytree(os.path.join(a, "step_3"),
                            os.path.join(b, "step_3"))
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                train_mod.main(args + ["--ckpt-dir", b])
            if "[train] resumed from step 3" not in log.getvalue():
                raise AssertionError("train gate 3: B did not resume")
            target = fresh(qwen, AdamWConfig(), "cpu")
            want = checkpointer.restore(a, 6, target)
            got = checkpointer.restore(b, 6, target)
            if int(got.step) != 6 or checkpointer.latest_step(b) != 6:
                raise AssertionError("train gate 3: the resumed run's step")
            pairs = list(zip(tree_leaves(got.params),
                             tree_leaves(want.params)))
            return (max(float((x - y).abs().max()) for x, y in pairs),
                    all(torch.equal(x, y) for x, y in pairs),
                    all(torch.allclose(x, y, rtol=1e-5, atol=1e-6)
                        for x, y in pairs))
        finally:
            shutil.rmtree(root, ignore_errors=True)

    # the two runs are equal bit for bit on an H100 (an updated leaf keeps
    # its parameter's layout); the gate is the reference's tolerance
    out["resume"] = dict(zip(("max_abs_diff", "bitwise", "within_tol"),
                             resume_pair()))
    if not out["resume"]["within_tol"]:
        raise AssertionError(f"train gate 3: resumed params differ from "
                             f"straight-through ones: {out['resume']}")

    # -- 4. the compressed DP step on a mesh of the one card -----------------
    opt_cfg = AdamWConfig(lr_peak=3e-3, warmup_steps=2, total_steps=30)
    data = SyntheticLM(DataConfig(global_batch=8, seq_len=32,
                                  vocab_size=qwen.vocab_size))
    mesh = mesh_mod.make_mesh((1,), ("data",))
    state = fresh(qwen, opt_cfg, dev)
    params, opt = state.params, state.opt
    err = [tree_map(torch.zeros_like, params)]
    dp = build_compressed_dp_step(qwen, opt_cfg, mesh)
    losses = []
    for i in range(30):
        params, opt, err, m = dp(params, opt, err,
                                 data.batch_at(i, device=dev))
        losses.append(float(m["loss"]))
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first - 0.3:
        raise AssertionError(f"train gate 4: loss {first} -> {last}")
    out["compressed_dp"] = {"first5": first, "last5": last}

    # -- 5. one step of every smoke config: card = CPU -----------------------
    b_, s_ = TRAIN_SMOKE_SHAPE
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    per_arch = {}
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch, smoke=True)
        tol = TRAIN_TOL_G.get(arch, TRAIN_TOL_G_DEFAULT)
        data = SyntheticLM(DataConfig(global_batch=b_, seq_len=s_,
                                      vocab_size=cfg.vocab_size,
                                      input_mode=cfg.input_mode,
                                      d_model=cfg.d_model))
        step = build_train_step(cfg, opt_cfg)
        want, wm = step(fresh(cfg, opt_cfg, "cpu"),
                        data.batch_at(0, device="cpu"))
        with _matmul_precision("high"):
            got, gm = step(fresh(cfg, opt_cfg, dev),
                           data.batch_at(0, device=dev))
            torch.cuda.synchronize()
        loss_tol = 1e-4 if cfg.ssm is not None else 1e-5
        rec = {"loss_rel": abs(float(gm["loss"]) / float(wm["loss"]) - 1),
               "grad_norm_rel": abs(float(gm["grad_norm"])
                                    / float(wm["grad_norm"]) - 1),
               "tol_g": tol}
        if not (math.isfinite(float(gm["loss"])) and rec["loss_rel"]
                <= loss_tol and rec["grad_norm_rel"] <= tol
                and float(gm["grad_norm"]) > 0):
            raise AssertionError(f"train gate 5 {arch}: {rec}")
        rec.update(_step_close(got, want, float(wm["lr"]), tol,
                               f"train gate 5 {arch}"))
        per_arch[arch] = rec
    out["card_vs_cpu"] = per_arch

    # -- 6. a bf16 step with remat: card against CPU, by the bf16 ratios -----
    cfgb = dataclasses.replace(qwen, param_dtype="bfloat16",
                               compute_dtype="bfloat16", remat="block")
    pb = tree_map(lambda v: v.to(torch.bfloat16),
                  init_params(torch.Generator().manual_seed(0), qwen, "cpu"))
    data = SyntheticLM(DataConfig(global_batch=b_, seq_len=s_,
                                  vocab_size=qwen.vocab_size))
    batch = data.batch_at(0, device="cpu")
    l32, g32 = value_and_grad(tree_map(lambda v: v.float(), pb), qwen, batch)
    lc, gc = value_and_grad(pb, cfgb, batch)
    with _matmul_precision("high"):
        ld, gd = value_and_grad(tree_map(lambda v: v.to(dev), pb), cfgb,
                                data.batch_at(0, device=dev))
        torch.cuda.synchronize()
    worst = {"mean_ratio": 0.0, "max_ratio": 0.0}
    for i, (want, cpu, card) in enumerate(zip(tree_leaves(g32),
                                              tree_leaves(gc),
                                              tree_leaves(gd))):
        if card.dtype != torch.bfloat16:
            raise AssertionError(f"train gate 6: leaf {i} is {card.dtype}")
        want = want.double()
        floor = float(want.abs().max()) * 2.0**-9
        e_cpu = (cpu.double() - want).abs()
        e_card = (card.double().cpu() - want).abs()
        mean_r = float(e_card.mean()) / max(float(e_cpu.mean()), floor)
        max_r = float(e_card.max()) / max(float(e_cpu.max()), floor)
        worst["mean_ratio"] = max(worst["mean_ratio"], mean_r)
        worst["max_ratio"] = max(worst["max_ratio"], max_r)
        if mean_r > BF16_MEAN_RATIO or max_r > BF16_MAX_RATIO:
            raise AssertionError(f"train gate 6: leaf {i}: the card's bf16 "
                                 f"gradient {mean_r} (mean) / {max_r} (max) "
                                 f"times the CPU's distance from fp32")
    loss_rel = abs(float(ld) / float(l32) - 1)
    if not loss_rel <= 2.0**-8:
        raise AssertionError(f"train gate 6: bf16 loss {float(ld)} against "
                             f"fp32 {float(l32)}")
    out["bf16_remat"] = {**worst, "loss_rel_fp32": loss_rel,
                         "cpu_loss_rel_fp32": abs(float(lc) / float(l32) - 1),
                         "bf16_reduced_precision_reduction":
                             torch.backends.cuda.matmul
                             .allow_bf16_reduced_precision_reduction}
    del g32, gc, gd
    emit({"phase": "train_gates", "device": name, "nvidia_smi": smi, **out,
          "phase_s": time.perf_counter() - t_phase})
    torch.cuda.empty_cache()
    return out


def _train_step_profile(run, cfg, seq: int, step: int) -> dict:
    """One more step of ``run``'s training from its final state, apart
    from the timed ones: the forward + backward (``value_and_grad``) and
    the AdamW update timed apart by CUDA events, under ``torch.profiler``:
    the device's busy time (kernel time) against the step's host clock,
    the GEMM kernels' share of it, and the top operators and kernels by
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.training import AdamWConfig, adamw_update
    from repro_torch.training.step import value_and_grad

    opt_cfg = AdamWConfig(lr_peak=3e-4, warmup_steps=1, total_steps=step)
    batch = SyntheticLM(DataConfig(seed=0, global_batch=TRAIN_BATCH,
                                   seq_len=seq, vocab_size=cfg.vocab_size)
                        ).batch_at(step, device="cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev[0].record()
        _loss, grads = value_and_grad(run.state.params, cfg, batch)
        ev[1].record()
        new = adamw_update(opt_cfg, run.state.params, grads, run.state.opt)
        ev[2].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del grads, new
    events = prof.key_averages()
    kernels = {e.key: e.self_device_time_total / 1e3 for e in events
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total}
    ops = {e.key: e.self_device_time_total / 1e3 for e in events
           if e.key.startswith("aten::") and e.self_device_time_total}
    busy = sum(kernels.values())
    gemm = sum(v for k, v in kernels.items()
               if any(w in k.lower() for w in ("gemm", "xmma", "nvjet",
                                               "cutlass")))
    return {"fwd_bwd_ms": ev[0].elapsed_time(ev[1]),
            "adamw_ms": ev[1].elapsed_time(ev[2]),
            "wall_ms_under_profiler": wall_ms, "device_busy_ms": busy,
            "busy_share": busy / wall_ms, "gemm_ms": gemm,
            "kernel_launches": sum(e.count for e in events
                                   if e.device_type == DeviceType.CUDA),
            "top_ops_ms": dict(sorted(ops.items(),
                                      key=lambda kv: -kv[1])[:12]),
            "top_kernels_ms": {k[:80]: v for k, v in sorted(
                kernels.items(), key=lambda kv: -kv[1])[:8]}}


def _counted_step(run, cfg, shape) -> dict:
    """One more step of ``run``'s training from its final state, untimed,
    under ``roofline.op_counter``: the dry-run's step of ``shape``
    (``launch/dryrun.py``'s optimizer config and microbatch policy) on the
    state the train phase holds and the pipeline's next batch.  Returns
    the counter's FLOPs by dtype, bytes, the bytes the step must move,
    argument and peak bytes, the state's and the batch's ``nbytes``, and
    the card's own peak above its arguments (``max_memory_allocated``)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.dryrun import _opt_config, train_step_config
    from repro_torch.models import tree_leaves
    from repro_torch.roofline import analyze
    from repro_torch.training import build_train_step

    batch = SyntheticLM(DataConfig(seed=0, global_batch=shape.global_batch,
                                   seq_len=shape.seq_len,
                                   vocab_size=cfg.vocab_size)
                        ).batch_at(int(run.state.step), device="cuda")
    step = build_train_step(cfg, _opt_config(cfg),
                            train_step_config(cfg, shape))
    leaves = (tree_leaves(run.state.params) + tree_leaves(run.state.opt)
              + [run.state.step, run.state.data_cursor, run.state.rng]
              + list(batch.values()))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cost = analyze(step, run.state, batch)
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated() - base
    return {"flops_by_dtype": dict(cost.flops), "bytes": cost.bytes,
            "moved_bytes": cost.moved_bytes,
            "argument_bytes": cost.argument_bytes,
            "peak_above_args": cost.peak_bytes - cost.argument_bytes,
            "state_batch_nbytes": sum(t.nbytes for t in leaves),
            "card_peak_above_args": card_peak}


def train_phase(gates: dict, reset_counts, counts, launches, smi: str,
                name: str) -> dict:
    """The ``train`` phase: qwen2-1.5b as published (28 layers, d_model
    1,536, vocab 151,936, bf16 params and compute, remat "block") trained
    through ``launch/train.py``'s ``train`` (the CLI's loop) on the card:
    AdamW with fp32 moments, global batch ``TRAIN_BATCH`` at
    ``SHAPES["train_4k"]``'s 4,096 positions, ``TRAIN_WARMUP`` +
    ``TRAIN_TIMED`` steps, no checkpoint; counters set to 0 before and read
    after (the training path launches none of the eight kernels).

    Gates: every loss and grad norm finite, every grad norm above 0; step
    0's loss equals ``lm_loss`` of the initial params (drawn again from
    the same seed) on the same batch within ``TRAIN_LOSS_TOL``; the first
    update follows AdamW's step-1 closed form on two sampled leaves, read
    from the state after step 1: with m̂ = m / (1 - b1) = g·s, v̂ = v /
    (1 - b2) = m̂² (to fp32 rounding), the new params are the bf16 rounding
    of p0 - lr·(m̂ / (|m̂| + eps) + wd·p0), to half a bf16 ulp:
    ``final_norm`` (p0 = 0: the update alone) and 4,096 entries of layer
    0's ``wq`` (an update of about 2.5 ulps of p0).  Line ``e2e_train``:
    each step's loss, grad norm,
    lr and ms (CUDA-synchronised), the median step ms of the timed steps,
    tokens/s end to end (the timed steps' tokens over the sum of their
    step and data seconds), the model FLOPs (6·N·T plus attention, PaLM's 12·L·H·hd·S a
    token) and their share of the card's dense bf16 peak, the peak memory
    above what was resident, the state's bytes, the data pipeline's host
    ms a batch, the kernels' launches, one more step profiled
    (:func:`_train_step_profile`), and one more counted
    (:func:`_counted_step`): its FLOPs by dtype and bytes, the step's
    dtype-aware roofline bound (the larger of each dtype's FLOPs at its
    peak and the bytes the step must move, ``OpCost.moved_bytes``, at the
    HBM rate), the median step over it, and beside it the eager ops'
    bytes at the HBM rate (``eager_bytes_ms``: they move with the
    implementation, so they bound nothing).  Returns what the
    ``roofline`` phase reads."""
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.models import init_params, lm_loss, tree_leaves
    from repro_torch.roofline import roofline_terms
    from repro_torch.training import AdamWConfig

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    seq = SHAPES["train_4k"].seq_len
    steps = TRAIN_WARMUP + TRAIN_TIMED
    cfg = configs.get_config(TRAIN_ARCH)
    opt_cfg = AdamWConfig()
    sampled = {}

    def wq0(tree):
        return tree["period"]["s0"]["attn"]["wq"][0].reshape(-1)[:4096]

    def hook(step, state, metrics):
        if step == 0:
            sampled["lr"] = float(metrics["lr"])
            for key, pick in (("final_norm", lambda t: t["final_norm"]),
                              ("wq0", wq0)):
                sampled[key] = {"p1": pick(state.params).clone(),
                                "m": pick(state.opt["m"]).clone(),
                                "v": pick(state.opt["v"]).clone()}

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = train_mod.train(TRAIN_ARCH, steps=steps, global_batch=TRAIN_BATCH,
                          seq_len=seq, seed=0, device="cuda", on_step=hook)
    torch.cuda.synchronize()
    launches["train"] = counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    if any(launches["train"].values()):
        raise AssertionError(f"train: a kernel launched {launches['train']}")
    if cfg.param_dtype != "bfloat16" or cfg.remat != "block":
        raise AssertionError("train: qwen2-1.5b is not the published config")
    state_bytes = sum(v.numel() * v.element_size()
                      for v in tree_leaves(run.state.params)
                      + tree_leaves(run.state.opt))
    n_params = sum(v.numel() for v in tree_leaves(run.state.params))
    hist = run.history
    for rec in hist:
        print(f"[train] step={rec['step']} loss={rec['loss']:.4f} "
              f"gnorm={rec['grad_norm']:.3f} lr={rec['lr']:.2e} "
              f"step_ms={rec['step_s'] * 1e3:.1f} "
              f"data_ms={rec['data_s'] * 1e3:.1f} ({smi})", flush=True)
        if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])
                and rec["grad_norm"] > 0):
            raise AssertionError(f"train: step {rec['step']}: {rec}")
    breakdown = _train_step_profile(run, cfg, seq, steps)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TRAIN_BATCH)
    counted = _counted_step(run, cfg, shape)
    del run
    torch.cuda.empty_cache()

    # step 0's loss against lm_loss of the same initial params and batch
    p0 = init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    batch = SyntheticLM(DataConfig(seed=0, global_batch=TRAIN_BATCH,
                                   seq_len=seq, vocab_size=cfg.vocab_size)
                        ).batch_at(0, device=dev)
    with torch.no_grad():
        loss0 = float(lm_loss(p0, cfg, tokens=batch["tokens"],
                              labels=batch["labels"]))
    loss_rel = abs(hist[0]["loss"] / loss0 - 1)
    if loss_rel > TRAIN_LOSS_TOL:
        raise AssertionError(f"train: step 0's loss {hist[0]['loss']} "
                             f"against lm_loss {loss0}")
    # the first update's closed form
    closed = {}
    lr, b1, b2 = sampled["lr"], opt_cfg.b1, opt_cfg.b2
    for key, start in (("final_norm", p0["final_norm"]), ("wq0", wq0(p0))):
        got = sampled[key]
        mhat = got["m"].double() / (1 - b1)
        vhat = got["v"].double() / (1 - b2)
        v_err = float(((vhat - mhat * mhat).abs()
                       / (mhat * mhat).clamp(min=1e-30)).max())
        if v_err > 1e-5:
            raise AssertionError(f"train: {key} v̂ != m̂² ({v_err})")
        p = start.double()
        want = p - lr * (mhat / (mhat.abs() + opt_cfg.eps)
                         + opt_cfg.weight_decay * p)
        p1 = got["p1"].double()
        diff = (p1 - want).abs()
        # the bf16 rounding of the fp32 result: half a bf16 ulp (2**(e - 8)
        # for |want| in [2**e, 2**(e + 1))), and fp32 slack
        half_ulp = torch.where(
            want != 0, 2.0 ** (torch.floor(torch.log2(want.abs())) - 8), 0.0)
        ok = diff <= half_ulp + 1e-6 * want.abs()
        if not bool(ok.all()):
            raise AssertionError(f"train: {key}'s first update is not "
                                 f"AdamW's (worst {float(diff.max())})")
        closed[key] = {"max_abs_diff": float(diff.max()),
                       "max_update": float((want - p).abs().max()),
                       "v_rel_err": v_err}
    del p0, batch
    torch.cuda.empty_cache()

    timed = hist[TRAIN_WARMUP:]
    step_ms = statistics.median(rec["step_s"] * 1e3 for rec in timed)
    tokens = TRAIN_BATCH * seq
    # end to end: every timed step's tokens over the loop's whole time,
    # the pipeline's batch and upload included
    loop_s = sum(rec["step_s"] + rec["data_s"] for rec in timed)
    tokens_per_s = tokens * len(timed) / loop_s
    hd = cfg.hd()
    flops = tokens * (6 * n_params
                      + 12 * cfg.num_layers * cfg.num_heads * hd * seq)
    hw = spec_for(name)
    peak_bf16 = hw.peak_flops_bf16
    terms = roofline_terms(
        {"flops": sum(counted["flops_by_dtype"].values()),
         "bytes accessed": counted["moved_bytes"],
         "flops_by_dtype": counted["flops_by_dtype"]}, {}, 1, flops, hw)
    bound = {"bound_ms": terms.step_time_lower_bound_s * 1e3,
             "dominant": terms.dominant,
             "compute_ms": terms.compute_s * 1e3,
             "memory_ms": terms.memory_s * 1e3,
             "eager_bytes_ms": counted["bytes"] / hw.hbm_bw * 1e3,
             "median_step_over_bound":
                 step_ms / (terms.step_time_lower_bound_s * 1e3)}
    emit({"phase": "e2e_train", "device": name, "nvidia_smi": smi,
          "arch": TRAIN_ARCH, "param_dtype": cfg.param_dtype,
          "remat": cfg.remat, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "global_batch": TRAIN_BATCH, "seq_len": seq,
          "tokens_per_step": tokens, "n_params": n_params,
          "steps": [{k: rec[k] for k in ("step", "loss", "grad_norm", "lr")}
                    | {"ms": rec["step_s"] * 1e3,
                       "data_ms": rec["data_s"] * 1e3} for rec in hist],
          "median_step_ms": step_ms, "timed_loop_s": loop_s,
          "tokens_per_s": tokens_per_s,
          "model_flops_per_step": flops, "peak_bf16_flops": peak_bf16,
          "mfu": flops * tokens_per_s / tokens / peak_bf16,
          "counted_step": counted, "dtype_aware_bound": bound,
          "bound_share": 1 / bound["median_step_over_bound"],
          "peak_mb_above_resident": peak, "resident_mb": base / 2**20,
          "state_bytes": state_bytes,
          "data_host_ms": statistics.median(rec["data_s"] * 1e3
                                            for rec in hist),
          "step0_loss": hist[0]["loss"], "lm_loss_step0": loss0,
          "step0_loss_rel": loss_rel, "first_update": closed,
          "profiled_step": breakdown,
          "launches": launches["train"], "gates": gates,
          "phase_s": time.perf_counter() - t_phase})
    return {"counted_step": counted, "bound": bound, "median_step_ms": step_ms,
            "peak_above_resident": peak * 2**20, "state_bytes": state_bytes}


def roofline_phase(trained: dict, cat, qv, p, r, reset_counts, counts,
                   launches, smi: str, name: str) -> None:
    """The ``roofline`` phase: the roofline tooling on the card, after the
    ``train`` phase (``trained`` is what it returned), counters set to 0
    before and read after (``lower`` and ``lower_batch`` run the plans,
    so the Q1, Q2 and Q3 kernels launch).

    Gate 1: ``launch/dryrun.py``'s ``run_cell`` of the train phase's cell
    (qwen2-1.5b as published, ``train_4k`` with the global batch cut to
    ``TRAIN_BATCH``, mesh ``one``) on ``meta`` counts, per dtype, exactly
    the FLOPs the counter read off one real step on the card.  Gate 2: its
    argument bytes equal the ``nbytes`` of the state and the batch the
    card's step took; its peak above the arguments lies within
    ``ROOFLINE_PEAK_TOL`` of the card's own peak above them in that step.
    Its whole peak is printed beside ``e2e_train``'s peak above resident,
    not gated: tensors of earlier phases, resident when ``train`` starts,
    are freed while it runs, so that reading understates the step by as
    much as they free.  The bytes the step must move are equal on both
    sides too.  Gate 3: ``lower_batch`` of Q1 at a list of ``N_QUERIES`` counts
    2·Q·N·D kernel operations (one ``scan_topk_batch`` launch) and no other
    FLOP, so its compute term is that over the fp32 peak; the bound is
    printed over the measured execute.  Gate 4: ``lower(...).as_text()``
    names ``scan_topk`` for a single-dict Q1 and ``range_scan`` for a
    single-dict perleft Q3; ``lower_batch`` of Q2 names
    ``range_topk_batch``, and a single-dict Q2, which runs the plain scan
    as the reference lowers it, names no kernel and counts its rowwise
    distance's 2·N·D operations; every answer after the lowerings equals
    the one before bit for bit."""
    from repro_torch.api import connect
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.roofline import roofline_terms

    t_phase = time.perf_counter()
    hw = spec_for(name)
    reset_counts()
    # gates 1 and 2: the dry-run of the train phase's cell
    rec = run_cell(TRAIN_ARCH, "train_4k", "one", global_batch=TRAIN_BATCH)
    if rec["status"] != "ok":
        raise AssertionError(f"roofline: the dry-run failed: {rec['error']}")
    card = trained["counted_step"]
    if rec["cost"]["flops_by_dtype"] != card["flops_by_dtype"]:
        raise AssertionError(f"roofline gate 1: meta FLOPs "
                             f"{rec['cost']['flops_by_dtype']} != the card's "
                             f"{card['flops_by_dtype']}")
    mem = rec["memory"]
    if not (mem["argument_bytes"] == card["argument_bytes"]
            == card["state_batch_nbytes"]
            and rec["cost"]["moved_bytes_per_device"] == card["moved_bytes"]):
        raise AssertionError(f"roofline gate 2: argument bytes "
                             f"{mem['argument_bytes']} against the card's "
                             f"{card['argument_bytes']} and nbytes "
                             f"{card['state_batch_nbytes']}, moved bytes "
                             f"{rec['cost']['moved_bytes_per_device']} "
                             f"against {card['moved_bytes']}")
    above_args = rec["peak_bytes"] - mem["argument_bytes"]
    peaks = {"predicted_above_args": above_args,
             "card_step_above_args": card["card_peak_above_args"],
             "predicted_total": rec["peak_bytes"],
             "e2e_train_above_resident": trained["peak_above_resident"],
             "e2e_train_above_state": (trained["peak_above_resident"]
                                       - trained["state_bytes"])}
    peaks["predicted_over_card_step"] = (above_args
                                         / card["card_peak_above_args"])
    peaks["predicted_total_over_e2e_train"] = (
        rec["peak_bytes"] / trained["peak_above_resident"])
    if abs(peaks["predicted_over_card_step"] - 1) > ROOFLINE_PEAK_TOL:
        raise AssertionError(f"roofline gate 2: predicted peak above the "
                             f"arguments {above_args} against the card's "
                             f"{card['card_peak_above_args']}")

    # gates 3 and 4: lower / lower_batch over the 1M x 512 catalog
    db = connect(cat, engine="brute", use_pallas=True)
    perleft_db = connect(cat, engine="brute", use_pallas=True,
                         join_lowering="perleft")
    q1, q2 = db.prepare(Q1, K=K), db.prepare(Q2)
    q3 = perleft_db.prepare(Q3)
    binds = [{"qv": qv[i], "p": p} for i in range(N_QUERIES)]
    q2_binds = [{"qv": qv[i], "r": r, "p": p} for i in range(N_QUERIES)]
    runs = {"q1_single": (q1, binds[0]), "q1_list": (q1, binds),
            "q2_single": (q2, q2_binds[0]), "q2_list": (q2, q2_binds),
            "q3_perleft": (q3, {"r": r})}
    before = {key: st.execute(b).data for key, (st, b) in runs.items()}
    lowered = {"q1_single": q1.compiled.lower(**binds[0]),
               "q1_list": q1.compiled.lower_batch(binds),
               "q2_single": q2.compiled.lower(**q2_binds[0]),
               "q2_list": q2.compiled.lower_batch(q2_binds),
               "q3_perleft": q3.compiled.lower(r=r)}
    after = {key: st.execute(b).data for key, (st, b) in runs.items()}
    torch.cuda.synchronize()
    launches["roofline"] = counts()
    for key in runs:
        bitwise(after[key], before[key], f"roofline: {key} after lower")
    names = {key: sorted({line.split()[1] for line in lw.as_text().splitlines()
                          if line.startswith("kernel ")})
             for key, lw in lowered.items()}
    want_names = {"q1_single": ["scan_topk"], "q1_list": ["scan_topk_batch"],
                  "q2_single": [], "q2_list": ["range_topk_batch"],
                  "q3_perleft": ["range_scan"]}
    if names != want_names:
        raise AssertionError(f"roofline gate 4: kernels named {names}")
    if lowered["q2_single"].cost.flops_total != 2 * N_ROWS * DIM:
        raise AssertionError(f"roofline gate 4: single Q2 counts "
                             f"{lowered['q2_single'].cost.flops} FLOPs")
    for kname in ("scan_topk", "scan_topk_batch", "range_scan",
                  "range_topk_batch"):
        if launches["roofline"][kname] < 1:
            raise AssertionError(f"roofline: {kname} never launched")
    cost = lowered["q1_list"].cost
    ops = 2 * N_QUERIES * N_ROWS * DIM
    k1 = cost.kernels["scan_topk_batch"]
    if not (k1["launches"] == 1 and k1["ops"] == ops
            and cost.flops_total == ops):
        raise AssertionError(f"roofline gate 3: {cost.kernels}, flops "
                             f"{cost.flops}")
    terms = roofline_terms({"flops": cost.flops_total,
                            "bytes accessed": cost.bytes,
                            "flops_by_dtype": cost.flops},
                           cost.collective_bytes, 1, 0.0, hw)
    if terms.compute_s != ops / hw.peak_flops_fp32:
        raise AssertionError(f"roofline gate 3: compute term "
                             f"{terms.compute_s}")
    q1_ms = latency_ms(lambda: q1.execute(binds))
    emit({"phase": "roofline", "device": name, "nvidia_smi": smi,
          "hw": dataclasses.asdict(hw),
          "train_cell": {"arch": TRAIN_ARCH, "shape": "train_4k",
                         "global_batch": TRAIN_BATCH,
                         "flops_by_dtype": rec["cost"]["flops_by_dtype"],
                         "card_flops_by_dtype": card["flops_by_dtype"],
                         "bytes": rec["cost"]["bytes_per_device"],
                         "card_bytes": card["bytes"],
                         "moved_bytes":
                             rec["cost"]["moved_bytes_per_device"],
                         "card_moved_bytes": card["moved_bytes"],
                         "memory": mem, "peaks": peaks,
                         "roofline": rec["roofline"],
                         "dry_run_s": rec["lower_s"],
                         "median_step_ms": trained["median_step_ms"],
                         "step_bound": trained["bound"]},
          "q1_list": {"queries": N_QUERIES, "kernel_ops": cost.kernel_ops,
                      "kernels": cost.kernels, "bytes": cost.bytes,
                      "compute_ms": terms.compute_s * 1e3,
                      "memory_ms": terms.memory_s * 1e3,
                      "bound_ms": terms.step_time_lower_bound_s * 1e3,
                      "execute_ms": q1_ms,
                      "bound_over_execute":
                          terms.step_time_lower_bound_s * 1e3 / q1_ms},
          "lowered": {key: {**lw.cost_analysis(), "kernels": names[key],
                            "ops": len(lw.cost.events)}
                      for key, lw in lowered.items()},
          "launches": launches["roofline"],
          "phase_s": time.perf_counter() - t_phase,
          "script_s": time.perf_counter() - T_START})


def mesh_cell(arch: str, shape: str, mesh: str, out: str) -> None:
    """A ``mesh`` phase child: the dry-run's record of one cell (full
    width, ``meta``, the host only), written to ``out`` as JSON."""
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell(arch, shape, mesh)
    with open(out, "w") as f:
        json.dump(rec, f)


def mesh_grid(out: str) -> None:
    """The ``mesh`` phase's grid child: the dry-run's record of every
    ``MESH_TINY_REF`` cell at --smoke-config under ``tiny`` (``meta``, the
    host only), and the host's torch version, written to ``out`` as
    JSON."""
    from repro_torch.launch.dryrun import run_cell
    recs = []
    for arch, shape in MESH_TINY_REF:
        recs.append(run_cell(arch, shape, "tiny", smoke_config=True))
    with open(out, "w") as f:
        json.dump({"torch": torch.__version__, "records": recs}, f)


class MeshCells:
    """The ``mesh`` phase's dry-run children (:func:`mesh_cell`,
    :func:`mesh_grid`): every cell of ``MESH_CELLS``, the mesh-``one``
    record of each of its (arch, shape), and the smoke grid, one process
    each, all started together (they count on ``meta`` on the host's
    cores and touch no card).  ``close`` (also at exit) stops any still
    running and removes their directory."""

    def __init__(self):
        import atexit
        import tempfile
        self.work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
        atexit.register(self.close)
        ones = [(a, sh, "one") for a, sh in dict.fromkeys(
            (a, sh) for a, sh, _m in MESH_CELLS)]
        self.started = time.perf_counter()
        self.procs = {}
        for cell in (*MESH_CELLS, *ones, "grid"):
            out = os.path.join(self.work, "-".join(cell) + ".json")
            log = open(out + ".log", "w+")
            args = ["--mesh-grid"] if cell == "grid" else ["--mesh-cell",
                                                            *cell]
            self.procs[cell] = (subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), *args, out],
                stdout=log, stderr=subprocess.STDOUT, text=True), log, out)

    def join(self) -> dict:
        """Each cell's record, once every child has ended."""
        recs = {}
        for cell, (proc, log, out) in self.procs.items():
            if proc.wait() != 0:
                log.seek(0)
                raise AssertionError(f"mesh: the dry-run child {cell} "
                                     f"failed:\n{log.read()[-4000:]}")
            with open(out) as f:
                recs[cell] = json.load(f)
        self.wall_s = time.perf_counter() - self.started
        return recs

    def close(self) -> None:
        import shutil
        for proc, log, _out in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(self.work, ignore_errors=True)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.detach().cpu().reshape(-1).view(torch.uint8),
        b.detach().cpu().reshape(-1).view(torch.uint8))


def mesh_phase(cells: MeshCells, reset_counts, counts, launches, smi: str,
               name: str) -> None:
    """The ``mesh`` phase: meshes of more than one device, counters set to
    0 before and read after (it launches no kernel).

    Gate 2, on the card, while gate 1's children count: ``make_mesh((2,
    2))`` on ``cuda``, and ``launch.train --mesh tiny`` and ``--mesh
    single`` with ``--device cuda``, raise ``DeviceCountError`` naming the
    card count before any work (no checkpoint directory, no memory taken
    on the card); ``restore(..., shardings)`` under a mesh of the one card
    puts every leaf of a saved smoke ``TrainState`` on ``cuda:0``, bit for
    bit what was saved.  Gate 1, on the host: each ``MESH_CELLS`` record
    (one device's of its mesh, ``launch/dryrun.py`` on DTensors of
    ``meta`` blocks) beside its mesh-``one`` record: per-device FLOPs
    times the chips at least the mesh-``one`` count (no work lost; the
    ratio printed), per-device argument bytes equal to
    ``shardspec.device_bytes`` of the arguments, the per-device peak below
    the mesh-``one`` peak, and a nonzero collective term; where
    ``MESH_FULL_RATIO`` names the cell, that ratio exactly.  Gate 3, on
    the host: every cell of the smoke grid under ``tiny`` counts the
    reference's pinned ``MESH_TINY_REF`` FLOPs per device exactly (the SSM
    training steps less ``testing.ssd_backward_gap``) and its argument
    bytes (less the decode cache's 4 bytes of ``pos``, a host int in the
    port), with a nonzero collective term; a cell the reference skips is
    skipped."""
    import tempfile
    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_config, get_shape
    from repro_torch.dist.sharding import DeviceCountError
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardspec import (param_logical_axes, rules_for,
                                              tree_flatten_with_path,
                                              tree_shardings)
    from repro_torch.models import init_params
    from repro_torch.training import AdamWConfig, TrainState, adamw_init
    from repro_torch.training.train_state import prng_key

    from repro_torch.testing import ssd_backward_gap

    t_phase = time.perf_counter()
    reset_counts()
    cards = torch.cuda.device_count()
    gate2 = {}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    try:
        make_mesh((2, 2), ("data", "model"))
        raise AssertionError("mesh gate 2: a 2 x 2 mesh on the card built")
    except DeviceCountError as e:
        if f"have {cards}" not in str(e):
            raise AssertionError(f"mesh gate 2: {e}") from e
        gate2["make_mesh_2x2"] = str(e)
    with tempfile.TemporaryDirectory() as tmp:
        for mesh in ("tiny", "single"):
            ck = os.path.join(tmp, f"ck_{mesh}")
            try:
                launch_train.main(["--arch", "qwen2-1.5b", "--smoke",
                                   "--mesh", mesh, "--device", "cuda",
                                   "--ckpt-dir", ck])
                raise AssertionError(f"mesh gate 2: train --mesh {mesh} "
                                     f"ran on {cards} card(s)")
            except DeviceCountError as e:
                if f"have {cards}" not in str(e) or os.path.exists(ck):
                    raise AssertionError(f"mesh gate 2: {e}") from e
                gate2[f"train_{mesh}"] = str(e)
        torch.cuda.synchronize()
        if torch.cuda.memory_allocated() != held:
            raise AssertionError("mesh gate 2: the refused runs took "
                                 "memory on the card")
        # the reshard onto a mesh of the one card
        cfg = get_config("qwen2-1.5b", smoke=True)
        opt_cfg = AdamWConfig()
        params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        state = TrainState.create(params, adamw_init(opt_cfg, params),
                                  prng_key(0))
        save(tmp, 1, state)
        mesh = make_mesh((1, 1), ("data", "model"))
        rules = rules_for(cfg, get_shape("train_4k", smoke=True), mesh)
        meta = init_params(torch.Generator(), cfg, "meta")
        target = TrainState.create(meta, adamw_init(opt_cfg, meta),
                                   prng_key(0, "meta"))
        got = restore(tmp, 1, target, tree_shardings(
            target, mesh, rules, param_logical_axes))
        pairs = list(zip(tree_flatten_with_path(got),
                         tree_flatten_with_path(state), strict=True))
        for (path, leaf), (_p, want) in pairs:
            if not (isinstance(leaf, torch.Tensor)
                    and leaf.device == torch.device("cuda", 0)
                    and _bits_equal(leaf, want)):
                raise AssertionError(f"mesh gate 2: restored leaf {path} "
                                     f"is not the saved one on cuda:0")
        gate2["restore_leaves_on_cuda0"] = len(pairs)
    gate2_s = time.perf_counter() - t_phase

    # gate 1: the children's records
    recs = cells.join()
    cells_out = []
    for arch, shape, mesh in MESH_CELLS:
        rec, one = recs[(arch, shape, mesh)], recs[(arch, shape, "one")]
        for r in (rec, one):
            if r["status"] != "ok":
                raise AssertionError(f"mesh gate 1: {r['arch']} "
                                     f"{r['shape']} {r['mesh']}: "
                                     f"{r.get('error')}")
        chips = rec["chips"]
        ratio = (rec["cost"]["flops_per_device"] * chips
                 / one["cost"]["flops_per_device"])
        row = {"arch": arch, "shape": shape, "mesh": mesh, "chips": chips,
               "global_batch": rec["global_batch"],
               "flops_by_dtype": rec["cost"]["flops_by_dtype"],
               "one_flops_by_dtype": one["cost"]["flops_by_dtype"],
               "flops_times_chips_over_one": ratio,
               "moved_bytes": rec["cost"]["moved_bytes_per_device"],
               "one_moved_bytes": one["cost"]["moved_bytes_per_device"],
               "argument_bytes": rec["memory"]["argument_bytes"],
               "device_bytes": rec["argument_bytes_per_device"],
               "peak_bytes": rec["peak_bytes"],
               "one_peak_bytes": one["peak_bytes"],
               "fits_hbm": rec["fits_hbm"],
               "collective_bytes": rec["collective_bytes"],
               "roofline": rec["roofline"], "one_roofline": one["roofline"],
               "dry_run_s": rec["lower_s"], "one_dry_run_s": one["lower_s"]}
        cells_out.append(row)
        if ratio < 1:
            raise AssertionError(f"mesh gate 1: {arch} {mesh} lost work: "
                                 f"{ratio} of the mesh-one FLOPs")
        want = MESH_FULL_RATIO.get((arch, shape, mesh))
        if want is not None and ratio != want:
            raise AssertionError(f"mesh gate 1: {arch} {mesh} FLOPs x "
                                 f"chips over one {ratio}, not {want}")
        if rec["memory"]["argument_bytes"] != \
                rec["argument_bytes_per_device"]:
            raise AssertionError(f"mesh gate 1: {arch} {mesh} argument "
                                 f"bytes {rec['memory']['argument_bytes']} "
                                 f"!= device_bytes "
                                 f"{rec['argument_bytes_per_device']}")
        if not rec["peak_bytes"] < one["peak_bytes"]:
            raise AssertionError(f"mesh gate 1: {arch} {mesh} peak "
                                 f"{rec['peak_bytes']} not below one's "
                                 f"{one['peak_bytes']}")
        if not rec["roofline"]["collective_s"] > 0:
            raise AssertionError(f"mesh gate 1: {arch} {mesh} has no "
                                 f"collective term")
    # gate 3: the smoke grid against the reference's pinned counts
    grid = recs["grid"]
    grid_out, failed = [], []
    for rec in grid["records"]:
        cell = (rec["arch"], rec["shape"])
        ref = MESH_TINY_REF[cell]
        if ref is None:
            if rec["status"] != "skipped":
                failed.append(f"{cell} ran where the reference skips it")
            grid_out.append({"cell": cell, "status": rec["status"]})
            continue
        if rec["status"] != "ok":
            failed.append(f"{cell}: {rec.get('traceback')}")
            continue
        pos = 4 if rec["kind"] == "decode" else 0
        row = {"cell": cell, "status": "ok",
               "flops": rec["cost"]["flops_per_device"],
               "ref_flops": ref[0], "ssd_gap": ssd_backward_gap(*cell),
               "argument_bytes": rec["argument_bytes_per_device"],
               "ref_argument_bytes": ref[1] - pos,
               "collective_bytes": sum(rec["collective_bytes"].values()),
               "dry_run_s": rec["lower_s"]}
        grid_out.append(row)
        if row["flops"] + row["ssd_gap"] != ref[0] \
                or rec["memory"]["argument_bytes"] != row["argument_bytes"] \
                or row["argument_bytes"] != row["ref_argument_bytes"] \
                or not rec["roofline"]["collective_s"] > 0:
            failed.append(f"{cell} counts {row}, not the reference's")
    if failed:
        raise AssertionError(f"mesh gate 3 (torch {grid['torch']}): "
                             + "\n".join(failed))
    launches["mesh"] = counts()
    if any(launches["mesh"].values()):
        raise AssertionError(f"mesh: kernels launched {launches['mesh']}")
    emit({"phase": "mesh", "device": name, "nvidia_smi": smi,
          "card_count": cards, "gate2": gate2, "gate2_s": gate2_s,
          "cells": cells_out, "host_torch": grid["torch"],
          "grid": grid_out, "grid_dry_run_s": sum(
              r.get("dry_run_s", 0) for r in grid_out),
          "children_wall_s": cells.wall_s,
          "launches": launches["mesh"],
          "phase_s": time.perf_counter() - t_phase,
          "script_s": time.perf_counter() - T_START})
    cells.close()


APPEND_QS = (1, 8, 17, 100, 128, 130)   # range_append_bits' batch sizes
APPEND_ROWS = 1_000_003                  # and its ragged 1M-row corpus


def range_append_bits(dev: torch.device, seed: int = 0) -> dict:
    """range_bits' append mode: ``range_topk_batch`` (the range tile's
    APPEND epilogue and the per-query sort) and ``ops.fused_range_topk_batch``
    equal ``compact_range`` of ``range_scan_batch``'s dense keys bit for bit
    (ids, sims as int32, valid, counts), every metric and mask kind with
    the last three lanes dead, radii at the 100th-best key (the first
    query's on duplicate rows) and above every key, capacities 16 (most
    queries past it: the dense fallback), 4,096 and 6,000 (past the rows),
    at the pairwise_bits shapes with Q in ``APPEND_QS`` and at 1,000,003 x
    64 with Q in {8, 100}; the sort kernel alone on crafted words (±0.0
    ties, ±inf hits, duplicate keys, shuffled slots) against the CPU's
    stable sort.  Returns the line's fields."""
    from repro_torch.core.expr import pairwise_order_keys
    from repro_torch.core.schema import Metric
    from repro_torch.index.flat import compact_range
    from repro_torch.kernels import ops
    from repro_torch.kernels import range_scan as rs_mod

    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = overflowed = 0

    def unit(shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return x / x.norm(dim=-1, keepdim=True)

    def mask8(kind: str, qn: int, n: int):
        if kind == "none":
            return None
        shape = (n,) if kind == "shared" else (qn, n)
        return (torch.rand(shape, generator=gen, device=dev) < 0.4).to(
            torch.int8)

    def same(got, want, rows, what):
        for name, a, b in zip(("ids", "sims", "valid"), got, want):
            a, b = a[rows], b[rows]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {name} differ")

    def check(corpus, qs, rk, m8, qv8, metric, what):
        nonlocal cases, overflowed
        keys, _hits, counts = rs_mod.range_scan_batch(corpus, qs, rk, m8,
                                                      qv8, metric)
        raw = -rk if metric.is_similarity() else rk
        for cap in (16, 4096, 6000):
            want = compact_range(keys, cap, metric)
            got = rs_mod.range_topk_batch(corpus, qs, rk, m8, qv8, metric,
                                          cap)
            if not torch.equal(got[3], counts):
                raise AssertionError(f"{what} cap={cap}: counts differ")
            fits = counts <= cap
            same(got[:3], want, fits, f"{what} cap={cap} kernel")
            empty = (got[0][~fits] == -1).all() and not got[2][~fits].any()
            if not bool(empty):
                raise AssertionError(f"{what} cap={cap}: overflow not empty")
            fused = ops.fused_range_topk_batch(
                corpus, qs, raw, None if m8 is None else m8.view(torch.bool),
                metric, cap, qvalid=qv8.view(torch.bool))
            every = torch.ones_like(fits)
            same(fused[:3], want, every, f"{what} cap={cap} fused")
            if not torch.equal(fused[3], counts):
                raise AssertionError(f"{what} cap={cap}: fused counts")
            cases += 1
            overflowed += int((~fits).sum())

    for n, d in ((5003, 130), (4099, 64), (3001, 512)):
        corpus = unit((n, d))
        corpus[n // 3: n // 3 + 40] = corpus[7]          # exact duplicates
        for metric in Metric:
            for qn in APPEND_QS:
                qs = unit((qn, d))
                qs[0] = corpus[7]
                keys = pairwise_order_keys(metric, corpus, qs)
                rk = torch.sort(keys, dim=-1).values[:, 100].contiguous()
                rk[0] = keys[0, 7]                      # on the duplicates
                radii = {"rank100": rk,
                         "everything": keys.max(dim=1).values + 1}
                qv8 = (torch.arange(qn, device=dev)
                       < max(1, qn - 3)).to(torch.int8)
                for mname in ("none", "shared", "per_query"):
                    m8 = mask8(mname, qn, n)
                    for rname, r in radii.items():
                        check(corpus, qs, r.contiguous(), m8, qv8, metric,
                              f"append bits {metric.value} n={n} d={d} "
                              f"q={qn} {mname} {rname}")
    n, d = APPEND_ROWS, 64
    corpus = unit((n, d))
    for metric in Metric:
        for qn in (8, 100):
            qs = unit((qn, d))
            keys = pairwise_order_keys(metric, corpus, qs)
            rk = torch.topk(keys, RANGE_TARGET, dim=1,
                            largest=False).values[:, -1].contiguous()
            del keys
            qv8 = (torch.arange(qn, device=dev)
                   < max(1, qn - 3)).to(torch.int8)
            check(corpus, qs, rk, mask8("per_query", qn, n), qv8, metric,
                  f"append bits {metric.value} n={n} d={d} q={qn}")
    del corpus
    # the sort kernel on crafted words: zeros of both signs, infinities,
    # repeated keys, slots shuffled, counts 0, 1, up to and past the width
    width, crafted = 64, 0
    cpu = torch.Generator().manual_seed(seed)
    pool = torch.tensor([0.0, -0.0, 1.5, -1.5, float("inf"), -float("inf"),
                         2.0 ** -140, -(2.0 ** -140)])
    for metric in Metric:
        for count in (0, 1, 2, 7, 33, 64, 65):
            qn, n = 3, 500
            keys = pool[torch.randint(len(pool), (qn, n), generator=cpu)]
            hit = torch.zeros((qn, n), dtype=torch.bool)
            for q in range(qn):
                hit[q, torch.randperm(n, generator=cpu)[:count]] = True
            dense = torch.where(hit, keys, float("inf"))
            order = torch.stack([torch.randperm(n, generator=cpu)
                                 for _ in range(qn)])
            words = rs_mod.append_hits_plain(keys, hit, width, order)
            card = (words ^ (-(1 << 63))).to(dev)
            counts = hit.sum(1, dtype=torch.int32).to(dev)
            got = [t.cpu() for t in rs_mod.sort_hits(card, counts, metric)]
            fits = counts.cpu() <= width
            same(got, compact_range(dense, width, metric), fits,
                 f"sort bits {metric.value} count={count}")
            if bool((got[0][~fits] != -1).any()):
                raise AssertionError(f"sort bits count={count}: overflow")
            crafted += 1
    return {"cases": cases, "overflowed_queries": overflowed,
            "crafted": crafted,
            "checks": ["range_topk_batch = compact_range(range_scan_batch "
                       "keys) bit for bit where count <= capacity, empty "
                       "past it; fused_range_topk_batch everywhere",
                       "sort kernel = the CPU's stable sort on crafted "
                       "words (±0.0, ±inf, shuffled)"]}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.api import ExecutionHints, connect
    from repro_torch.core.expr import (evaluate, evaluate_batch, order_key,
                                       pairwise_order_keys)
    from repro_torch.core.physical import _ranked_buffer
    from repro_torch.core.schema import Metric
    from repro_torch.data import make_laion_catalog, selectivity_threshold
    from repro_torch.data.quantized import quantize_corpus
    from repro_torch.index.flat import compact_range
    from repro_torch.kernels import build, ops, pairwise_keys
    from repro_torch.kernels import distance as dist_mod
    from repro_torch.kernels import quant as qt_mod
    from repro_torch.kernels import range_scan as rs_mod
    from repro_torch.kernels import scan_topk as st_mod
    from repro_torch.testing import assert_range_close, assert_topk_close

    wrappers = {"scan_topk": st_mod.scan_topk,
                "scan_topk_batch": st_mod.scan_topk_batch,
                "range_scan": rs_mod.range_scan,
                "range_scan_batch": rs_mod.range_scan_batch,
                "range_topk_batch": rs_mod.range_topk_batch,
                "quant_scan_topk_batch": qt_mod.quant_scan_topk_batch,
                "quant_keys_batch": qt_mod.quant_keys_batch,
                "replay_keys": qt_mod.replay_keys,
                "pairwise_keys": dist_mod.pairwise_keys}

    def reset_counts() -> None:
        for fn in wrappers.values():
            fn.launches = 0

    def counts() -> dict:
        return {name: fn.launches for name, fn in wrappers.items()}

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
    max_err = {kname: 0.0 for kname in KERNELS}
    cases = {kname: 0 for kname in KERNELS}
    rng = np.random.default_rng(0)

    def unit(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        return torch.from_numpy(x).to(dev)

    def record(kname: str, err: float) -> None:
        max_err[kname] = max(max_err[kname], err)
        cases[kname] += 1

    def check_single(corpus, q, mask, k, metric, tol, what):
        got = st_mod.scan_topk(corpus, q, mask, k, metric)
        want = st_mod.scan_topk_plain(corpus, q, mask, k, metric)
        torch.cuda.synchronize()
        record("scan_topk", assert_topk_close(
            slab(*got, k), slab(*want, k), atol=tol, tie_tol=tol, what=what))

    def check_batch(corpus, qs, mask, qvalid, k, metric, tol, what):
        got = st_mod.scan_topk_batch(corpus, qs, mask, qvalid, k, metric)
        want = st_mod.scan_topk_batch_plain(corpus, qs, mask, qvalid, k,
                                            metric)
        torch.cuda.synchronize()
        record("scan_topk_batch", assert_topk_close(
            slab(*got, k), slab(*want, k), atol=tol, tie_tol=tol, what=what))

    def check_range_single(corpus, q, rk, mask, metric, tol, what):
        got = rs_mod.range_scan(corpus, q, rk, mask, metric)
        want = rs_mod.range_scan_plain(corpus, q, rk, mask, metric)
        torch.cuda.synchronize()
        record("range_scan", range_err(got, want, rk, tol, what))
        return got

    def check_range_batch(corpus, qs, rk, mask, qvalid, metric, tol, what):
        got = rs_mod.range_scan_batch(corpus, qs, rk, mask, qvalid, metric)
        want = rs_mod.range_scan_batch_plain(corpus, qs, rk, mask, qvalid,
                                             metric)
        torch.cuda.synchronize()
        record("range_scan_batch", range_err(got, want, rk, tol, what))
        return got

    def raw_of(rk, metric):
        return -rk if metric.is_similarity() else rk

    def radius_at(keys, rank: int):
        """Per query, the order key of its ``rank``-th best row."""
        return torch.sort(keys, dim=-1).values[..., rank].contiguous()

    for n, d in ((5003, 130), (4099, 64), (3001, 512)):
        tol = 1e-4 if d > 130 else 1e-5
        corpus = unit((n, d))
        dups = torch.cat([torch.tensor([7]),
                          torch.arange(n // 3, n // 3 + 40)]).to(dev)
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
            # range scans: radii at rank 100, hitting nothing, everything,
            # and exactly on the duplicates' key
            q = corpus[7].clone()
            keys = pairwise_order_keys(metric, corpus, q[None])[0]
            radii = {"rank100": radius_at(keys, 100),
                     "nothing": keys.min() - 1, "everything": keys.max() + 1,
                     "on_duplicates": keys[7]}
            for mname, mask in (("none", None),
                                ("shared", torch.rand(n, device=dev) < 0.5)):
                m8 = None if mask is None else mask.to(torch.int8)
                for rname, rk in radii.items():
                    hits = check_range_single(
                        corpus, q, rk.reshape(1).contiguous(), m8, metric,
                        tol, f"range single {metric.value} n={n} d={d} "
                        f"{mname} {rname}")[1]
                    live = dups if mask is None else dups[mask[dups]]
                    if len(set(hits[live].tolist())) > 1:
                        raise AssertionError("duplicate rows split by the "
                                             "radius")
            for qn in (1, 8, 37):
                qs = unit((qn, d))
                qs[0] = corpus[7]
                keys = pairwise_order_keys(metric, corpus, qs)
                rk = radius_at(keys, 100)
                rk[0] = keys[0, 7]                      # on the duplicates
                qv = (torch.arange(qn, device=dev) < max(1, qn - 3))
                for mname in ("none", "shared", "per_query"):
                    mask = {"none": None,
                            "shared": torch.rand(n, device=dev) < 0.5,
                            "per_query": torch.rand((qn, n), device=dev)
                            < 0.3}[mname]
                    m8 = None if mask is None else mask.to(torch.int8)
                    what = (f"range batch {metric.value} n={n} d={d} q={qn} "
                            f"{mname}")
                    hits = check_range_batch(corpus, qs, rk, m8,
                                             qv.to(torch.int8), metric, tol,
                                             what)[1]
                    live = dups if mask is None else dups[
                        (mask if mask.ndim == 1 else mask[0])[dups]]
                    if len(set(hits[0, live].tolist())) > 1:
                        raise AssertionError(f"{what}: duplicate rows split")
                    if qn < 37:
                        continue
                    # the compaction: capacity below and beyond the counts
                    pk, _ph, pc = rs_mod.range_scan_batch_plain(
                        corpus, qs, rk, m8, qv.to(torch.int8), metric)
                    live = qv[:, None] if mask is None else (
                        qv[:, None] & (mask if mask.ndim == 2
                                       else mask[None]))
                    near = (((keys - rk[:, None]).abs() <= tol) & live).sum(1)
                    for cap in (16, n):
                        got = ops.fused_range_topk_batch(
                            corpus, qs, raw_of(rk, metric), mask, metric,
                            cap, qvalid=qv)
                        want = compact_range(pk, cap, metric) + (pc,)
                        keys_out = ("ids", "sim", "valid", "count")
                        assert_range_close(
                            dict(zip(keys_out, got)),
                            dict(zip(keys_out, want)),
                            radius=raw_of(rk, metric), atol=tol,
                            tie_tol=tol, near=near,
                            what=f"{what} compaction cap={cap}")
    # k beyond the live rows, and the large-k lists (kp = 256 and 1,024)
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
    # the quantized kernels: int8 and bf16 twins, every metric and mask
    # kind, pad lanes, ragged N (N % 8 != 0) and D, duplicate rows,
    # c·k segments for k in {1, 10, 50, 512} and c in {1, 2}
    def mask8(kind: str, qn: int, n: int):
        mask = {"none": None, "shared": torch.rand(n, device=dev) < 0.5,
                "per_query": torch.rand((qn, n), device=dev) < 0.3}[kind]
        return None if mask is None else mask.to(torch.int8)

    def keys_err(got, want, tol: float, what: str) -> float:
        """Two masked key matrices: +inf in the same places, the finite
        keys within ``tol``.  Returns the largest difference."""
        if not torch.equal(torch.isinf(got), torch.isinf(want)):
            raise AssertionError(f"{what}: dead lanes differ")
        live = torch.isfinite(want)
        err = float((got[live] - want[live]).abs().max()) \
            if bool(live.any()) else 0.
        if not err <= tol:
            raise AssertionError(f"{what}: keys differ by {err} > {tol}")
        return err

    for n, d in ((5003, 130), (4099, 64), (3001, 512)):
        tol = 1e-4 if d > 130 else 1e-5
        corpus = unit((n, d))
        corpus[n // 3: n // 3 + 40] = corpus[7]          # exact duplicates
        for mode in MODES:
            qc = quantize_corpus(corpus, mode)
            for metric in Metric:
                for qn in (1, 37):
                    qs = unit((qn, d))
                    qs[0] = corpus[7]
                    qv8 = (torch.arange(qn, device=dev)
                           < max(1, qn - 3)).to(torch.int8)
                    for mname in ("none", "shared", "per_query"):
                        m8 = mask8(mname, qn, n)
                        what = (f"quant {mode} {metric.value} n={n} d={d} "
                                f"q={qn} {mname}")
                        args = (qc.qvecs, qc.scales, qs, m8, qv8)
                        got = qt_mod.quant_keys_batch(*args, metric)
                        want = qt_mod.quant_keys_batch_plain(*args, metric)
                        torch.cuda.synchronize()
                        record("quant_keys_batch",
                               keys_err(got, want, tol, what + " keys"))
                        for k in (1, 10, 50, 512):
                            for c in (1, 2):
                                s = qt_mod.quant_plan(n, qn, c * k)[3]
                                got = qt_mod.quant_scan_topk_batch(
                                    *args, c * k, metric)
                                want = qt_mod.quant_scan_topk_batch_plain(
                                    *args, c * k, metric)
                                torch.cuda.synchronize()
                                record("quant_scan_topk_batch",
                                       assert_topk_close(
                                           slab(*got, s), slab(*want, s),
                                           atol=tol, tie_tol=tol,
                                           what=f"{what} k={k} c={c}"))
    # the pairwise key matrix: every metric, ragged Q, N and D (one query,
    # one row, D = 1), fp32 and bf16 inputs (the op casts them to fp32;
    # the plain version gets the same rounded values)
    def check_pairwise(qs, corpus, metric, tol, what):
        got = pairwise_keys(qs, corpus, metric)
        want = dist_mod.pairwise_keys_plain(qs.float(), corpus.float(),
                                            metric)
        torch.cuda.synchronize()
        record("pairwise_keys", keys_err(got, want, tol, what))

    for metric in Metric:
        for n in (1, 513, 5003):
            for d in (1, 64, 130, 512):
                tol = 1e-4 if d > 130 else 1e-5
                corpus = unit((n, d))
                for qn in (1, 37, 130):
                    qs = unit((qn, d))
                    check_pairwise(qs, corpus, metric, tol,
                                   f"pairwise {metric.value} q={qn} n={n} "
                                   f"d={d}")
                check_pairwise(qs.bfloat16(), corpus.bfloat16(), metric, tol,
                               f"pairwise bf16 {metric.value} n={n} d={d}")
    emit({"phase": "sweep", "cases": cases, "max_abs_err": max_err})

    # -- replay: bit for bit the fp32 batched kernels' keys ------------------
    def bits(x):
        return x.contiguous().view(torch.int32)

    replay_pairs = 0
    for n, d in ((5003, 130), (4099, 64), (3001, 512)):
        corpus = unit((n, d))
        all_rows = torch.arange(n, dtype=torch.int32, device=dev)
        for metric in Metric:
            for qn in (3, 20, 37):                  # narrow, mid, wide
                qs = unit((qn, d))
                what = f"replay {metric.value} n={n} d={d} q={qn}"
                keys, ids = st_mod.scan_topk_batch(corpus, qs, None, None,
                                                   10, metric)
                rows = torch.where(ids >= 0, ids, qt_mod.I32_MAX)
                rep = qt_mod.replay_keys(corpus, qs, rows, metric)
                found = ids >= 0
                if not torch.equal(bits(rep[found]), bits(keys[found])):
                    raise AssertionError(f"{what}: not scan_topk_batch's keys")
                if not bool(torch.isinf(rep[~found]).all()):
                    raise AssertionError(f"{what}: an empty slot replayed")
                inf = torch.full((qn,), float("inf"), device=dev)
                rkeys, hits, _ = rs_mod.range_scan_batch(corpus, qs, inf,
                                                         None, None, metric)
                rows = all_rows.expand(qn, n).contiguous()
                rep = qt_mod.replay_keys(corpus, qs, rows, metric)
                hit = hits.bool()
                if not torch.equal(bits(rep[hit]), bits(rkeys[hit])):
                    raise AssertionError(f"{what}: not range_scan_batch's keys")
                want = qt_mod.replay_keys_plain(corpus, qs, rows, metric)
                torch.cuda.synchronize()
                record("replay_keys", keys_err(rep, want, 1e-4, what))
                replay_pairs += int(found.sum()) + int(hit.sum())
    emit({"phase": "replay", "bitwise_pairs": replay_pairs,
          "cases": cases["replay_keys"],
          "max_abs_err_vs_plain": max_err["replay_keys"]})

    # -- pairwise_bits: the pairwise kernel's keys bit for bit ----------------
    # against replay_keys over all rows (inner product and cosine: the same
    # fmaf chains, query norms and epilogue; L2 adds the norms in another
    # order), and row i of a Q-query call against the single-query call
    pair_cases = 0
    for n, d in ((5003, 130), (4099, 64), (3001, 512)):
        corpus = unit((n, d))
        all_rows = torch.arange(n, dtype=torch.int32, device=dev)
        for metric in Metric:
            for qn in (1, 8, 37, 100, 130):
                qs = unit((qn, d))
                what = f"pairwise bits {metric.value} n={n} d={d} q={qn}"
                got = pairwise_keys(qs, corpus, metric)
                if metric != Metric.L2:
                    rep = qt_mod.replay_keys(
                        corpus, qs, all_rows.expand(qn, n).contiguous(),
                        metric)
                    if not torch.equal(bits(got), bits(rep)):
                        raise AssertionError(f"{what}: not replay_keys' keys")
                for i in range(qn):
                    one = pairwise_keys(qs[i:i + 1], corpus, metric)
                    if not torch.equal(bits(one[0]), bits(got[i])):
                        raise AssertionError(
                            f"{what}: row {i} is not the single-query call")
                pair_cases += 1
    emit({"phase": "pairwise_bits", "cases": pair_cases,
          "checks": ["= replay_keys over all rows (ip, cosine)",
                     "row of batch = single query (every metric)"]})

    # -- topk_bits: the batched fp32 top-k's keys and ids bit for bit --------
    # against scan_topk_batch_replayed (replay_keys over all rows, masked,
    # each split's best k) at the pairwise_bits shapes, k in {1, 50, 200,
    # 1000} (between them every block shape and list length), with dead
    # valid lanes; at 1,000,003 x 64 (splits of many tiles); on a corpus
    # ordered so that each row beats the one before it for every query
    # (every insertion round overflows its lists); and row i of a Q-query
    # call gives the single-query call's stage-2 answer (K, one mask kind
    # per metric)
    mask_of = {Metric.INNER_PRODUCT: "per_query", Metric.L2: "shared",
               Metric.COSINE: "none"}
    topk_cases = topk_rows = 0

    def topk_bits(args, k, metric, what):
        nonlocal topk_cases
        got = st_mod.scan_topk_batch(*args, k, metric)
        want = st_mod.scan_topk_batch_replayed(*args, k, metric)
        if not (torch.equal(bits(got[0]), bits(want[0]))
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"{what}: not the replayed top-k")
        topk_cases += 1
        return got

    def stage2(out, k, metric):
        ids, sims, _ = ops._merge(*out, k, metric)
        return bits(sims), ids

    for n, d in ((5003, 130), (4099, 64), (3001, 512)):
        corpus = unit((n, d))
        corpus[n // 3: n // 3 + 40] = corpus[7]          # exact duplicates
        for metric in Metric:
            for qn in (1, 8, 20, 37, 100, 130):
                qs = unit((qn, d))
                qs[0] = corpus[7]
                qv8 = (torch.arange(qn, device=dev)
                       < max(1, qn - 3)).to(torch.int8)
                for mname in ("none", "shared", "per_query"):
                    m8 = mask8(mname, qn, n)
                    args = (corpus, qs, m8, qv8)
                    for k in (1, K, 200, 1000):
                        topk_bits(args, k, metric,
                                  f"topk bits {metric.value} n={n} d={d} "
                                  f"q={qn} {mname} k={k}")
                    if mname != mask_of[metric]:
                        continue
                    top = stage2(st_mod.scan_topk_batch(*args, K, metric), K,
                                 metric)
                    for i in range(qn):
                        one = stage2(st_mod.scan_topk_batch(
                            corpus, qs[i:i + 1].contiguous(),
                            None if m8 is None else m8 if m8.ndim == 1
                            else m8[i:i + 1].contiguous(),
                            qv8[i:i + 1].contiguous(), K, metric), K, metric)
                        if not (torch.equal(one[0][0], top[0][i])
                                and torch.equal(one[1][0], top[1][i])):
                            raise AssertionError(
                                f"topk bits {metric.value} n={n} d={d} "
                                f"q={qn}: row {i} is not the single-query "
                                "call")
                        topk_rows += 1
    n, d = 1_000_003, 64
    corpus = unit((n, d))
    for metric in Metric:
        for qn in (8, 40):
            qs = unit((qn, d))
            qv8 = (torch.arange(qn, device=dev)
                   < max(1, qn - 3)).to(torch.int8)
            args = (corpus, qs, mask8(mask_of[metric], qn, n), qv8)
            for k in (K, 200, 1000):
                topk_bits(args, k, metric,
                          f"topk bits {metric.value} n={n} d={d} q={qn} "
                          f"{mask_of[metric]} k={k}")
    # t·q + 2(1 − t)·u with u ⊥ q and t rising from 0.5 to 1: each row has
    # a larger inner product and cosine with q, and a smaller L2 distance
    n = 100_003
    q = unit((d,))
    u = unit((d,))
    u = u - (u @ q) * q
    u = u / u.norm()
    t = torch.linspace(0.5, 1.0, n, device=dev)[:, None]
    ordered = (t * q + 2.0 * (1.0 - t) * u).contiguous()
    for metric in Metric:
        for qn in (8, 40):
            for k in (K, 1000):
                topk_bits((ordered, q.expand(qn, d).contiguous(), None, None),
                          k, metric, f"topk bits ordered {metric.value} "
                          f"n={n} q={qn} k={k}")
    del corpus, ordered
    emit({"phase": "topk_bits", "cases": topk_cases,
          "single_query_rows": topk_rows,
          "checks": ["= scan_topk_batch_replayed, keys (int32 view) and "
                     "ids, every metric and mask kind",
                     "row of batch = single query (stage 2)",
                     "rows each beating the last (every round overflows)"]})

    # -- quant_bits: the quantized top-k kernel's segments bit for bit -------
    # against its definition on the fp32 kernels' arithmetic (replay_keys
    # over the dequantized rows, masked, each segment's minimum, each
    # split's best), with count = ceil(N / 8) (every segment emitted),
    # Q1's c·K = 100 and 150 (between them the kernel's three block
    # shapes); and row i of a Q-query call gives the single-query call's
    # candidate rows (one mask kind per metric)
    qbit_cases = qbit_rows = 0
    for n, d in ((5003, 130), (4099, 64), (3001, 512)):
        corpus = unit((n, d))
        corpus[n // 3: n // 3 + 40] = corpus[7]          # exact duplicates
        for mode in MODES:
            qc = quantize_corpus(corpus, mode)
            for metric in Metric:
                for qn in (1, 8, 37, 100, 130):
                    qs = unit((qn, d))
                    qs[0] = corpus[7]
                    qv8 = (torch.arange(qn, device=dev)
                           < max(1, qn - 3)).to(torch.int8)
                    for mname in ("none", "shared", "per_query"):
                        m8 = mask8(mname, qn, n)
                        args = (qc.qvecs, qc.scales, qs, m8, qv8)
                        for count in (-(-n // qt_mod.SEG), 2 * K, 3 * K):
                            what = (f"quant bits {mode} {metric.value} n={n} "
                                    f"d={d} q={qn} {mname} count={count}")
                            got = qt_mod.quant_scan_topk_batch(*args, count,
                                                               metric)
                            want = qt_mod.quant_scan_topk_batch_replayed(
                                *args, count, metric)
                            if not (torch.equal(bits(got[0]), bits(want[0]))
                                    and torch.equal(got[1], want[1])):
                                raise AssertionError(
                                    f"{what}: not the replayed segments")
                            qbit_cases += 1
                        if mname != mask_of[metric]:
                            continue
                        rows = qt_mod.candidate_rows(*got, 2 * K)
                        for i in range(qn):
                            one = qt_mod.quant_scan_topk_batch(
                                qc.qvecs, qc.scales, qs[i:i + 1].contiguous(),
                                None if m8 is None else m8 if m8.ndim == 1
                                else m8[i:i + 1].contiguous(),
                                qv8[i:i + 1].contiguous(), 2 * K, metric)
                            if not torch.equal(
                                    qt_mod.candidate_rows(*one, 2 * K)[0],
                                    rows[i]):
                                raise AssertionError(
                                    f"{what}: row {i} is not the "
                                    "single-query call")
                            qbit_rows += 1
    # lists longer than one tile's segments need splits of thousands of
    # rows: 1M ragged rows at D = 64, counts whose lists hold 256 and 1,024
    # entries (the mid and narrow shapes)
    n, d = 1_000_003, 64
    corpus = unit((n, d))
    for mode in MODES:
        qc = quantize_corpus(corpus, mode)
        for metric in Metric:
            for qn in (8, 40):
                qs = unit((qn, d))
                qv8 = (torch.arange(qn, device=dev)
                       < max(1, qn - 3)).to(torch.int8)
                m8 = mask8(mask_of[metric], qn, n)
                args = (qc.qvecs, qc.scales, qs, m8, qv8)
                for count in (3 * K, 600, 1024):
                    what = (f"quant bits {mode} {metric.value} n={n} d={d} "
                            f"q={qn} {mask_of[metric]} count={count}")
                    got = qt_mod.quant_scan_topk_batch(*args, count, metric)
                    want = qt_mod.quant_scan_topk_batch_replayed(
                        *args, count, metric)
                    if not (torch.equal(bits(got[0]), bits(want[0]))
                            and torch.equal(got[1], want[1])):
                        raise AssertionError(
                            f"{what}: not the replayed segments")
                    qbit_cases += 1
    del corpus, qc, got, want
    emit({"phase": "quant_bits", "cases": qbit_cases,
          "single_query_rows": qbit_rows,
          "checks": ["= quant_scan_topk_batch_replayed, keys (int32 view) "
                     "and ids, every metric, mode and mask kind",
                     "row of batch = single query (candidate_rows)"]})

    # -- range_bits: the batched range scan's keys and hits bit for bit ------
    # against range_scan_batch_replayed (replay_keys over all rows, then the
    # mask, the valid lane and the radius) at the pairwise_bits shapes, Q
    # in {1, 8, 16, 17, 37, 100, 128, 130} (every block shape and a second
    # query tile), every metric and mask kind with the last three lanes
    # dead, radii at each query's 100th-best key (the first query's on the
    # duplicates), below every key and above every key; at 1,000,003 x 64
    # with Q in {8, 100} (splits of many tiles, a ragged N); and row i of a
    # Q-query call equals the single-query call (one mask kind per metric)
    range_cases = range_rows = 0

    def range_bits(args, metric, what):
        nonlocal range_cases
        got = rs_mod.range_scan_batch(*args, metric)
        want = rs_mod.range_scan_batch_replayed(*args, metric)
        if not (torch.equal(bits(got[0]), bits(want[0]))
                and torch.equal(got[1], want[1])
                and torch.equal(got[2], want[2])):
            raise AssertionError(f"{what}: not the replayed range scan")
        range_cases += 1
        return got

    for n, d in ((5003, 130), (4099, 64), (3001, 512)):
        corpus = unit((n, d))
        corpus[n // 3: n // 3 + 40] = corpus[7]          # exact duplicates
        for metric in Metric:
            for qn in (1, 8, 16, 17, 37, 100, 128, 130):
                qs = unit((qn, d))
                qs[0] = corpus[7]
                keys = pairwise_order_keys(metric, corpus, qs)
                rk = radius_at(keys, 100)
                rk[0] = keys[0, 7]                      # on the duplicates
                radii = {"rank100": rk,
                         "nothing": keys.min(dim=1).values - 1,
                         "everything": keys.max(dim=1).values + 1}
                qv8 = (torch.arange(qn, device=dev)
                       < max(1, qn - 3)).to(torch.int8)
                for mname in ("none", "shared", "per_query"):
                    m8 = mask8(mname, qn, n)
                    for rname, r in radii.items():
                        what = (f"range bits {metric.value} n={n} d={d} "
                                f"q={qn} {mname} {rname}")
                        got = range_bits((corpus, qs, r.contiguous(), m8,
                                          qv8), metric, what)
                        if rname != "rank100" or mname != mask_of[metric]:
                            continue
                        for i in range(qn):
                            one = rs_mod.range_scan_batch(
                                corpus, qs[i:i + 1].contiguous(),
                                r[i:i + 1].contiguous(),
                                None if m8 is None else m8 if m8.ndim == 1
                                else m8[i:i + 1].contiguous(),
                                qv8[i:i + 1].contiguous(), metric)
                            if not (torch.equal(bits(one[0][0]),
                                                bits(got[0][i]))
                                    and torch.equal(one[1][0], got[1][i])
                                    and int(one[2][0]) == int(got[2][i])):
                                raise AssertionError(
                                    f"{what}: row {i} is not the "
                                    "single-query call")
                            range_rows += 1
    n, d = 1_000_003, 64
    corpus = unit((n, d))
    for metric in Metric:
        for qn in (8, 100):
            qs = unit((qn, d))
            keys = pairwise_order_keys(metric, corpus, qs)
            rk = torch.topk(keys, RANGE_TARGET, dim=1,
                            largest=False).values[:, -1].contiguous()
            del keys
            qv8 = (torch.arange(qn, device=dev)
                   < max(1, qn - 3)).to(torch.int8)
            range_bits((corpus, qs, rk, mask8(mask_of[metric], qn, n), qv8),
                       metric, f"range bits {metric.value} n={n} d={d} "
                       f"q={qn} {mask_of[metric]}")
    del corpus
    emit({"phase": "range_bits", "cases": range_cases,
          "single_query_rows": range_rows,
          "checks": ["= range_scan_batch_replayed, keys (int32 view), hits "
                     "and counts, every metric, mask kind and radius kind",
                     "row of batch = single query"]})
    emit({"phase": "range_append_bits", **range_append_bits(dev)})

    # -- keys_bits: the quantized key kernel's keys bit for bit -------------
    # against quant_keys_batch_replayed (replay_keys over the dequantized
    # twin, then the mask and the valid lane) and range_scan_batch's keys on
    # the dequantized twin with every radius at +inf, in int8 and bf16, at
    # the pairwise_bits shapes, Q in {1, 8, 16, 17, 37, 64, 100, 128, 130}
    # (every block shape, the wide shape's skipped query groups, a second
    # query tile), every metric and mask kind with the last three lanes
    # dead; at 1,000,003 x 64 with Q in {8, 100}; and row i of a Q-query
    # call equals the single-query call (one mask kind per metric)
    keys_cases = keys_rows = 0

    def keys_bits(qc, args, metric, what):
        nonlocal keys_cases
        got = qt_mod.quant_keys_batch(qc.qvecs, qc.scales, *args, metric)
        want = qt_mod.quant_keys_batch_replayed(qc.qvecs, qc.scales, *args,
                                                metric)
        deq = qc.qvecs.to(torch.float32) * qc.scales
        inf = torch.full((args[0].shape[0],), float("inf"), device=dev)
        ranged = rs_mod.range_scan_batch(deq, args[0], inf, *args[1:],
                                         metric)[0]
        if not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"{what}: not the replayed keys")
        if not torch.equal(bits(got), bits(ranged)):
            raise AssertionError(f"{what}: not range_scan_batch's keys on "
                                 "the dequantized twin")
        keys_cases += 1
        return got

    for n, d in ((5003, 130), (4099, 64), (3001, 512)):
        corpus = unit((n, d))
        corpus[n // 3: n // 3 + 40] = corpus[7]          # exact duplicates
        for mode in MODES:
            qc = quantize_corpus(corpus, mode)
            for metric in Metric:
                for qn in (1, 8, 16, 17, 37, 64, 100, 128, 130):
                    qs = unit((qn, d))
                    qs[0] = corpus[7]
                    qv8 = (torch.arange(qn, device=dev)
                           < max(1, qn - 3)).to(torch.int8)
                    for mname in ("none", "shared", "per_query"):
                        m8 = mask8(mname, qn, n)
                        what = (f"keys bits {mode} {metric.value} n={n} "
                                f"d={d} q={qn} {mname}")
                        got = keys_bits(qc, (qs, m8, qv8), metric, what)
                        if mname != mask_of[metric]:
                            continue
                        for i in range(qn):
                            one = qt_mod.quant_keys_batch(
                                qc.qvecs, qc.scales, qs[i:i + 1].contiguous(),
                                None if m8 is None else m8 if m8.ndim == 1
                                else m8[i:i + 1].contiguous(),
                                qv8[i:i + 1].contiguous(), metric)
                            if not torch.equal(bits(one[0]), bits(got[i])):
                                raise AssertionError(
                                    f"{what}: row {i} is not the "
                                    "single-query call")
                            keys_rows += 1
    n, d = 1_000_003, 64
    corpus = unit((n, d))
    for mode in MODES:
        qc = quantize_corpus(corpus, mode)
        for metric in Metric:
            for qn in (8, 100):
                qv8 = (torch.arange(qn, device=dev)
                       < max(1, qn - 3)).to(torch.int8)
                keys_bits(qc, (unit((qn, d)), mask8(mask_of[metric], qn, n),
                               qv8), metric,
                          f"keys bits {mode} {metric.value} n={n} d={d} "
                          f"q={qn} {mask_of[metric]}")
        del qc
    del corpus
    emit({"phase": "keys_bits", "cases": keys_cases,
          "single_query_rows": keys_rows,
          "checks": ["= quant_keys_batch_replayed, keys (int32 view), "
                     "every mode, metric and mask kind",
                     "= range_scan_batch keys on the dequantized twin at "
                     "+inf radii", "row of batch = single query"]})

    # -- the catalog at full width -------------------------------------------
    t0 = time.perf_counter()
    cat = make_laion_catalog(n_rows=N_ROWS, n_queries=N_QUERIES, dim=DIM,
                             n_modes=N_MODES, seed=0, device="cuda")
    torch.cuda.synchronize()
    table = cat.table("products")
    qtable = cat.table("queries")
    corpus = table["embedding"]
    price = table["price"]
    p = np.float32(selectivity_threshold(price, SELECTIVITY))
    qv = qtable["embedding"].cpu().numpy()
    # the paper's radius: median over the queries of the 120th-best sim
    sims = qtable["embedding"] @ corpus.T                  # (100, N)
    kth = torch.topk(sims, RANGE_TARGET, dim=1).values[:, -1]
    r = np.float32(np.median(kth.cpu().numpy()))
    setup_s = time.perf_counter() - t0

    # the aot phase's child A starts now: its cold nvcc runs beside the
    # full and slice phases, which time nothing
    aot_children = AotChildren(cat, qv, p)

    def near(radius, tol: float = 1e-4) -> torch.Tensor:
        """Per query, the rows whose sim lies within ``tol`` of
        ``radius``."""
        return ((sims - float(radius)).abs() <= tol).sum(1).cpu()

    # -- full: each kernel at the paths' shapes ------------------------------
    metric = Metric.INNER_PRODUCT
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
    check_single(corpus, single_q, single_mask, K, metric, 1e-4,
                 "single full shape")
    check_batch(corpus, batch_q, batch_mask, batch_qvalid, K, metric, 1e-4,
                "batch full shape")
    # Q2 at bucket 128 (100 live) and Q3 at its 100 left rows
    rk = order_key(metric, torch.tensor(r, device=dev))
    q2_rk = rk.expand(bucket).contiguous()
    left = qtable["embedding"]
    date_mask = (table["capture_date"][None, :]
                 > qtable["capture_date"][:, None]).view(torch.int8)
    q3_rk = rk.expand(N_QUERIES).contiguous()
    check_range_batch(corpus, batch_q, q2_rk, batch_mask, batch_qvalid,
                      metric, 1e-4, "range batch full shape (Q2)")
    check_range_batch(corpus, left, q3_rk, date_mask, None, metric, 1e-4,
                      "range batch full shape (Q3)")
    check_range_single(corpus, left[0], rk.reshape(1), date_mask[0], metric,
                       1e-4, "range single full shape (Q3 perleft row)")
    # the quantized kernels at the paths' shapes (Q1's c·K segments, Q2's
    # keys); the twins are registered under every table name the paths
    # scan, so the session reuses them
    twins = {}
    for mode in MODES:
        qc = quantize_corpus(corpus, mode)
        for tname in ("products", "images", "movies", "recipes"):
            cat.register_quantized(tname, "embedding", qc)
        twins[mode] = qc
        args = (qc.qvecs, qc.scales, batch_q, batch_mask, batch_qvalid)
        s = qt_mod.quant_plan(N_ROWS, bucket, 2 * K)[3]
        got = qt_mod.quant_scan_topk_batch(*args, 2 * K, metric)
        want = qt_mod.quant_scan_topk_batch_plain(*args, 2 * K, metric)
        torch.cuda.synchronize()
        record("quant_scan_topk_batch", assert_topk_close(
            slab(*got, s), slab(*want, s), atol=1e-4, tie_tol=1e-4,
            what=f"quant {mode} full shape"))
        rows = qt_mod.candidate_rows(*got, 2 * K)
        rep = qt_mod.replay_keys(corpus, batch_q, rows, metric)
        want = qt_mod.replay_keys_plain(corpus, batch_q, rows, metric)
        torch.cuda.synchronize()
        record("replay_keys", keys_err(rep, want, 1e-4,
                                       f"replay {mode} full shape"))
        got = qt_mod.quant_keys_batch(*args, metric)
        want = qt_mod.quant_keys_batch_plain(*args, metric)
        torch.cuda.synchronize()
        record("quant_keys_batch", keys_err(got, want, 1e-4,
                                            f"quant keys {mode} full shape"))
        del got, want, rep
    # the pairwise key matrix at 100 x 1M x 512: a 400 MB output
    for m in Metric:
        check_pairwise(left, corpus, m, 1e-4, f"pairwise {m.value} full shape")
    twin_mb = {mode: {"qvecs": qc.qvecs.numel() * qc.qvecs.element_size()
                      / 1e6, "per_row": 4 * 4 * N_ROWS / 1e6}
               for mode, qc in twins.items()}
    emit({"phase": "full", "n": N_ROWS, "d": DIM, "k": K, "radius": float(r),
          "twin_mb": twin_mb,
          "quant_plan": list(qt_mod.quant_plan(N_ROWS, bucket, 2 * K)),
          "catalog_setup_s": setup_s,
          "single_blocks": st_mod.single_plan(N_ROWS)[0],
          "batch_plan": list(st_mod.batch_plan(N_ROWS, bucket, K)),
          "range_batch_plan": list(rs_mod.batch_plan(N_ROWS, bucket)),
          "max_abs_err": max_err})

    # -- slice: Q1, Q2, Q3 through the session API ---------------------------
    exact = ExecutionHints(exact_shape=True)
    perleft = ExecutionHints(join_lowering="perleft")
    plain_db = connect(cat, engine="brute", use_pallas=False)
    price_np = price.cpu().numpy()
    launches = {}

    def drive(path: str, runs: list) -> list:
        """Run one path's executions with every counter at 0 before and
        read after; ``runs`` holds (label, statement, binds, hints)."""
        reset_counts()
        results = [(label, s, b, h, s.execute(b, hints=h))
                   for label, s, b, h in runs]
        torch.cuda.synchronize()
        launches[path] = counts()
        return results

    # Q1
    nofilter = db.prepare(Q1_NOFILTER, K=K)
    binds = [{"qv": qv[i], "p": p} for i in range(N_QUERIES)]
    stacked = {"qv": qv, "p": np.full(N_QUERIES, p, np.float32)}
    runs = [("single", stmt, binds[i], None) for i in range(3)]
    runs += [(f"list{qn}", stmt, binds[:qn], None) for qn in BATCHES]
    runs += [("stacked", stmt, stacked, None),
             ("exact_shape", stmt, stacked, exact),
             ("fast_path", nofilter, {"qv": qv[:1]}, exact)]
    results = drive("q1", runs)
    checked = {path: {} for path in ("q1", "q2", "q3", "q4", "q5", "q6")}
    for label, s, b, h, res in results:
        want = plain_db.prepare(s.sql, K=K).execute(b, hints=h)
        torch.cuda.synchronize()
        err = assert_topk_close(res.data, want.data, atol=1e-4, tie_tol=1e-4,
                                what=f"slice q1 {label}")
        ids = res["ids"].cpu().numpy().reshape(-1, K)
        valid = res["valid"].cpu().numpy().reshape(-1, K)
        sims_k = res["sim"].cpu().numpy().reshape(-1, K)
        if not np.isfinite(sims_k).all() or not valid.all():
            raise AssertionError(f"slice {label}: non-finite or short result")
        if s is stmt and not (price_np[ids[valid]] < p).all():
            raise AssertionError(f"slice {label}: a row fails price < p")
        if (np.diff(sims_k, axis=1) > 0).any():
            raise AssertionError(f"slice {label}: sims not descending")
        checked["q1"][label] = {"shape": list(res["ids"].shape),
                                "max_abs_err": err,
                                "path": res.explain().path,
                                "bucket": res.explain().bucket}

    def check_range_answers(path: str, results, radius_of, near_of,
                            extra) -> None:
        """Hold every answer against use_pallas=False on the card, and
        check the radius, the ordering and ``extra`` on every hit."""
        for label, s, b, h, res in results:
            want = plain_db.prepare(s.sql, hints=s.hints).execute(b, hints=h)
            torch.cuda.synchronize()
            err = assert_range_close(res.data, want.data,
                                     radius=radius_of(label), atol=1e-4,
                                     tie_tol=1e-4, near=near_of(label),
                                     what=f"slice {path} {label}")
            ids = res.ids.cpu().numpy()
            valid = res["valid"].cpu().numpy()
            sims_r = res["sim"].cpu().numpy()
            if (sims_r[valid] < np.min(radius_of(label)) - 1e-4).any():
                raise AssertionError(f"slice {path} {label}: a hit below r")
            if ((np.diff(sims_r, axis=-1) > 0) & valid[..., 1:]).any():
                raise AssertionError(f"slice {path} {label}: not best-first")
            extra(label, ids, valid)
            counts_np = res["count"].cpu().numpy()
            rep = res.explain()
            checked[path][label] = {
                "shape": list(res.ids.shape), "max_abs_err": err,
                "path": rep.path, "bucket": rep.bucket,
                "lowering": rep.batch_lowering,
                "hits_median": float(np.median(counts_np)),
                "hits_max": int(counts_np.max()),
                "truncated_rows": int((counts_np > ids.shape[-1]).sum())}

    # Q2
    q2 = db.prepare(Q2)
    q2_binds = [{"qv": qv[i], "r": r, "p": p} for i in range(N_QUERIES)]
    q2_stacked = {"qv": qv, "r": np.full(N_QUERIES, r, np.float32),
                  "p": np.full(N_QUERIES, p, np.float32)}
    runs = [(f"single{i}", q2, q2_binds[i], None) for i in range(3)]
    runs += [(f"list{qn}", q2, q2_binds[:qn], None) for qn in BATCHES]
    runs += [("stacked", q2, q2_stacked, None),
             ("exact_shape", q2, q2_stacked, exact)]
    near_q = near(r)

    def q2_rows(label: str):
        if label.startswith("single"):
            return int(label[6:])
        return slice(int(label[4:])) if label.startswith("list") else \
            slice(None)

    def price_ok(label, ids, valid):
        if not (price_np[ids[valid]] < p).all():
            raise AssertionError(f"slice q2 {label}: a row fails price < p")

    check_range_answers("q2", drive("q2", runs), lambda label: r,
                        lambda label: near_q[q2_rows(label)], price_ok)
    for i in range(3):
        checked["q2"][f"single{i}"]["kernel"] = "none (reference lowering)"

    # Q3
    q3 = db.prepare(Q3)
    q3_perleft = db.prepare(Q3, hints=perleft)
    if q3.compiled.options.max_pairs != MAX_PAIRS:
        raise AssertionError("Q3 runs with the EngineOptions max_pairs")
    radii = np.array([r - 0.01, r, r + 0.01, r + 0.02], np.float32)
    runs = [("batch", q3, {"r": r}, None),
            ("perleft", q3_perleft, {"r": r}, None),
            ("list4", q3, [{"r": x} for x in radii], None)]
    near_list = torch.stack([near(x) for x in radii])
    qdate = qtable["capture_date"].cpu().numpy()
    cdate = table["capture_date"].cpu().numpy()

    def date_ok(label, ids, valid):
        ids, valid = ids.reshape(-1, N_QUERIES, MAX_PAIRS), valid.reshape(
            -1, N_QUERIES, MAX_PAIRS)
        for i in range(N_QUERIES):
            if not (cdate[ids[:, i][valid[:, i]]] > qdate[i]).all():
                raise AssertionError(f"slice q3 {label}: a pair fails the "
                                     f"date predicate")

    check_range_answers(
        "q3", drive("q3", runs),
        lambda label: radii[:, None] if label == "list4" else r,
        lambda label: near_list if label == "list4" else near_q, date_ok)

    # the pairwise key matrix through its public entry point
    reset_counts()
    keys_pk = pairwise_keys(left, corpus, metric)
    torch.cuda.synchronize()
    launches["pairwise"] = counts()
    checked["pairwise"] = {"shape": list(keys_pk.shape), "max_abs_err": keys_err(
        keys_pk, dist_mod.pairwise_keys_plain(left, corpus, metric), 1e-4,
        "slice pairwise")}
    del keys_pk

    def as_topk(data: dict) -> dict:
        return {"ids": data["tid"], "sim": data["sim"],
                "valid": data["valid"], "stats": data["stats"]}

    # Q4: batch, perleft, brute_sort, and a list of two bind sets
    users, movies = cat.table("users"), cat.table("movies")
    qrating = users["preferred_rating"].cpu().numpy()
    rating = movies["rating"].cpu().numpy()
    year = movies["release_year"].cpu().numpy()
    sort_db = connect(cat, engine="brute_sort", use_pallas=True)
    plain_sort_db = connect(cat, engine="brute_sort", use_pallas=False)
    q4, q4y = db.prepare(Q4), db.prepare(Q4Y)
    q4_list = [{"y": np.int32(y)} for y in (1980, 2000)]
    runs = [("batch", q4, {}, None),
            ("perleft", db.prepare(Q4, hints=perleft), {}, None),
            ("brute_sort", sort_db.prepare(Q4), {}, None),
            ("list2", q4y, q4_list, None)]
    for label, s, b, h, res in drive("q4", runs):
        pdb = plain_sort_db if label == "brute_sort" else plain_db
        want = pdb.prepare(s.sql, hints=s.hints).execute(b, hints=h)
        torch.cuda.synchronize()
        for key in ("qid", "rank"):
            if not torch.equal(res[key], want[key]):
                raise AssertionError(f"slice q4 {label}: {key} differs")
        err = assert_topk_close(as_topk(res.data), as_topk(want.data),
                                atol=1e-4, tie_tol=1e-4,
                                what=f"slice q4 {label}")
        tid = res["tid"].cpu().numpy().reshape(-1, N_QUERIES, K)
        sims_k = res["sim"].cpu().numpy().reshape(-1, N_QUERIES, K)
        # every user has about 200,000 movies of its rating: lists are full
        if not res["valid"].all() or not np.isfinite(sims_k).all():
            raise AssertionError(f"slice q4 {label}: short or non-finite")
        for j, bset in enumerate(b if isinstance(b, list) else [b]):
            ok = ((rating[tid[j]] == qrating[:, None])
                  & (year[tid[j]] >= bset.get("y", 0)))
            if not ok.all():
                raise AssertionError(f"slice q4 {label}: a pair fails the "
                                     f"join predicate")
        if (np.diff(sims_k, axis=-1) > 0).any():
            raise AssertionError(f"slice q4 {label}: sims not descending")
        checked["q4"][label] = {"shape": list(res["tid"].shape),
                                "max_abs_err": err, "path": res.explain().path,
                                "lowering": res.explain().batch_lowering}

    # Q5 and Q6: each (query, category) list held as a range buffer
    recipes = cat.table("recipes")
    level = recipes["calorie_level"].cpu().numpy()
    cuisine = recipes["cuisine"].cpu().numpy()
    qcuisine = qtable["cuisine"].cpu().numpy()

    def category_close(got: dict, want: dict, radius, what: str) -> float:
        """Hold one Q5/Q6 answer against another: category (and qid)
        equal, and every (query, category) list under assert_range_close
        with its count the hits it holds — a row at the radius may be in
        one side's list only, near-ties may swap."""
        for key in ("category", "qid"):
            if key in want and not torch.equal(got[key], want[key]):
                raise AssertionError(f"{what}: {key} differs")
        key = "ids" if "ids" in want else "tid"

        def view(d):
            return {key: d[key], "sim": d["sim"], "valid": d["valid"],
                    "count": d["valid"].sum(-1), "stats": d["stats"]}

        return assert_range_close(view(got), view(want), radius=radius,
                                  atol=1e-4, tie_tol=1e-4, what=what)

    def check_category_answers(path: str, results, radius_of, extra):
        """Hold every answer against use_pallas=False on the card; check
        the radius, the order within each list, each list's level, and
        ``extra`` on every hit."""
        for label, s, b, h, res in results:
            want = plain_db.prepare(s.sql, hints=s.hints).execute(b, hints=h)
            torch.cuda.synchronize()
            err = category_close(res.data, want.data, radius_of(label),
                                 f"slice {path} {label}")
            ids = res.ids.cpu().numpy()
            valid = res["valid"].cpu().numpy()
            sims_c = res["sim"].cpu().numpy()
            if (sims_c[valid] < np.min(radius_of(label)) - 1e-4).any():
                raise AssertionError(f"slice {path} {label}: a hit below r")
            if ((np.diff(sims_c, axis=-1) > 0) & valid[..., 1:]).any():
                raise AssertionError(f"slice {path} {label}: not best-first")
            lv = res["category"].cpu().numpy()
            if (level[ids[valid]] != lv[valid]).any():
                raise AssertionError(f"slice {path} {label}: a row in "
                                     f"another level's list")
            extra(label, ids, valid)
            held = valid.sum(-1)
            checked[path.split("_")[0]][label] = {
                "shape": list(ids.shape), "max_abs_err": err,
                "path": res.explain().path, "bucket": res.explain().bucket,
                "lowering": res.explain().batch_lowering,
                "held_median": float(np.median(held)),
                "full_lists": float((held == K_CATEGORY).mean())}

    def cuisine_ok(label, ids, valid):
        if not (cuisine[ids[valid]] != EX).all():
            raise AssertionError(f"slice q5 {label}: a row of cuisine {EX}")

    q5 = db.prepare(Q5)
    q5_binds = [{"qv": qv[i], "r": r, "ex": np.int32(EX)}
                for i in range(N_QUERIES)]
    q5_stacked = {"qv": qv, "r": np.full(N_QUERIES, r, np.float32),
                  "ex": np.full(N_QUERIES, EX, np.int32)}
    runs = [(f"list{qn}", q5, q5_binds[:qn], None) for qn in BATCHES]
    runs += [("stacked", q5, q5_stacked, None),
             ("exact_shape", q5, q5_stacked, exact)]
    check_category_answers("q5", drive("q5", runs), lambda label: r,
                           cuisine_ok)
    runs = [(f"single{i}", q5, q5_binds[i], None) for i in range(3)]
    check_category_answers("q5_single", drive("q5_single", runs),
                           lambda label: r, cuisine_ok)

    def join_cuisine_ok(label, ids, valid):
        ids = ids.reshape(-1, N_QUERIES, ids.shape[-2] * ids.shape[-1])
        valid = valid.reshape(ids.shape)
        for i in range(N_QUERIES):
            if not (cuisine[ids[:, i][valid[:, i]]] != qcuisine[i]).all():
                raise AssertionError(f"slice q6 {label}: a pair of one "
                                     f"cuisine")

    q6 = db.prepare(Q6)
    runs = [("batch", q6, {"r": r}, None),
            ("list4", q6, [{"r": x} for x in radii], None)]
    check_category_answers(
        "q6", drive("q6", runs),
        lambda label: radii[:, None, None] if label == "list4" else r,
        join_cuisine_ok)
    check_category_answers(
        "q6_perleft", drive("q6_perleft", [
            ("perleft", db.prepare(Q6, hints=perleft), {"r": r}, None)]),
        lambda label: r, join_cuisine_ok)
    need = {"q1": ("scan_topk", "scan_topk_batch"),
            "q2": ("range_topk_batch",),
            "q3": ("range_scan", "range_topk_batch"),
            "pairwise": ("pairwise_keys",),
            "q4": ("scan_topk_batch", "scan_topk", "pairwise_keys"),
            "q5": ("range_topk_batch",),
            "q6": ("range_topk_batch",)}
    for path, kernels in need.items():
        for kname in kernels:
            if launches[path][kname] < 1:
                raise AssertionError(f"path {path} never launched {kname}")
    # the reference lowers these without a kernel, and so does the port
    for path in ("q5_single", "q6_perleft"):
        if any(launches[path].values()):
            raise AssertionError(f"path {path} launched {launches[path]}")
    emit({"phase": "slice", "radius": float(r), "launches": launches,
          "runs": checked,
          "trace_counts": {str(b): c for b, c in
                           stmt.explain().trace_counts.items()},
          "cache": list(map(int, (db.cache_info().hits,
                                  db.cache_info().misses)))})

    # -- slice_quant: the same paths under int8 and bf16 ----------------------
    def first(tree):
        return {key: first(v) if isinstance(v, dict) else v[0]
                for key, v in tree.items()}

    fp32_top = ops.fused_scan_topk_batch(
        corpus, batch_q, K, batch_mask.view(torch.bool), metric,
        qvalid=batch_qvalid.bool())[0][:N_QUERIES]

    def missing(qc, c: int, qs, mask, valid, top) -> int:
        """Queries whose fp32 top-K ``top`` holds a row outside the rows of
        the quantized top-(c·K) segments."""
        got = qt_mod.quant_scan_topk_batch(qc.qvecs, qc.scales, qs, mask,
                                           valid, c * K, metric)
        rows = qt_mod.candidate_rows(*got, c * K)[:top.shape[0]]
        inside = ((top[:, :, None] == rows[:, None, :]).any(-1) | (top < 0))
        return int((~inside.all(1)).sum())

    def coverage_factor(qc, cov: tuple, what: str) -> tuple[dict, int]:
        """The smallest rescore factor whose candidates hold every fp32
        top-K row, with the misses of each factor tried."""
        miss = {}
        for c in RESCORE:
            miss[c] = missing(qc, c, *cov)
            if miss[c] == 0:
                return miss, c
        raise AssertionError(f"{what}: no rescore factor in {RESCORE} "
                             f"covers the fp32 top-K")

    # Q1 at bucket 128; Q4's two bind sets (200 left rows)
    q1_cov = (batch_q, batch_mask, batch_qvalid, fp32_top)
    q4_masks = torch.cat([
        (movies["rating"][None, :] == users["preferred_rating"][:, None])
        & (movies["release_year"][None, :] >= int(b["y"])) for b in q4_list])
    q4_qs = left.repeat(len(q4_list), 1)
    q4_cov = (q4_qs, q4_masks.view(torch.int8), None,
              ops.fused_scan_topk_batch(corpus, q4_qs, K, q4_masks,
                                        metric)[0])

    # every row hits: the maybe band is the corpus, wider than the replay
    # budget of 2·CAPACITY rows
    def band(qc, qs, rks, mask, valid) -> dict:
        """Per query, the rows the range path classifies as maybe hits
        (quantized key within the slack of the radius, or below it) and as
        certain hits: the replay budget is max_pairs (or the capacity)
        times the rescore factor, and a wider band takes the full branch."""
        qkeys = qt_mod.quant_keys_batch(qc.qvecs, qc.scales, qs, mask, valid,
                                        metric)
        slack = qt_mod._range_slack(metric, qc.half_step, qc.row_l1,
                                    qc.row_l2, qs, DIM)
        maybe = (qkeys <= rks[:, None] + slack).sum(1)
        certain = (qkeys <= rks[:, None] - slack).sum(1)
        return {"maybe_max": int(maybe.max()),
                "maybe_median": float(maybe.float().median()),
                "certain_median": float(certain.float().median())}

    q2_full_binds = [{"qv": qv[i], "r": np.float32(-2.0),
                      "p": np.float32(3e38)} for i in range(8)]
    fp32_of = {"q1": stmt, "q2": q2, "q2_full": q2, "q3": q3,
               "q3_budget": q3, "q4": q4y, "q5": q5, "q6": q6}
    need_q = {"q1": ("quant_scan_topk_batch", "replay_keys"),
              "q2": ("quant_keys_batch",),
              "q2_full": ("quant_keys_batch", "range_topk_batch"),
              "q3": ("quant_keys_batch",),
              "q3_budget": ("quant_keys_batch", "replay_keys"),
              "q4": ("quant_scan_topk_batch", "replay_keys"),
              "q5": ("quant_keys_batch",),
              "q6": ("quant_keys_batch",)}
    coverage, bands, qchecked, qstmts = {}, {}, {}, {}
    for mode in MODES:
        miss, c1 = coverage_factor(twins[mode], q1_cov, f"q1 {mode}")
        miss4, c4 = coverage_factor(twins[mode], q4_cov, f"q4 {mode}")
        coverage[mode] = {"missing_queries": miss, "rescore_factor": c1,
                          "q4_missing_queries": miss4,
                          "q4_rescore_factor": c4}
        qdb = connect(cat, engine="brute", use_pallas=True, quant=mode)
        q1s = connect(cat, engine="brute", use_pallas=True, quant=mode,
                      rescore_factor=c1).prepare(Q1, K=K)
        q2s, q3s = qdb.prepare(Q2), qdb.prepare(Q3)
        qstmts[mode] = (q1s, q2s, q3s)
        results = {}
        runs = [(f"single{i}", q1s, binds[i], None) for i in range(3)]
        runs += [(f"list{qn}", q1s, binds[:qn], None) for qn in BATCHES]
        runs += [("stacked", q1s, stacked, None),
                 ("exact_shape", q1s, stacked, exact)]
        results["q1"] = drive(f"q1_{mode}", runs)
        runs = [(f"single{i}", q2s, q2_binds[i], None) for i in range(3)]
        runs += [(f"list{qn}", q2s, q2_binds[:qn], None) for qn in BATCHES]
        runs += [("stacked", q2s, q2_stacked, None),
                 ("exact_shape", q2s, q2_stacked, exact)]
        results["q2"] = drive(f"q2_{mode}", runs)
        results["q2_full"] = drive(f"q2_full_{mode}", [
            ("list8_r_everything", q2s, q2_full_binds, None)])
        results["q3"] = drive(f"q3_{mode}", [
            ("single", q3s, {"r": r}, None),
            ("list4", q3s, [{"r": x} for x in radii], None)])
        # Q3 again with a replay budget that holds its band: the budgeted
        # branch (replay, no fp32 kernel) on the join
        bands[mode] = {
            "q2": band(twins[mode], batch_q, q2_rk, batch_mask,
                       batch_qvalid),
            "q3": band(twins[mode], left, q3_rk, date_mask, None)}
        c3 = max(2, -(-bands[mode]["q3"]["maybe_max"] // MAX_PAIRS))
        bands[mode]["q3_budget_rescore_factor"] = c3
        q3b = connect(cat, engine="brute", use_pallas=True, quant=mode,
                      rescore_factor=c3).prepare(Q3)
        results["q3_budget"] = drive(f"q3_budget_{mode}", [
            ("single", q3b, {"r": r}, None)])
        # the batched Q4–Q6 lowerings (a single dict runs them at Q = 1)
        q4s = connect(cat, engine="brute", use_pallas=True, quant=mode,
                      rescore_factor=c4).prepare(Q4Y)
        qstmts[mode] += (q4s,)
        results["q4"] = drive(f"q4_{mode}", [
            ("single", q4s, q4_list[0], None),
            ("list2", q4s, q4_list, None)])
        q5s, q6s = qdb.prepare(Q5), qdb.prepare(Q6)
        qstmts[mode] += (q5s, q6s)
        results["q5"] = drive(f"q5_{mode}", [
            ("single0", q5s, q5_binds[0], None),
            (f"list{N_QUERIES}", q5s, q5_binds, None)])
        results["q6"] = drive(f"q6_{mode}", [
            ("single", q6s, {"r": r}, None),
            ("list4", q6s, [{"r": x} for x in radii], None)])
        for path, res in results.items():
            for label, _s, b, h, out in res:
                if label.startswith("single"):
                    want = first(fp32_of[path].execute([b], hints=exact).data)
                else:
                    want = fp32_of[path].execute(b, hints=h).data
                torch.cuda.synchronize()
                bitwise(out.data, want, f"slice_quant {path} {mode} {label}")
                rep = out.explain()
                qchecked[f"{path}_{mode}_{label}"] = {
                    "shape": list(out.data["valid"].shape), "path": rep.path,
                    "bucket": rep.bucket, "bitwise_fp32": True}
            for kname in need_q[path]:
                if launches[f"{path}_{mode}"][kname] < 1:
                    raise AssertionError(f"path {path}_{mode} never launched "
                                         f"{kname}")
        for kname in ("scan_topk", "scan_topk_batch"):
            if launches[f"q1_{mode}"][kname]:
                raise AssertionError(f"q1_{mode} launched fp32 {kname}")
        if launches[f"q3_budget_{mode}"]["range_topk_batch"]:
            raise AssertionError(f"q3_budget_{mode} took the full branch")
    emit({"phase": "slice_quant", "coverage": coverage, "bands": bands,
          "launches": {key: v for key, v in launches.items()
                       if key.endswith(MODES)},
          "runs": qchecked})

    # -- lm gates: the LM side's model gates, which time nothing, while the
    # aot phase's child A builds its kernels --------------------------------
    lm_gates = lm_gates_phase(smi, name)
    # and the training path's smoke gates, which time nothing either
    train_gates = train_gates_phase(smi, name)

    # the aot phase's child A ends before the first phase that times
    aot_children.join_a()

    # -- ivf: the IVF index and the chase, vbase and pase engines -------------
    index = ivf_phase(cat, qv, p, r, sims, near_q, drive, launches, smi,
                      name)

    # -- ivf_joins: Q3–Q6 over the same index ---------------------------------
    ivf_joins_phase(cat, qv, r, sims, index, drive, launches, smi, name)

    # -- serve: Q1 through the scheduler and the front door -------------------
    serve_phase(cat, qv, r, index, reset_counts, counts, launches, record,
                smi, name)

    # -- live: the live corpus under Q1–Q6 ------------------------------------
    live_phase(cat, qv, p, r, drive, launches, reset_counts, counts, smi,
               name)

    # -- sharded: every class under EngineOptions.dist at one shard -----------
    sharded_phase(cat, qv, p, r, drive, launches, smi, name)

    # -- large_k: LIMIT and rank above the top-k kernels' lists --------------
    large_k_phase(cat, qv, p, twins, drive, launches, smi, name)

    # -- adaptive: the advisor over the ivf phase's index ---------------------
    adaptive_phase(cat, qv, r, drive, launches, smi, name)

    # -- interp: the Volcano interpreter against the compiled Q1 --------------
    interp_phase(cat, qv, p, drive, launches, reset_counts, counts, smi, name)

    # -- aot: the on-disk plan cache, in process and across processes ---------
    aot_phase(cat, qv, p, r, aot_children, reset_counts, counts, launches,
              smi, name)

    # -- lm: the LM side and the RAG tier -------------------------------------
    lm_phase(lm_gates, record, reset_counts, counts, launches, smi, name)

    # -- train: qwen2-1.5b trained at full width ------------------------------
    trained = train_phase(train_gates, reset_counts, counts, launches, smi,
                          name)

    # -- roofline: the dry-run, the counter and lower on the card -------------
    roofline_phase(trained, cat, qv, p, r, reset_counts, counts, launches,
                   smi, name)

    # the mesh phase's dry-run children count on the host's cores while the
    # card times its kernels below
    mesh_cells = MeshCells()

    # -- times ----------------------------------------------------------------
    # every bound is its wrapper's work formula (``*_work``): live queries
    # only, each input byte read once and each output written once
    nb, _rows = st_mod.single_plan(N_ROWS)
    qt, splits, _ = st_mod.batch_plan(N_ROWS, bucket, K)
    live_q = int(batch_qvalid.sum())

    def bound(work):
        """The kernel's bound: its wrapper's work formula on this card."""
        return bound_ms(work, spec_for(name))

    def lib_single():
        keys = -(corpus @ single_q)
        keys = keys.masked_fill(single_mask == 0, float("inf"))
        return torch.topk(keys, K, largest=False)

    def lib_batch():
        keys = -(batch_q @ corpus.T)
        keys = keys.masked_fill(batch_mask == 0, float("inf"))
        keys = keys.masked_fill((batch_qvalid == 0)[:, None], float("inf"))
        return torch.topk(keys, K, dim=1, largest=False)

    def lib_range_single():
        keys = -(corpus @ left[0])
        hit = (keys <= rk) & (date_mask[0] != 0)
        return keys.masked_fill(~hit, float("inf")), hit

    def lib_range_batch():
        keys = -(batch_q @ corpus.T)
        hit = ((keys <= q2_rk[:, None]) & (batch_mask != 0)
               & (batch_qvalid != 0)[:, None])
        return keys.masked_fill(~hit, float("inf")), hit

    # quantized kernels at the Q1 / Q2 bucket-128 shapes; the replay at the
    # Q1 path's candidate rows (only rows < N are read: pad queries and
    # empty slots cost nothing)
    q_plan = qt_mod.quant_plan(N_ROWS, bucket, 2 * K)

    def qargs(qc):
        return qc.qvecs, qc.scales, batch_q, batch_mask, batch_qvalid

    def twin_bytes(qc):
        return (qc.qvecs.numel() * qc.qvecs.element_size()
                + (N_ROWS * 4 if qc.mode == "int8" else 0))

    replay_rows = qt_mod.candidate_rows(*qt_mod.quant_scan_topk_batch(
        *qargs(twins["int8"]), 2 * K, metric), 2 * K)
    replay_pairs = int((replay_rows < N_ROWS).sum())

    def dequantized_keys(qc, qs=batch_q, mask=batch_mask,
                         valid=batch_qvalid):
        keys = -(qs @ (qc.qvecs.to(torch.float32) * qc.scales).T)
        keys = keys.masked_fill(mask == 0, float("inf"))
        return keys.masked_fill((valid == 0)[:, None], float("inf"))

    def lib_quant_topk(qc, qs=batch_q, mask=batch_mask, valid=batch_qvalid):
        seg = dequantized_keys(qc, qs, mask, valid).view(
            qs.shape[0], -1, qt_mod.SEG).amin(-1)
        return torch.topk(seg, 2 * K, dim=1, largest=False)

    def lib_replay():
        rows = replay_rows.clamp(max=N_ROWS - 1).long()
        return -torch.bmm(corpus[rows], batch_q[:, :, None])[..., 0]

    def quant_calls(qc) -> dict:
        return {
            "quant_scan_topk_batch": (
                lambda: qt_mod.quant_scan_topk_batch(*qargs(qc), 2 * K,
                                                     metric),
                lambda: qt_mod.quant_scan_topk_batch_plain(
                    *qargs(qc), 2 * K, metric),
                lambda: lib_quant_topk(qc),
                bound(qt_mod.quant_scan_topk_batch_work(*qargs(qc), 2 * K))),
            "quant_keys_batch": (
                lambda: qt_mod.quant_keys_batch(*qargs(qc), metric),
                lambda: qt_mod.quant_keys_batch_plain(*qargs(qc), metric),
                lambda: dequantized_keys(qc),
                bound(qt_mod.quant_keys_batch_work(*qargs(qc))))}

    calls = {
        "scan_topk": (lambda: st_mod.scan_topk(corpus, single_q, single_mask,
                                               K, metric),
                      lambda: st_mod.scan_topk_plain(
                          corpus, single_q, single_mask, K, metric),
                      lib_single, bound(st_mod.scan_topk_work(
                          corpus, single_q, single_mask, K))),
        "scan_topk_batch": (lambda: st_mod.scan_topk_batch(
            corpus, batch_q, batch_mask, batch_qvalid, K, metric),
            lambda: st_mod.scan_topk_batch_plain(
                corpus, batch_q, batch_mask, batch_qvalid, K, metric),
            lib_batch, bound(st_mod.scan_topk_batch_work(
                corpus, batch_q, batch_mask, batch_qvalid, K))),
        "range_scan": (lambda: rs_mod.range_scan(
            corpus, left[0], rk.reshape(1), date_mask[0], metric),
            lambda: rs_mod.range_scan_plain(
                corpus, left[0], rk.reshape(1), date_mask[0], metric),
            lib_range_single, bound(rs_mod.range_scan_work(
                corpus, left[0], rk.reshape(1), date_mask[0]))),
        "range_scan_batch": (lambda: rs_mod.range_scan_batch(
            corpus, batch_q, q2_rk, batch_mask, batch_qvalid, metric),
            lambda: rs_mod.range_scan_batch_plain(
                corpus, batch_q, q2_rk, batch_mask, batch_qvalid, metric),
            lib_range_batch, bound(rs_mod.range_scan_batch_work(
                corpus, batch_q, q2_rk, batch_mask, batch_qvalid))),
        **quant_calls(twins["int8"]),
        "replay_keys": (
            lambda: qt_mod.replay_keys(corpus, batch_q, replay_rows, metric),
            lambda: qt_mod.replay_keys_plain(corpus, batch_q, replay_rows,
                                             metric),
            lib_replay, bound(qt_mod.replay_keys_work(corpus, batch_q,
                                                      replay_rows))),
        # the (100, 1M) key matrix: corpus and queries in, keys out
        "pairwise_keys": (
            lambda: dist_mod.pairwise_keys(left, corpus, metric),
            lambda: dist_mod.pairwise_keys_plain(left, corpus, metric),
            lambda: -torch.matmul(left, corpus.T),
            bound(dist_mod.pairwise_keys_work(left, corpus))),
    }

    times = timed(calls)
    times_bf16 = timed(quant_calls(twins["bf16"]))
    # a few queries, where the bytes bound: bucket 8, the fp32 kernel
    # against its quantized twins (each at its own stage-1 count)
    q8, m8, v8 = batch_q[:8], batch_mask[:8], batch_qvalid[:8]
    bucket8 = {"fp32_scan_topk_batch": {
        "ms": time_ms(lambda: st_mod.scan_topk_batch(corpus, q8, m8, v8, K,
                                                     metric)),
        "bytes_bound_ms": (N_ROWS * DIM * 4 + 8 * N_ROWS) / bw * 1e3}}
    for mode, qc in twins.items():
        bucket8[f"quant_scan_topk_batch_{mode}"] = {
            "ms": time_ms(lambda: qt_mod.quant_scan_topk_batch(
                qc.qvecs, qc.scales, q8, m8, v8, 2 * K, metric)),
            "bytes_bound_ms": (twin_bytes(qc) + 8 * N_ROWS) / bw * 1e3}
    def with_runs(kernel, lib, **row) -> dict:
        """A kernel and its library yardstick, each one call between an
        event pair and per call over a back-to-back run."""
        row["ms"] = time_ms(kernel)
        row["run_ms"] = run_ms(kernel, row["ms"])
        row["library_ms"] = time_ms(lib, 2, 5)
        row["library_run_ms"] = run_ms(lib, row["library_ms"])
        return row

    # the quantized top-k at one query (a quantized single dict), bucket 8
    # and bucket 128 (100 live), each mode beside the library yardstick
    quant_by_q = {}
    for live, b in ((1, 1), (8, 8), (N_QUERIES, bucket)):
        qs_, m_, v_ = batch_q[:b], batch_mask[:b], batch_qvalid[:b]
        quant_by_q[live] = {"bucket": b, "plan": list(qt_mod.quant_plan(
            N_ROWS, b, 2 * K))}
        for mode, qc in twins.items():
            b_ms, b_by = bound(qt_mod.quant_scan_topk_batch_work(
                qc.qvecs, qc.scales, qs_, m_, v_, 2 * K))
            quant_by_q[live][mode] = with_runs(
                lambda: qt_mod.quant_scan_topk_batch(
                    qc.qvecs, qc.scales, qs_, m_, v_, 2 * K, metric),
                lambda: lib_quant_topk(qc, qs_, m_, v_),
                bound_ms=b_ms, bound_by=b_by)
    # the fp32 batched top-k at one query (a list of 1), buckets 8 and 32
    # (30 live; the narrow and mid shapes) and 128 (100 live), beside the
    # library yardstick
    fp32_by_q = {}
    for live, b in ((1, 1), (8, 8), (30, 32), (N_QUERIES, bucket)):
        qs_, m_ = batch_q[:b], batch_mask[:b]
        v_ = (torch.arange(b, device=dev) < live).to(torch.int8)
        b_ms, b_by = bound(st_mod.scan_topk_batch_work(corpus, qs_, m_, v_,
                                                       K))

        def lib_b():
            keys = -(qs_ @ corpus.T)
            keys = keys.masked_fill(m_ == 0, float("inf"))
            keys = keys.masked_fill((v_ == 0)[:, None], float("inf"))
            return torch.topk(keys, K, dim=1, largest=False)
        fp32_by_q[live] = with_runs(
            lambda: st_mod.scan_topk_batch(corpus, qs_, m_, v_, K, metric),
            lib_b, bucket=b, plan=list(st_mod.batch_plan(N_ROWS, b, K)),
            bound_ms=b_ms, bound_by=b_by)
    # the batched range scan at one query (a Q2 list of 1), buckets 8, 32
    # (30 live; the narrow and mid shapes) and 128 (100 live; the wide
    # one), at the Q2 radius, beside the library yardstick
    range_by_q = {}
    for live, b in ((1, 1), (8, 8), (30, 32), (N_QUERIES, bucket)):
        qs_, m_, rk_ = batch_q[:b], batch_mask[:b], q2_rk[:b]
        v_ = (torch.arange(b, device=dev) < live).to(torch.int8)
        b_ms, b_by = bound(rs_mod.range_scan_batch_work(corpus, qs_, rk_, m_,
                                                        v_))

        def lib_r():
            keys = -(qs_ @ corpus.T)
            hit = ((keys <= rk_[:, None]) & (m_ != 0)
                   & (v_ != 0)[:, None])
            return keys.masked_fill(~hit, float("inf")), hit
        range_by_q[live] = with_runs(
            lambda: rs_mod.range_scan_batch(corpus, qs_, rk_, m_, v_,
                                            metric),
            lib_r, bucket=b, plan=list(rs_mod.batch_plan(N_ROWS, b)),
            bound_ms=b_ms, bound_by=b_by)
    # the quantized key kernel at one query (a quantized single dict), and
    # buckets 8, 32 (30 live), 64 and 128 (100 live) of Q2's shapes, each
    # mode beside the library yardstick (dequantize, matmul, masked_fill)
    keys_by_q = {}
    for live, b in ((1, 1), (8, 8), (30, 32), (64, 64), (N_QUERIES, bucket)):
        qs_, m_ = batch_q[:b], batch_mask[:b]
        v_ = (torch.arange(b, device=dev) < live).to(torch.int8)
        keys_by_q[live] = {"bucket": b,
                           "plan": list(rs_mod.batch_plan(N_ROWS, b))}
        for mode, qc in twins.items():
            b_ms, b_by = bound(qt_mod.quant_keys_batch_work(
                qc.qvecs, qc.scales, qs_, m_, v_))
            keys_by_q[live][mode] = with_runs(
                lambda: qt_mod.quant_keys_batch(qc.qvecs, qc.scales, qs_, m_,
                                                v_, metric),
                lambda: dequantized_keys(qc, qs_, m_, v_),
                bound_ms=b_ms, bound_by=b_by)
    # the pairwise kernel at a single query (Q4 brute_sort perleft), a few
    # and the 100 queries, each beside one torch.matmul
    pairwise_by_q = {}
    for qn in (1, 8, N_QUERIES):
        qs_ = left[:qn]
        pairwise_by_q[qn] = with_runs(
            lambda: dist_mod.pairwise_keys(qs_, corpus, metric),
            lambda: torch.matmul(qs_, corpus.T),
            bound_ms=bound(dist_mod.pairwise_keys_work(qs_, corpus))[0],
            plan=list(dist_mod.pairwise_plan(N_ROWS, qn)))
    emit({"phase": "times", "device": name, "nvidia_smi": smi,
          "shapes": {"n": N_ROWS, "d": DIM, "k": K, "bucket": bucket,
                     "live_queries": live_q, "qt": qt, "splits": splits,
                     "single_blocks": nb,
                     "range_batch_plan": list(rs_mod.batch_plan(N_ROWS,
                                                                bucket)),
                     "quant_plan": list(q_plan),
                     "replay_pairs": replay_pairs,
                     "pairwise": [N_QUERIES, N_ROWS, DIM],
                     "pairwise_plan": list(dist_mod.pairwise_plan(
                         N_ROWS, N_QUERIES))},
          "kernels": times, "kernels_bf16": times_bf16,
          "bucket8": bucket8, "fp32_by_q": fp32_by_q,
          "range_by_q": range_by_q, "quant_by_q": quant_by_q,
          "keys_by_q": keys_by_q,
          "pairwise_by_q": pairwise_by_q})

    # -- e2e -------------------------------------------------------------------
    e2e = {"single": latency_ms(lambda: stmt.execute(binds[0]))}
    for qn in BATCHES:
        e2e[f"batch{qn}"] = latency_ms(lambda: stmt.execute(binds[:qn]))
    emit({"phase": "e2e", "path": "q1", "device": name, "nvidia_smi": smi,
          "latency_ms": e2e,
          "qps": {key: (1 if key == "single" else int(key[5:])) * 1e3 / v
                  for key, v in e2e.items()}})

    def q2_inputs(qn: int):
        """The batched kernel's inputs for a Q2 list of ``qn`` binds, as
        the bucketed executor builds them (edge-padded to the bucket)."""
        b = 1 << (qn - 1).bit_length()
        idx = np.minimum(np.arange(b), qn - 1)
        qs = torch.from_numpy(qv[idx]).to(dev)
        mask = evaluate_batch(pred, table, {"p": np.full(b, p, np.float32)},
                              b).contiguous().view(torch.int8)
        valid = (torch.arange(b, device=dev) < qn).to(torch.int8)
        return qs, rk.expand(b).contiguous(), mask, valid

    def stage_ms(args, cap: int) -> tuple:
        """(kernel ms, stage-2 ms) at one path's shapes: range_topk_batch
        (the range tile appending each query's hits and the per-query
        sort), then stage 2's read of the counts for the dense fallback."""
        out = rs_mod.range_topk_batch(corpus, *args, metric, cap)
        return (time_ms(lambda: rs_mod.range_topk_batch(corpus, *args,
                                                        metric, cap), 2, 5),
                time_ms(lambda: (out[3].cpu() > cap).nonzero(), 2, 5))

    q2_e2e = {}
    single_keys = torch.where(
        (sims[0] >= float(r)) & (price < float(p)), -sims[0], float("inf"))
    q2_e2e["single"] = {
        "latency_ms": latency_ms(lambda: q2.execute(q2_binds[0])),
        "kernel": "none (reference lowering)", "kernel_ms": 0.0,
        "stage2_ms": time_ms(lambda: compact_range(single_keys, CAPACITY,
                                                   metric)),
        "peak_mb": peak_mb(lambda: q2.execute(q2_binds[0])), "queries": 1}
    for qn in BATCHES:
        inputs = q2_inputs(qn)
        k_ms, s_ms = stage_ms(inputs, CAPACITY)
        q2_e2e[f"batch{qn}"] = {
            "latency_ms": latency_ms(lambda: q2.execute(q2_binds[:qn]),
                                     iters=5),
            "kernel": "range_topk_batch", "kernel_ms": k_ms,
            "stage2_ms": s_ms,
            "peak_mb": peak_mb(lambda: q2.execute(q2_binds[:qn])),
            "queries": qn, "bucket": inputs[0].shape[0]}
    q3_e2e = {}
    k_ms, s_ms = stage_ms((left, q3_rk, date_mask, None), MAX_PAIRS)
    q3_e2e["batch"] = {"latency_ms": latency_ms(lambda: q3.execute({"r": r}),
                                                iters=5),
                       "kernel": "range_topk_batch", "kernel_ms": k_ms,
                       "stage2_ms": s_ms,
                       "peak_mb": peak_mb(lambda: q3.execute({"r": r}))}
    row_masks = [date_mask[i] for i in range(N_QUERIES)]
    k_ms = time_ms(lambda: [rs_mod.range_scan(corpus, left[i], rk.reshape(1),
                                              row_masks[i], metric)
                            for i in range(N_QUERIES)], 1, 3)
    row_keys = rs_mod.range_scan(corpus, left[0], rk.reshape(1),
                                 row_masks[0], metric)[0]
    s_ms = time_ms(lambda: [compact_range(row_keys, MAX_PAIRS, metric)
                            for _ in range(N_QUERIES)], 1, 3)
    q3_e2e["perleft"] = {
        "latency_ms": latency_ms(lambda: q3_perleft.execute({"r": r}),
                                 iters=3),
        "kernel": f"range_scan x {N_QUERIES}", "kernel_ms": k_ms,
        "stage2_ms": s_ms,
        "peak_mb": peak_mb(lambda: q3_perleft.execute({"r": r}))}
    list4 = [{"r": x} for x in radii]
    left4 = left.repeat(4, 1)
    mask4 = date_mask.repeat(4, 1)
    rk4 = order_key(metric, torch.from_numpy(radii).to(dev)
                    ).repeat_interleave(N_QUERIES).contiguous()
    k_ms, s_ms = stage_ms((left4, rk4, mask4, None), MAX_PAIRS)
    q3_e2e["list4"] = {"latency_ms": latency_ms(lambda: q3.execute(list4),
                                                iters=3),
                       "kernel": "range_topk_batch", "kernel_ms": k_ms,
                       "stage2_ms": s_ms,
                       "peak_mb": peak_mb(lambda: q3.execute(list4))}
    for key, row in list(q2_e2e.items()) + list(q3_e2e.items()):
        row["kernel_share"] = row["kernel_ms"] / row["latency_ms"]
        row["stage2_share"] = row["stage2_ms"] / row["latency_ms"]
    for key, row in q2_e2e.items():
        row["qps"] = row["queries"] * 1e3 / row["latency_ms"]
    emit({"phase": "e2e", "path": "q2", "device": name, "nvidia_smi": smi,
          "resident_mb": torch.cuda.memory_allocated() / 2**20,
          "runs": q2_e2e})
    emit({"phase": "e2e", "path": "q3", "device": name, "nvidia_smi": smi,
          "left_rows": N_QUERIES, "runs": q3_e2e})

    # Q4: each lowering beside its kernel and its stage 2 (the merge of the
    # per-split lists, or the full sort)
    rating_mask = (movies["rating"][None, :]
                   == users["preferred_rating"][:, None])
    rating_m8 = rating_mask.view(torch.int8)
    sort_stmt = sort_db.prepare(Q4)
    q4_perleft = db.prepare(Q4, hints=perleft)
    q4_e2e = {}
    stage1 = st_mod.scan_topk_batch(corpus, left, rating_m8, None, K, metric)
    q4_e2e["batch"] = {
        "latency_ms": latency_ms(lambda: q4.execute(), iters=5),
        "kernel": "scan_topk_batch",
        "kernel_ms": time_ms(lambda: st_mod.scan_topk_batch(
            corpus, left, rating_m8, None, K, metric), 2, 5),
        "stage2_ms": time_ms(lambda: ops._merge(*stage1, K, metric), 2, 5),
        "peak_mb": peak_mb(lambda: q4.execute())}
    rows1 = [st_mod.scan_topk(corpus, left[i], rating_m8[i], K, metric)
             for i in range(N_QUERIES)]
    q4_e2e["perleft"] = {
        "latency_ms": latency_ms(lambda: q4_perleft.execute(), iters=3),
        "kernel": f"scan_topk x {N_QUERIES}",
        "kernel_ms": time_ms(lambda: [st_mod.scan_topk(
            corpus, left[i], rating_m8[i], K, metric)
            for i in range(N_QUERIES)], 1, 3),
        "stage2_ms": time_ms(lambda: [ops._merge(kk.reshape(-1),
                                                 ii.reshape(-1), K, metric)
                                      for kk, ii in rows1], 1, 3),
        "peak_mb": peak_mb(lambda: q4_perleft.execute())}
    del stage1, rows1
    sort_keys = dist_mod.pairwise_keys(left, corpus, metric)
    q4_e2e["brute_sort"] = {
        "latency_ms": latency_ms(lambda: sort_stmt.execute(), iters=3),
        "kernel": "pairwise_keys",
        "kernel_ms": time_ms(lambda: dist_mod.pairwise_keys(left, corpus,
                                                            metric), 2, 5),
        "stage2_ms": time_ms(lambda: compact_range(
            sort_keys.masked_fill(~rating_mask, float("inf")), K, metric),
            1, 3),
        "peak_mb": peak_mb(lambda: sort_stmt.execute())}
    del sort_keys
    for row in q4_e2e.values():
        row["left_rows_per_s"] = N_QUERIES * 1e3 / row["latency_ms"]
        row["kernel_share"] = row["kernel_ms"] / row["latency_ms"]
        row["stage2_share"] = row["stage2_ms"] / row["latency_ms"]
    emit({"phase": "e2e", "path": "q4", "device": name, "nvidia_smi": smi,
          "left_rows": N_QUERIES, "k": K, "runs": q4_e2e})

    # Q5 per batch size and Q6 per lowering: the range kernel, then stage 2
    # (the compaction to the 4096-row buffer and the per-category rank)
    n_levels = recipes.schema["calorie_level"].num_categories
    levels = recipes["calorie_level"]

    def rank_stage(keys):
        return _ranked_buffer(metric, levels,
                              *compact_range(keys, CAPACITY, metric),
                              n_levels, K_CATEGORY)

    q5_pred = q5.compiled.analysis.structured_predicate

    def q5_inputs(qn: int):
        """The batched kernel's inputs for a Q5 list of ``qn`` binds,
        edge-padded to the bucket as the executor pads them."""
        b = 1 << (qn - 1).bit_length()
        idx = np.minimum(np.arange(b), qn - 1)
        mask = evaluate_batch(q5_pred, recipes,
                              {"ex": np.full(b, EX, np.int32)},
                              b).contiguous().view(torch.int8)
        valid = (torch.arange(b, device=dev) < qn).to(torch.int8)
        return (torch.from_numpy(qv[idx]).to(dev), rk.expand(b).contiguous(),
                mask, valid)

    def cat_stage(args) -> tuple:
        """(kernel ms, stage-2 ms) at one path's shapes: range_topk_batch,
        then the count read and the category rank of its buffers."""
        out = rs_mod.range_topk_batch(corpus, *args, metric, CAPACITY)

        def stage2():
            (out[3].cpu() > CAPACITY).nonzero()
            return _ranked_buffer(metric, levels, *out[:3], n_levels,
                                  K_CATEGORY)
        return (time_ms(lambda: rs_mod.range_topk_batch(
                    corpus, *args, metric, CAPACITY), 2, 5),
                time_ms(stage2, 2, 5))

    q5_e2e = {}
    single_keys = torch.where(
        (sims[0] >= float(r)) & (recipes["cuisine"] != EX), -sims[0],
        float("inf"))
    q5_e2e["single"] = {
        "latency_ms": latency_ms(lambda: q5.execute(q5_binds[0])),
        "kernel": "none (reference lowering)", "kernel_ms": 0.0,
        "stage2_ms": time_ms(lambda: rank_stage(single_keys)),
        "peak_mb": peak_mb(lambda: q5.execute(q5_binds[0])), "queries": 1}
    for qn in BATCHES:
        inputs = q5_inputs(qn)
        k_ms, s_ms = cat_stage(inputs)
        q5_e2e[f"batch{qn}"] = {
            "latency_ms": latency_ms(lambda: q5.execute(q5_binds[:qn]),
                                     iters=5),
            "kernel": "range_topk_batch", "kernel_ms": k_ms,
            "stage2_ms": s_ms,
            "peak_mb": peak_mb(lambda: q5.execute(q5_binds[:qn])),
            "queries": qn, "bucket": inputs[0].shape[0]}
    for row in q5_e2e.values():
        row["qps"] = row["queries"] * 1e3 / row["latency_ms"]
    q6_mask = (recipes["cuisine"][None, :]
               != qtable["cuisine"][:, None]).view(torch.int8)
    q6_perleft = db.prepare(Q6, hints=perleft)
    q6_e2e = {}
    k_ms, s_ms = cat_stage((left, q3_rk, q6_mask, None))
    q6_e2e["batch"] = {"latency_ms": latency_ms(lambda: q6.execute({"r": r}),
                                                iters=5),
                       "kernel": "range_topk_batch", "kernel_ms": k_ms,
                       "stage2_ms": s_ms, "bind_sets": 1,
                       "peak_mb": peak_mb(lambda: q6.execute({"r": r}))}
    row_keys = torch.where((sims[0] >= float(r)) & (q6_mask[0] != 0),
                           -sims[0], float("inf"))
    q6_e2e["perleft"] = {
        "latency_ms": latency_ms(lambda: q6_perleft.execute({"r": r}),
                                 iters=3),
        "kernel": "none (reference lowering)", "kernel_ms": 0.0,
        "stage2_ms": time_ms(lambda: [rank_stage(row_keys)
                                      for _ in range(N_QUERIES)], 1, 3),
        "bind_sets": 1,
        "peak_mb": peak_mb(lambda: q6_perleft.execute({"r": r}))}
    mask4_q6 = q6_mask.repeat(4, 1)
    k_ms, s_ms = cat_stage((left4, rk4, mask4_q6, None))
    q6_e2e["list4"] = {"latency_ms": latency_ms(lambda: q6.execute(list4),
                                                iters=3),
                       "kernel": "range_topk_batch", "kernel_ms": k_ms,
                       "stage2_ms": s_ms, "bind_sets": 4,
                       "peak_mb": peak_mb(lambda: q6.execute(list4))}
    for row in list(q5_e2e.values()) + list(q6_e2e.values()):
        row["kernel_share"] = row["kernel_ms"] / row["latency_ms"]
        row["stage2_share"] = row["stage2_ms"] / row["latency_ms"]
    for row in q6_e2e.values():
        row["left_rows_per_s"] = (row["bind_sets"] * N_QUERIES * 1e3
                                  / row["latency_ms"])
    emit({"phase": "e2e", "path": "q5", "device": name, "nvidia_smi": smi,
          "k_per_category": K_CATEGORY, "runs": q5_e2e})
    emit({"phase": "e2e", "path": "q6", "device": name, "nvidia_smi": smi,
          "left_rows": N_QUERIES, "k_per_category": K_CATEGORY,
          "runs": q6_e2e})

    # the quantized paths, each beside the fp32 number measured above
    for mode in MODES:
        q1s, q2s, q3s, q4s, q5s, q6s = qstmts[mode]
        lat = {"single": latency_ms(lambda: q1s.execute(binds[0]))}
        for qn in BATCHES:
            lat[f"batch{qn}"] = latency_ms(lambda: q1s.execute(binds[:qn]))
        emit({"phase": "e2e", "path": f"q1_{mode}", "device": name,
              "nvidia_smi": smi, "latency_ms": lat,
              "qps": {key: (1 if key == "single" else int(key[5:])) * 1e3 / v
                      for key, v in lat.items()},
              "fp32_latency_ms": e2e})
        runs = {}
        qc = twins[mode]
        # (label, binds, queries, the quantized key kernel's inputs)
        q2_calls = [("single", q2_binds[0], 1, q2_inputs(1))] + [
            (f"batch{qn}", q2_binds[:qn], qn, q2_inputs(qn))
            for qn in BATCHES]
        q3_calls = [("batch", {"r": r}, N_QUERIES,
                     (left, None, date_mask, None)),
                    ("list4", list4, 4 * N_QUERIES,
                     (left4, None, mask4, None))]
        for path, st, calls_, fp32 in (("q2", q2s, q2_calls, q2_e2e),
                                       ("q3", q3s, q3_calls, q3_e2e)):
            runs[path] = {}
            for key, b, nq, (qs_, _rk, mask_, valid_) in calls_:
                ms = latency_ms(lambda: st.execute(b), iters=5)
                k_ms = time_ms(lambda: qt_mod.quant_keys_batch(
                    qc.qvecs, qc.scales, qs_, mask_, valid_, metric), 2, 5)
                runs[path][key] = {
                    "latency_ms": ms, "qps": nq * 1e3 / ms,
                    "kernel_ms": k_ms, "kernel_share": k_ms / ms,
                    "peak_mb": peak_mb(lambda: st.execute(b)),
                    "fp32_latency_ms": fp32[key]["latency_ms"],
                    "fp32_peak_mb": fp32[key]["peak_mb"]}
        emit({"phase": "e2e", "path": f"q2_q3_{mode}", "device": name,
              "nvidia_smi": smi, "runs": runs})
        # quantized Q4 batch: one bind set (100 users) and the list of two,
        # beside fp32; the kernel at the list's stage-1 shape (200 left
        # rows, their rating and year masks, c·K segments)
        c4 = coverage[mode]["q4_rescore_factor"]
        q4_runs = {}
        for key, b in (("single", q4_list[0]), ("list2", q4_list)):
            ms = latency_ms(lambda: q4s.execute(b), iters=5)
            fp32_ms = latency_ms(lambda: q4y.execute(b), iters=5)
            q4_runs[key] = {
                "latency_ms": ms, "fp32_latency_ms": fp32_ms,
                "left_rows_per_s": (N_QUERIES * (1 if key == "single"
                                                 else len(q4_list))
                                    * 1e3 / ms),
                "peak_mb": peak_mb(lambda: q4s.execute(b))}
        q4_runs["list2"]["kernel_ms"] = time_ms(
            lambda: qt_mod.quant_scan_topk_batch(
                qc.qvecs, qc.scales, q4_qs, q4_masks.view(torch.int8), None,
                c4 * K, metric), 2, 5)
        q4_runs["list2"]["kernel_share"] = (q4_runs["list2"]["kernel_ms"]
                                            / q4_runs["list2"]["latency_ms"])
        emit({"phase": "e2e", "path": f"q4_{mode}", "device": name,
              "nvidia_smi": smi, "rescore_factor": c4, "k": K,
              "runs": q4_runs})
        # quantized Q5 (a single dict and the lists) and Q6 (the batch
        # lowering and the list of 4 radii), beside fp32
        q5_runs, q6_runs = {}, {}
        for key, b, nq in [("single", q5_binds[0], 1)] + [
                (f"batch{qn}", q5_binds[:qn], qn) for qn in BATCHES]:
            ms = latency_ms(lambda: q5s.execute(b), iters=5)
            q5_runs[key] = {"latency_ms": ms, "qps": nq * 1e3 / ms,
                            "peak_mb": peak_mb(lambda: q5s.execute(b)),
                            "fp32_latency_ms": q5_e2e[key]["latency_ms"]}
        for key, b, sets in (("batch", {"r": r}, 1), ("list4", list4, 4)):
            ms = latency_ms(lambda: q6s.execute(b), iters=5 if sets == 1
                            else 3)
            q6_runs[key] = {"latency_ms": ms,
                            "left_rows_per_s": sets * N_QUERIES * 1e3 / ms,
                            "peak_mb": peak_mb(lambda: q6s.execute(b)),
                            "fp32_latency_ms": q6_e2e[key]["latency_ms"]}
        emit({"phase": "e2e", "path": f"q5_q6_{mode}", "device": name,
              "nvidia_smi": smi, "q5": q5_runs, "q6": q6_runs})

    # -- mesh: meshes of more than one device ---------------------------------
    mesh_phase(mesh_cells, reset_counts, counts, launches, smi, name)

    emit({"phase": "script", "seconds": time.perf_counter() - T_START})
    emit({"kernels": [
        {"name": kname, "route": "cuda", "source": SOURCES[kname],
         "replaces": REPLACES[kname],
         "launches": sum(path[kname] for path in launches.values()),
         "max_abs_err": max_err[kname], **times[kname]}
        for kname in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--aot-child"]:
        aot_child(*sys.argv[2:])
    elif sys.argv[1:2] == ["--mesh-cell"]:
        mesh_cell(*sys.argv[2:])
    elif sys.argv[1:2] == ["--mesh-grid"]:
        mesh_grid(*sys.argv[2:])
    else:
        main()
