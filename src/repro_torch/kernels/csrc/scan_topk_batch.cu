// Query-batched fused scan + filter + top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel `scan_topk_batch_pallas`
// (src/repro/kernels/scan_topk.py, body `_scan_topk_batch_kernel`): order
// keys of every (corpus row, query) pair, the shared (N,) or per-query
// (Q, N) row mask ANDed with the per-query valid lane, and each query's
// top-k per corpus split, lowest row id on ties.
//
// Bound on the H100 at N = 1,000,000, D = 512, Q = 128, fp32 without TF32:
// operations.  2·N·D·Q = 131 GFLOP at the 67 TFLOP/s fp32 CUDA-core peak is
// 1.96 ms, against 0.61 ms to read the 2.05 GB corpus once.  Design:
//   * the TPU's 1024 x 128 fp32 key tile (512 KB) does not fit the 227 KB a
//     block may hold, and its (n_blocks·k, Qpad) candidate slab would be
//     48,850 candidates per query; instead a block owns QT queries and one
//     contiguous corpus split, and loops over the split in 64-row tiles;
//   * each tile is a register-blocked fp32 FMA product (no TF32, no tensor
//     cores): 64 rows x QT queries, staged through shared memory 32 columns
//     of D at a time, so a corpus byte read from memory feeds QT queries;
//   * keys never leave the chip: each (row, query) key is masked in
//     registers and appended to the query's candidate buffer only if it
//     beats that query's current k-th key; a query's list is re-sorted
//     (bitonic, shared memory) only when its buffer could overflow;
//   * the per-query mask is read in its query-major (Q, N) layout, as the
//     batched predicate evaluation produces it.
// Output: per query, splits·k candidates with global row ids; the stage-2
// merge is plain torch (kernels/ops.py).  The kernel body is topk_batch.cuh,
// shared with quant_scan_topk_batch.cu; this file instantiates it for fp32
// rows, one row per candidate.
#include "topk_batch.cuh"

// Returns the launch's cudaError_t (0 on success).  `qt` (queries per
// block) is 4, 16 or 64; the caller sizes it so that qt·2·kp (key, id)
// pairs fit in shared memory, kp = next power of two >= max(k, 64).
// `mask` is null for mask_mode 0, (n,) for 1 and query-major (qn, n) for 2;
// `qvalid` is null or (qn,).
extern "C" int scan_topk_batch_launch(
    const float* corpus, const float* queries, const int8_t* mask,
    int mask_mode, const int8_t* qvalid, float* out_keys, int* out_ids,
    int n, int d, int qn, int k, int metric, int qt, int rows_per_split,
    int splits, cudaStream_t stream) {
  return static_cast<int>(repro_topk_batch::launch_any<1>(
      metric, qt, repro_tile::Fp32Rows{corpus}, queries, mask, mask_mode,
      qvalid, out_keys, out_ids, n, d, qn, k, rows_per_split, splits,
      stream));
}
