// Query-batched fused range scan (distance + per-query radius + row
// predicate), for Hopper (sm_90a).
//
// Replaces the TPU kernel `range_scan_batch_pallas` (src/repro/kernels/
// range_scan.py, body `_range_batch_kernel`): for every (query, corpus row)
// pair the order key, hit = mask && qvalid[q] && key <= radius_keys[q], the
// keys with +inf off the hits, the int8 hits, and each query's hit count.
//
// Bound on the H100 at N = 1,000,000, D = 512, 100 live queries, fp32
// without TF32: operations.  2·N·D·Q = 102 GFLOP at the 67 TFLOP/s fp32
// CUDA-core peak is 1.528 ms, against about 0.79 ms to move the 2.05 GB
// corpus and the (Q, N) mask, keys and hits once.  Design:
//   * the same tile product as scan_topk_batch.cu (fp32_tile.cuh): a block
//     owns QT queries and one contiguous corpus split and scores it in
//     64-row tiles, register-blocked fp32 FMAs staged through shared memory,
//     so a corpus byte read from memory feeds QT queries;
//   * there is no selection: the epilogue masks each (row, query) key in
//     registers and writes the key and the hit straight to the query-major
//     (Q, N) outputs, neighbouring threads on neighbouring rows;
//   * hits are summed per thread, then per block in shared memory, and
//     added to each query's count with one integer atomicAdd per block;
//   * every output and mask offset is computed in 64 bits: Q·N passes 2^31
//     at about 2,100 queries of a 1M-row corpus, and Q·N·4 bytes at 540.
// The kernel body is range_batch.cuh, shared with quant_keys_batch.cu; this
// file instantiates it for fp32 rows with the radius test.
#include "range_batch.cuh"

// Returns the launch's cudaError_t (0 on success).  `qt` (queries per
// block) is 4, 16 or 64.  `radius_keys` is (qn,) fp32 order keys; `mask` is
// null for mask_mode 0, (n,) for 1 and query-major (qn, n) for 2; `qvalid`
// is null or (qn,); `counts` is (qn,) ints the caller zeroes.
extern "C" int range_scan_batch_launch(
    const float* corpus, const float* queries, const float* radius_keys,
    const int8_t* mask, int mask_mode, const int8_t* qvalid,
    float* out_keys, int8_t* out_hits, int* counts, int n, int d, int qn,
    int metric, int qt, int rows_per_split, int splits,
    cudaStream_t stream) {
  return static_cast<int>(repro_range_batch::launch_any<true>(
      metric, qt, repro_tile::Fp32Rows{corpus}, queries, radius_keys, mask,
      mask_mode, qvalid, out_keys, out_hits, counts, n, d, qn,
      rows_per_split, splits, stream));
}
