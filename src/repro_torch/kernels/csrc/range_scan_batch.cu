// Query-batched fused range scan (distance + per-query radius + row
// predicate), for Hopper (sm_90a).
//
// Replaces the TPU kernel `range_scan_batch_pallas` (src/repro/kernels/
// range_scan.py, body `_range_batch_kernel`): for every (query, corpus row)
// pair the order key, hit = mask && qvalid[q] && key <= radius_keys[q], the
// keys with +inf off the hits, the int8 hits, and each query's hit count,
// all query-major (Q, N).
//
// Bound on the H100 at N = 1,000,000, D = 512, 100 live queries, fp32
// without TF32: operations.  2·N·D·Q = 102 GFLOP at the 67 TFLOP/s fp32
// CUDA-core peak is 1.528 ms, against about 0.79 ms to move the 2.05 GB
// corpus and the (Q, N) mask, keys and hits once.  At Q <= 16 the corpus
// bytes bound it instead.
//
// Design: range_tile.cuh's tile (128 × 128 wide, 32 × 256 mid and 8 × 512
// narrow shapes, register micro-tiles, swizzled staging two chunks ahead,
// a 4-row epilogue) with its fp32 row loader and the radius epilogue
// (HITS): keys +inf off the hits, int8 hits, per-query counts.  Keys and
// hits bit for bit: a pair's key is replay_keys.cu's at every Q, shape and
// plan, and a row of a batch is the single-query call's.
#include "range_tile.cuh"

// Returns the launch's cudaError_t (0 on success).  corpus (n, d) and
// queries (qn, d) fp32; `radius_keys` (qn,) fp32 order keys; `mask` null
// (`mask_mode` 0), (n,) (1) or query-major (qn, n) (2) int8; `qvalid` null
// or (qn,) int8; `out_keys` / `out_hits` (qn, n); `counts` (qn,) ints the
// caller zeroes.  The plan (kernels/range_scan.py `batch_plan`) gives the
// block shape by its queries per block `qt` (128 wide, 32 mid, 8 narrow)
// and the splits of `rows_per_split` rows, a multiple of the shape's row
// tile.  `vec` only when d % 4 == 0 and the corpus and query bases are
// 16-byte aligned; `vec_out` only when n % 4 == 0 and the key and hit
// bases are 16- and 4-byte aligned.
extern "C" int range_scan_batch_launch(
    const float* corpus, const float* queries, const float* radius_keys,
    const int8_t* mask, int mask_mode, const int8_t* qvalid,
    float* out_keys, int8_t* out_hits, int* counts, int n, int d, int qn,
    int metric, int qt, int rows_per_split, int splits, int vec, int vec_out,
    cudaStream_t stream) {
  using namespace repro_range_tile;
  const Args a{queries, radius_keys, mask, mask_mode, qvalid, out_keys,
               out_hits, counts, n, d, qn, rows_per_split, splits, vec,
               vec_out};
  return static_cast<int>(
      launch_any<Fp32Rows, true>(qt, metric, Fp32Rows{corpus}, a, stream));
}
