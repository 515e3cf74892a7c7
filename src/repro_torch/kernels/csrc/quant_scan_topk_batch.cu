// Query-batched quantized scan + filter + segment top-k, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `quant_scan_topk_batch_pallas`
// (src/repro/kernels/quant.py, body `_quant_topk_batch_kernel`): order keys
// of every (dequantized corpus row, query) pair, the shared (N,) or
// per-query (Q, N) row mask ANDed with the per-query valid lane, the
// minimum key of every SEG = 8-row segment (segment = row // 8, global),
// and each query's best `k` segments per corpus split, ascending by key and
// then segment id, (+inf, -1) in empty slots.  Stage 2 (kernels/quant.py)
// merges them, expands the segments back to rows and re-ranks those rows
// with the exact fp32 keys of replay_keys.cu.
//
// Bound on the H100 at N = 1,000,000, D = 512: bytes at a few queries (the
// int8 twin is 0.51 GB and the bf16 twin 1.02 GB against the fp32 corpus's
// 2.05 GB: 0.154 ms and 0.306 ms against 0.612 ms at 3.35 TB/s), operations
// at 100 queries (2·N·D·Q = 102 GFLOP of fp32 FMAs, 1.528 ms at 67 TFLOP/s,
// for every mode: int8 rows are widened and scaled to fp32, never fed to an
// int8 dot, which would quantize the query and break the range path's
// slack bound).  Design:
//   * the fp32 kernel's own body (topk_batch.cuh) with an int8 or bf16 row
//     loader (fp32_tile.cuh): a row element is widened (times its row scale
//     for int8) as it is staged into shared memory, and the tile product
//     from there on is the fp32 kernel's;
//   * a thread owns rows tr + TR·i, so a segment's 8 rows sit in 8
//     neighbouring lanes of one warp: three shuffles give the segment
//     minimum, and only the segment's first lane competes for the query's
//     candidate buffer — the selection handles 8× fewer candidates than
//     the fp32 kernel's;
//   * the caller keeps splits to at most 8·1024 rows (1,024 segments), so
//     a split that cannot hold the c·k segments stage 2 needs emits all of
//     its segments, and the superset guarantee of the reference's
//     128-segment blocks holds for every c·k.
#include "topk_batch.cuh"

// Returns the launch's cudaError_t (0 on success).  `mode` is 0 for int8
// rows with (n,) fp32 `scales`, 1 for bf16 rows (`scales` not read);
// `k` is the segment count per split, `rows_per_split` a multiple of 64.
// The other arguments are scan_topk_batch_launch's.
extern "C" int quant_scan_topk_batch_launch(
    const void* qcorpus, const float* scales, int mode, const float* queries,
    const int8_t* mask, int mask_mode, const int8_t* qvalid,
    float* out_keys, int* out_ids, int n, int d, int qn, int k, int metric,
    int qt, int rows_per_split, int splits, cudaStream_t stream) {
  using repro_topk_batch::launch_any;
  constexpr int kSeg = 8;
  if (mode == 0)
    return static_cast<int>(launch_any<kSeg>(
        metric, qt,
        repro_tile::Int8Rows{static_cast<const int8_t*>(qcorpus), scales},
        queries, mask, mask_mode, qvalid, out_keys, out_ids, n, d, qn, k,
        rows_per_split, splits, stream));
  if (mode == 1)
    return static_cast<int>(launch_any<kSeg>(
        metric, qt, repro_tile::Bf16Rows{static_cast<const uint16_t*>(qcorpus)},
        queries, mask, mask_mode, qvalid, out_keys, out_ids, n, d, qn, k,
        rows_per_split, splits, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}
