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
#include "fp32_tile.cuh"

namespace {

using namespace repro_topk;
using repro_tile::kDepth;
using repro_tile::kRows;
using repro_tile::TileShape;

enum MaskMode : int { kNoMask = 0, kSharedMask = 1, kPerQueryMask = 2 };

template <int QT, int TR, int METRIC>
__global__ void __launch_bounds__(kThreads) range_scan_batch_kernel(
    const float* __restrict__ corpus, const float* __restrict__ queries,
    const float* __restrict__ radius_keys, const int8_t* __restrict__ mask,
    int mask_mode, const int8_t* __restrict__ qvalid,
    float* __restrict__ out_keys, int8_t* __restrict__ out_hits,
    int* __restrict__ counts, int n, int d, int qn, int rows_per_split) {
  using S = TileShape<QT, TR>;
  constexpr int TQ = S::TQ;
  constexpr int RPT = S::RPT;
  constexpr int QPT = S::QPT;

  extern __shared__ float smem[];
  float* r_s = smem;
  float* q_s = r_s + kDepth * S::RS;
  __shared__ float s_qq[QT];
  __shared__ float s_rk[QT];
  __shared__ int s_live[QT];
  __shared__ int s_cnt[QT];

  const int tid = threadIdx.x;
  const int tr = tid % TR;
  const int tq = tid / TR;
  const int q0 = blockIdx.x * QT;
  const int row0 = blockIdx.y * rows_per_split;
  const int row_end = min(n, row0 + rows_per_split);

  for (int qi = tid; qi < QT; qi += kThreads) {
    const int q = q0 + qi;
    s_cnt[qi] = 0;
    s_live[qi] = q < qn && (qvalid == nullptr || qvalid[q] != 0);
    s_rk[qi] = q < qn ? radius_keys[q] : -pos_inf();
  }
  repro_tile::query_norms<QT>(queries, q0, qn, d, s_qq);
  __syncthreads();

  int hits[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) hits[j] = 0;
  for (int t0 = row0; t0 < row_end; t0 += kRows) {
    float acc[RPT][QPT];
    float xx[RPT];
    repro_tile::tile_product<QT, TR, METRIC>(corpus, queries, t0, row_end, q0,
                                             qn, d, r_s, q_s, acc, xx);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = t0 + tr + TR * i;
      if (row >= row_end) continue;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int qi = tq + TQ * j;
        const int q = q0 + qi;
        if (q >= qn) continue;
        const size_t o = static_cast<size_t>(q) * n + row;
        bool live = s_live[qi] != 0;
        if (live && mask_mode == kSharedMask) live = mask[row] != 0;
        if (live && mask_mode == kPerQueryMask) live = mask[o] != 0;
        const float key = order_key<METRIC>(acc[i][j], xx[i], s_qq[qi]);
        const bool hit = live && key <= s_rk[qi];
        out_keys[o] = hit ? key : pos_inf();
        out_hits[o] = hit ? 1 : 0;
        hits[j] += hit ? 1 : 0;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < QPT; ++j)
    if (hits[j] > 0) atomicAdd(&s_cnt[tq + TQ * j], hits[j]);
  __syncthreads();
  for (int qi = tid; qi < QT; qi += kThreads)
    if (q0 + qi < qn && s_cnt[qi] > 0) atomicAdd(&counts[q0 + qi], s_cnt[qi]);
}

template <int QT, int TR, int METRIC>
cudaError_t launch(const float* corpus, const float* queries,
                   const float* radius_keys, const int8_t* mask,
                   int mask_mode, const int8_t* qvalid, float* out_keys,
                   int8_t* out_hits, int* counts, int n, int d, int qn,
                   int rows_per_split, int splits, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * static_cast<size_t>(TileShape<QT, TR>::kStageFloats);
  auto kernel = range_scan_batch_kernel<QT, TR, METRIC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((qn + QT - 1) / QT, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      corpus, queries, radius_keys, mask, mask_mode, qvalid, out_keys,
      out_hits, counts, n, d, qn, rows_per_split);
  return cudaGetLastError();
}

template <int METRIC>
cudaError_t launch_qt(int qt, const float* corpus, const float* queries,
                      const float* radius_keys, const int8_t* mask,
                      int mask_mode, const int8_t* qvalid, float* out_keys,
                      int8_t* out_hits, int* counts, int n, int d, int qn,
                      int rows_per_split, int splits, cudaStream_t stream) {
  switch (qt) {
    case 64:
      return launch<64, 16, METRIC>(corpus, queries, radius_keys, mask,
                                    mask_mode, qvalid, out_keys, out_hits,
                                    counts, n, d, qn, rows_per_split, splits,
                                    stream);
    case 16:
      return launch<16, 16, METRIC>(corpus, queries, radius_keys, mask,
                                    mask_mode, qvalid, out_keys, out_hits,
                                    counts, n, d, qn, rows_per_split, splits,
                                    stream);
    case 4:
      return launch<4, 64, METRIC>(corpus, queries, radius_keys, mask,
                                   mask_mode, qvalid, out_keys, out_hits,
                                   counts, n, d, qn, rows_per_split, splits,
                                   stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

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
  switch (metric) {
    case kInnerProduct:
      return launch_qt<kInnerProduct>(qt, corpus, queries, radius_keys, mask,
                                      mask_mode, qvalid, out_keys, out_hits,
                                      counts, n, d, qn, rows_per_split,
                                      splits, stream);
    case kL2:
      return launch_qt<kL2>(qt, corpus, queries, radius_keys, mask,
                            mask_mode, qvalid, out_keys, out_hits, counts, n,
                            d, qn, rows_per_split, splits, stream);
    case kCosine:
      return launch_qt<kCosine>(qt, corpus, queries, radius_keys, mask,
                                mask_mode, qvalid, out_keys, out_hits, counts,
                                n, d, qn, rows_per_split, splits, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
