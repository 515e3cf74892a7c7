// The query-batched key kernel behind quant_keys_batch.cu (int8 / bf16
// rows; masked keys only, no radius).  Its HITS form (keys, hits and counts
// against a per-query radius) has no caller.
//
// A block owns QT queries and one contiguous corpus split and scores it in
// 64-row tiles (fp32_tile.cuh).  The epilogue masks each (row, query) key
// in registers and writes it straight to the query-major (Q, N) output,
// neighbouring threads on neighbouring rows; with HITS it also writes the
// int8 hit, sums hits per thread, then per block in shared memory, and adds
// them to each query's count with one integer atomicAdd per block.  Every
// output and mask offset is computed in 64 bits: Q·N passes 2^31 at about
// 2,100 queries of a 1M-row corpus, and Q·N·4 bytes at 540.
#pragma once

#include "fp32_tile.cuh"

namespace repro_range_batch {

using namespace repro_topk;
using repro_tile::kDepth;
using repro_tile::kRows;
using repro_tile::TileShape;

enum MaskMode : int { kNoMask = 0, kSharedMask = 1, kPerQueryMask = 2 };

// Without HITS, `radius_keys`, `out_hits` and `counts` are not read or
// written (null), and a key is +inf only on a dead lane.
template <int QT, int TR, int METRIC, bool HITS, typename Rows>
__global__ void __launch_bounds__(kThreads) range_batch_kernel(
    Rows corpus, const float* __restrict__ queries,
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
    if constexpr (HITS) s_rk[qi] = q < qn ? radius_keys[q] : -pos_inf();
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
        if constexpr (HITS) {
          const bool hit = live && key <= s_rk[qi];
          out_keys[o] = hit ? key : pos_inf();
          out_hits[o] = hit ? 1 : 0;
          hits[j] += hit ? 1 : 0;
        } else {
          out_keys[o] = live ? key : pos_inf();
        }
      }
    }
  }
  if constexpr (HITS) {
#pragma unroll
    for (int j = 0; j < QPT; ++j)
      if (hits[j] > 0) atomicAdd(&s_cnt[tq + TQ * j], hits[j]);
    __syncthreads();
    for (int qi = tid; qi < QT; qi += kThreads)
      if (q0 + qi < qn && s_cnt[qi] > 0)
        atomicAdd(&counts[q0 + qi], s_cnt[qi]);
  }
}

template <int QT, int TR, int METRIC, bool HITS, typename Rows>
cudaError_t launch(Rows corpus, const float* queries,
                   const float* radius_keys, const int8_t* mask,
                   int mask_mode, const int8_t* qvalid, float* out_keys,
                   int8_t* out_hits, int* counts, int n, int d, int qn,
                   int rows_per_split, int splits, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * static_cast<size_t>(TileShape<QT, TR>::kStageFloats);
  auto kernel = range_batch_kernel<QT, TR, METRIC, HITS, Rows>;
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

// Every (metric, qt) instantiation of one row loader; `qt` (queries per
// block) is 4, 16 or 64.
template <bool HITS, typename Rows>
cudaError_t launch_any(int metric, int qt, Rows corpus, const float* queries,
                       const float* radius_keys, const int8_t* mask,
                       int mask_mode, const int8_t* qvalid, float* out_keys,
                       int8_t* out_hits, int* counts, int n, int d, int qn,
                       int rows_per_split, int splits, cudaStream_t stream) {
#define REPRO_RANGE_BATCH_LAUNCH(QT_, TR_, M_)                                \
  launch<QT_, TR_, M_, HITS, Rows>(corpus, queries, radius_keys, mask,        \
                                   mask_mode, qvalid, out_keys, out_hits,     \
                                   counts, n, d, qn, rows_per_split, splits,  \
                                   stream)
#define REPRO_RANGE_BATCH_BY_QT(M_)                                           \
  switch (qt) {                                                               \
    case 64: return REPRO_RANGE_BATCH_LAUNCH(64, 16, M_);                     \
    case 16: return REPRO_RANGE_BATCH_LAUNCH(16, 16, M_);                     \
    case 4: return REPRO_RANGE_BATCH_LAUNCH(4, 64, M_);                       \
    default: return cudaErrorInvalidValue;                                    \
  }
  switch (metric) {
    case kInnerProduct: REPRO_RANGE_BATCH_BY_QT(kInnerProduct)
    case kL2: REPRO_RANGE_BATCH_BY_QT(kL2)
    case kCosine: REPRO_RANGE_BATCH_BY_QT(kCosine)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_RANGE_BATCH_BY_QT
#undef REPRO_RANGE_BATCH_LAUNCH
}

}  // namespace repro_range_batch
