// The query-batched scan + filter + top-k kernel, shared by
// scan_topk_batch.cu (fp32 rows, one row per candidate) and
// quant_scan_topk_batch.cu (int8 / bf16 rows, one SEG-row segment per
// candidate).
//
// A block owns QT queries and one contiguous corpus split and loops over
// the split in 64-row tiles (fp32_tile.cuh).  Each (row, query) key is
// masked in registers; with SEG > 1 the SEG keys of a segment, which sit in
// SEG neighbouring lanes of one warp (thread tr owns rows tr + TR*i, and TR
// and the tile start are multiples of SEG), are reduced to their minimum by
// shuffles and only the segment's first lane goes on.  A candidate enters
// its query's buffer only if it beats the query's current k-th key; a
// query's list is re-sorted (bitonic, shared memory) only when its buffer
// could overflow.  Output per query and split: the best k (key, global
// row // SEG) pairs, ascending by key and then id, (+inf, -1) in empty
// slots.
#pragma once

#include "fp32_tile.cuh"

namespace repro_topk_batch {

using namespace repro_topk;
using repro_tile::kDepth;
using repro_tile::kRows;
using repro_tile::TileShape;

enum MaskMode : int { kNoMask = 0, kSharedMask = 1, kPerQueryMask = 2 };

template <int QT, int TR, int METRIC, int SEG, typename Rows>
__global__ void __launch_bounds__(kThreads) topk_batch_kernel(
    Rows corpus, const float* __restrict__ queries,
    const int8_t* __restrict__ mask, int mask_mode,
    const int8_t* __restrict__ qvalid, float* __restrict__ out_keys,
    int* __restrict__ out_ids, int n, int d, int qn, int k, int kp,
    int rows_per_split, int splits) {
  using S = TileShape<QT, TR>;
  constexpr int TQ = S::TQ;
  constexpr int RPT = S::RPT;
  constexpr int QPT = S::QPT;
  static_assert(TR % SEG == 0 && kRows % SEG == 0, "segments straddle lanes");
  const int seg = 2 * kp;

  extern __shared__ float smem[];
  float* r_s = smem;                                 // tile staging
  float* q_s = r_s + kDepth * S::RS;
  float* l_keys = smem + S::kStageFloats;            // [QT][seg]
  int* l_ids = reinterpret_cast<int*>(l_keys + QT * seg);
  __shared__ int s_cnt[QT];
  __shared__ int s_need[QT];
  __shared__ int s_flag[QT];
  __shared__ int s_live[QT];
  __shared__ float s_thr[QT];
  __shared__ float s_qq[QT];
  __shared__ int s_any;

  const int tid = threadIdx.x;
  const int tr = tid % TR;
  const int tq = tid / TR;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const int row0 = split * rows_per_split;
  const int row_end = min(n, row0 + rows_per_split);

  for (int i = tid; i < QT * seg; i += kThreads) {
    l_keys[i] = pos_inf();
    l_ids[i] = kEmptyId;
  }
  for (int qi = tid; qi < QT; qi += kThreads) {
    const int q = q0 + qi;
    s_cnt[qi] = 0;
    s_need[qi] = 0;
    s_thr[qi] = pos_inf();
    s_live[qi] = q < qn && (qvalid == nullptr || qvalid[q] != 0);
  }
  repro_tile::query_norms<QT>(queries, q0, qn, d, s_qq);
  __syncthreads();

  for (int t0 = row0; t0 < row_end; t0 += kRows) {
    float acc[RPT][QPT];
    float xx[RPT];
    repro_tile::tile_product<QT, TR, METRIC>(corpus, queries, t0, row_end, q0,
                                             qn, d, r_s, q_s, acc, xx);
    // epilogue: keys, masks, and the count of candidates per query
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = t0 + tr + TR * i;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int qi = tq + TQ * j;
        bool live = row < row_end && s_live[qi] != 0;
        if (live && mask_mode == kSharedMask) live = mask[row] != 0;
        if (live && mask_mode == kPerQueryMask)
          live = mask[static_cast<size_t>(q0 + qi) * n + row] != 0;
        const float key = order_key<METRIC>(acc[i][j], xx[i], s_qq[qi]);
        acc[i][j] = live ? key : pos_inf();
        if constexpr (SEG == 1) {
          if (acc[i][j] < s_thr[qi]) atomicAdd(&s_need[qi], 1);
        }
      }
    }
    if constexpr (SEG > 1) {
      // segment minima across the SEG lanes; only the first lane of a
      // segment stays a candidate
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          const int qi = tq + TQ * j;
          float v = acc[i][j];
#pragma unroll
          for (int o = 1; o < SEG; o <<= 1)
            v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
          acc[i][j] = tr % SEG == 0 ? v : pos_inf();
          if (acc[i][j] < s_thr[qi]) atomicAdd(&s_need[qi], 1);
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      int any = 0;
      for (int qi = 0; qi < QT; ++qi) {
        s_flag[qi] = s_cnt[qi] + s_need[qi] > kp;
        any |= s_flag[qi];
      }
      s_any = any;
    }
    __syncthreads();
    if (s_any) {
      sort_segments(l_keys, l_ids, QT, seg, s_flag);
      reset_buffers(l_keys, l_ids, QT, seg, kp, k, s_flag, s_cnt, s_thr);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = t0 + tr + TR * i;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int qi = tq + TQ * j;
        if (acc[i][j] < s_thr[qi]) {
          const int pos = atomicAdd(&s_cnt[qi], 1);
          l_keys[qi * seg + kp + pos] = acc[i][j];
          l_ids[qi * seg + kp + pos] = row / SEG;
        }
      }
    }
    for (int qi = tid; qi < QT; qi += kThreads) s_need[qi] = 0;
  }
  __syncthreads();
  if (tid == 0) {
    int any = 0;
    for (int qi = 0; qi < QT; ++qi) {
      s_flag[qi] = s_cnt[qi] > 0;
      any |= s_flag[qi];
    }
    s_any = any;
  }
  __syncthreads();
  if (s_any) sort_segments(l_keys, l_ids, QT, seg, s_flag);
  const size_t width = static_cast<size_t>(splits) * k;
  for (int e = tid; e < QT * k; e += kThreads) {
    const int qi = e / k, j = e % k;
    if (q0 + qi >= qn) continue;
    const float key = l_keys[qi * seg + j];
    const bool found = key < pos_inf();
    const size_t o = static_cast<size_t>(q0 + qi) * width +
                     static_cast<size_t>(split) * k + j;
    out_keys[o] = found ? key : pos_inf();
    out_ids[o] = found ? l_ids[qi * seg + j] : -1;
  }
}

template <int QT, int TR, int METRIC, int SEG, typename Rows>
cudaError_t launch(Rows corpus, const float* queries, const int8_t* mask,
                   int mask_mode, const int8_t* qvalid, float* out_keys,
                   int* out_ids, int n, int d, int qn, int k,
                   int rows_per_split, int splits, cudaStream_t stream) {
  const int kp = next_pow2(k < kRows ? kRows : k);
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(TileShape<QT, TR>::kStageFloats) +
       static_cast<size_t>(2) * QT * 2 * kp);
  auto kernel = topk_batch_kernel<QT, TR, METRIC, SEG, Rows>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((qn + QT - 1) / QT, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      corpus, queries, mask, mask_mode, qvalid, out_keys, out_ids, n, d, qn,
      k, kp, rows_per_split, splits);
  return cudaGetLastError();
}

// Every (metric, qt) instantiation of one row loader.  `qt` (queries per
// block) is 4, 16 or 64; the caller sizes it so that qt·2·kp (key, id)
// pairs fit in shared memory, kp = next power of two >= max(k, 64).
template <int SEG, typename Rows>
cudaError_t launch_any(int metric, int qt, Rows corpus, const float* queries,
                       const int8_t* mask, int mask_mode,
                       const int8_t* qvalid, float* out_keys, int* out_ids,
                       int n, int d, int qn, int k, int rows_per_split,
                       int splits, cudaStream_t stream) {
#define REPRO_TOPK_BATCH_LAUNCH(QT_, TR_, M_)                                 \
  launch<QT_, TR_, M_, SEG, Rows>(corpus, queries, mask, mask_mode, qvalid,   \
                                  out_keys, out_ids, n, d, qn, k,             \
                                  rows_per_split, splits, stream)
#define REPRO_TOPK_BATCH_BY_QT(M_)                                            \
  switch (qt) {                                                               \
    case 64: return REPRO_TOPK_BATCH_LAUNCH(64, 16, M_);                      \
    case 16: return REPRO_TOPK_BATCH_LAUNCH(16, 16, M_);                      \
    case 4: return REPRO_TOPK_BATCH_LAUNCH(4, 64, M_);                        \
    default: return cudaErrorInvalidValue;                                    \
  }
  switch (metric) {
    case kInnerProduct: REPRO_TOPK_BATCH_BY_QT(kInnerProduct)
    case kL2: REPRO_TOPK_BATCH_BY_QT(kL2)
    case kCosine: REPRO_TOPK_BATCH_BY_QT(kCosine)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_TOPK_BATCH_BY_QT
#undef REPRO_TOPK_BATCH_LAUNCH
}

}  // namespace repro_topk_batch
