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
// merge is plain torch (kernels/ops.py).
#include "fp32_tile.cuh"

namespace {

using namespace repro_topk;
using repro_tile::kDepth;
using repro_tile::kRows;
using repro_tile::TileShape;

enum MaskMode : int { kNoMask = 0, kSharedMask = 1, kPerQueryMask = 2 };

template <int QT, int TR, int METRIC>
__global__ void __launch_bounds__(kThreads) scan_topk_batch_kernel(
    const float* __restrict__ corpus, const float* __restrict__ queries,
    const int8_t* __restrict__ mask, int mask_mode,
    const int8_t* __restrict__ qvalid, float* __restrict__ out_keys,
    int* __restrict__ out_ids, int n, int d, int qn, int k, int kp,
    int rows_per_split, int splits) {
  using S = TileShape<QT, TR>;
  constexpr int TQ = S::TQ;
  constexpr int RPT = S::RPT;
  constexpr int QPT = S::QPT;
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
        if (acc[i][j] < s_thr[qi]) atomicAdd(&s_need[qi], 1);
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
          l_ids[qi * seg + kp + pos] = row;
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

template <int QT, int TR, int METRIC>
cudaError_t launch(const float* corpus, const float* queries,
                   const int8_t* mask, int mask_mode, const int8_t* qvalid,
                   float* out_keys, int* out_ids, int n, int d, int qn, int k,
                   int rows_per_split, int splits, cudaStream_t stream) {
  const int kp = next_pow2(k < kRows ? kRows : k);
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(TileShape<QT, TR>::kStageFloats) +
       static_cast<size_t>(2) * QT * 2 * kp);
  auto kernel = scan_topk_batch_kernel<QT, TR, METRIC>;
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

template <int METRIC>
cudaError_t launch_qt(int qt, const float* corpus, const float* queries,
                      const int8_t* mask, int mask_mode, const int8_t* qvalid,
                      float* out_keys, int* out_ids, int n, int d, int qn,
                      int k, int rows_per_split, int splits,
                      cudaStream_t stream) {
  switch (qt) {
    case 64:
      return launch<64, 16, METRIC>(corpus, queries, mask, mask_mode, qvalid,
                                    out_keys, out_ids, n, d, qn, k,
                                    rows_per_split, splits, stream);
    case 16:
      return launch<16, 16, METRIC>(corpus, queries, mask, mask_mode, qvalid,
                                    out_keys, out_ids, n, d, qn, k,
                                    rows_per_split, splits, stream);
    case 4:
      return launch<4, 64, METRIC>(corpus, queries, mask, mask_mode, qvalid,
                                   out_keys, out_ids, n, d, qn, k,
                                   rows_per_split, splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

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
  switch (metric) {
    case kInnerProduct:
      return launch_qt<kInnerProduct>(qt, corpus, queries, mask, mask_mode,
                                      qvalid, out_keys, out_ids, n, d, qn, k,
                                      rows_per_split, splits, stream);
    case kL2:
      return launch_qt<kL2>(qt, corpus, queries, mask, mask_mode, qvalid,
                            out_keys, out_ids, n, d, qn, k, rows_per_split,
                            splits, stream);
    case kCosine:
      return launch_qt<kCosine>(qt, corpus, queries, mask, mask_mode, qvalid,
                                out_keys, out_ids, n, d, qn, k,
                                rows_per_split, splits, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
