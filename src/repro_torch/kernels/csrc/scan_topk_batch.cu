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
#include "topk_common.cuh"

namespace {

using namespace repro_topk;

constexpr int kRows = 64;   // corpus rows per tile
constexpr int kDepth = 32;  // columns of D staged in shared memory at once

enum MaskMode : int { kNoMask = 0, kSharedMask = 1, kPerQueryMask = 2 };

template <int QT, int TR, int METRIC>
__global__ void __launch_bounds__(kThreads) scan_topk_batch_kernel(
    const float* __restrict__ corpus, const float* __restrict__ queries,
    const int8_t* __restrict__ mask, int mask_mode,
    const int8_t* __restrict__ qvalid, float* __restrict__ out_keys,
    int* __restrict__ out_ids, int n, int d, int qn, int k, int kp,
    int rows_per_split, int splits) {
  constexpr int TQ = kThreads / TR;
  constexpr int RPT = kRows / TR;  // rows per thread
  constexpr int QPT = QT / TQ;     // queries per thread
  static_assert(RPT >= 1 && QPT >= 1, "tile does not cover the block");
  constexpr int RS = kRows + 1;    // padded strides: conflict-free stores
  constexpr int QS = QT + 1;
  const int seg = 2 * kp;

  extern __shared__ float smem[];
  float* r_s = smem;                                 // [kDepth][RS]
  float* q_s = r_s + kDepth * RS;                    // [kDepth][QS]
  float* l_keys = q_s + kDepth * QS;                 // [QT][seg]
  int* l_ids = reinterpret_cast<int*>(l_keys + QT * seg);
  __shared__ int s_cnt[QT];
  __shared__ int s_need[QT];
  __shared__ int s_flag[QT];
  __shared__ int s_live[QT];
  __shared__ float s_thr[QT];
  __shared__ float s_qq[QT];
  __shared__ int s_any;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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
  for (int qi = warp; qi < QT; qi += kThreads / 32) {
    float qq = 0.f;
    if (q0 + qi < qn) {
      const float* qp = queries + static_cast<size_t>(q0 + qi) * d;
      for (int i = lane; i < d; i += 32) qq = fmaf(qp[i], qp[i], qq);
    }
    for (int o = 16; o > 0; o >>= 1) qq += __shfl_xor_sync(0xffffffffu, qq, o);
    if (lane == 0) s_qq[qi] = qq;
  }
  __syncthreads();

  for (int t0 = row0; t0 < row_end; t0 += kRows) {
    float acc[RPT][QPT];
    float xx[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      xx[i] = 0.f;
#pragma unroll
      for (int j = 0; j < QPT; ++j) acc[i][j] = 0.f;
    }
    for (int d0 = 0; d0 < d; d0 += kDepth) {
      __syncthreads();  // the previous chunk's readers are done
      for (int e = tid; e < kRows * kDepth; e += kThreads) {
        const int row = e / kDepth, c = e % kDepth;
        const int gr = t0 + row, gc = d0 + c;
        r_s[c * RS + row] = (gr < row_end && gc < d)
            ? __ldg(corpus + static_cast<size_t>(gr) * d + gc) : 0.f;
      }
      for (int e = tid; e < QT * kDepth; e += kThreads) {
        const int qi = e / kDepth, c = e % kDepth;
        const int gq = q0 + qi, gc = d0 + c;
        q_s[c * QS + qi] = (gq < qn && gc < d)
            ? __ldg(queries + static_cast<size_t>(gq) * d + gc) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kDepth; ++c) {
        float a[RPT], b[QPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = r_s[c * RS + tr + TR * i];
#pragma unroll
        for (int j = 0; j < QPT; ++j) b[j] = q_s[c * QS + tq + TQ * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          if (METRIC != kInnerProduct) xx[i] = fmaf(a[i], a[i], xx[i]);
#pragma unroll
          for (int j = 0; j < QPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
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
      (static_cast<size_t>(kDepth) * (kRows + 1 + QT + 1) +
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
