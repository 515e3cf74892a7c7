// The register-blocked fp32 tile product of the quantized key kernel
// (range_batch.cuh: quant_keys_batch.cu), and the chunk depth and query
// norms that every kernel keeping these keys bit for bit shares
// (scan_topk_batch.cu, range_scan_batch.cu, quant_scan_topk_batch.cu,
// pairwise_keys.cu, replay_keys.cu).
//
// A block of kThreads threads scores a kRows-row corpus tile against its QT
// queries with plain fp32 FMAs (no TF32, no tensor cores).  Thread
// (tr, tq) = (tid % TR, tid / TR) keeps rows tr + TR*i and queries
// tq + TQ*j in registers; kDepth columns of D at a time are staged through
// shared memory, transposed, with padded strides so the stores are
// conflict-free.  Each (row, query) dot product is summed over D in the same
// order whatever QT, TR and the launch geometry, so a pair's key is bitwise
// the same at every batch size.  Corpus elements reach the staging through a
// row loader (Fp32Rows, Int8Rows, Bf16Rows): the quantized kernels stage
// the dequantized fp32 value, and from the staging on every instantiation
// runs the same FMAs in the same order.
#pragma once

#include "topk_common.cuh"

namespace repro_tile {

using repro_topk::kInnerProduct;
using repro_topk::kThreads;

// Row loaders: element `idx` = row * d + col of the corpus as fp32.
struct Fp32Rows {
  const float* x;
  __device__ __forceinline__ float operator()(int, size_t idx) const {
    return __ldg(x + idx);
  }
};

// int8 rows times their per-row fp32 scale: one rounded fp32 product, the
// reference's `q.astype(f32) * s`.
struct Int8Rows {
  const int8_t* q;
  const float* scales;
  __device__ __forceinline__ float operator()(int row, size_t idx) const {
    return static_cast<float>(__ldg(q + idx)) * __ldg(scales + row);
  }
};

// bf16 rows (raw 16-bit patterns) widened exactly to fp32; their scales are
// ones by construction and are not read.
struct Bf16Rows {
  const uint16_t* q;
  __device__ __forceinline__ float operator()(int, size_t idx) const {
    return __uint_as_float(static_cast<unsigned int>(__ldg(q + idx)) << 16);
  }
};

constexpr int kRows = 64;   // corpus rows per tile
constexpr int kDepth = 32;  // columns of D staged in shared memory at once

template <int QT, int TR>
struct TileShape {
  static constexpr int TQ = kThreads / TR;
  static constexpr int RPT = kRows / TR;  // rows per thread
  static constexpr int QPT = QT / TQ;     // queries per thread
  static constexpr int RS = kRows + 1;    // padded strides
  static constexpr int QS = QT + 1;
  // floats of dynamic shared memory the staging needs: [kDepth][RS] rows
  // followed by [kDepth][QS] queries
  static constexpr int kStageFloats = kDepth * (RS + QS);
  static_assert(RPT >= 1 && QPT >= 1, "tile does not cover the block");
};

// Squared norms of the block's queries q0 .. q0 + QT - 1 into s_qq (0 past
// qn), one warp per query.  The caller synchronises before reading s_qq.
template <int QT>
__device__ __forceinline__ void query_norms(const float* __restrict__ queries,
                                            int q0, int qn, int d,
                                            float* s_qq) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int qi = warp; qi < QT; qi += kThreads / 32) {
    float qq = 0.f;
    if (q0 + qi < qn) {
      const float* qp = queries + static_cast<size_t>(q0 + qi) * d;
      for (int i = lane; i < d; i += 32) qq = fmaf(qp[i], qp[i], qq);
    }
    for (int o = 16; o > 0; o >>= 1) qq += __shfl_xor_sync(0xffffffffu, qq, o);
    if (lane == 0) s_qq[qi] = qq;
  }
}

// acc[i][j] = <row t0 + tr + TR*i, query q0 + tq + TQ*j> and, unless the
// metric is inner product, xx[i] = the row's squared norm; rows at or past
// row_end and queries at or past qn read as zeros.  Every thread of the
// block calls it together: it synchronises before each staging step (so
// the previous tile's readers are done) and after it.  Per pair, the dot
// and the norm are one fmaf chain over d = 0 .. ceil(D / kDepth)·kDepth − 1
// (zeros past D): replay_keys.cu reproduces it pair by pair.
template <int QT, int TR, int METRIC, typename Rows>
__device__ __forceinline__ void tile_product(
    const Rows& corpus, const float* __restrict__ queries,
    int t0, int row_end, int q0, int qn, int d, float* r_s, float* q_s,
    float (&acc)[TileShape<QT, TR>::RPT][TileShape<QT, TR>::QPT],
    float (&xx)[TileShape<QT, TR>::RPT]) {
  using S = TileShape<QT, TR>;
  const int tid = threadIdx.x;
  const int tr = tid % TR;
  const int tq = tid / TR;
#pragma unroll
  for (int i = 0; i < S::RPT; ++i) {
    xx[i] = 0.f;
#pragma unroll
    for (int j = 0; j < S::QPT; ++j) acc[i][j] = 0.f;
  }
  for (int d0 = 0; d0 < d; d0 += kDepth) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < kRows * kDepth; e += kThreads) {
      const int row = e / kDepth, c = e % kDepth;
      const int gr = t0 + row, gc = d0 + c;
      r_s[c * S::RS + row] = (gr < row_end && gc < d)
          ? corpus(gr, static_cast<size_t>(gr) * d + gc) : 0.f;
    }
    for (int e = tid; e < QT * kDepth; e += kThreads) {
      const int qi = e / kDepth, c = e % kDepth;
      const int gq = q0 + qi, gc = d0 + c;
      q_s[c * S::QS + qi] = (gq < qn && gc < d)
          ? __ldg(queries + static_cast<size_t>(gq) * d + gc) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kDepth; ++c) {
      float a[S::RPT], b[S::QPT];
#pragma unroll
      for (int i = 0; i < S::RPT; ++i) a[i] = r_s[c * S::RS + tr + TR * i];
#pragma unroll
      for (int j = 0; j < S::QPT; ++j) b[j] = q_s[c * S::QS + tq + S::TQ * j];
#pragma unroll
      for (int i = 0; i < S::RPT; ++i) {
        if (METRIC != kInnerProduct) xx[i] = fmaf(a[i], a[i], xx[i]);
#pragma unroll
        for (int j = 0; j < S::QPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
}

}  // namespace repro_tile
