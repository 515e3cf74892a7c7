// Pairwise order-key matrix (a GEMM with a metric epilogue), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `pairwise_keys_pallas` (src/repro/kernels/
// distance.py, body `_pairwise_kernel`): for every (query, corpus row) pair
// the order key, smaller = better, written query-major (Q, N) in fp32:
//   inner product  −ip
//   L2             ‖q‖² − 2·ip + ‖c‖²            (the TPU kernel's order)
//   cosine         −ip / (‖q‖·‖c‖ + 1e-12)
// No mask, no radius, no selection.
//
// Bound on the H100 at Q = 100, N = 1,000,000, D = 512, fp32 without TF32:
// operations.  2·Q·N·D = 102 GFLOP at the 67 TFLOP/s fp32 CUDA-core peak is
// 1.528 ms, against 0.731 ms to read the 2.05 GB corpus and write the
// 0.4 GB key matrix once.  Design: the register-blocked fp32 tile product of
// the batched scans (fp32_tile.cuh): a block owns QT queries and one
// contiguous corpus split and scores it in 64-row tiles, plain fp32 FMAs
// staged through shared memory, so a corpus byte read from memory feeds QT
// queries; the tile also sums each row's squared norm and query_norms the
// queries', so the kernel needs no norm inputs.  The epilogue writes each
// key straight to the query-major output, neighbouring threads on
// neighbouring rows, every offset in 64 bits (Q·N·4 bytes passes 2^31 at
// 540 queries of a 1M-row corpus).  Q, N and D are ragged: the tile reads
// zeros past D and past the last row and query.
#include "fp32_tile.cuh"

namespace {

using namespace repro_topk;
using repro_tile::kDepth;
using repro_tile::kRows;
using repro_tile::TileShape;

// The TPU kernel's metric epilogue, written as rounded intrinsics so that
// nvcc cannot contract a product and a sum into one FMA.
template <int METRIC>
__device__ __forceinline__ float pairwise_key(float ip, float cc, float qq) {
  if (METRIC == kInnerProduct) return -ip;
  if (METRIC == kL2) return __fadd_rn(__fsub_rn(qq, __fmul_rn(2.0f, ip)), cc);
  return -__fdiv_rn(ip, __fadd_rn(__fmul_rn(sqrtf(qq), sqrtf(cc)), 1e-12f));
}

template <int QT, int TR, int METRIC>
__global__ void __launch_bounds__(kThreads) pairwise_keys_kernel(
    const float* __restrict__ corpus, const float* __restrict__ queries,
    float* __restrict__ out_keys, int n, int d, int qn, int rows_per_split) {
  using S = TileShape<QT, TR>;
  constexpr int TQ = S::TQ;
  constexpr int RPT = S::RPT;
  constexpr int QPT = S::QPT;

  extern __shared__ float smem[];
  float* r_s = smem;
  float* q_s = r_s + kDepth * S::RS;
  __shared__ float s_qq[QT];

  const int tid = threadIdx.x;
  const int tr = tid % TR;
  const int tq = tid / TR;
  const int q0 = blockIdx.x * QT;
  const int row0 = blockIdx.y * rows_per_split;
  const int row_end = min(n, row0 + rows_per_split);

  if (METRIC != kInnerProduct)
    repro_tile::query_norms<QT>(queries, q0, qn, d, s_qq);
  // tile_product synchronises before it stages anything, so s_qq is
  // written before any epilogue reads it
  const repro_tile::Fp32Rows rows{corpus};
  for (int t0 = row0; t0 < row_end; t0 += kRows) {
    float acc[RPT][QPT];
    float cc[RPT];
    repro_tile::tile_product<QT, TR, METRIC>(rows, queries, t0, row_end, q0,
                                             qn, d, r_s, q_s, acc, cc);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = t0 + tr + TR * i;
      if (row >= row_end) continue;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int qi = tq + TQ * j;
        const int q = q0 + qi;
        if (q >= qn) continue;
        const float qq = METRIC == kInnerProduct ? 0.f : s_qq[qi];
        out_keys[static_cast<size_t>(q) * n + row] =
            pairwise_key<METRIC>(acc[i][j], cc[i], qq);
      }
    }
  }
}

template <int QT, int TR, int METRIC>
cudaError_t launch(const float* corpus, const float* queries, float* out_keys,
                   int n, int d, int qn, int rows_per_split, int splits,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * static_cast<size_t>(TileShape<QT, TR>::kStageFloats);
  auto kernel = pairwise_keys_kernel<QT, TR, METRIC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((qn + QT - 1) / QT, splits);
  kernel<<<grid, kThreads, smem, stream>>>(corpus, queries, out_keys, n, d,
                                           qn, rows_per_split);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  `corpus` is (n, d) and
// `queries` (qn, d) fp32, row-major; `out_keys` is (qn, n).  `qt` (queries
// per block) is 4, 16 or 64; the grid is (ceil(qn / qt), splits) blocks,
// each split `rows_per_split` rows (a multiple of 64).
extern "C" int pairwise_keys_launch(const float* corpus, const float* queries,
                                    float* out_keys, int n, int d, int qn,
                                    int metric, int qt, int rows_per_split,
                                    int splits, cudaStream_t stream) {
#define REPRO_PAIRWISE_LAUNCH(QT_, TR_, M_)                                   \
  launch<QT_, TR_, M_>(corpus, queries, out_keys, n, d, qn, rows_per_split,  \
                       splits, stream)
#define REPRO_PAIRWISE_BY_QT(M_)                                              \
  switch (qt) {                                                               \
    case 64: return static_cast<int>(REPRO_PAIRWISE_LAUNCH(64, 16, M_));      \
    case 16: return static_cast<int>(REPRO_PAIRWISE_LAUNCH(16, 16, M_));      \
    case 4: return static_cast<int>(REPRO_PAIRWISE_LAUNCH(4, 64, M_));        \
    default: return static_cast<int>(cudaErrorInvalidValue);                  \
  }
  switch (metric) {
    case repro_topk::kInnerProduct:
      REPRO_PAIRWISE_BY_QT(repro_topk::kInnerProduct)
    case repro_topk::kL2: REPRO_PAIRWISE_BY_QT(repro_topk::kL2)
    case repro_topk::kCosine: REPRO_PAIRWISE_BY_QT(repro_topk::kCosine)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_PAIRWISE_BY_QT
#undef REPRO_PAIRWISE_LAUNCH
}
