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
// 0.4 GB key matrix once.  At Q <= 16 the corpus bytes bound it instead.
//
// Design: a classic SIMT SGEMM, one output tile per block, plain fp32 FMAs
// (no TF32, no tensor cores).
// - The wide shape takes 128 queries × 128 rows with 256 threads; each
//   thread keeps an 8 × 8 register micro-tile (rows tr*4 + {0..3} and
//   64 + tr*4 + {0..3}, the same for queries).  A warp is 4 threads along
//   rows by 8 along queries, so each k step is four 16-byte shared loads
//   (each at most one wavefront, the query ones broadcast) for 64 FFMAs.
//   Q = 100 fits one query tile: each corpus byte is read once.
// - The narrow shape takes 16 queries × 256 rows (micro-tile 4 × 4), for
//   small batches, where the corpus bytes bound the kernel; a 128-query
//   tile would do 128× the FMAs at Q = 1.  (On the H100 a 4-query shape
//   ran within 1% of it at Q = 1, 2 and 4.)
// - Staging: D is taken in chunks of BK columns through two shared buffers,
//   transposed to [k][row] and [k][query].  The next chunk's global loads
//   (32 bytes of one row or query per thread, two 16-byte loads where
//   D % 4 == 0 and the bases are 16-byte aligned, scalar loads otherwise;
//   lanes on consecutive rows) are in flight while the current chunk
//   computes, and are stored to the other buffer after it: one barrier per
//   chunk.  Zeros past D, past the last row and past the last query.
// - Norms: for L2 and cosine a prepass (one block per query tile) sums the
//   squared query norms into a scratch vector, which each block reads; the
//   row norms are summed from the staged chunks, one row per thread.
// - Epilogue: each thread writes its keys along N, 16 bytes at a time where
//   N % 4 == 0 (streaming stores), one at a time at a ragged end; every
//   offset in 64 bits (Q·N·4 bytes passes 2^31 at 540 queries of a 1M-row
//   corpus).
//
// Keys bit for bit: each (row, query) dot product and each row's squared
// norm is one sequential fmaf chain over d = 0 .. ceil(D / 32)·32 − 1, zeros
// past D, as every batched key kernel sums it (fp32_tile.cuh; no
// split-K); ‖q‖² comes from the same repro_tile::query_norms; the
// epilogue is unchanged.  So any query tile gives the same bits, a row
// of a batch equals the single-query call, and for inner product and
// cosine the keys equal replay_keys.cu's.
#include "fp32_tile.cuh"

namespace {

using namespace repro_topk;

// each chain runs over whole chunks of the batched tile's depth
constexpr int kChunk = repro_tile::kDepth;

// The TPU kernel's metric epilogue, written as rounded intrinsics so that
// nvcc cannot contract a product and a sum into one FMA.
template <int METRIC>
__device__ __forceinline__ float pairwise_key(float ip, float cc, float qq) {
  if (METRIC == kInnerProduct) return -ip;
  if (METRIC == kL2) return __fadd_rn(__fsub_rn(qq, __fmul_rn(2.0f, ip)), cc);
  return -__fdiv_rn(ip, __fadd_rn(__fmul_rn(sqrtf(qq), sqrtf(cc)), 1e-12f));
}

// A block shape: BQ queries × BR rows, each thread an RM × QM micro-tile, a
// warp LR threads along rows, BK columns of D per staged chunk, MINB blocks
// per SM asked of the register allocator.  A micro-tile's rows (queries)
// come in groups of 4 consecutive ones, the groups BR / (RM / 4) rows
// (BQ / (QM / 4) queries) apart.
template <int BQ_, int BR_, int QM_, int RM_, int LR_, int BK_, int MINB_>
struct Shape {
  static constexpr int BQ = BQ_, BR = BR_, QM = QM_, RM = RM_, LR = LR_;
  static constexpr int BK = BK_, MINB = MINB_;
  static constexpr int TQ = BQ / QM;             // threads along queries
  static constexpr int TR = BR / RM;             // threads along rows
  static constexpr int WR = TR / LR;             // warps along rows
  static constexpr int UPR = BK / 8;             // 32-byte units per row
  static constexpr int UNITS = (BR + BQ) * UPR;  // per chunk
  static constexpr int UPT = (UNITS + kThreads - 1) / kThreads;
  static constexpr int NX = (BR + kThreads - 1) / kThreads;  // norms/thread
  static constexpr int kStage = BK * (BR + BQ);  // floats per buffer
  static_assert(TQ * TR == kThreads, "the micro-tiles must cover the block");
  static_assert(RM % 4 == 0 && QM % 4 == 0, "fragment groups");
  static_assert(32 % LR == 0 && TR % LR == 0 && TQ % (32 / LR) == 0,
                "warp layout");
  static_assert(BK % 8 == 0 && kChunk % BK == 0, "chunks of 32 columns");
};

using Wide = Shape<128, 128, 8, 8, 4, 8, 2>;
using Narrow = Shape<16, 256, 4, 4, 8, 16, 3>;

// M values of a micro-tile from one staged k row, 16 bytes at a time:
// groups of 4 consecutive entries starting at t·4, the groups B / (M / 4)
// entries apart.
template <int M, int B>
__device__ __forceinline__ void fragment(const float* row, int t,
                                         float (&v)[M]) {
#pragma unroll
  for (int g = 0; g < M / 4; ++g) {
    const float4 x =
        *reinterpret_cast<const float4*>(row + g * (B / (M / 4)) + t * 4);
    v[4 * g] = x.x; v[4 * g + 1] = x.y; v[4 * g + 2] = x.z;
    v[4 * g + 3] = x.w;
  }
}

// Squared norms of query tile blockIdx.x into qq[q0 .. q0 + BQ − 1] (0 past
// qn): the prepass of the L2 and cosine keys, so that the blocks of the
// product read BQ floats instead of summing BQ·D each.
template <int BQ>
__global__ void __launch_bounds__(kThreads) query_norms_kernel(
    const float* __restrict__ queries, float* __restrict__ qq, int qn,
    int d) {
  __shared__ float s_qq[BQ];
  const int q0 = blockIdx.x * BQ;
  repro_tile::query_norms<BQ>(queries, q0, qn, d, s_qq);
  __syncthreads();
  for (int i = threadIdx.x; i < BQ; i += kThreads) qq[q0 + i] = s_qq[i];
}

template <class S, int METRIC, bool VEC4>
__global__ void __launch_bounds__(kThreads, S::MINB) pairwise_keys_kernel(
    const float* __restrict__ corpus, const float* __restrict__ queries,
    const float* __restrict__ qq, float* __restrict__ out_keys, int n, int d,
    int qn, int vec_out) {
  __shared__ __align__(16) float stage[2 * S::kStage];
  __shared__ float s_qq[S::BQ];
  __shared__ float s_cc[S::BR];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tr = (warp % S::WR) * S::LR + lane % S::LR;
  const int tq = (warp / S::WR) * (32 / S::LR) + lane / S::LR;
  const int row0 = blockIdx.x * S::BR;
  const int q0 = blockIdx.y * S::BQ;

  if (METRIC != kInnerProduct)
    for (int i = tid; i < S::BQ; i += kThreads) s_qq[i] = qq[q0 + i];

  // this thread's staging units: 8 consecutive columns k8 .. k8 + 7 of
  // one row or query per chunk, read from `src` (null past the last row or
  // query) and stored transposed at stage[buffer + (k8 + j) * stride + dst]
  const float* src[S::UPT];
  int col[S::UPT], dst[S::UPT], stride[S::UPT];
#pragma unroll
  for (int s = 0; s < S::UPT; ++s) {
    const int u = tid + s * kThreads;
    src[s] = nullptr;
    col[s] = 0;
    dst[s] = 0;
    stride[s] = 0;
    if (u < S::BR * S::UPR) {
      const int r = u % S::BR;
      col[s] = (u / S::BR) * 8;
      if (row0 + r < n) src[s] = corpus + static_cast<size_t>(row0 + r) * d;
      dst[s] = r;
      stride[s] = S::BR;
    } else if (u < S::UNITS) {
      const int v = u - S::BR * S::UPR;
      const int qi = v % S::BQ;
      col[s] = (v / S::BQ) * 8;
      if (q0 + qi < qn) src[s] = queries + static_cast<size_t>(q0 + qi) * d;
      dst[s] = S::BK * S::BR + qi;
      stride[s] = S::BQ;
    }
  }
  float pre[S::UPT][8];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int s = 0; s < S::UPT; ++s) {
      const int c = k0 + col[s];
#pragma unroll
      for (int j = 0; j < 8; ++j) pre[s][j] = 0.f;
      if (src[s] == nullptr) continue;
      if constexpr (VEC4) {
        // d % 4 == 0: a 16-byte group lies wholly inside D or past it
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (c + 4 * h < d) {
            const float4 x =
                __ldg(reinterpret_cast<const float4*>(src[s] + c + 4 * h));
            pre[s][4 * h] = x.x; pre[s][4 * h + 1] = x.y;
            pre[s][4 * h + 2] = x.z; pre[s][4 * h + 3] = x.w;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < d) pre[s][j] = __ldg(src[s] + c + j);
      }
    }
  };
  auto stash = [&](float* buf) {
#pragma unroll
    for (int s = 0; s < S::UPT; ++s) {
      if (tid + s * kThreads >= S::UNITS) continue;
      float* p = buf + col[s] * stride[s] + dst[s];
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j * stride[s]] = pre[s][j];
    }
  };

  float acc[S::RM][S::QM];
  float xx[S::NX];
#pragma unroll
  for (int i = 0; i < S::RM; ++i)
#pragma unroll
    for (int j = 0; j < S::QM; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int x = 0; x < S::NX; ++x) xx[x] = 0.f;

  const int chunks = (d + kChunk - 1) / kChunk * (kChunk / S::BK);
  fetch(0);
  stash(stage);
  __syncthreads();  // also publishes s_qq
  for (int c = 0; c < chunks; ++c) {
    const float* a_s = stage + (c & 1) * S::kStage;
    const float* b_s = a_s + S::BK * S::BR;
    const bool more = c + 1 < chunks;
    if (more) fetch((c + 1) * S::BK);
#pragma unroll
    for (int k = 0; k < S::BK; ++k) {
      float a[S::RM], b[S::QM];
      fragment<S::RM, S::BR>(a_s + k * S::BR, tr, a);
      fragment<S::QM, S::BQ>(b_s + k * S::BQ, tq, b);
      if (METRIC != kInnerProduct) {
        // row norms: thread t sums rows t, t + 256, ... (one chain each)
#pragma unroll
        for (int x = 0; x < S::NX; ++x) {
          const int r = tid + x * kThreads;
          if (r < S::BR) {
            const float v = a_s[k * S::BR + r];
            xx[x] = fmaf(v, v, xx[x]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < S::RM; ++i)
#pragma unroll
        for (int j = 0; j < S::QM; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer's readers passed the previous chunk's barrier
    if (more) stash(stage + ((c + 1) & 1) * S::kStage);
    __syncthreads();
  }

  if (METRIC != kInnerProduct) {
#pragma unroll
    for (int x = 0; x < S::NX; ++x) {
      const int r = tid + x * kThreads;
      if (r < S::BR) s_cc[r] = xx[x];
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < S::QM; ++j) {
    const int qi = (j / 4) * (S::BQ / (S::QM / 4)) + tq * 4 + j % 4;
    const int q = q0 + qi;
    if (q >= qn) continue;
    const float q_sq = METRIC == kInnerProduct ? 0.f : s_qq[qi];
#pragma unroll
    for (int g = 0; g < S::RM / 4; ++g) {
      const int rl = g * (S::BR / (S::RM / 4)) + tr * 4;
      const int row = row0 + rl;
      if (row >= n) continue;
      float key[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        key[e] = pairwise_key<METRIC>(
            acc[4 * g + e][j], METRIC == kInnerProduct ? 0.f : s_cc[rl + e],
            q_sq);
      float* o = out_keys + static_cast<size_t>(q) * n + row;
      if (vec_out && row + 3 < n) {
        __stcs(reinterpret_cast<float4*>(o),
               make_float4(key[0], key[1], key[2], key[3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (row + e < n) o[e] = key[e];
      }
    }
  }
}

template <class S, int METRIC, bool VEC4>
cudaError_t launch(const float* corpus, const float* queries, float* qq,
                   float* out_keys, int n, int d, int qn, int row_blocks,
                   int query_blocks, cudaStream_t stream) {
  if (static_cast<long long>(row_blocks) * S::BR < n ||
      static_cast<long long>(query_blocks) * S::BQ < qn)
    return cudaErrorInvalidValue;
  if (METRIC != kInnerProduct) {
    if (qq == nullptr) return cudaErrorInvalidValue;
    query_norms_kernel<S::BQ><<<query_blocks, kThreads, 0, stream>>>(
        queries, qq, qn, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(row_blocks, query_blocks);
  pairwise_keys_kernel<S, METRIC, VEC4><<<grid, kThreads, 0, stream>>>(
      corpus, queries, qq, out_keys, n, d, qn, n % 4 == 0);
  return cudaGetLastError();
}

template <class S, int METRIC>
cudaError_t launch_vec(int vec4, const float* corpus, const float* queries,
                       float* qq, float* out_keys, int n, int d, int qn,
                       int row_blocks, int query_blocks, cudaStream_t stream) {
  return vec4 ? launch<S, METRIC, true>(corpus, queries, qq, out_keys, n, d,
                                        qn, row_blocks, query_blocks, stream)
              : launch<S, METRIC, false>(corpus, queries, qq, out_keys, n, d,
                                         qn, row_blocks, query_blocks,
                                         stream);
}

template <class S>
cudaError_t launch_metric(int metric, int vec4, const float* corpus,
                          const float* queries, float* qq, float* out_keys,
                          int n, int d, int qn, int row_blocks,
                          int query_blocks, cudaStream_t stream) {
#define REPRO_PAIRWISE_LAUNCH(M_)                                            \
  launch_vec<S, M_>(vec4, corpus, queries, qq, out_keys, n, d, qn,           \
                    row_blocks, query_blocks, stream)
  switch (metric) {
    case kInnerProduct: return REPRO_PAIRWISE_LAUNCH(kInnerProduct);
    case kL2: return REPRO_PAIRWISE_LAUNCH(kL2);
    case kCosine: return REPRO_PAIRWISE_LAUNCH(kCosine);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_PAIRWISE_LAUNCH
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  `corpus` is (n, d) and
// `queries` (qn, d) fp32, row-major; `out_keys` is (qn, n); `qq` is scratch
// for query_blocks · qt squared query norms (unused, and may be null, for
// inner product).  The plan (kernels/distance.py `pairwise_plan`) gives the
// block shape, `qt` queries × `rt` rows (16 × 256 or 128 × 128),
// and a grid of `row_blocks` × `query_blocks` blocks that must cover every
// row and query.  `vec4` only when d % 4 == 0 and both bases are 16-byte
// aligned.
extern "C" int pairwise_keys_launch(const float* corpus, const float* queries,
                                    float* qq, float* out_keys, int n, int d,
                                    int qn, int metric, int qt, int rt,
                                    int row_blocks, int query_blocks,
                                    int vec4, cudaStream_t stream) {
#define REPRO_PAIRWISE_SHAPE(S_)                                             \
  if (qt == S_::BQ && rt == S_::BR)                                          \
    return static_cast<int>(launch_metric<S_>(                               \
        metric, vec4, corpus, queries, qq, out_keys, n, d, qn, row_blocks,   \
        query_blocks, stream));
  REPRO_PAIRWISE_SHAPE(Wide)
  REPRO_PAIRWISE_SHAPE(Narrow)
#undef REPRO_PAIRWISE_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}
