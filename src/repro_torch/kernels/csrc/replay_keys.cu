// Exact fp32 order keys of gathered (query, corpus row) pairs, bitwise equal
// to the fp32 batched kernels' keys, for Hopper (sm_90a).
//
// Replaces `_replay_keys` (src/repro/kernels/quant.py), which the reference
// runs in plain XLA: the quantized paths re-rank their candidate rows with
// the keys the fp32 kernels (scan_topk_batch.cu, range_scan_batch.cu) give
// the same (row, query) pairs, so that a quantized answer is the fp32
// answer bit for bit.  A gather plus torch.matmul would sum each dot in
// another order.  Instead each pair runs the chain of fp32_tile.cuh: the
// dot and the row's squared norm as one sequential fmaf chain over
// d = 0 .. D − 1, one fmaf(0, 0, ·) more where the tile pads D to a whole
// 32-column chunk (it can turn −0 into +0), the query's squared norm from
// the same query_norms, and the key from the same order_key<METRIC>.
//
// Bound on the H100: bytes, the gathered rows (C·D·4 bytes per query, at
// most; slots past N are skipped) and the (Q, C) ids and keys.  Design: a
// block takes one query and 256 of its candidate slots, stages the query in
// shared memory (every lane reads the same word: a broadcast) and gives
// each thread one pair; a thread streams its row through L1, 16 bytes at a
// time where D % 4 == 0 and the rows are 16-byte aligned.
#include "fp32_tile.cuh"

namespace {

using namespace repro_topk;
using repro_tile::kDepth;

template <int METRIC, bool VEC4>
__global__ void __launch_bounds__(kThreads) replay_keys_kernel(
    const float* __restrict__ corpus, const float* __restrict__ queries,
    const int* __restrict__ rows, float* __restrict__ out, int n, int d,
    int qn, int c) {
  extern __shared__ float q_s[];
  __shared__ float s_qq[1];
  const int q = blockIdx.x;
  const float* qp = queries + static_cast<size_t>(q) * d;
  for (int i = threadIdx.x; i < d; i += kThreads) q_s[i] = qp[i];
  repro_tile::query_norms<1>(queries, q, qn, d, s_qq);
  __syncthreads();
  const int slot = blockIdx.y * kThreads + threadIdx.x;
  if (slot >= c) return;
  const size_t o = static_cast<size_t>(q) * c + slot;
  const int row = rows[o];
  if (row < 0 || row >= n) {
    out[o] = pos_inf();
    return;
  }
  const float* x = corpus + static_cast<size_t>(row) * d;
  float ip = 0.f, xx = 0.f;
  if (VEC4) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int j = 0; j < d / 4; ++j) {
      const float4 v = __ldg(x4 + j);
      const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        ip = fmaf(a[t], q_s[4 * j + t], ip);
        if (METRIC != kInnerProduct) xx = fmaf(a[t], a[t], xx);
      }
    }
  } else {
    for (int j = 0; j < d; ++j) {
      const float a = __ldg(x + j);
      ip = fmaf(a, q_s[j], ip);
      if (METRIC != kInnerProduct) xx = fmaf(a, a, xx);
    }
  }
  if (d % kDepth != 0) {
    ip = fmaf(0.f, 0.f, ip);
    if (METRIC != kInnerProduct) xx = fmaf(0.f, 0.f, xx);
  }
  out[o] = order_key<METRIC>(ip, xx, s_qq[0]);
}

template <int METRIC, bool VEC4>
cudaError_t launch(const float* corpus, const float* queries, const int* rows,
                   float* out, int n, int d, int qn, int c,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(d);
  auto kernel = replay_keys_kernel<METRIC, VEC4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(qn, (c + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, smem, stream>>>(corpus, queries, rows, out, n, d,
                                           qn, c);
  return cudaGetLastError();
}

template <int METRIC>
cudaError_t launch_vec(int vec4, const float* corpus, const float* queries,
                       const int* rows, float* out, int n, int d, int qn,
                       int c, cudaStream_t stream) {
  return vec4 ? launch<METRIC, true>(corpus, queries, rows, out, n, d, qn, c,
                                     stream)
              : launch<METRIC, false>(corpus, queries, rows, out, n, d, qn,
                                      c, stream);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  corpus (n, d) and
// queries (qn, d) fp32, rows (qn, c) int32 row ids (a slot outside
// [0, n) gets +inf and reads nothing), out (qn, c) fp32.  `vec4` only when
// d % 4 == 0 and the corpus is 16-byte aligned.
extern "C" int replay_keys_launch(const float* corpus, const float* queries,
                                  const int* rows, float* out, int n, int d,
                                  int qn, int c, int metric, int vec4,
                                  cudaStream_t stream) {
  switch (metric) {
    case kInnerProduct:
      return launch_vec<kInnerProduct>(vec4, corpus, queries, rows, out, n, d,
                                       qn, c, stream);
    case kL2:
      return launch_vec<kL2>(vec4, corpus, queries, rows, out, n, d, qn, c,
                             stream);
    case kCosine:
      return launch_vec<kCosine>(vec4, corpus, queries, rows, out, n, d, qn,
                                 c, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
