// Single-query fused scan + filter + top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel `scan_topk_pallas` (src/repro/kernels/scan_topk.py,
// body `_scan_topk_kernel`): order keys of every corpus row against one
// query, the row mask, and per-block top-k candidates with global ids.
//
// Bound on the H100: memory.  Each corpus byte is read once and used for one
// multiply-add, so at N = 1,000,000 x D = 512 fp32 the kernel must move
// 2.05 GB: 0.61 ms at 3.35 TB/s.  Design against that bound:
//   * one warp per row, 16-byte loads (float4) when D % 4 == 0: a warp reads
//     512 contiguous bytes per instruction, and the query sits in shared
//     memory, so device memory sees the corpus and the mask only;
//   * the row's squared norm (L2, cosine) comes from the same loads;
//   * a warp-shuffle reduction gives the dot product, and lane 0 appends the
//     row to the block's candidate buffer only if it beats the block's
//     current k-th key, so after the first tiles almost no row is kept;
//   * a merge (a bitonic sort of list + buffer in shared memory) runs only
//     when the next tile could overflow the buffer.  Many small blocks per
//     SM keep loads in flight while one block sorts.
// Each block emits its k best (key, id) pairs; the stage-2 merge over
// blocks is plain torch (kernels/ops.py).
#include "topk_common.cuh"

namespace {

using namespace repro_topk;

constexpr int kTile = 256;  // rows scored between two merge checks

template <int METRIC, bool VEC4>
__global__ void __launch_bounds__(kThreads) scan_topk_kernel(
    const float* __restrict__ corpus, const float* __restrict__ query,
    const int8_t* __restrict__ mask, float* __restrict__ out_keys,
    int* __restrict__ out_ids, int n, int d, int d_pad, int k, int kp,
    int seg, int rows_per_block) {
  extern __shared__ float smem[];
  float* q_s = smem;                                   // d_pad floats
  float* s_keys = smem + d_pad;                        // seg
  int* s_ids = reinterpret_cast<int*>(s_keys + seg);   // seg
  __shared__ int s_cnt;
  __shared__ float s_thr;
  __shared__ float s_qq;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = min(n, row0 + rows_per_block);

  for (int i = tid; i < d_pad; i += kThreads) q_s[i] = i < d ? query[i] : 0.f;
  for (int i = tid; i < seg; i += kThreads) {
    s_keys[i] = pos_inf();
    s_ids[i] = kEmptyId;
  }
  if (tid == 0) {
    s_cnt = 0;
    s_thr = pos_inf();
  }
  __syncthreads();
  if (warp == 0) {
    float qq = 0.f;
    for (int i = lane; i < d; i += 32) qq = fmaf(q_s[i], q_s[i], qq);
    for (int o = 16; o > 0; o >>= 1) qq += __shfl_xor_sync(0xffffffffu, qq, o);
    if (lane == 0) s_qq = qq;
  }
  __syncthreads();
  const float qq = s_qq;
  const int buf = seg - kp;

  for (int t0 = row0; t0 < row_end; t0 += kTile) {
    const int cnt = s_cnt;
    __syncthreads();  // every thread has read the count before any append
    if (cnt + kTile > buf) {
      sort_segments(s_keys, s_ids, 1, seg, nullptr);
      reset_buffers(s_keys, s_ids, 1, seg, kp, k, nullptr, &s_cnt, &s_thr);
    }
    const float thr = s_thr;
    const int t_end = min(row_end, t0 + kTile);
    for (int r = t0 + warp; r < t_end; r += kThreads / 32) {
      const float* x = corpus + static_cast<size_t>(r) * d;
      float ip = 0.f, xx = 0.f;
      if (VEC4) {
        const float4* x4 = reinterpret_cast<const float4*>(x);
        const float4* q4 = reinterpret_cast<const float4*>(q_s);
        for (int j = lane; j < (d >> 2); j += 32) {
          const float4 a = __ldg(x4 + j);
          const float4 b = q4[j];
          ip = fmaf(a.x, b.x, ip); ip = fmaf(a.y, b.y, ip);
          ip = fmaf(a.z, b.z, ip); ip = fmaf(a.w, b.w, ip);
          if (METRIC != kInnerProduct) {
            xx = fmaf(a.x, a.x, xx); xx = fmaf(a.y, a.y, xx);
            xx = fmaf(a.z, a.z, xx); xx = fmaf(a.w, a.w, xx);
          }
        }
      } else {
        for (int j = lane; j < d; j += 32) {
          const float a = __ldg(x + j);
          ip = fmaf(a, q_s[j], ip);
          if (METRIC != kInnerProduct) xx = fmaf(a, a, xx);
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        ip += __shfl_xor_sync(0xffffffffu, ip, o);
        if (METRIC != kInnerProduct) xx += __shfl_xor_sync(0xffffffffu, xx, o);
      }
      if (lane == 0) {
        const float key = order_key<METRIC>(ip, xx, qq);
        const bool live = mask == nullptr || mask[r] != 0;
        if (live && key < thr) {
          const int pos = atomicAdd(&s_cnt, 1);
          s_keys[kp + pos] = key;
          s_ids[kp + pos] = r;
        }
      }
    }
    __syncthreads();
  }
  if (s_cnt > 0) {
    sort_segments(s_keys, s_ids, 1, seg, nullptr);
  }
  float* ok = out_keys + static_cast<size_t>(blockIdx.x) * k;
  int* oi = out_ids + static_cast<size_t>(blockIdx.x) * k;
  for (int j = tid; j < k; j += kThreads) {
    const float key = s_keys[j];
    const bool found = key < pos_inf();
    ok[j] = found ? key : pos_inf();
    oi[j] = found ? s_ids[j] : -1;
  }
}

template <int METRIC, bool VEC4>
cudaError_t launch(const float* corpus, const float* query,
                   const int8_t* mask, float* out_keys, int* out_ids, int n,
                   int d, int k, int rows_per_block, int num_blocks,
                   cudaStream_t stream) {
  const int kp = next_pow2(k);
  const int seg = next_pow2(kp + kTile);
  const int d_pad = (d + 3) & ~3;
  const size_t smem = static_cast<size_t>(d_pad + 2 * seg) * sizeof(float);
  auto kernel = scan_topk_kernel<METRIC, VEC4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<num_blocks, kThreads, smem, stream>>>(
      corpus, query, mask, out_keys, out_ids, n, d, d_pad, k, kp, seg,
      rows_per_block);
  return cudaGetLastError();
}

template <int METRIC>
cudaError_t launch_metric(bool vec4, const float* corpus, const float* query,
                          const int8_t* mask, float* out_keys, int* out_ids,
                          int n, int d, int k, int rows_per_block,
                          int num_blocks, cudaStream_t stream) {
  if (vec4)
    return launch<METRIC, true>(corpus, query, mask, out_keys, out_ids, n, d,
                                k, rows_per_block, num_blocks, stream);
  return launch<METRIC, false>(corpus, query, mask, out_keys, out_ids, n, d,
                               k, rows_per_block, num_blocks, stream);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  `mask` may be null (no
// row predicate); `vec4` requires d % 4 == 0 and a 16-byte aligned corpus.
extern "C" int scan_topk_launch(const float* corpus, const float* query,
                                const int8_t* mask, float* out_keys,
                                int* out_ids, int n, int d, int k, int metric,
                                int vec4, int rows_per_block, int num_blocks,
                                cudaStream_t stream) {
  switch (metric) {
    case kInnerProduct:
      return launch_metric<kInnerProduct>(vec4 != 0, corpus, query, mask,
                                          out_keys, out_ids, n, d, k,
                                          rows_per_block, num_blocks, stream);
    case kL2:
      return launch_metric<kL2>(vec4 != 0, corpus, query, mask, out_keys,
                                out_ids, n, d, k, rows_per_block, num_blocks,
                                stream);
    case kCosine:
      return launch_metric<kCosine>(vec4 != 0, corpus, query, mask, out_keys,
                                    out_ids, n, d, k, rows_per_block,
                                    num_blocks, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
