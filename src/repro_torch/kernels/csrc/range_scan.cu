// Single-query fused range scan (distance + radius + row predicate), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `range_scan_pallas` (src/repro/kernels/
// range_scan.py, body `_range_kernel`): the order key of every corpus row
// against one query, hit = mask[row] && key <= radius_key, the keys with
// +inf off the hits, the int8 hits, and the hit count.
//
// Bound on the H100: memory.  Each corpus byte is read once and used for one
// multiply-add; at N = 1,000,000 x D = 512 fp32 the kernel must move about
// 2.054 GB (the corpus, plus mask, keys and hits): 0.613 ms at 3.35 TB/s.
// Design against that bound, as scan_topk.cu without the selection:
//   * one warp per row, 16-byte loads (float4) when D % 4 == 0, the query
//     in shared memory, so device memory sees the corpus, the mask and the
//     outputs only;
//   * the row's squared norm (L2, cosine) comes from the same loads, and a
//     warp-shuffle reduction gives the dot product; the metric epilogue is
//     the reference's float order (topk_common.cuh order_key);
//   * lane 0 writes the row's key and hit; hits are summed per block in
//     shared memory and added to the global count with one integer
//     atomicAdd per block, so the count does not depend on the order of
//     the adds;
//   * the grid is as many blocks as the card holds at once (occupancy API)
//     and strides over the rows, so no partial second wave idles the SMs.
#include "topk_common.cuh"

namespace {

using namespace repro_topk;

constexpr int kWarps = kThreads / 32;

template <int METRIC, bool VEC4>
__global__ void __launch_bounds__(kThreads) range_scan_kernel(
    const float* __restrict__ corpus, const float* __restrict__ query,
    const float* __restrict__ radius_key, const int8_t* __restrict__ mask,
    float* __restrict__ out_keys, int8_t* __restrict__ out_hits,
    int* __restrict__ count, int n, int d, int d_pad) {
  extern __shared__ float q_s[];  // d_pad floats
  __shared__ float s_qq;
  __shared__ int s_cnt;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < d_pad; i += kThreads) q_s[i] = i < d ? query[i] : 0.f;
  if (tid == 0) s_cnt = 0;
  __syncthreads();
  if (warp == 0) {
    float qq = 0.f;
    for (int i = lane; i < d; i += 32) qq = fmaf(q_s[i], q_s[i], qq);
    for (int o = 16; o > 0; o >>= 1) qq += __shfl_xor_sync(0xffffffffu, qq, o);
    if (lane == 0) s_qq = qq;
  }
  __syncthreads();
  const float qq = s_qq;
  const float rk = *radius_key;

  int mine = 0;  // hits of this warp's rows (lane 0 only)
  for (int r = blockIdx.x * kWarps + warp; r < n; r += gridDim.x * kWarps) {
    const float* x = corpus + static_cast<size_t>(r) * d;
    float ip = 0.f, xx = 0.f;
    if (VEC4) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
      const float4* q4 = reinterpret_cast<const float4*>(q_s);
#pragma unroll 4
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
      const bool hit = (mask == nullptr || mask[r] != 0) && key <= rk;
      out_keys[r] = hit ? key : pos_inf();
      out_hits[r] = hit ? 1 : 0;
      mine += hit ? 1 : 0;
    }
  }
  if (lane == 0 && mine > 0) atomicAdd(&s_cnt, mine);
  __syncthreads();
  if (tid == 0 && s_cnt > 0) atomicAdd(count, s_cnt);
}

template <int METRIC, bool VEC4>
cudaError_t launch(const float* corpus, const float* query,
                   const float* radius_key, const int8_t* mask,
                   float* out_keys, int8_t* out_hits, int* count, int n,
                   int d, cudaStream_t stream) {
  const int d_pad = (d + 3) & ~3;
  const size_t smem = static_cast<size_t>(d_pad) * sizeof(float);
  auto kernel = range_scan_kernel<METRIC, VEC4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const int num_blocks =
      max(1, min((n + kWarps - 1) / kWarps, sms * max(1, per_sm)));
  kernel<<<num_blocks, kThreads, smem, stream>>>(
      corpus, query, radius_key, mask, out_keys, out_hits, count, n, d,
      d_pad);
  return cudaGetLastError();
}

template <int METRIC>
cudaError_t launch_metric(bool vec4, const float* corpus, const float* query,
                          const float* radius_key, const int8_t* mask,
                          float* out_keys, int8_t* out_hits, int* count,
                          int n, int d, cudaStream_t stream) {
  if (vec4)
    return launch<METRIC, true>(corpus, query, radius_key, mask, out_keys,
                                out_hits, count, n, d, stream);
  return launch<METRIC, false>(corpus, query, radius_key, mask, out_keys,
                               out_hits, count, n, d, stream);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  `radius_key` is one
// fp32 order key on the device; `mask` may be null (no row predicate);
// `count` is one int the caller zeroes; `vec4` requires d % 4 == 0 and a
// 16-byte aligned corpus.
extern "C" int range_scan_launch(const float* corpus, const float* query,
                                 const float* radius_key, const int8_t* mask,
                                 float* out_keys, int8_t* out_hits,
                                 int* count, int n, int d, int metric,
                                 int vec4, cudaStream_t stream) {
  switch (metric) {
    case kInnerProduct:
      return launch_metric<kInnerProduct>(vec4 != 0, corpus, query,
                                          radius_key, mask, out_keys,
                                          out_hits, count, n, d, stream);
    case kL2:
      return launch_metric<kL2>(vec4 != 0, corpus, query, radius_key, mask,
                                out_keys, out_hits, count, n, d, stream);
    case kCosine:
      return launch_metric<kCosine>(vec4 != 0, corpus, query, radius_key,
                                    mask, out_keys, out_hits, count, n, d,
                                    stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
