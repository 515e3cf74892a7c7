// Shared device helpers of the fused scan + top-k kernels.
//
// Selection works on (key, id) entries in shared memory, ordered by key and
// then by id, so an equal key always ranks the lower row id first: the
// reference's lax.top_k order.  A "segment" is one running top-k list of
// `kp` sorted entries followed by a candidate buffer; a merge sorts the
// whole segment and keeps its head.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_topk {

constexpr int kThreads = 256;
constexpr int kEmptyId = 0x7fffffff;

enum Metric : int { kInnerProduct = 0, kL2 = 1, kCosine = 2 };

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// Order key of one (row, query) pair from its dot product and the two
// squared norms; the same float operations, in the same order, as the
// reference's metric epilogue.  Each is written as a rounded intrinsic so
// that nvcc never contracts a product and a sum into one FMA: every kernel
// that calls it gives a pair the same key bits (replay_keys.cu relies on
// it).
template <int METRIC>
__device__ __forceinline__ float order_key(float ip, float xx, float qq) {
  if (METRIC == kInnerProduct) return -ip;
  if (METRIC == kL2) return __fadd_rn(__fsub_rn(xx, __fmul_rn(2.0f, ip)), qq);
  return -__fdiv_rn(ip, __fadd_rn(__fmul_rn(sqrtf(xx), sqrtf(qq)), 1e-12f));
}

__device__ __forceinline__ bool entry_greater(float ka, int ia, float kb,
                                              int ib) {
  return ka > kb || (ka == kb && ia > ib);
}

// Ascending bitonic sort of `nseg` segments of `seg` entries each (seg a
// power of two), block-wide.  Segments whose flag is 0 are left alone; a
// null `flags` sorts every segment.  Starts and ends with a barrier.
__device__ void sort_segments(float* keys, int* ids, int nseg, int seg,
                              const int* flags) {
  const int half = seg >> 1;
  for (int size = 2; size <= seg; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int p = threadIdx.x; p < nseg * half; p += blockDim.x) {
        const int s = p / half;
        if (flags != nullptr && flags[s] == 0) continue;
        const int t = p - s * half;
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const int a = s * seg + lo;
        const int b = s * seg + hi;
        const float ka = keys[a], kb = keys[b];
        const int ia = ids[a], ib = ids[b];
        if (entry_greater(ka, ia, kb, ib) == up) {
          keys[a] = kb; keys[b] = ka;
          ids[a] = ib; ids[b] = ia;
        }
      }
    }
  }
  __syncthreads();
}

// After sort_segments: empty the candidate buffers of the merged segments,
// reset their counts and raise their thresholds to the new k-th key.
__device__ void reset_buffers(float* keys, int* ids, int nseg, int seg,
                              int kp, int k, const int* flags, int* count,
                              float* thr) {
  const int buf = seg - kp;
  for (int p = threadIdx.x; p < nseg * buf; p += blockDim.x) {
    const int s = p / buf;
    if (flags != nullptr && flags[s] == 0) continue;
    const int i = s * seg + kp + (p - s * buf);
    keys[i] = pos_inf();
    ids[i] = kEmptyId;
  }
  for (int s = threadIdx.x; s < nseg; s += blockDim.x) {
    if (flags != nullptr && flags[s] == 0) continue;
    count[s] = 0;
    thr[s] = keys[s * seg + k - 1];
  }
  __syncthreads();
}

inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace repro_topk

// Text of a cudaError_t returned by a launcher, for the Python wrapper.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
