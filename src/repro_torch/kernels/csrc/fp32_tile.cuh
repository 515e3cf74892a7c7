// The chunk depth and query norms that every kernel keeping the batched
// fp32 keys bit for bit shares (range_tile.cuh: range_scan_batch.cu and
// quant_keys_batch.cu; scan_topk_batch.cu, quant_scan_topk_batch.cu,
// pairwise_keys.cu, replay_keys.cu).
//
// Each (row, query) dot product and each row's squared norm is one
// sequential fmaf chain over d = 0 .. ceil(D / kDepth)·kDepth − 1, zeros
// past D, whatever the kernel's block shape, query tile and launch
// geometry; ‖q‖² is query_norms' warp sum below.  So a pair's key is
// bitwise the same at every batch size, and replay_keys.cu reproduces it
// pair by pair.
#pragma once

#include "topk_common.cuh"

namespace repro_tile {

using repro_topk::kThreads;

constexpr int kDepth = 32;  // each chain runs over whole chunks of kDepth

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

}  // namespace repro_tile
