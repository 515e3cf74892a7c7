// Device helpers of the query-batched kernels on register micro-tiles
// (scan_topk_batch.cu, fp32 rows; quant_scan_topk_batch.cu, int8 / bf16
// rows; range_tile.cuh, both): the micro-tile's 16-byte fragment loads,
// the row mask as 4-byte words, the dequantization of an int8 or bf16
// unit, and the one-warp merge of a query's candidate list.
#pragma once

#include "fp32_tile.cuh"

namespace repro_select {

using namespace repro_topk;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBlockSmem = 232448;  // H100: the most one block may use

enum MaskMode : int { kNoMask = 0, kSharedMask = 1, kPerQueryMask = 2 };

// M values of a micro-tile from one staged k row, 16 bytes at a time:
// groups of 4 consecutive entries starting at t·4, the groups B / (M / 4)
// entries apart; entry i of the row is stored at i ^ swz (swz a multiple
// of 4, so a group stays 4 consecutive floats).
template <int M, int B>
__device__ __forceinline__ void fragment(const float* row, int t,
                                         float (&v)[M], int swz = 0) {
#pragma unroll
  for (int g = 0; g < M / 4; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(
        row + ((g * (B / (M / 4)) + t * 4) ^ swz));
    v[4 * g] = x.x; v[4 * g + 1] = x.y; v[4 * g + 2] = x.z;
    v[4 * g + 3] = x.w;
  }
}

// Mask bytes p[0 .. 3] packed little-endian, 0 past `avail` (>= 1): one
// 4-byte load where the address allows it.
__device__ __forceinline__ unsigned mask4(const int8_t* p, int avail) {
  if (avail >= 4 && (reinterpret_cast<uintptr_t>(p) & 3) == 0)
    return __ldg(reinterpret_cast<const unsigned*>(p));
  unsigned w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < avail)
      w |= static_cast<unsigned>(static_cast<uint8_t>(__ldg(p + e)))
           << (8 * e);
  return w;
}

// The 16 / sizeof(T) fp32 values of a 16-byte unit of an int8 or bf16
// row.  int8: float(q) · scale, one rounded product; the byte is widened
// exactly as 2^23 + (q + 128) − (2^23 + 128) (integer ops and one exact
// subtraction instead of the quarter-rate conversion).  bf16: the 16 bits
// as the high half of a float.
template <typename T>
__device__ __forceinline__ void dequant(const uint4& raw, float scale,
                                        float (&v)[16 / sizeof(T)]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 1) {
      const unsigned x = w[i] ^ 0x80808080u;  // each byte q + 128
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float q = __fsub_rn(
            __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u | b)),
            8388736.0f);
        v[4 * i + b] = __fmul_rn(q, scale);
      }
    } else {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Merge one query's list by one warp: `keys` / `ids` hold kp sorted
// entries followed by a buffer of `cnt` candidates (then empty entries).
// The occupied part of the buffer is sorted (sort_segments' bitonic network
// on the next power of two >= cnt), the head keeps the smaller of entry i
// and buffer entry kp − 1 − i (a bitonic sequence of the kp smallest), and
// a bitonic merge sorts it; the buffer is emptied, the count reset and the
// threshold raised to the new k-th key.  Entries are ordered by (key, id)
// as in topk_common.cuh, so the head is what a full sort would keep.  With
// `thr_id`, the threshold is the k-th entry itself: its id, or -1 while the
// k-th slot is empty (so that no +inf candidate beats it).
__device__ __forceinline__ void warp_merge(float* keys, int* ids, int kp,
                                           int k, int cnt, int lane,
                                           int* count, float* thr,
                                           int* thr_id = nullptr) {
  float* bk = keys + kp;
  int* bi = ids + kp;
  int p2 = 1;
  while (p2 < cnt) p2 <<= 1;
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < p2 / 2; t += 32) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const float ka = bk[lo], kb = bk[hi];
        const int ia = bi[lo], ib = bi[hi];
        if (entry_greater(ka, ia, kb, ib) == up) {
          bk[lo] = kb; bk[hi] = ka;
          bi[lo] = ib; bi[hi] = ia;
        }
      }
      __syncwarp();
    }
  }
  for (int i = lane; i < kp; i += 32) {
    const float kb = bk[kp - 1 - i];
    const int ib = bi[kp - 1 - i];
    if (entry_greater(keys[i], ids[i], kb, ib)) {
      keys[i] = kb;
      ids[i] = ib;
    }
  }
  __syncwarp();
  for (int stride = kp >> 1; stride > 0; stride >>= 1) {
    for (int t = lane; t < kp / 2; t += 32) {
      const int lo = 2 * t - (t & (stride - 1));
      const int hi = lo + stride;
      const float ka = keys[lo], kb = keys[hi];
      const int ia = ids[lo], ib = ids[hi];
      if (entry_greater(ka, ia, kb, ib)) {
        keys[lo] = kb; keys[hi] = ka;
        ids[lo] = ib; ids[hi] = ia;
      }
    }
    __syncwarp();
  }
  for (int i = lane; i < kp; i += 32) {
    bk[i] = pos_inf();
    bi[i] = kEmptyId;
  }
  if (lane == 0) {
    *count = 0;
    *thr = keys[k - 1];
    if (thr_id != nullptr)
      *thr_id = keys[k - 1] < pos_inf() ? ids[k - 1] : -1;
  }
}

}  // namespace repro_select
