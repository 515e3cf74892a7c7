// Query-batched fused range scan (distance + per-query radius + row
// predicate), for Hopper (sm_90a).
//
// Replaces the TPU kernel `range_scan_batch_pallas` (src/repro/kernels/
// range_scan.py, body `_range_batch_kernel`): for every (query, corpus row)
// pair the order key, hit = mask && qvalid[q] && key <= radius_keys[q], the
// keys with +inf off the hits, the int8 hits, and each query's hit count,
// all query-major (Q, N).
//
// Bound on the H100 at N = 1,000,000, D = 512, 100 live queries, fp32
// without TF32: operations.  2·N·D·Q = 102 GFLOP at the 67 TFLOP/s fp32
// CUDA-core peak is 1.528 ms, against about 0.79 ms to move the 2.05 GB
// corpus and the (Q, N) mask, keys and hits once.  At Q <= 16 the corpus
// bytes bound it instead.
//
// Design: range_tile.cuh's tile (128 × 128 wide, 32 × 256 mid and 8 × 512
// narrow shapes, register micro-tiles, swizzled staging two chunks ahead,
// a 4-row epilogue) with its fp32 row loader and the radius epilogue
// (HITS): keys +inf off the hits, int8 hits, per-query counts.  Keys and
// hits bit for bit: a pair's key is replay_keys.cu's at every Q, shape and
// plan, and a row of a batch is the single-query call's.
//
// The same library compacts each query's hits to its best W on the chip
// (kernels/range_scan.py `range_topk_batch`), for the Q2, Q3, Q5 and Q6
// range lists, in two launches:
// - range_append_batch_launch: the same tile in its APPEND epilogue (no
//   (Q, N) keys or hits; each hit's packed (key, row) word appended to its
//   query's row of a (Q, W) buffer at a slot the lane group's atomicAdd
//   on the query's count returns; counts exact, slots past W dropped);
// - range_sort_launch: one block per query.  A query whose count is at
//   most W loads its count words into shared memory (padded with
//   all-ones words to a power of two P <= W's, 8·P bytes), sorts them
//   ascending with a block-wide bitonic sort (one barrier per stage), and
//   writes the compaction's outputs for every slot 0 .. W − 1: the row id,
//   the raw similarity (−key for a similarity metric, else the key, from
//   the key's own bits) and valid, where the slot holds a hit with a
//   finite key; −1, 0 and 0 elsewhere.  A query whose count passes W
//   writes those empty slots in every position (the caller recomputes it
//   on the dense path).  The words' order is (key as a float, row), a
//   total order since rows are distinct, so the order the atomics filled
//   the buffer in cannot show, and the result equals a stable sort of the
//   dense keys (index/flat.py `compact_range`) bit for bit: −0.0 ties
//   +0.0 (lower row first), −inf and +inf hits sort first and last and
//   are not valid, as there.
// The pair's bound is the tile's above less the (Q, N) keys and hits it
// no longer stores, plus Q·W·9 bytes of outputs (4.6 MB at 128 × 4,096).
#include "range_tile.cuh"

// Returns the launch's cudaError_t (0 on success).  corpus (n, d) and
// queries (qn, d) fp32; `radius_keys` (qn,) fp32 order keys; `mask` null
// (`mask_mode` 0), (n,) (1) or query-major (qn, n) (2) int8; `qvalid` null
// or (qn,) int8; `out_keys` / `out_hits` (qn, n); `counts` (qn,) ints the
// caller zeroes.  The plan (kernels/range_scan.py `batch_plan`) gives the
// block shape by its queries per block `qt` (128 wide, 32 mid, 8 narrow)
// and the splits of `rows_per_split` rows, a multiple of the shape's row
// tile.  `vec` only when d % 4 == 0 and the corpus and query bases are
// 16-byte aligned; `vec_out` only when n % 4 == 0 and the key and hit
// bases are 16- and 4-byte aligned.
extern "C" int range_scan_batch_launch(
    const float* corpus, const float* queries, const float* radius_keys,
    const int8_t* mask, int mask_mode, const int8_t* qvalid,
    float* out_keys, int8_t* out_hits, int* counts, int n, int d, int qn,
    int metric, int qt, int rows_per_split, int splits, int vec, int vec_out,
    cudaStream_t stream) {
  using namespace repro_range_tile;
  const Args a{queries, radius_keys, mask, mask_mode, qvalid, out_keys,
               out_hits, counts, n, d, qn, rows_per_split, splits, vec,
               vec_out};
  return static_cast<int>(
      launch_any<Fp32Rows, kHits>(qt, metric, Fp32Rows{corpus}, a, stream));
}

// Returns the launch's cudaError_t.  As range_scan_batch_launch, without
// `out_keys` / `out_hits`: `pairs` (qn, width) 64-bit words (slots past a
// query's count are not written) and `counts` (qn,) ints the caller zeroes.
extern "C" int range_append_batch_launch(
    const float* corpus, const float* queries, const float* radius_keys,
    const int8_t* mask, int mask_mode, const int8_t* qvalid,
    unsigned long long* pairs, int width, int* counts, int n, int d, int qn,
    int metric, int qt, int rows_per_split, int splits, int vec,
    cudaStream_t stream) {
  using namespace repro_range_tile;
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{queries, radius_keys, mask, mask_mode, qvalid, nullptr,
               nullptr, counts, n, d, qn, rows_per_split, splits, vec, 0,
               pairs, width};
  return static_cast<int>(
      launch_any<Fp32Rows, kAppend>(qt, metric, Fp32Rows{corpus}, a, stream));
}

namespace {
namespace repro_range_sort {

using repro_range_tile::unpack_key;
using repro_range_tile::unpack_row;

constexpr int kSortThreads = 256;
// the widest W: the largest power of two whose words fit one block's
// shared memory (227 KB); kernels/range_scan.py APPEND_WIDTH mirrors it
constexpr int kMaxWidth = 16384;

__global__ void __launch_bounds__(kSortThreads) range_sort_kernel(
    const unsigned long long* __restrict__ pairs,
    const int* __restrict__ counts, int width, int similarity,
    int* __restrict__ out_ids, float* __restrict__ out_sims,
    int8_t* __restrict__ out_valid) {
  extern __shared__ unsigned long long s_words[];
  const int tid = threadIdx.x;
  const size_t o = static_cast<size_t>(blockIdx.x) * width;
  const int count = counts[blockIdx.x];
  const int m = count <= width ? count : 0;  // past W: empty slots
  int p = 1;
  while (p < m) p <<= 1;
  for (int i = tid; i < p; i += kSortThreads)
    s_words[i] = i < m ? pairs[o + i] : ~0ull;
  // ascending bitonic sort of p words: each stage's p / 2 pairs spread
  // over the block, a barrier after each
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = tid; t < p / 2; t += kSortThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = s_words[lo], b = s_words[hi];
        if ((a > b) == ((lo & size) == 0)) {
          s_words[lo] = b;
          s_words[hi] = a;
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < width; i += kSortThreads) {
    int id = -1;
    float sim = 0.f;
    int8_t valid = 0;
    if (i < m) {
      const unsigned long long w = s_words[i];
      const float key = unpack_key(w);
      if (isfinite(key)) {
        id = unpack_row(w);
        sim = similarity ? -key : key;
        valid = 1;
      }
    }
    out_ids[o + i] = id;
    out_sims[o + i] = sim;
    out_valid[o + i] = valid;
  }
}

}  // namespace repro_range_sort
}  // namespace

// Returns the launch's cudaError_t.  `pairs` and `counts` as
// range_append_batch_launch left them; `out_ids` int32, `out_sims` fp32
// and `out_valid` int8, each (qn, width); `similarity` 1 for inner product
// and cosine.  width in 1 .. 16,384.
extern "C" int range_sort_launch(const unsigned long long* pairs,
                                 const int* counts, int width, int qn,
                                 int similarity, int* out_ids,
                                 float* out_sims, int8_t* out_valid,
                                 cudaStream_t stream) {
  using namespace repro_range_sort;
  if (width < 1 || width > kMaxWidth || qn < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // once (the process's one card): the widest W's buffer
  static const cudaError_t attr = cudaFuncSetAttribute(
      range_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxWidth * sizeof(unsigned long long)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem =
      sizeof(unsigned long long) * repro_topk::next_pow2(width);
  range_sort_kernel<<<qn, kSortThreads, smem, stream>>>(
      pairs, counts, width, similarity, out_ids, out_sims, out_valid);
  return static_cast<int>(cudaGetLastError());
}
