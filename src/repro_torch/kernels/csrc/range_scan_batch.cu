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
// Design: pairwise_keys.cu's SGEMM tile with scan_topk_batch.cu's staging
// and a radius epilogue, plain fp32 FMAs (no TF32, no tensor cores).
// - Block shapes.  The wide one takes 128 queries × 128 rows with 256
//   threads, each an 8 × 8 register micro-tile (rows tr*4 + {0..3} and
//   64 + tr*4 + {0..3}, the same for queries), read with 16-byte shared
//   loads laid out to broadcast: four loads for 64 FFMAs.  Buckets 64 and
//   128 fit one query tile, so every corpus byte is read once; at 33..64
//   queries the upper query groups lie past the last query and their
//   products are skipped (an 8 × 4 micro-tile).  The mid shape takes 32
//   queries × 256 rows (micro-tile 8 rows × 4 queries) for 17..32
//   queries; the narrow one 8 queries × 512 rows (4 × 4) for small
//   batches, where the corpus bytes bound the kernel.  A block owns one
//   query tile and one contiguous split of whole row tiles (the plan,
//   kernels/range_scan.py `batch_plan`, fills whole waves of the SMs).
// - Staging (scan_topk_batch.cu's): D is taken in chunks of 16 columns
//   through two shared buffers, transposed to [k][row] and [k][query].  A
//   thread loads 16-byte units (4 floats of one row or query; scalar loads
//   where D or a base does not allow it) two chunks ahead into two
//   register sets: one barrier per chunk.  A row's four units of a chunk
//   sit in neighbouring lanes (a warp reads 64 contiguous bytes of each of
//   8 rows and asks L2 for the whole 128-byte line), and the rows are
//   stored XOR-swizzled so that those lanes' transposed stores hit
//   distinct banks.  The next tile's first chunks are in flight during the
//   epilogue.  Zeros past D, past the split's last row and past the last
//   query.
// - Epilogue.  The tile's mask words are loaded after its product; each
//   thread owns runs of 4 consecutive rows per query, so it reads the
//   per-query mask 4 bytes at a time, writes keys 16 bytes at a time along
//   N (streaming stores) and hits 4 bytes at a time, scalar at a ragged N
//   (N % 4 != 0 or an unaligned base).  Hits are summed per thread over
//   the split, over the lanes that share a query, then per block in shared
//   memory, and added to each query's count with one integer atomicAdd
//   per (block, query).  Every output and mask offset is computed in 64
//   bits: Q·N·4 bytes passes 2^31 at 540 queries of a 1M-row corpus.
//
// Keys and hits bit for bit: each (row, query) dot product and each row's
// squared norm is one sequential fmaf chain over d = 0 .. ceil(D / 32)·32
// − 1, zeros past D (no split-K); ‖q‖² comes from repro_tile::query_norms
// and the key from repro_topk::order_key.  So a pair's key is
// replay_keys.cu's at every Q, shape and plan, and a row of a batch is the
// single-query call's.
#include "select_tile.cuh"

namespace {

using namespace repro_topk;
using namespace repro_select;

constexpr int kChunk = repro_tile::kDepth;  // each chain runs over whole chunks

// A block shape: BQ queries × BR rows, each thread an RM × QM micro-tile, a
// warp LR threads along rows, BK columns of D per staged chunk, MINB blocks
// per SM asked of the register allocator.  A micro-tile's rows (queries)
// come in groups of 4 consecutive ones, the groups BR / (RM / 4) rows
// (BQ / (QM / 4) queries) apart.  kernels/range_scan.py BATCH_SHAPES
// mirrors (BQ, BR, BK, MINB) and smem_bytes below.
template <int BQ_, int BR_, int QM_, int RM_, int LR_, int BK_, int MINB_>
struct Shape {
  static constexpr int BQ = BQ_, BR = BR_, QM = QM_, RM = RM_, LR = LR_;
  static constexpr int BK = BK_, MINB = MINB_;
  static constexpr int TQ = BQ / QM;          // threads along queries
  static constexpr int TR = BR / RM;          // threads along rows
  static constexpr int WR = TR / LR;          // warps along rows
  static constexpr int RG = RM / 4, RGS = BR / RG;  // row groups, stride
  static constexpr int QG = QM / 4, QGS = BQ / QG;  // query groups, stride
  static constexpr int NX = (BR + kThreads - 1) / kThreads;  // norms/thread
  static constexpr int kStage = BK * (BR + BQ);  // floats per buffer
  // staging units (4 floats each) per thread: RUT of rows, then QUT of
  // queries (the last ones past BQ·BK/4 idle)
  static constexpr int RU = BR * (BK / 4), QU = BQ * (BK / 4);
  static constexpr int RUT = RU / kThreads;
  static constexpr int QUT = (QU + kThreads - 1) / kThreads;
  static_assert(TQ * TR == kThreads, "the micro-tiles must cover the block");
  static_assert(RM % 4 == 0 && QM % 4 == 0, "fragment groups");
  static_assert(32 % LR == 0 && TR % LR == 0 && TQ % (32 / LR) == 0,
                "warp layout");
  static_assert(RU % kThreads == 0, "row units");
  static_assert(BK % 4 == 0 && BK <= 32 && kChunk % (2 * BK) == 0,
                "16-byte units, a swizzle within 32 rows; an even number "
                "of chunks per tile");

  // dynamic shared memory: two staging buffers and the tile's row norms
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * static_cast<size_t>(kStage) + BR);
};

using Wide = Shape<128, 128, 8, 8, 4, 16, 1>;
using Mid = Shape<32, 256, 4, 8, 4, 16, 2>;
using Narrow = Shape<8, 512, 4, 4, 16, 16, 2>;

// One 16-byte unit of corpus rows, read-only, asking L2 to fetch the whole
// 128-byte line around it: the row's next chunk is then an L2 hit
// (scan_topk_batch.cu measured the pattern).
__device__ __forceinline__ uint4 ld_rows(const float* p) {
  uint4 v;
  asm("ld.global.nc.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// QGA: the micro-tile's query groups that hold a query below qn (S::QG, or
// fewer when the block's upper query groups all lie past the last query).
template <class S, int METRIC, int QGA>
__global__ void __launch_bounds__(kThreads, S::MINB) range_batch_kernel(
    const float* __restrict__ corpus, const float* __restrict__ queries,
    const float* __restrict__ radius_keys, const int8_t* __restrict__ mask,
    int mask_mode, const int8_t* __restrict__ qvalid,
    float* __restrict__ out_keys, int8_t* __restrict__ out_hits,
    int* __restrict__ counts, int n, int d, int qn, int rows_per_split,
    int vec, int vec_out) {
  constexpr int BQ = S::BQ, BR = S::BR, BK = S::BK, QM = S::QM, RM = S::RM;
  constexpr int RG = S::RG, LR = S::LR;
  constexpr int QJ = 4 * QGA;  // the micro-tile's queries that are computed

  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                         // [2][kStage]
  float* s_cc = stage + 2 * S::kStage;         // [BR] row norms of the tile
  __shared__ float s_qq[BQ];
  __shared__ float s_rk[BQ];
  __shared__ int s_live[BQ];
  __shared__ int s_cnt[BQ];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tr = (warp % S::WR) * LR + lane % LR;
  const int tq = (warp / S::WR) * (32 / LR) + lane / LR;
  const int q0 = blockIdx.x * BQ;
  const int row0 = blockIdx.y * rows_per_split;
  const int row_end = min(n, row0 + rows_per_split);

  for (int qi = tid; qi < BQ; qi += kThreads) {
    const int q = q0 + qi;
    s_cnt[qi] = 0;
    s_live[qi] = q < qn && (qvalid == nullptr || qvalid[q] != 0);
    s_rk[qi] = q < qn ? radius_keys[q] : -pos_inf();
  }
  if (METRIC != kInnerProduct)
    repro_tile::query_norms<BQ>(queries, q0, qn, d, s_qq);

  const int tiles = max(0, (row_end - row0 + BR - 1) / BR);
  const int chunks = (d + kChunk - 1) / kChunk * (kChunk / BK);  // even
  const int steps = tiles * chunks;

  // This thread's staging units: row unit s holds columns r_col .. r_col
  // + 3 of tile row r_idx(s), a row's BK / 4 units in neighbouring lanes;
  // query unit s holds columns (v / BQ)·4 .. + 3 of query v % BQ,
  // v = q_unit(s) (none past QU).  In a staging buffer, column c of tile
  // row r lies at c·BR + (r ^ swz(c)), swz(c) = (c / 4)·(32 / (BK / 4)):
  // the lanes that store one column's rows hit distinct banks, and the
  // fragments' groups of 4 rows stay 4 consecutive floats.
  constexpr int UR = BK / 4;
  auto swz = [](int c) { return (c / 4) * (32 / UR); };
  auto r_idx = [&](int s) { return tid / UR + s * (kThreads / UR); };
  const int r_col = (tid % UR) * 4;
  auto q_unit = [&](int s) { return tid + s * kThreads; };

  // Load the units of global step `step` (tile step / chunks, chunk step %
  // chunks) into a register set.
  auto fetch = [&](int step, uint4 (&pre)[S::RUT + S::QUT]) {
    const int t0 = row0 + (step / chunks) * BR;
    const int k0 = (step % chunks) * BK;
#pragma unroll
    for (int s = 0; s < S::RUT; ++s) {
      pre[s] = make_uint4(0u, 0u, 0u, 0u);
      const int row = t0 + r_idx(s), c = k0 + r_col;
      if (row >= row_end || c >= d) continue;
      const float* p = corpus + static_cast<size_t>(row) * d + c;
      if (vec) {
        pre[s] = ld_rows(p);
      } else {
        unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) w[e] = __float_as_uint(__ldg(p + e));
        pre[s] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
#pragma unroll
    for (int s = 0; s < S::QUT; ++s) {
      uint4& x = pre[S::RUT + s];
      x = make_uint4(0u, 0u, 0u, 0u);
      const int v = q_unit(s);
      const int q = q0 + v % BQ, c = k0 + (v / BQ) * 4;
      if (v >= S::QU || q >= qn || c >= d) continue;
      const float* p = queries + static_cast<size_t>(q) * d + c;
      if (vec) {
        x = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) w[e] = __float_as_uint(__ldg(p + e));
        x = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };
  // Store one register set into a staging buffer, transposed.
  auto stash = [&](float* buf, const uint4 (&pre)[S::RUT + S::QUT]) {
#pragma unroll
    for (int s = 0; s < S::RUT; ++s) {
      float* p = buf + r_col * BR + (r_idx(s) ^ swz(r_col));
      p[0] = __uint_as_float(pre[s].x);
      p[BR] = __uint_as_float(pre[s].y);
      p[2 * BR] = __uint_as_float(pre[s].z);
      p[3 * BR] = __uint_as_float(pre[s].w);
    }
#pragma unroll
    for (int s = 0; s < S::QUT; ++s) {
      const int v = q_unit(s);
      if (v >= S::QU) continue;
      float* p = buf + BK * BR + (v / BQ) * 4 * BQ + v % BQ;
      const uint4& x = pre[S::RUT + s];
      p[0] = __uint_as_float(x.x);
      p[BQ] = __uint_as_float(x.y);
      p[2 * BQ] = __uint_as_float(x.z);
      p[3 * BQ] = __uint_as_float(x.w);
    }
  };

  // Two chunks in flight: the even steps go through set A and buffer 0,
  // the odd ones through set B and buffer 1, and a set is stored one
  // chunk's compute after the one its loads were issued in.
  uint4 pa[S::RUT + S::QUT], pb[S::RUT + S::QUT];
  float* const buf0 = stage;
  float* const buf1 = stage + S::kStage;
  if (steps > 0) fetch(0, pa);
  if (steps > 1) fetch(1, pb);
  if (steps > 0) stash(buf0, pa);
  __syncthreads();  // the per-query state, s_qq and chunk 0

  // the micro-tile's queries: j -> block query qi(j); its rows: i -> tile
  // row rl(i)
  auto qi_of = [&](int j) { return (j / 4) * S::QGS + tq * 4 + j % 4; };
  int cnt[QJ];
#pragma unroll
  for (int j = 0; j < QJ; ++j) cnt[j] = 0;

  for (int t = 0; t < tiles; ++t) {
    const int t0 = row0 + t * BR;
    float acc[RM][QJ];
    float xx[S::NX];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < QJ; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int x = 0; x < S::NX; ++x) xx[x] = 0.f;

    auto product = [&](const float* a_s) {
      const float* b_s = a_s + BK * BR;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[RM], b[QJ];
        fragment<RM, BR>(a_s + kk * BR, tr, a, swz(kk));
        fragment<QJ, BQ * QJ / QM>(b_s + kk * BQ, tq, b);
        if (METRIC != kInnerProduct) {
          // row norms: thread t sums rows t, t + 256, ... (one chain each)
#pragma unroll
          for (int x = 0; x < S::NX; ++x) {
            const int r = tid + x * kThreads;
            if (r < BR) {
              const float v = a_s[kk * BR + (r ^ swz(kk))];
              xx[x] = fmaf(v, v, xx[x]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < QJ; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    };
    for (int c = 0; c < chunks; c += 2) {
      const int step = t * chunks + c;
      if (step + 2 < steps) fetch(step + 2, pa);
      product(buf0);
      // buffer 1's readers passed the previous chunk's barrier
      stash(buf1, pb);
      __syncthreads();
      if (step + 3 < steps) fetch(step + 3, pb);
      product(buf1);
      // the next tile's first chunk is stored below, with this tile's
      // row norms
      if (c + 2 < chunks) {
        stash(buf0, pa);
        __syncthreads();
      }
    }
    // the tile's mask words, loaded after its product (held through it
    // they would cost the product registers): byte e of word (g, j) is 1
    // where row t0 + g·RGS + tr·4 + e is in the split and live for query
    // j (its lane and the row mask)
    unsigned mw[RG][QJ];
#pragma unroll
    for (int g = 0; g < RG; ++g) {
      const int row = t0 + g * S::RGS + tr * 4;
      const int avail = row_end - row;
      unsigned shared_w = avail >= 4 ? 0x01010101u
          : avail > 0 ? 0x01010101u & ((1u << (8 * avail)) - 1u) : 0u;
      if (mask_mode == kSharedMask && avail > 0)
        shared_w = mask4(mask + row, min(avail, 4));
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const int qi = qi_of(j);
        mw[g][j] = s_live[qi] != 0 ? shared_w : 0u;
        if (mask_mode == kPerQueryMask && avail > 0 && s_live[qi] != 0)
          mw[g][j] = mask4(mask + static_cast<size_t>(q0 + qi) * n + row,
                           min(avail, 4));
      }
    }
    if (METRIC != kInnerProduct) {
#pragma unroll
      for (int x = 0; x < S::NX; ++x) {
        const int r = tid + x * kThreads;
        if (r < BR) s_cc[r] = xx[x];
      }
    }
    // the other buffer's readers passed the last chunk's barrier
    if ((t + 1) * chunks < steps) stash(buf0, pa);
    __syncthreads();  // s_cc and the next tile's first chunk

    // keys, hits and counts of the micro-tile, 4 consecutive rows at a
    // time along N
#pragma unroll
    for (int j = 0; j < QJ; ++j) {
      const int qi = qi_of(j);
      const int q = q0 + qi;
      if (q >= qn) continue;
      const float qq = METRIC == kInnerProduct ? 0.f : s_qq[qi];
      const float rk = s_rk[qi];
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        const int rl = g * S::RGS + tr * 4;
        const int row = t0 + rl;
        const int avail = row_end - row;
        if (avail <= 0) continue;
        float key[4];
        unsigned hw = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float k = order_key<METRIC>(
              acc[4 * g + e][j],
              METRIC == kInnerProduct ? 0.f : s_cc[rl + e], qq);
          const bool hit = ((mw[g][j] >> (8 * e)) & 0xffu) != 0 && k <= rk;
          key[e] = hit ? k : pos_inf();
          hw |= hit ? 1u << (8 * e) : 0u;
        }
        cnt[j] += __popc(hw);
        const size_t o = static_cast<size_t>(q) * n + row;
        if (vec_out && avail >= 4) {
          __stcs(reinterpret_cast<float4*>(out_keys + o),
                 make_float4(key[0], key[1], key[2], key[3]));
          __stcs(reinterpret_cast<unsigned int*>(out_hits + o), hw);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (e < avail) {
              out_keys[o + e] = key[e];
              out_hits[o + e] = static_cast<int8_t>((hw >> (8 * e)) & 1u);
            }
          }
        }
      }
    }
  }

  // counts: over the LR lanes that share a query, then one shared atomic
  // per lane group and one global atomic per (block, query)
#pragma unroll
  for (int j = 0; j < QJ; ++j) {
#pragma unroll
    for (int o = 1; o < LR; o <<= 1)
      cnt[j] += __shfl_xor_sync(kFull, cnt[j], o);
    if (lane % LR == 0 && cnt[j] > 0) atomicAdd(&s_cnt[qi_of(j)], cnt[j]);
  }
  __syncthreads();
  for (int qi = tid; qi < BQ; qi += kThreads)
    if (q0 + qi < qn && s_cnt[qi] > 0) atomicAdd(&counts[q0 + qi], s_cnt[qi]);
}

template <class S, int METRIC, int QGA>
cudaError_t launch(const float* corpus, const float* queries,
                   const float* radius_keys, const int8_t* mask,
                   int mask_mode, const int8_t* qvalid, float* out_keys,
                   int8_t* out_hits, int* counts, int n, int d, int qn,
                   int rows_per_split, int splits, int vec, int vec_out,
                   cudaStream_t stream) {
  if (rows_per_split < S::BR || rows_per_split % S::BR != 0 ||
      static_cast<long long>(splits) * rows_per_split < n)
    return cudaErrorInvalidValue;
  auto kernel = range_batch_kernel<S, METRIC, QGA>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((qn + S::BQ - 1) / S::BQ, splits);
  kernel<<<grid, kThreads, S::kSmemBytes, stream>>>(
      corpus, queries, radius_keys, mask, mask_mode, qvalid, out_keys,
      out_hits, counts, n, d, qn, rows_per_split, vec, vec_out);
  return cudaGetLastError();
}

// The wide shape's upper query groups are all past the last query when Q
// fits the lower ones (buckets of 33..64 queries): their products are
// skipped, half the block's FMAs.
template <class S, int METRIC>
cudaError_t launch_groups(const float* corpus, const float* queries,
                          const float* radius_keys, const int8_t* mask,
                          int mask_mode, const int8_t* qvalid,
                          float* out_keys, int8_t* out_hits, int* counts,
                          int n, int d, int qn, int rows_per_split,
                          int splits, int vec, int vec_out,
                          cudaStream_t stream) {
  if constexpr (S::QG > 1) {
    if (qn <= S::QGS)
      return launch<S, METRIC, 1>(corpus, queries, radius_keys, mask,
                                  mask_mode, qvalid, out_keys, out_hits,
                                  counts, n, d, qn, rows_per_split, splits,
                                  vec, vec_out, stream);
  }
  return launch<S, METRIC, S::QG>(corpus, queries, radius_keys, mask,
                                  mask_mode, qvalid, out_keys, out_hits,
                                  counts, n, d, qn, rows_per_split, splits,
                                  vec, vec_out, stream);
}

template <class S>
cudaError_t launch_metric(int metric, const float* corpus,
                          const float* queries, const float* radius_keys,
                          const int8_t* mask, int mask_mode,
                          const int8_t* qvalid, float* out_keys,
                          int8_t* out_hits, int* counts, int n, int d, int qn,
                          int rows_per_split, int splits, int vec,
                          int vec_out, cudaStream_t stream) {
#define REPRO_RANGE_BATCH_LAUNCH(M_)                                          \
  launch_groups<S, M_>(corpus, queries, radius_keys, mask, mask_mode,       \
                       qvalid, out_keys, out_hits, counts, n, d, qn,         \
                       rows_per_split, splits, vec, vec_out, stream)
  switch (metric) {
    case kInnerProduct: return REPRO_RANGE_BATCH_LAUNCH(kInnerProduct);
    case kL2: return REPRO_RANGE_BATCH_LAUNCH(kL2);
    case kCosine: return REPRO_RANGE_BATCH_LAUNCH(kCosine);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_RANGE_BATCH_LAUNCH
}

}  // namespace

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
#define REPRO_RANGE_BATCH_SHAPE(S_)                                           \
  if (qt == S_::BQ)                                                           \
    return static_cast<int>(launch_metric<S_>(                                \
        metric, corpus, queries, radius_keys, mask, mask_mode, qvalid,        \
        out_keys, out_hits, counts, n, d, qn, rows_per_split, splits, vec,    \
        vec_out, stream));
  REPRO_RANGE_BATCH_SHAPE(Wide)
  REPRO_RANGE_BATCH_SHAPE(Mid)
  REPRO_RANGE_BATCH_SHAPE(Narrow)
#undef REPRO_RANGE_BATCH_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}
