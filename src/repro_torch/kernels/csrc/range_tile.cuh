// The query-batched key tile of the two range kernels, for Hopper (sm_90a):
// range_scan_batch.cu (fp32 rows; keys, hits and counts at a per-query
// radius, or each query's hits appended to a buffer) and
// quant_keys_batch.cu (int8 / bf16 rows; masked keys, no radius).  For
// every (query, corpus row) pair it computes the order key and masks it
// with the row mask (none, shared (N,) or query-major (Q, N)) and the
// query's valid lane, all query-major (Q, N).
//
// Design: pairwise_keys.cu's SGEMM tile with scan_topk_batch.cu's staging
// and a 4-row epilogue, plain fp32 FMAs (no TF32, no tensor cores).
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
//   thread loads 16-byte units two chunks ahead into two register sets:
//   one barrier per chunk.  A row unit is 4 fp32, 8 bf16 or 16 int8
//   columns of one row (the row loaders below; scalar loads where D or a
//   base does not allow 16 bytes), a query unit 4 fp32 columns.  A row's
//   units of a chunk sit in neighbouring lanes, each load asks L2 for the
//   whole 128-byte line around it (the row's next chunks are then L2
//   hits), and a unit is widened to fp32 as it is stored (int8: times the
//   row's scale, loaded once per tile and register set), XOR-swizzled so
//   that the lanes' transposed stores hit distinct banks.  From the
//   staging buffers on, every loader runs the same FMAs.  The next tile's
//   first chunks are in flight during the epilogue.  Zeros past D, past
//   the split's last row and past the last query.
// - Epilogue.  The tile's mask words are loaded after its product; each
//   thread owns runs of 4 consecutive rows per query, so it reads the
//   per-query mask 4 bytes at a time and writes keys 16 bytes at a time
//   along N (streaming stores), scalar at a ragged N (N % 4 != 0 or an
//   unaligned base).  With HITS a key is +inf off the hits, the hits are
//   written 4 bytes at a time and summed per thread over the split, over
//   the lanes that share a query, then per block in shared memory, and
//   added to each query's count with one integer atomicAdd per (block,
//   query).  Every output and mask offset is computed in 64 bits: Q·N·4
//   bytes passes 2^31 at 540 queries of a 1M-row corpus.
// - Epilogue modes (`MODE`): KEYS (masked keys only), HITS (the radius
//   test, keys, hits and counts, above) and APPEND.  APPEND writes no
//   (Q, N) output: each hit's (key, row) goes, as one 64-bit word
//   (pack_hit below), into its query's row of a (Q, W) buffer, and each
//   query's count is the number of its hits, as in HITS.  A hit's slot:
//   per tile, the LR lanes that share a query (a warp's lane group) sum
//   their hits with an inclusive shuffle scan, the group's last lane adds
//   the group's total to counts[q] with one integer atomicAdd, whose
//   return value is the group's base, and each lane writes its hits at
//   base + its exclusive prefix.  So counts[q] ends at the exact hit
//   count, and the slots 0 .. count − 1 are each written once, in an
//   order the atomics choose; slots at or past W are not written (the
//   count still counts them).  A warp vote skips the scan where no lane
//   of the warp has a hit for the query.  The hits are rare where the
//   mode is used (a radius of about a hundred matches a query), so the
//   atomics are a few per query and tile; a block takes no barrier for
//   them.  range_scan_batch.cu sorts each row of the buffer.
//
// Keys bit for bit: each (row, query) dot product and each row's squared
// norm is one sequential fmaf chain over d = 0 .. ceil(D / 32)·32 − 1,
// zeros past D (no split-K); ‖q‖² comes from repro_tile::query_norms and
// the key from repro_topk::order_key.  So a pair's key is replay_keys.cu's
// on the (dequantized) rows at every Q, shape and plan, and a row of a
// batch is the single-query call's.
#pragma once

#include "select_tile.cuh"

// Internal linkage: each kernel library includes its own copy, so that two
// libraries loaded into one process (a kernel and its variants) share no
// symbol, not even a function-local static (set once per instantiation,
// below), which the dynamic linker would otherwise unify across them.
namespace {
namespace repro_range_tile {

using namespace repro_topk;
using namespace repro_select;

constexpr int kChunk = repro_tile::kDepth;  // each chain runs over whole chunks

// A block shape: BQ queries × BR rows, each thread an RM × QM micro-tile, a
// warp LR threads along rows, BK columns of D per staged chunk, MINB blocks
// per SM asked of the register allocator.  A micro-tile's rows (queries)
// come in groups of 4 consecutive ones, the groups BR / (RM / 4) rows
// (BQ / (QM / 4) queries) apart.  kernels/range_scan.py BATCH_SHAPES
// mirrors (BQ, BR, BK, MINB) and kSmemBytes below.
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
  // query units (4 floats each) per chunk and per thread (the last ones
  // past QU idle)
  static constexpr int QU = BQ * (BK / 4);
  static constexpr int QUT = (QU + kThreads - 1) / kThreads;
  // a staged column c of tile row r lies at c·BR + (r ^ swz(c)),
  // swz(c) = (c / 4)·kSwz: the lanes that store one column's rows hit
  // distinct banks, and the fragments' groups of 4 rows stay 4
  // consecutive floats
  static constexpr int kSwz = 32 / (BK / 4);
  static_assert(TQ * TR == kThreads, "the micro-tiles must cover the block");
  static_assert(RM % 4 == 0 && QM % 4 == 0, "fragment groups");
  static_assert(32 % LR == 0 && TR % LR == 0 && TQ % (32 / LR) == 0,
                "warp layout");
  static_assert(BK % 4 == 0 && BK <= 32 && kChunk % (2 * BK) == 0,
                "whole 4-column groups, a swizzle within 32 rows; an even "
                "number of chunks per tile");

  // dynamic shared memory: two staging buffers and the tile's row norms
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * static_cast<size_t>(kStage) + BR);
};

// The epilogue's modes (see the header).
enum Mode : int { kKeys = 0, kHits = 1, kAppend = 2 };

// One appended hit as a 64-bit word whose unsigned order is the (key, row)
// order with keys compared as floats: the high word is the key's bits made
// monotone (sign flipped for +, all bits for −), −0.0 first made +0.0 so
// that it ties +0.0; the low word is row·2 + 1 where the key was −0.0, so
// that unpack_key returns the key's own bits.  Rows are below 2^31, and
// distinct, so no two hits of a query share a word.
__device__ __forceinline__ unsigned long long pack_hit(float key, int row) {
  unsigned b = __float_as_uint(key);
  const unsigned neg0 = b == 0x80000000u;
  if (neg0) b = 0u;
  const unsigned hi = b ^ ((b & 0x80000000u) ? 0xffffffffu : 0x80000000u);
  return (static_cast<unsigned long long>(hi) << 32) |
         (static_cast<unsigned>(row) << 1) | neg0;
}
__device__ __forceinline__ float unpack_key(unsigned long long w) {
  if (w & 1ull) return __uint_as_float(0x80000000u);
  const unsigned hi = static_cast<unsigned>(w >> 32);
  return __uint_as_float(hi ^ ((hi & 0x80000000u) ? 0x80000000u
                                                  : 0xffffffffu));
}
__device__ __forceinline__ int unpack_row(unsigned long long w) {
  return static_cast<int>(static_cast<unsigned>(w) >> 1);
}

using Wide = Shape<128, 128, 8, 8, 4, 16, 1>;
using Mid = Shape<32, 256, 4, 8, 4, 16, 2>;
using Narrow = Shape<8, 512, 4, 4, 16, 16, 2>;

// One 16-byte unit of corpus rows, read-only, asking L2 to fetch the whole
// 128-byte line around it: the row's next chunk is then an L2 hit
// (scan_topk_batch.cu measured the pattern).
__device__ __forceinline__ uint4 ld_rows(const void* p) {
  uint4 v;
  asm("ld.global.nc.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned raw_bits(int8_t x) {
  return static_cast<uint8_t>(x);
}
__device__ __forceinline__ unsigned raw_bits(uint16_t x) { return x; }

// The 16 bytes of twin row elements at p: at once where `vec`, else
// element by element, the `avail` ones inside D and zeros past them.
template <typename T>
__device__ __forceinline__ uint4 load_unit(const T* p, int avail, int vec) {
  if (vec) return ld_rows(p);
  constexpr int UC = 16 / sizeof(T), PW = 4 / sizeof(T);  // per unit, word
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < UC; ++e)
    if (e < avail)
      w[e / PW] |= raw_bits(__ldg(p + e)) << (8 * sizeof(T) * (e % PW));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Row loaders.  `unit` loads the UC columns c .. c + UC − 1 of one row
// (c < d), `widen` turns them into fp32 for the staging buffer (`scale` is
// the row's, read only where kScaled; `lim` the unit's columns inside D).

// fp32 rows, stored as they are.  (Their own scalar loop: load_unit's
// form of it costs the fp32 kernel registers and 1–5% of its time.)
struct Fp32Rows {
  static constexpr int UC = 4;
  static constexpr bool kScaled = false;
  const float* x;
  __device__ __forceinline__ uint4 unit(int row, int c, int d,
                                        int vec) const {
    const float* p = x + static_cast<size_t>(row) * d + c;
    if (vec) return ld_rows(p);
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < d) w[e] = __float_as_uint(__ldg(p + e));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ void widen(const uint4& u, float, int,
                                        float (&v)[UC]) const {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
};

// int8 rows times their per-row fp32 scale: one rounded product per
// element, the reference's `q.astype(f32) * s` (select_tile.cuh `dequant`).
struct Int8Rows {
  static constexpr int UC = 16;
  static constexpr bool kScaled = true;
  const int8_t* q;
  const float* scales;
  __device__ __forceinline__ uint4 unit(int row, int c, int d,
                                        int vec) const {
    return load_unit(q + static_cast<size_t>(row) * d + c, d - c, vec);
  }
  __device__ __forceinline__ float scale(int row) const {
    return __ldg(scales + row);
  }
  // the columns past D are +0 whatever the scale (0 · scale is −0 or NaN
  // for a negative or non-finite one)
  __device__ __forceinline__ void widen(const uint4& u, float s, int lim,
                                        float (&v)[UC]) const {
    dequant<int8_t>(u, s, v);
    if (lim < UC) {
#pragma unroll
      for (int e = 0; e < UC; ++e)
        if (e >= lim) v[e] = 0.f;
    }
  }
};

// bf16 rows (raw 16-bit patterns) widened exactly; their scales are ones
// by construction and are not read.
struct Bf16Rows {
  static constexpr int UC = 8;
  static constexpr bool kScaled = false;
  const uint16_t* q;
  __device__ __forceinline__ uint4 unit(int row, int c, int d,
                                        int vec) const {
    return load_unit(q + static_cast<size_t>(row) * d + c, d - c, vec);
  }
  __device__ __forceinline__ void widen(const uint4& u, float, int,
                                        float (&v)[UC]) const {
    dequant<uint16_t>(u, 1.f, v);
  }
};

// QGA: the micro-tile's query groups that hold a query below qn (S::QG, or
// fewer when the block's upper query groups all lie past the last query).
// In KEYS, `radius_keys`, `out_hits` and `counts` are not read or written
// (null), and a key is +inf only where the mask or the lane is 0.  Only
// APPEND writes `pairs` ((qn, width) words) and only it leaves `out_keys`
// and `out_hits` unwritten (null).
template <class S, int METRIC, int QGA, class Rows, int MODE>
__global__ void __launch_bounds__(kThreads, S::MINB) range_tile_kernel(
    const Rows corpus, const float* __restrict__ queries,
    const float* __restrict__ radius_keys, const int8_t* __restrict__ mask,
    int mask_mode, const int8_t* __restrict__ qvalid,
    float* __restrict__ out_keys, int8_t* __restrict__ out_hits,
    int* __restrict__ counts, unsigned long long* __restrict__ pairs,
    int width, int n, int d, int qn, int rows_per_split, int vec,
    int vec_out) {
  constexpr bool HITS = MODE != kKeys;  // the radius test and the counts
  constexpr int BQ = S::BQ, BR = S::BR, BK = S::BK, QM = S::QM, RM = S::RM;
  constexpr int RG = S::RG, LR = S::LR;
  constexpr int QJ = 4 * QGA;  // the micro-tile's queries that are computed
  // row units of a chunk: UR per row, RU in all, RUT per thread (threads
  // past RU idle where RU < RUT·kThreads)
  constexpr int UC = Rows::UC, UR = BK / UC, RU = BR * UR;
  constexpr int RUT = (RU + kThreads - 1) / kThreads;
  constexpr bool kRagged = RU % kThreads != 0;
  constexpr int QUT = S::QUT;
  static_assert(BK % UC == 0, "whole row units per chunk");

  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                         // [2][kStage]
  float* s_cc = stage + 2 * S::kStage;         // [BR] row norms of the tile
  __shared__ float s_qq[BQ];
  __shared__ float s_rk[HITS ? BQ : 1];
  __shared__ int s_live[BQ];
  __shared__ int s_cnt[MODE == kHits ? BQ : 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tr = (warp % S::WR) * LR + lane % LR;
  const int tq = (warp / S::WR) * (32 / LR) + lane / LR;
  const int q0 = blockIdx.x * BQ;
  const int row0 = blockIdx.y * rows_per_split;
  const int row_end = min(n, row0 + rows_per_split);

  for (int qi = tid; qi < BQ; qi += kThreads) {
    const int q = q0 + qi;
    s_live[qi] = q < qn && (qvalid == nullptr || qvalid[q] != 0);
    if constexpr (MODE == kHits) s_cnt[qi] = 0;
    if constexpr (HITS) s_rk[qi] = q < qn ? radius_keys[q] : -pos_inf();
  }
  if (METRIC != kInnerProduct)
    repro_tile::query_norms<BQ>(queries, q0, qn, d, s_qq);

  const int tiles = max(0, (row_end - row0 + BR - 1) / BR);
  const int chunks = (d + kChunk - 1) / kChunk * (kChunk / BK);  // even
  const int steps = tiles * chunks;

  // This thread's staging units: row unit s holds columns r_col .. r_col
  // + UC − 1 of tile row r_idx(s), a row's UR units in neighbouring lanes;
  // query unit s holds columns (v / BQ)·4 .. + 3 of query v % BQ,
  // v = q_unit(s) (none past QU).
  auto swz = [](int c) { return (c / 4) * S::kSwz; };
  auto r_idx = [&](int s) { return tid / UR + s * (kThreads / UR); };
  const int r_col = (tid % UR) * UC;
  auto q_unit = [&](int s) { return tid + s * kThreads; };

  // Load the units of global step `step` (tile step / chunks, chunk step %
  // chunks) into a register set; a set loads its rows' scales with its
  // first chunk of a tile (set A takes the even chunks, set B the odd).
  auto fetch = [&](int step, uint4 (&pre)[RUT + QUT], float (&sc)[RUT]) {
    const int t0 = row0 + (step / chunks) * BR;
    const int k0 = (step % chunks) * BK;
#pragma unroll
    for (int s = 0; s < RUT; ++s) {
      pre[s] = make_uint4(0u, 0u, 0u, 0u);
      if (kRagged && r_idx(s) >= BR) continue;
      const int row = t0 + r_idx(s), c = k0 + r_col;
      if constexpr (Rows::kScaled) {
        if (k0 < 2 * BK) sc[s] = row < row_end ? corpus.scale(row) : 0.f;
      }
      if (row >= row_end || c >= d) continue;
      pre[s] = corpus.unit(row, c, d, vec);
    }
#pragma unroll
    for (int s = 0; s < QUT; ++s) {
      uint4& x = pre[RUT + s];
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
  // Store the register set of global step `step` into a staging buffer,
  // widened and transposed.
  auto stash = [&](float* buf, const uint4 (&pre)[RUT + QUT],
                   const float (&sc)[RUT], int step) {
#pragma unroll
    for (int s = 0; s < RUT; ++s) {
      if (kRagged && r_idx(s) >= BR) continue;
      float v[UC];
      corpus.widen(pre[s], sc[s], d - ((step % chunks) * BK + r_col), v);
#pragma unroll
      for (int g = 0; g < UC / 4; ++g) {
        const int c = r_col + 4 * g;
        float* p = buf + c * BR + (r_idx(s) ^ swz(c));
        p[0] = v[4 * g];
        p[BR] = v[4 * g + 1];
        p[2 * BR] = v[4 * g + 2];
        p[3 * BR] = v[4 * g + 3];
      }
    }
#pragma unroll
    for (int s = 0; s < QUT; ++s) {
      const int v = q_unit(s);
      if (v >= S::QU) continue;
      float* p = buf + BK * BR + (v / BQ) * 4 * BQ + v % BQ;
      const uint4& x = pre[RUT + s];
      p[0] = __uint_as_float(x.x);
      p[BQ] = __uint_as_float(x.y);
      p[2 * BQ] = __uint_as_float(x.z);
      p[3 * BQ] = __uint_as_float(x.w);
    }
  };

  // Two chunks in flight: the even steps go through set A and buffer 0,
  // the odd ones through set B and buffer 1, and a set is stored one
  // chunk's compute after the one its loads were issued in.
  uint4 pa[RUT + QUT], pb[RUT + QUT];
  float sa[RUT], sb[RUT];
#pragma unroll
  for (int s = 0; s < RUT; ++s) sa[s] = sb[s] = 0.f;
  float* const buf0 = stage;
  float* const buf1 = stage + S::kStage;
  if (steps > 0) fetch(0, pa, sa);
  if (steps > 1) fetch(1, pb, sb);
  if (steps > 0) stash(buf0, pa, sa, 0);
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
      if (step + 2 < steps) fetch(step + 2, pa, sa);
      product(buf0);
      // buffer 1's readers passed the previous chunk's barrier
      stash(buf1, pb, sb, step + 1);
      __syncthreads();
      if (step + 3 < steps) fetch(step + 3, pb, sb);
      product(buf1);
      // the next tile's first chunk is stored below, with this tile's
      // row norms
      if (c + 2 < chunks) {
        stash(buf0, pa, sa, step + 2);
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
    if ((t + 1) * chunks < steps) stash(buf0, pa, sa, (t + 1) * chunks);
    __syncthreads();  // s_cc and the next tile's first chunk

    if constexpr (MODE == kAppend) {
      // each hit of the micro-tile appended to its query's row of `pairs`
      // (no lane leaves the loop early: the lane group's shuffles need
      // every lane; a row past the split or a query past qn is never live)
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const int qi = qi_of(j);
        const float qq = METRIC == kInnerProduct ? 0.f : s_qq[qi];
        const float rk = s_rk[qi];
        float key[RG][4];
        unsigned hw[RG];
        int h = 0;
#pragma unroll
        for (int g = 0; g < RG; ++g) {
          const int rl = g * S::RGS + tr * 4;
          hw[g] = 0u;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            key[g][e] = order_key<METRIC>(
                acc[4 * g + e][j],
                METRIC == kInnerProduct ? 0.f : s_cc[rl + e], qq);
            const bool live = ((mw[g][j] >> (8 * e)) & 0xffu) != 0;
            hw[g] |= live && key[g][e] <= rk ? 1u << (8 * e) : 0u;
          }
          h += __popc(hw[g]);
        }
        if (!__any_sync(kFull, h != 0)) continue;  // warp-uniform
        int incl = h;  // inclusive scan over the lane group
#pragma unroll
        for (int o = 1; o < LR; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o, LR);
          if (lane % LR >= o) incl += v;
        }
        const int total = __shfl_sync(kFull, incl, LR - 1, LR);
        int base = 0;
        if (lane % LR == LR - 1 && total > 0)
          base = atomicAdd(&counts[q0 + qi], total);
        int slot = __shfl_sync(kFull, base, LR - 1, LR) + incl - h;
        if (h > 0) {
          unsigned long long* dst =
              pairs + static_cast<size_t>(q0 + qi) * width;
#pragma unroll
          for (int g = 0; g < RG; ++g) {
            const int row = t0 + g * S::RGS + tr * 4;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if ((hw[g] >> (8 * e)) & 1u) {
                if (slot < width) dst[slot] = pack_hit(key[g][e], row + e);
                ++slot;
              }
            }
          }
        }
      }
      continue;
    }
    // keys (and hits and counts) of the micro-tile, 4 consecutive rows at
    // a time along N
#pragma unroll
    for (int j = 0; j < QJ; ++j) {
      const int qi = qi_of(j);
      const int q = q0 + qi;
      if (q >= qn) continue;
      const float qq = METRIC == kInnerProduct ? 0.f : s_qq[qi];
      const float rk = HITS ? s_rk[qi] : 0.f;
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
          const bool live = ((mw[g][j] >> (8 * e)) & 0xffu) != 0;
          const bool hit = HITS ? live && k <= rk : live;
          key[e] = hit ? k : pos_inf();
          hw |= hit ? 1u << (8 * e) : 0u;
        }
        const size_t o = static_cast<size_t>(q) * n + row;
        if constexpr (HITS) cnt[j] += __popc(hw);
        if (vec_out && avail >= 4) {
          __stcs(reinterpret_cast<float4*>(out_keys + o),
                 make_float4(key[0], key[1], key[2], key[3]));
          if constexpr (HITS)
            __stcs(reinterpret_cast<unsigned int*>(out_hits + o), hw);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (e < avail) {
              out_keys[o + e] = key[e];
              if constexpr (HITS)
                out_hits[o + e] = static_cast<int8_t>((hw >> (8 * e)) & 1u);
            }
          }
        }
      }
    }
  }

  if constexpr (MODE == kHits) {
    // counts: over the LR lanes that share a query, then one shared
    // atomic per lane group and one global atomic per (block, query)
#pragma unroll
    for (int j = 0; j < QJ; ++j) {
#pragma unroll
      for (int o = 1; o < LR; o <<= 1)
        cnt[j] += __shfl_xor_sync(kFull, cnt[j], o);
      if (lane % LR == 0 && cnt[j] > 0) atomicAdd(&s_cnt[qi_of(j)], cnt[j]);
    }
    __syncthreads();
    for (int qi = tid; qi < BQ; qi += kThreads)
      if (q0 + qi < qn && s_cnt[qi] > 0)
        atomicAdd(&counts[q0 + qi], s_cnt[qi]);
  }
}

// A launch's arguments past the corpus (see range_tile_kernel).
struct Args {
  const float* queries;
  const float* radius_keys;
  const int8_t* mask;
  int mask_mode;
  const int8_t* qvalid;
  float* out_keys;
  int8_t* out_hits;
  int* counts;
  int n, d, qn, rows_per_split, splits, vec, vec_out;
  unsigned long long* pairs;  // APPEND only: (qn, width) words
  int width;
};

template <class S, int METRIC, int QGA, class Rows, int MODE>
cudaError_t launch(const Rows& corpus, const Args& a, cudaStream_t stream) {
  if (a.rows_per_split < S::BR || a.rows_per_split % S::BR != 0 ||
      static_cast<long long>(a.splits) * a.rows_per_split < a.n)
    return cudaErrorInvalidValue;
  auto kernel = range_tile_kernel<S, METRIC, QGA, Rows, MODE>;
  // once per instantiation (the process's one card)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmemBytes));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.qn + S::BQ - 1) / S::BQ, a.splits);
  kernel<<<grid, kThreads, S::kSmemBytes, stream>>>(
      corpus, a.queries, a.radius_keys, a.mask, a.mask_mode, a.qvalid,
      a.out_keys, a.out_hits, a.counts, a.pairs, a.width, a.n, a.d, a.qn,
      a.rows_per_split, a.vec, a.vec_out);
  return cudaGetLastError();
}

// The wide shape's upper query groups are all past the last query when Q
// fits the lower ones (buckets of 33..64 queries): their products are
// skipped, half the block's FMAs.
template <class S, int METRIC, class Rows, int MODE>
cudaError_t launch_groups(const Rows& corpus, const Args& a,
                          cudaStream_t stream) {
  if constexpr (S::QG > 1) {
    if (a.qn <= S::QGS)
      return launch<S, METRIC, 1, Rows, MODE>(corpus, a, stream);
  }
  return launch<S, METRIC, S::QG, Rows, MODE>(corpus, a, stream);
}

template <class S, class Rows, int MODE>
cudaError_t launch_metric(int metric, const Rows& corpus, const Args& a,
                          cudaStream_t stream) {
  switch (metric) {
    case kInnerProduct:
      return launch_groups<S, kInnerProduct, Rows, MODE>(corpus, a, stream);
    case kL2: return launch_groups<S, kL2, Rows, MODE>(corpus, a, stream);
    case kCosine:
      return launch_groups<S, kCosine, Rows, MODE>(corpus, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The block shape by its queries per block `qt` (128 wide, 32 mid, 8
// narrow), then the metric.
template <class Rows, int MODE>
cudaError_t launch_any(int qt, int metric, const Rows& corpus,
                       const Args& a, cudaStream_t stream) {
  if (qt == Wide::BQ)
    return launch_metric<Wide, Rows, MODE>(metric, corpus, a, stream);
  if (qt == Mid::BQ)
    return launch_metric<Mid, Rows, MODE>(metric, corpus, a, stream);
  if (qt == Narrow::BQ)
    return launch_metric<Narrow, Rows, MODE>(metric, corpus, a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace repro_range_tile
}  // namespace
