// Query-batched quantized scan + filter + segment top-k, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `quant_scan_topk_batch_pallas`
// (src/repro/kernels/quant.py, body `_quant_topk_batch_kernel`): order keys
// of every (dequantized corpus row, query) pair, the shared (N,) or
// per-query (Q, N) row mask ANDed with the per-query valid lane, the
// minimum key of every 8-row segment (segment = row // 8, global), and each
// query's best `k` segments per corpus split, ascending by key and then
// segment id, (+inf, -1) in empty slots.  Stage 2 (kernels/quant.py) merges
// them, expands the segments back to rows and re-ranks those rows with the
// exact fp32 keys of replay_keys.cu.
//
// Bound on the H100 at N = 1,000,000, D = 512: operations at 100 queries
// (2·N·D·Q = 102 GFLOP of fp32 FMAs, 1.528 ms at 67 TFLOP/s, for both
// modes: int8 rows are widened and scaled to fp32, never fed to an int8
// dot, which would quantize the query and break the range path's slack
// bound); bytes at a few queries (the int8 twin is 0.51 GB, the bf16 twin
// 1.02 GB: 0.154 ms and 0.306 ms at 3.35 TB/s).
//
// Design (the SIMT SGEMM of pairwise_keys.cu with a selection epilogue):
// - A block keeps one list of 2·kp (key, id) pairs per query in shared
//   memory, which sets its query tile.  The wide shape takes 64 queries ×
//   256 rows (kp <= 128: 128 KB of lists, one block per SM; 100 queries
//   take two query tiles); each thread keeps an 8 × 8 register micro-tile
//   (rows tr*4 + {0..3} and 128 + tr*4 + {0..3}, queries tq*4 + {0..3} and
//   32 + tq*4 + {0..3}), read with 16-byte shared loads laid out to
//   broadcast: four loads for 64 FFMAs.  The mid shape takes 32 queries ×
//   256 rows (micro-tile 8 rows × 4 queries), two blocks per SM at
//   kp <= 128, for buckets of 17..32 queries and for kp = 256.  The narrow
//   shape takes 8 queries × 512 rows (micro-tile 4 × 4), for small
//   batches, where the twin's bytes bound the kernel, and for kp >= 512
//   (8 × 16 KB of lists at kp = 1,024).
// - Staging: D is taken in chunks of 16 columns through two shared
//   buffers, transposed to [k][row] and [k][query].  A thread loads
//   16-byte units (16 int8 or 8 bf16 columns of one twin row, 4 floats of
//   one query; scalar loads where D or a base does not allow it) two
//   chunks ahead into two register sets, and dequantizes a set as it
//   stores it to a buffer, so the inner loop is plain fp32 FFMAs: one
//   barrier per chunk.  A row's scale is loaded once per tile and set.
//   The next tile's first chunks are in flight during the selection, and
//   the tile's mask words are loaded during its last two chunks.  Zeros
//   past D, past the split's last row and past the last query.
// - Segments: a thread's rows come in groups of 4 consecutive rows and a
//   tile starts on a multiple of 8, so a segment is one thread's group and
//   its neighbour lane's (tr even, tr + 1; lanes l, l ^ 1): one register
//   minimum and one shuffle.  The even lane carries the segment on.
// - Selection: a candidate enters its query's buffer only if it beats the
//   query's current k-th key (topk_common.cuh's threshold and buffered
//   insert); counts are summed over the lanes that share a query before
//   one shared atomic per lane group, the lane group that takes a buffer
//   past kp flags its query, and one __syncthreads_or tells the block.
//   Each flagged list is then merged by one warp (warp_merge), not by the
//   block-wide sort_segments, whose 36 block barriers over every list per
//   merge took half the kernel's time at 100 queries.
//
// Keys bit for bit: the dequantized element is the one rounded product
// float(q) · scale (int8; the byte is widened exactly by integer
// arithmetic) or the exact widening (bf16) of select_tile.cuh's `dequant`;
// each (row, query) dot product and each row's squared norm is one
// sequential fmaf chain over d = 0 .. ceil(D / 32)·32 − 1, zeros past D, as
// every batched key kernel sums it (no split-K, no TF32); ‖q‖² comes from
// the same repro_tile::query_norms and the key from the same
// repro_topk::order_key.  So a segment's key is the minimum of
// replay_keys.cu's keys of its rows on the dequantized corpus, at every
// batch size and plan.
#include "select_tile.cuh"

namespace {

using namespace repro_topk;
using namespace repro_select;

constexpr int kSeg = 8;                     // rows per segment
constexpr int kChunk = repro_tile::kDepth;  // each chain runs over whole chunks

// A block shape: BQ queries × BR rows, each thread an RM × QM micro-tile, a
// warp LR threads along rows, BK columns of D per staged chunk, MINB blocks
// per SM asked of the register allocator.  A micro-tile's rows (queries)
// come in groups of 4 consecutive ones, the groups BR / (RM / 4) rows
// (BQ / (QM / 4) queries) apart.  kernels/quant.py QUANT_SHAPES mirrors
// (BQ, BR, BK, MINB) and smem_bytes below.
template <int BQ_, int BR_, int QM_, int RM_, int LR_, int BK_, int MINB_>
struct Shape {
  static constexpr int BQ = BQ_, BR = BR_, QM = QM_, RM = RM_, LR = LR_;
  static constexpr int BK = BK_, MINB = MINB_;
  static constexpr int TQ = BQ / QM;          // threads along queries
  static constexpr int TR = BR / RM;          // threads along rows
  static constexpr int WR = TR / LR;          // warps along rows
  static constexpr int RG = RM / 4, RGS = BR / RG;  // row groups, stride
  static constexpr int QG = QM / 4, QGS = BQ / QG;  // query groups, stride
  static constexpr int NX = BR / kThreads;    // row norms per thread
  static constexpr int SPT = BR / kSeg;       // segments per tile
  static constexpr int kStage = BK * (BR + BQ);  // floats per buffer
  static_assert(TQ * TR == kThreads, "the micro-tiles must cover the block");
  static_assert(RM % 4 == 0 && QM % 4 == 0, "fragment groups");
  static_assert(32 % LR == 0 && TR % LR == 0 && TQ == 32 / LR,
                "a warp spans all the block's query threads");
  static_assert(LR % 2 == 0, "a segment's two row groups in lanes l, l ^ 1");
  static_assert(BR % kThreads == 0 && BR % kSeg == 0, "norm threads");
  static_assert(BK % 16 == 0 && kChunk % (2 * BK) == 0,
                "16-byte units; an even number of chunks per tile");
  static_assert(BQ <= kThreads, "one thread per query for the flags");

  // dynamic shared memory: two staging buffers, the tile's row norms and
  // BQ lists of 2·kp (key, id) pairs
  static size_t smem_bytes(int kp) {
    return sizeof(float) * (2 * static_cast<size_t>(kStage) + BR) +
           static_cast<size_t>(BQ) * 2 * kp * (sizeof(float) + sizeof(int));
  }
  // the per-query state in static shared memory
  static constexpr size_t kStaticBytes = 6 * sizeof(int) * BQ;
};

using Wide = Shape<64, 256, 8, 8, 4, 16, 1>;
using Mid = Shape<32, 256, 4, 8, 4, 16, 2>;
using Narrow = Shape<8, 512, 4, 4, 16, 16, 2>;

// Staging units of a chunk for twin element type T: BR·BK/UC twin units
// (UC columns of one row each) then BQ·BK/4 query units (4 floats each).
template <class S, typename T>
struct Units {
  static constexpr int UC = 16 / static_cast<int>(sizeof(T));
  static constexpr int RU = S::BR * (S::BK / UC);
  static constexpr int QU = S::BQ * (S::BK / 4);
  static constexpr int UPT = (RU + QU + kThreads - 1) / kThreads;
  static_assert(RU % 32 == 0 && QU % 32 == 0, "unit kinds switch by warp");
};

template <class S, int METRIC, typename T>
__global__ void __launch_bounds__(kThreads, S::MINB) quant_topk_kernel(
    const T* __restrict__ qcorpus, const float* __restrict__ scales,
    const float* __restrict__ queries, const int8_t* __restrict__ mask,
    int mask_mode, const int8_t* __restrict__ qvalid,
    float* __restrict__ out_keys, int* __restrict__ out_ids, int n, int d,
    int qn, int k, int kp, int rows_per_split, int splits, int vec) {
  using U = Units<S, T>;
  constexpr int BQ = S::BQ, BR = S::BR, BK = S::BK, QM = S::QM, RG = S::RG;
  constexpr bool kInt8 = sizeof(T) == 1;
  const int seg = 2 * kp;

  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                         // [2][kStage]
  float* s_cc = stage + 2 * S::kStage;         // [BR] row norms of the tile
  float* l_keys = s_cc + BR;                   // [BQ][seg]
  int* l_ids = reinterpret_cast<int*>(l_keys + BQ * seg);
  __shared__ int s_cnt[BQ];                    // entries in the buffer
  __shared__ int s_need[BQ];                   // this tile's candidates
  __shared__ int s_flag[BQ];                   // list to re-sort
  __shared__ int s_live[BQ];
  __shared__ float s_thr[BQ];                  // the list's k-th key
  __shared__ float s_qq[BQ];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tr = (warp % S::WR) * S::LR + lane % S::LR;
  const int tq = lane / S::LR;
  const int q0 = blockIdx.x * BQ;
  const int row0 = blockIdx.y * rows_per_split;
  const int row_end = min(n, row0 + rows_per_split);

  for (int i = tid; i < BQ * seg; i += kThreads) {
    l_keys[i] = pos_inf();
    l_ids[i] = kEmptyId;
  }
  for (int qi = tid; qi < BQ; qi += kThreads) {
    const int q = q0 + qi;
    s_cnt[qi] = 0;
    s_need[qi] = 0;
    s_flag[qi] = 0;
    s_thr[qi] = pos_inf();
    s_live[qi] = q < qn && (qvalid == nullptr || qvalid[q] != 0);
  }
  if (METRIC != kInnerProduct)
    repro_tile::query_norms<BQ>(queries, q0, qn, d, s_qq);

  // this thread's staging units: kind 1 a twin unit (row offset `idx` in
  // the tile), kind 2 a query unit (query offset `idx`), 0 none; `col` is
  // the unit's first column within the chunk
  int kind[U::UPT], idx[U::UPT], col[U::UPT];
#pragma unroll
  for (int s = 0; s < U::UPT; ++s) {
    const int u = tid + s * kThreads;
    kind[s] = 0;
    idx[s] = 0;
    col[s] = 0;
    if (u < U::RU) {
      kind[s] = 1;
      idx[s] = u % BR;
      col[s] = (u / BR) * U::UC;
    } else if (u < U::RU + U::QU) {
      const int v = u - U::RU;
      kind[s] = 2;
      idx[s] = v % BQ;
      col[s] = (v / BQ) * 4;
    }
  }
  const int tiles = max(0, (row_end - row0 + BR - 1) / BR);
  const int chunks = (d + kChunk - 1) / kChunk * (kChunk / BK);  // even
  const int steps = tiles * chunks;

  // Load the units of global step `step` (tile step / chunks, chunk step %
  // chunks) into one of two register sets: set A takes the even steps,
  // set B the odd ones, and each loads its rows' scales at its first chunk
  // of a tile.
  auto fetch = [&](int step, uint4 (&pre)[U::UPT], float (&sc)[U::UPT],
                   int& pre_k0) {
    const int t0 = row0 + (step / chunks) * BR;
    const int k0 = (step % chunks) * BK;
    pre_k0 = k0;
#pragma unroll
    for (int s = 0; s < U::UPT; ++s) {
      pre[s] = make_uint4(0u, 0u, 0u, 0u);
      const int c = k0 + col[s];
      if (kind[s] == 1) {
        const int row = t0 + idx[s];
        const bool ok = row < row_end;
        if (kInt8 && k0 < 2 * BK) sc[s] = ok ? __ldg(scales + row) : 0.f;
        if (!ok || c >= d) continue;
        const T* p = qcorpus + static_cast<size_t>(row) * d + c;
        if (vec) {
          pre[s] = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < U::UC; ++e) {
            if (c + e < d) {
              const unsigned x = kInt8
                  ? static_cast<unsigned>(static_cast<uint8_t>(__ldg(p + e)))
                  : static_cast<unsigned>(__ldg(p + e));
              w[e / (U::UC / 4)] |= x << (8 * sizeof(T) * (e % (U::UC / 4)));
            }
          }
          pre[s] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      } else if (kind[s] == 2) {
        const int q = q0 + idx[s];
        if (q >= qn || c >= d) continue;
        const float* p = queries + static_cast<size_t>(q) * d + c;
        if (vec) {
          pre[s] = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < d) w[e] = __float_as_uint(__ldg(p + e));
          pre[s] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
  };
  // Dequantize one register set into a staging buffer, transposed.
  auto stash = [&](float* buf, const uint4 (&pre)[U::UPT],
                   const float (&sc)[U::UPT], int pre_k0) {
#pragma unroll
    for (int s = 0; s < U::UPT; ++s) {
      if (kind[s] == 1) {
        float v[U::UC];
        dequant<T>(pre[s], kInt8 ? sc[s] : 1.f, v);
        const int lim = d - (pre_k0 + col[s]);  // columns inside D
        if (lim < U::UC) {
#pragma unroll
          for (int e = 0; e < U::UC; ++e)
            if (e >= lim) v[e] = 0.f;
        }
        float* p = buf + col[s] * BR + idx[s];
#pragma unroll
        for (int e = 0; e < U::UC; ++e) p[e * BR] = v[e];
      } else if (kind[s] == 2) {
        float* p = buf + BK * BR + col[s] * BQ + idx[s];
        p[0] = __uint_as_float(pre[s].x);
        p[BQ] = __uint_as_float(pre[s].y);
        p[2 * BQ] = __uint_as_float(pre[s].z);
        p[3 * BQ] = __uint_as_float(pre[s].w);
      }
    }
  };

  // Two chunks in flight: the even steps go through set A and buffer 0,
  // the odd ones through set B and buffer 1, and a set is stored one
  // chunk's compute after the one its loads were issued in.
  uint4 pa[U::UPT], pb[U::UPT];
  float sa[U::UPT], sb[U::UPT];
  int ka = 0, kb = 0;
#pragma unroll
  for (int s = 0; s < U::UPT; ++s) sa[s] = sb[s] = 0.f;
  float* const buf0 = stage;
  float* const buf1 = stage + S::kStage;
  if (steps > 0) fetch(0, pa, sa, ka);
  if (steps > 1) fetch(1, pb, sb, kb);
  if (steps > 0) stash(buf0, pa, sa, ka);
  __syncthreads();  // the lists, the per-query state, s_qq and chunk 0

  for (int t = 0; t < tiles; ++t) {
    const int t0 = row0 + t * BR;
    float acc[S::RM][QM];
    float xx[S::NX];
#pragma unroll
    for (int i = 0; i < S::RM; ++i)
#pragma unroll
      for (int j = 0; j < QM; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int x = 0; x < S::NX; ++x) xx[x] = 0.f;

    auto product = [&](const float* a_s) {
      const float* b_s = a_s + BK * BR;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[S::RM], b[QM];
        fragment<S::RM, BR>(a_s + kk * BR, tr, a);
        fragment<QM, BQ>(b_s + kk * BQ, tq, b);
        if (METRIC != kInnerProduct) {
          // row norms: thread t sums rows t, t + 256, ... (one chain each)
#pragma unroll
          for (int x = 0; x < S::NX; ++x) {
            const float v = a_s[kk * BR + tid + x * kThreads];
            xx[x] = fmaf(v, v, xx[x]);
          }
        }
#pragma unroll
        for (int i = 0; i < S::RM; ++i)
#pragma unroll
          for (int j = 0; j < QM; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    };
    // the tile's mask words, loaded during its last two chunks: word
    // (g, j) holds the bytes of rows t0 + g·RGS + tr·4 + {0..3} for query
    // j (0 where no row is left in the split)
    unsigned mw[RG][QM];
    auto load_masks = [&]() {
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        const int row = t0 + g * S::RGS + tr * 4;
        const int avail = row_end - row;
        unsigned shared_w = avail > 0 ? kFull : 0u;
        if (mask_mode == kSharedMask && avail > 0)
          shared_w = mask4(mask + row, min(avail, 4));
#pragma unroll
        for (int j = 0; j < QM; ++j) {
          const int qi = (j / 4) * S::QGS + tq * 4 + j % 4;
          mw[g][j] = shared_w;
          if (mask_mode == kPerQueryMask && avail > 0 && s_live[qi] != 0)
            mw[g][j] = mask4(mask + static_cast<size_t>(q0 + qi) * n + row,
                             min(avail, 4));
        }
      }
    };
    for (int c = 0; c < chunks; c += 2) {
      const int step = t * chunks + c;
      if (c + 2 == chunks) load_masks();
      if (step + 2 < steps) fetch(step + 2, pa, sa, ka);
      product(buf0);
      // buffer 1's readers passed the previous chunk's barrier
      stash(buf1, pb, sb, kb);
      __syncthreads();
      if (step + 3 < steps) fetch(step + 3, pb, sb, kb);
      product(buf1);
      // the next tile's first chunk is stored after the selection
      if (c + 2 < chunks) {
        stash(buf0, pa, sa, ka);
        __syncthreads();
      }
    }
    if (METRIC != kInnerProduct) {
#pragma unroll
      for (int x = 0; x < S::NX; ++x) s_cc[tid + x * kThreads] = xx[x];
    }
    __syncthreads();  // s_cc; every thread is past the tile's last chunk

    // keys, masks and segment minima; the even lane of a pair carries them
    float cand[RG][QM];
    float thr[QM];
#pragma unroll
    for (int g = 0; g < RG; ++g) {
      const int rl = g * S::RGS + tr * 4;
      const int avail = row_end - (t0 + rl);
      float cc[4] = {0.f, 0.f, 0.f, 0.f};
      if (METRIC != kInnerProduct) {
#pragma unroll
        for (int e = 0; e < 4; ++e) cc[e] = s_cc[rl + e];
      }
#pragma unroll
      for (int j = 0; j < QM; ++j) {
        const int qi = (j / 4) * S::QGS + tq * 4 + j % 4;
        float m = pos_inf();
        if (avail > 0 && s_live[qi] != 0) {
          const unsigned w = mw[g][j];
          const float qq = METRIC == kInnerProduct ? 0.f : s_qq[qi];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (e < avail && ((w >> (8 * e)) & 0xffu) != 0)
              m = fminf(m, order_key<METRIC>(acc[4 * g + e][j], cc[e], qq));
          }
        }
        m = fminf(m, __shfl_xor_sync(kFull, m, 1));
        cand[g][j] = (tr & 1) ? pos_inf() : m;
      }
    }

    // pass 1: count the candidates per query, one atomic per lane group;
    // the group that takes a buffer past kp flags its query
#pragma unroll
    for (int j = 0; j < QM; ++j) thr[j] = s_thr[(j / 4) * S::QGS + tq * 4 + j % 4];
    bool mine = false;
#pragma unroll
    for (int g = 0; g < RG; ++g)
#pragma unroll
      for (int j = 0; j < QM; ++j) mine |= cand[g][j] < thr[j];
    bool over = false;
    if (__any_sync(kFull, mine)) {
#pragma unroll
      for (int j = 0; j < QM; ++j) {
        int cnt = 0;
#pragma unroll
        for (int g = 0; g < RG; ++g) cnt += cand[g][j] < thr[j];
#pragma unroll
        for (int o = 1; o < S::LR; o <<= 1)
          cnt += __shfl_xor_sync(kFull, cnt, o);
        if (lane % S::LR == 0 && cnt > 0) {
          const int qi = (j / 4) * S::QGS + tq * 4 + j % 4;
          const int before = atomicAdd(&s_need[qi], cnt);
          if (s_cnt[qi] + before + cnt > kp) {
            s_flag[qi] = 1;
            over = true;
          }
        }
      }
    }
    if (__syncthreads_or(over)) {
      for (int qi = warp; qi < BQ; qi += kThreads / 32)
        if (s_flag[qi])
          warp_merge(l_keys + qi * seg, l_ids + qi * seg, kp, k, s_cnt[qi],
                     lane, &s_cnt[qi], &s_thr[qi]);
      __syncthreads();
    }
    for (int qi = tid; qi < BQ; qi += kThreads) {
      s_flag[qi] = 0;
      s_need[qi] = 0;
    }

    // pass 2: against the (raised) thresholds, reserve slots per lane
    // group and write the candidates
#pragma unroll
    for (int j = 0; j < QM; ++j) thr[j] = s_thr[(j / 4) * S::QGS + tq * 4 + j % 4];
    mine = false;
#pragma unroll
    for (int g = 0; g < RG; ++g)
#pragma unroll
      for (int j = 0; j < QM; ++j) mine |= cand[g][j] < thr[j];
    if (__any_sync(kFull, mine)) {
      const int gl = lane % S::LR;
#pragma unroll
      for (int j = 0; j < QM; ++j) {
        const int qi = (j / 4) * S::QGS + tq * 4 + j % 4;
        int cnt = 0;
#pragma unroll
        for (int g = 0; g < RG; ++g) cnt += cand[g][j] < thr[j];
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < S::LR; o <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, o, S::LR);
          if (gl >= o) incl += y;
        }
        const int total = __shfl_sync(kFull, incl, S::LR - 1, S::LR);
        int base = 0;
        if (gl == 0 && total > 0) base = atomicAdd(&s_cnt[qi], total);
        int pos = __shfl_sync(kFull, base, 0, S::LR) + incl - cnt;
#pragma unroll
        for (int g = 0; g < RG; ++g) {
          if (cand[g][j] < thr[j]) {
            l_keys[qi * seg + kp + pos] = cand[g][j];
            l_ids[qi * seg + kp + pos] = (t0 + g * S::RGS + tr * 4) / kSeg;
            ++pos;
          }
        }
      }
    }
    if ((t + 1) * chunks < steps) stash(buf0, pa, sa, ka);
    __syncthreads();  // the next tile's first chunk; this tile's entries
  }

  bool has = false;
  for (int qi = tid; qi < BQ; qi += kThreads) {
    s_flag[qi] = s_cnt[qi] > 0;
    has |= s_cnt[qi] > 0;
  }
  if (__syncthreads_or(has)) {
    for (int qi = warp; qi < BQ; qi += kThreads / 32)
      if (s_flag[qi])
        warp_merge(l_keys + qi * seg, l_ids + qi * seg, kp, k, s_cnt[qi],
                   lane, &s_cnt[qi], &s_thr[qi]);
    __syncthreads();
  }
  const size_t width = static_cast<size_t>(splits) * k;
  for (int e = tid; e < BQ * k; e += kThreads) {
    const int qi = e / k, j = e % k;
    if (q0 + qi >= qn) continue;
    const float key = l_keys[qi * seg + j];
    const bool found = key < pos_inf();
    const size_t o = static_cast<size_t>(q0 + qi) * width +
                     static_cast<size_t>(blockIdx.y) * k + j;
    out_keys[o] = found ? key : pos_inf();
    out_ids[o] = found ? l_ids[qi * seg + j] : -1;
  }
}

template <class S, int METRIC, typename T>
cudaError_t launch(const void* qcorpus, const float* scales,
                   const float* queries, const int8_t* mask, int mask_mode,
                   const int8_t* qvalid, float* out_keys, int* out_ids, int n,
                   int d, int qn, int k, int rows_per_split, int splits,
                   int vec, cudaStream_t stream) {
  if (k < 1 || rows_per_split < S::BR || rows_per_split % S::BR != 0 ||
      static_cast<long long>(splits) * rows_per_split < n)
    return cudaErrorInvalidValue;
  const int kp = next_pow2(k < S::SPT ? S::SPT : k);
  const size_t smem = S::smem_bytes(kp);
  if (smem + S::kStaticBytes > static_cast<size_t>(kMaxBlockSmem))
    return cudaErrorInvalidValue;
  auto kernel = quant_topk_kernel<S, METRIC, T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((qn + S::BQ - 1) / S::BQ, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qcorpus), scales, queries, mask, mask_mode,
      qvalid, out_keys, out_ids, n, d, qn, k, kp, rows_per_split, splits,
      vec);
  return cudaGetLastError();
}

template <class S, typename T>
cudaError_t launch_metric(int metric, const void* qcorpus,
                          const float* scales, const float* queries,
                          const int8_t* mask, int mask_mode,
                          const int8_t* qvalid, float* out_keys, int* out_ids,
                          int n, int d, int qn, int k, int rows_per_split,
                          int splits, int vec, cudaStream_t stream) {
#define REPRO_QUANT_TOPK_LAUNCH(M_)                                           \
  launch<S, M_, T>(qcorpus, scales, queries, mask, mask_mode, qvalid,         \
                   out_keys, out_ids, n, d, qn, k, rows_per_split, splits,    \
                   vec, stream)
  switch (metric) {
    case kInnerProduct: return REPRO_QUANT_TOPK_LAUNCH(kInnerProduct);
    case kL2: return REPRO_QUANT_TOPK_LAUNCH(kL2);
    case kCosine: return REPRO_QUANT_TOPK_LAUNCH(kCosine);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_QUANT_TOPK_LAUNCH
}

template <class S>
cudaError_t launch_mode(int mode, int metric, const void* qcorpus,
                        const float* scales, const float* queries,
                        const int8_t* mask, int mask_mode,
                        const int8_t* qvalid, float* out_keys, int* out_ids,
                        int n, int d, int qn, int k, int rows_per_split,
                        int splits, int vec, cudaStream_t stream) {
  if (mode == 0)
    return launch_metric<S, int8_t>(metric, qcorpus, scales, queries, mask,
                                    mask_mode, qvalid, out_keys, out_ids, n,
                                    d, qn, k, rows_per_split, splits, vec,
                                    stream);
  if (mode == 1)
    return launch_metric<S, uint16_t>(metric, qcorpus, scales, queries, mask,
                                      mask_mode, qvalid, out_keys, out_ids, n,
                                      d, qn, k, rows_per_split, splits, vec,
                                      stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  `qcorpus` is (n, d)
// int8 (`mode` 0, with (n,) fp32 `scales`) or bf16 bit patterns (`mode` 1,
// `scales` not read); `queries` (qn, d) fp32; `mask` null (`mask_mode` 0),
// (n,) (1) or (qn, n) (2) int8; `qvalid` null or (qn,) int8; `out_keys` /
// `out_ids` (qn, splits·k).  The plan (kernels/quant.py `quant_plan`) gives
// the block shape by its queries per block `qt` (64 wide, 32 mid, 8
// narrow), the segments kept per split `k` and the splits of
// `rows_per_split` rows, a multiple of the shape's row tile.  `vec` only
// when d is a multiple of 16 / element size and both bases are 16-byte
// aligned.
extern "C" int quant_scan_topk_batch_launch(
    const void* qcorpus, const float* scales, int mode, const float* queries,
    const int8_t* mask, int mask_mode, const int8_t* qvalid,
    float* out_keys, int* out_ids, int n, int d, int qn, int k, int metric,
    int qt, int rows_per_split, int splits, int vec, cudaStream_t stream) {
#define REPRO_QUANT_TOPK_SHAPE(S_)                                            \
  if (qt == S_::BQ)                                                           \
    return static_cast<int>(launch_mode<S_>(                                  \
        mode, metric, qcorpus, scales, queries, mask, mask_mode, qvalid,      \
        out_keys, out_ids, n, d, qn, k, rows_per_split, splits, vec,          \
        stream));
  REPRO_QUANT_TOPK_SHAPE(Wide)
  REPRO_QUANT_TOPK_SHAPE(Mid)
  REPRO_QUANT_TOPK_SHAPE(Narrow)
#undef REPRO_QUANT_TOPK_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}
