// Query-batched fused scan + filter + top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel `scan_topk_batch_pallas`
// (src/repro/kernels/scan_topk.py, body `_scan_topk_batch_kernel`): order
// keys of every (corpus row, query) pair, the shared (N,) or per-query
// (Q, N) row mask ANDed with the per-query valid lane, and each query's best
// `k` (key, global row id) pairs per corpus split, ascending by key and then
// id, (+inf, -1) in empty slots.  Stage 2 is kernels/ops.py
// fused_scan_topk_batch.
//
// Bound on the H100 at N = 1,000,000, D = 512: operations at 100 queries
// (2·N·D·Q = 102 GFLOP of fp32 FMAs, 1.528 ms at 67 TFLOP/s), bytes at a
// few queries (the 2.05 GB corpus, 0.61 ms at 3.35 TB/s).
//
// Design: the fp32 twin of quant_scan_topk_batch.cu (pairwise_keys.cu's SGEMM
// with a selection epilogue), one candidate per row instead of one per
// 8-row segment.
// - A block keeps one list of 2·kp (key, id) pairs per query in shared
//   memory, which sets its query tile.  The wide shape takes 64 queries ×
//   256 rows (kp = 128: 128 KB of lists, one block per SM; 100 queries take
//   two query tiles); each thread keeps an 8 × 8 register micro-tile (rows
//   tr*4 + {0..3} and 128 + tr*4 + {0..3}, queries tq*4 + {0..3} and
//   32 + tq*4 + {0..3}), read with 16-byte shared loads laid out to
//   broadcast: four loads for 64 FFMAs.  The mid shape takes 32 queries ×
//   256 rows (micro-tile 8 rows × 4 queries) for buckets of 17..32 queries
//   and for kp = 256.  The narrow shape takes 8 queries × 512 rows
//   (micro-tile 4 × 4) for small batches, where the corpus's bytes bound
//   the kernel, and for kp >= 512 (8 × 16 KB of lists at kp = 1,024).
// - Staging: D is taken in chunks of 16 columns through two shared
//   buffers, transposed to [k][row] and [k][query].  A thread loads 16-byte
//   units (4 floats of one row or one query; scalar loads where D or a base
//   does not allow it) two chunks ahead into two register sets: one barrier
//   per chunk.  A row's four units of a chunk sit in neighbouring lanes (a
//   warp reads 64 contiguous bytes of each of 8 rows, and asks L2 for the
//   whole 128-byte line), and the rows are stored XOR-swizzled so that
//   those lanes' transposed stores hit distinct banks.  The next tile's
//   first chunks are in flight during the selection; the tile's mask words
//   are loaded after its product, before the barrier that ends it.  Zeros
//   past D, past the split's last row and past the last query.
// - Insertion rounds: a 256- or 512-row tile could push one candidate per
//   row into a list, so a tile enters the lists in rounds of 128 rows (the
//   wide and mid shapes' two row groups, the narrow shape's 4 rows of a
//   group one at a time), each flagged and merged before the next: a
//   buffer of kp = next_pow2(max(k, 128)) entries takes any round.  A
//   candidate enters its query's buffer only if it beats the query's k-th
//   entry by (key, id), which keeps the split's best k whatever order the
//   rows enter in.  A round's candidates are one bit mask per thread;
//   counts are summed over the lanes that share a query before one shared
//   atomic per lane group, the lane group that takes a buffer past kp flags
//   its query, and one __syncthreads_or tells the block.
// - Merges: one warp per list.  When any list overflows, every list whose
//   buffer is half full merges too, so that merges gather into few rounds
//   with the block's 8 warps busy (one list merging per round, 7 warps at
//   the barrier, was most of the selection at 100 queries).  At kp = 128
//   the wide and mid shapes merge in registers (warp_merge_regs: bitonic
//   stages of shuffles), the narrow shape and larger kp in shared memory
//   (warp_merge).
//
// Keys bit for bit: each (row, query) dot product and each row's squared
// norm is one sequential fmaf chain over d = 0 .. ceil(D / 32)·32 − 1,
// zeros past D (no split-K, no TF32, no tensor cores); ‖q‖² comes from
// repro_tile::query_norms and the key from repro_topk::order_key.  So a
// pair's key is replay_keys.cu's, at every batch size and plan.
#include "select_tile.cuh"

namespace {

using namespace repro_topk;
using namespace repro_select;

constexpr int kChunk = repro_tile::kDepth;  // each chain runs over whole chunks
constexpr int kRoundRows = 128;             // rows per insertion round

// A block shape: BQ queries × BR rows, each thread an RM × QM micro-tile, a
// warp LR threads along rows, BK columns of D per staged chunk, MINB blocks
// per SM asked of the register allocator.  A micro-tile's rows (queries)
// come in groups of 4 consecutive ones, the groups BR / (RM / 4) rows
// (BQ / (QM / 4) queries) apart.  kernels/scan_topk.py BATCH_SHAPES mirrors
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
  static constexpr int NR = BR / kRoundRows;  // insertion rounds per tile
  static constexpr int RPR = RM / NR;         // a thread's rows per round
  static constexpr int kStage = BK * (BR + BQ);  // floats per buffer
  // staging units (4 floats each) per thread: RUT of rows, then QUT of
  // queries (the last ones past BQ·BK/4 idle)
  static constexpr int RU = BR * (BK / 4), QU = BQ * (BK / 4);
  static constexpr int RUT = RU / kThreads;
  static constexpr int QUT = (QU + kThreads - 1) / kThreads;
  static_assert(TQ * TR == kThreads, "the micro-tiles must cover the block");
  static_assert(RM % 4 == 0 && QM % 4 == 0, "fragment groups");
  static_assert(32 % LR == 0 && TR % LR == 0 && TQ == 32 / LR,
                "a warp spans all the block's query threads");
  static_assert(BR % kThreads == 0 && RU % kThreads == 0, "row units");
  static_assert(NR * kRoundRows == BR && NR * RPR == RM &&
                    TR * RPR == kRoundRows && (RPR % 4 == 0 || 4 % RPR == 0),
                "a round is 128 rows: whole row groups or rows of one group");
  static_assert(BK % 4 == 0 && BK <= 32 && kChunk % (2 * BK) == 0,
                "16-byte units, a swizzle within 32 rows; an even number "
                "of chunks per tile");
  static_assert(BQ <= kThreads, "one thread per query for the flags");
  static_assert(RPR * QM <= 32, "a round's candidates in one 32-bit word");

  // dynamic shared memory: two staging buffers, the tile's row norms and
  // BQ lists of 2·kp (key, id) pairs
  static size_t smem_bytes(int kp) {
    return sizeof(float) * (2 * static_cast<size_t>(kStage) + BR) +
           static_cast<size_t>(BQ) * 2 * kp * (sizeof(float) + sizeof(int));
  }
  // the per-query state in static shared memory
  static constexpr size_t kStaticBytes = 7 * sizeof(int) * BQ;
};

using Wide = Shape<64, 256, 8, 8, 4, 16, 1>;
using Mid = Shape<32, 256, 4, 8, 4, 16, 2>;
using Narrow = Shape<8, 512, 4, 4, 16, 16, 2>;

// One 16-byte unit of corpus rows, read-only, asking L2 to fetch the whole
// 128-byte line around it: the row's next chunk is then an L2 hit.  A
// chunk reads BK·4 bytes of each of BR rows that lie D·4 bytes apart, a
// pattern the card streams far slower than whole lines (on an H100 at
// 1M × 512 and 8 queries, about 0.95 against 1.2 ms with a plain load:
// scripts/scan_variants.py).
__device__ __forceinline__ uint4 ld_rows(const float* p) {
  uint4 v;
  asm("ld.global.nc.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// (key, id) beats the threshold entry (tk, ti); ti is -1 while the k-th
// slot is empty, so a +inf key (a dead pair) never enters.
__device__ __forceinline__ bool beats(float key, int id, float tk, int ti) {
  return key < tk || (key == tk && id < ti);
}

// One bitonic compare-exchange stage over E entries per lane of a warp
// (entry i = lane·E + t): entry i takes the smaller of itself and entry
// i ^ stride, or the larger where `larger(i)` holds, by (key, id).  Called
// from fully unrolled loops, so `stride` is a constant: a shuffle for
// stride >= E, a register otherwise.
template <int E, class Larger>
__device__ __forceinline__ void bitonic_stage(float (&key)[E], int (&id)[E],
                                              int lane, int stride,
                                              Larger larger) {
  float pk[E];
  int pi[E];
#pragma unroll
  for (int t = 0; t < E; ++t) {
    if (stride >= E) {
      pk[t] = __shfl_xor_sync(kFull, key[t], stride / E);
      pi[t] = __shfl_xor_sync(kFull, id[t], stride / E);
    } else {
      pk[t] = key[t ^ stride];
      pi[t] = id[t ^ stride];
    }
  }
#pragma unroll
  for (int t = 0; t < E; ++t) {
    if (entry_greater(key[t], id[t], pk[t], pi[t]) != larger(lane * E + t)) {
      key[t] = pk[t];
      id[t] = pi[t];
    }
  }
}

// warp_merge (select_tile.cuh) for kp = 32·E with the list in registers,
// E entries per lane: the buffer sorted descending by a bitonic network of
// shuffles, the head keeping the smaller of entry i and buffer entry i (a
// bitonic sequence of the kp smallest), a bitonic merge sorting it.  The
// same (key, id) order, so the same head.
template <int E>
__device__ __forceinline__ void warp_merge_regs(float* keys, int* ids, int k,
                                                int lane, int* count,
                                                float* thr, int* thr_id) {
  constexpr int KP = 32 * E;
  static_assert(E % 4 == 0, "16-byte loads");
  float hk[E], bk[E];
  int hi[E], bi[E];
#pragma unroll
  for (int t = 0; t < E; t += 4) {
    const float4 a = *reinterpret_cast<const float4*>(keys + lane * E + t);
    const int4 b = *reinterpret_cast<const int4*>(ids + lane * E + t);
    const float4 c =
        *reinterpret_cast<const float4*>(keys + KP + lane * E + t);
    const int4 e = *reinterpret_cast<const int4*>(ids + KP + lane * E + t);
    hk[t] = a.x; hk[t + 1] = a.y; hk[t + 2] = a.z; hk[t + 3] = a.w;
    hi[t] = b.x; hi[t + 1] = b.y; hi[t + 2] = b.z; hi[t + 3] = b.w;
    bk[t] = c.x; bk[t + 1] = c.y; bk[t + 2] = c.z; bk[t + 3] = c.w;
    bi[t] = e.x; bi[t + 1] = e.y; bi[t + 2] = e.z; bi[t + 3] = e.w;
  }
  // the buffer, descending: the lower entry of a pair takes the larger in
  // the blocks of `size` that end descending (i & size == 0)
#pragma unroll
  for (int size = 2; size <= KP; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      bitonic_stage<E>(bk, bi, lane, stride, [&](int i) {
        return ((i & stride) == 0) == ((i & size) == 0);
      });
  }
  // ascending head against descending buffer: a bitonic sequence
#pragma unroll
  for (int t = 0; t < E; ++t) {
    if (entry_greater(hk[t], hi[t], bk[t], bi[t])) {
      hk[t] = bk[t];
      hi[t] = bi[t];
    }
  }
#pragma unroll
  for (int stride = KP >> 1; stride > 0; stride >>= 1)
    bitonic_stage<E>(hk, hi, lane, stride,
                     [&](int i) { return (i & stride) != 0; });
  const float4 inf4 = make_float4(pos_inf(), pos_inf(), pos_inf(), pos_inf());
  const int4 empty4 = make_int4(kEmptyId, kEmptyId, kEmptyId, kEmptyId);
#pragma unroll
  for (int t = 0; t < E; t += 4) {
    *reinterpret_cast<float4*>(keys + lane * E + t) =
        make_float4(hk[t], hk[t + 1], hk[t + 2], hk[t + 3]);
    *reinterpret_cast<int4*>(ids + lane * E + t) =
        make_int4(hi[t], hi[t + 1], hi[t + 2], hi[t + 3]);
    *reinterpret_cast<float4*>(keys + KP + lane * E + t) = inf4;
    *reinterpret_cast<int4*>(ids + KP + lane * E + t) = empty4;
  }
  __syncwarp();
  if (lane == 0) {
    *count = 0;
    *thr = keys[k - 1];
    if (thr_id != nullptr)
      *thr_id = keys[k - 1] < pos_inf() ? ids[k - 1] : -1;
  }
}

// Merge one query's list by one warp: in registers at kp = 128 (every k <=
// 128) in the shapes of 32 and more queries, where a warp merges several
// lists and the merges were most of the selection; in shared memory
// otherwise (the narrow shape's 8 lists take one warp each, and its
// 128 registers have no room for the list).
template <class S>
__device__ __forceinline__ void merge_list(float* keys, int* ids, int kp,
                                           int k, int cnt, int lane,
                                           int* count, float* thr,
                                           int* thr_id = nullptr) {
  if (S::BQ >= 32 && kp == 128)
    warp_merge_regs<4>(keys, ids, k, lane, count, thr, thr_id);
  else
    warp_merge(keys, ids, kp, k, cnt, lane, count, thr, thr_id);
}

template <class S, int METRIC>
__global__ void __launch_bounds__(kThreads, S::MINB) topk_batch_kernel(
    const float* __restrict__ corpus, const float* __restrict__ queries,
    const int8_t* __restrict__ mask, int mask_mode,
    const int8_t* __restrict__ qvalid, float* __restrict__ out_keys,
    int* __restrict__ out_ids, int n, int d, int qn, int k, int kp,
    int rows_per_split, int splits, int vec) {
  constexpr int BQ = S::BQ, BR = S::BR, BK = S::BK, QM = S::QM, RM = S::RM;
  constexpr int RG = S::RG, LR = S::LR;
  const int seg = 2 * kp;

  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                         // [2][kStage]
  float* s_cc = stage + 2 * S::kStage;         // [BR] row norms of the tile
  float* l_keys = s_cc + BR;                   // [BQ][seg]
  int* l_ids = reinterpret_cast<int*>(l_keys + BQ * seg);
  __shared__ int s_cnt[BQ];                    // entries in the buffer
  __shared__ int s_need[BQ];                   // this round's candidates
  __shared__ int s_flag[BQ];                   // list to merge
  __shared__ int s_live[BQ];
  __shared__ float s_thr[BQ];                  // the list's k-th entry:
  __shared__ int s_tid[BQ];                    //   key and id
  __shared__ float s_qq[BQ];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tr = (warp % S::WR) * LR + lane % LR;
  const int tq = lane / LR;
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
    s_tid[qi] = -1;
    s_live[qi] = q < qn && (qvalid == nullptr || qvalid[q] != 0);
  }
  if (METRIC != kInnerProduct)
    repro_tile::query_norms<BQ>(queries, q0, qn, d, s_qq);

  const int tiles = max(0, (row_end - row0 + BR - 1) / BR);
  const int chunks = (d + kChunk - 1) / kChunk * (kChunk / BK);  // even
  const int steps = tiles * chunks;

  // This thread's staging units: row unit s holds columns r_col .. r_col
  // + 3 of tile row r_idx(s), a row's BK / 4 units in neighbouring lanes (a
  // warp loads whole BK-column pieces of 32 / (BK / 4) rows); query unit s
  // holds columns (v / BQ)·4 .. + 3 of query v % BQ, v = q_unit(s) (none
  // past QU).  In a staging buffer, column c of tile row r lies at
  // c·BR + (r ^ swz(c)), swz(c) = (c / 4)·(32 / (BK / 4)): the lanes that
  // store one column's rows hit distinct banks, and the fragments' groups
  // of 4 rows stay 4 consecutive floats.
  constexpr int UR = BK / 4;
  auto swz = [](int c) { return (c / 4) * (32 / UR); };
  auto r_idx = [&](int s) { return tid / UR + s * (kThreads / UR); };
  const int r_col = (tid % UR) * 4;
  auto q_unit = [&](int s) { return tid + s * kThreads; };

  // Load the units of global step `step` (tile step / chunks, chunk step %
  // chunks) into a register set: set A takes the even steps, set B the odd
  // ones.
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
  __syncthreads();  // the lists, the per-query state, s_qq and chunk 0

  for (int t = 0; t < tiles; ++t) {
    const int t0 = row0 + t * BR;
    float acc[RM][QM];
    float xx[S::NX];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < QM; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int x = 0; x < S::NX; ++x) xx[x] = 0.f;

    auto product = [&](const float* a_s) {
      const float* b_s = a_s + BK * BR;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[RM], b[QM];
        fragment<RM, BR>(a_s + kk * BR, tr, a, swz(kk));
        fragment<QM, BQ>(b_s + kk * BQ, tq, b);
        if (METRIC != kInnerProduct) {
          // row norms: thread t sums rows t, t + 256, ... (one chain each)
#pragma unroll
          for (int x = 0; x < S::NX; ++x) {
            const float v = a_s[kk * BR + ((tid + x * kThreads) ^ swz(kk))];
            xx[x] = fmaf(v, v, xx[x]);
          }
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < QM; ++j)
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
      // the next tile's first chunk is stored after the selection
      if (c + 2 < chunks) {
        stash(buf0, pa);
        __syncthreads();
      }
    }
    // the tile's mask words, loaded after its product (held through it
    // they cost the product more registers than their latency costs
    // here): byte e of word (g, j) is 1 where row t0 + g·RGS + tr·4 + e is
    // in the split and live for query j (its lane and the row mask)
    unsigned mw[RG][QM];
#pragma unroll
    for (int g = 0; g < RG; ++g) {
      const int row = t0 + g * S::RGS + tr * 4;
      const int avail = row_end - row;
      unsigned shared_w = avail >= 4 ? kFull
          : avail > 0 ? (1u << (8 * avail)) - 1u : 0u;
      if (mask_mode == kSharedMask && avail > 0)
        shared_w = mask4(mask + row, min(avail, 4));
#pragma unroll
      for (int j = 0; j < QM; ++j) {
        const int qi = (j / 4) * S::QGS + tq * 4 + j % 4;
        mw[g][j] = s_live[qi] != 0 ? shared_w : 0u;
        if (mask_mode == kPerQueryMask && avail > 0 && s_live[qi] != 0)
          mw[g][j] = mask4(mask + static_cast<size_t>(q0 + qi) * n + row,
                           min(avail, 4));
      }
    }
    if (METRIC != kInnerProduct) {
#pragma unroll
      for (int x = 0; x < S::NX; ++x) s_cc[tid + x * kThreads] = xx[x];
    }
    __syncthreads();  // s_cc; every thread is past the tile's last chunk

    // keys of the live pairs, +inf elsewhere, in place of the products;
    // micro-tile row i is tile row rl(i)
    auto rl = [&](int i) { return (i / 4) * S::RGS + tr * 4 + i % 4; };
    float qq[QM];
#pragma unroll
    for (int j = 0; j < QM; ++j)
      qq[j] = METRIC == kInnerProduct
          ? 0.f : s_qq[(j / 4) * S::QGS + tq * 4 + j % 4];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float cc = METRIC == kInnerProduct ? 0.f : s_cc[rl(i)];
#pragma unroll
      for (int j = 0; j < QM; ++j) {
        const bool live = ((mw[i / 4][j] >> (8 * (i % 4))) & 0xffu) != 0;
        acc[i][j] =
            live ? order_key<METRIC>(acc[i][j], cc, qq[j]) : pos_inf();
      }
    }

    // the insertion rounds: round r takes micro-tile rows r·RPR ..
    // (r + 1)·RPR − 1, 128 tile rows.  A round's candidates are one bit
    // each, bit ii·QM + j for micro-tile row r·RPR + ii and query j.
    float thr[QM];
    int thr_id[QM];
    auto thresholds = [&]() {
#pragma unroll
      for (int j = 0; j < QM; ++j) {
        const int qi = (j / 4) * S::QGS + tq * 4 + j % 4;
        thr[j] = s_thr[qi];
        thr_id[j] = s_tid[qi];
      }
    };
    auto candidates = [&](int r) {
      unsigned bits = 0u;
#pragma unroll
      for (int ii = 0; ii < S::RPR; ++ii) {
        const int i = r * S::RPR + ii;
#pragma unroll
        for (int j = 0; j < QM; ++j)
          if (beats(acc[i][j], t0 + rl(i), thr[j], thr_id[j]))
            bits |= 1u << (ii * QM + j);
      }
      return bits;
    };
    // the bits of query j's candidates
    auto query_bits = [](int j) {
      unsigned m = 0u;
#pragma unroll
      for (int ii = 0; ii < S::RPR; ++ii) m |= 1u << (ii * QM + j);
      return m;
    };
#pragma unroll
    for (int r = 0; r < S::NR; ++r) {
      // pass 1: count the candidates per query, one atomic per lane group;
      // the group that takes a buffer past kp flags its query
      thresholds();
      unsigned bits = candidates(r);
      bool over = false;
      if (__any_sync(kFull, bits != 0u)) {
#pragma unroll
        for (int j = 0; j < QM; ++j) {
          int cnt = __popc(bits & query_bits(j));
#pragma unroll
          for (int o = 1; o < LR; o <<= 1)
            cnt += __shfl_xor_sync(kFull, cnt, o);
          if (lane % LR == 0 && cnt > 0) {
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
        // with the flagged lists, every list whose buffer is half full:
        // lists fill at about the same rate, so merges gather into few
        // rounds, where the block's warps merge in parallel, instead of
        // one list per round while the other warps wait at the barrier
        for (int qi = warp; qi < BQ; qi += kThreads / 32)
          if (s_flag[qi] || 2 * s_cnt[qi] >= kp)
            merge_list<S>(l_keys + qi * seg, l_ids + qi * seg, kp, k,
                          s_cnt[qi], lane, &s_cnt[qi], &s_thr[qi],
                          &s_tid[qi]);
        __syncthreads();
        // against the raised thresholds
        thresholds();
        bits = candidates(r);
      }
      for (int qi = tid; qi < BQ; qi += kThreads) {
        s_flag[qi] = 0;
        s_need[qi] = 0;
      }

      // pass 2: reserve slots per lane group and write the candidates
      if (__any_sync(kFull, bits != 0u)) {
        const int gl = lane % LR;
#pragma unroll
        for (int j = 0; j < QM; ++j) {
          const int qi = (j / 4) * S::QGS + tq * 4 + j % 4;
          const int cnt = __popc(bits & query_bits(j));
          int incl = cnt;
#pragma unroll
          for (int o = 1; o < LR; o <<= 1) {
            const int y = __shfl_up_sync(kFull, incl, o, LR);
            if (gl >= o) incl += y;
          }
          const int total = __shfl_sync(kFull, incl, LR - 1, LR);
          int base = 0;
          if (gl == 0 && total > 0) base = atomicAdd(&s_cnt[qi], total);
          int pos = __shfl_sync(kFull, base, 0, LR) + incl - cnt;
#pragma unroll
          for (int ii = 0; ii < S::RPR; ++ii) {
            const int i = r * S::RPR + ii;
            if (bits & (1u << (ii * QM + j))) {
              l_keys[qi * seg + kp + pos] = acc[i][j];
              l_ids[qi * seg + kp + pos] = t0 + rl(i);
              ++pos;
            }
          }
        }
      }
      // the next round's counts read this one's; the last round's barrier
      // is the tile's, below
      if (r + 1 < S::NR) __syncthreads();
    }
    if ((t + 1) * chunks < steps) stash(buf0, pa);
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
        merge_list<S>(l_keys + qi * seg, l_ids + qi * seg, kp, k,
                      s_cnt[qi], lane, &s_cnt[qi], &s_thr[qi]);
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

template <class S, int METRIC>
cudaError_t launch(const float* corpus, const float* queries,
                   const int8_t* mask, int mask_mode, const int8_t* qvalid,
                   float* out_keys, int* out_ids, int n, int d, int qn, int k,
                   int rows_per_split, int splits, int vec,
                   cudaStream_t stream) {
  if (k < 1 || rows_per_split < S::BR || rows_per_split % S::BR != 0 ||
      static_cast<long long>(splits) * rows_per_split < n)
    return cudaErrorInvalidValue;
  const int kp = next_pow2(k < kRoundRows ? kRoundRows : k);
  const size_t smem = S::smem_bytes(kp);
  if (smem + S::kStaticBytes > static_cast<size_t>(kMaxBlockSmem))
    return cudaErrorInvalidValue;
  auto kernel = topk_batch_kernel<S, METRIC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((qn + S::BQ - 1) / S::BQ, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      corpus, queries, mask, mask_mode, qvalid, out_keys, out_ids, n, d, qn,
      k, kp, rows_per_split, splits, vec);
  return cudaGetLastError();
}

template <class S>
cudaError_t launch_metric(int metric, const float* corpus,
                          const float* queries, const int8_t* mask,
                          int mask_mode, const int8_t* qvalid,
                          float* out_keys, int* out_ids, int n, int d, int qn,
                          int k, int rows_per_split, int splits, int vec,
                          cudaStream_t stream) {
#define REPRO_TOPK_BATCH_LAUNCH(M_)                                           \
  launch<S, M_>(corpus, queries, mask, mask_mode, qvalid, out_keys, out_ids,  \
                n, d, qn, k, rows_per_split, splits, vec, stream)
  switch (metric) {
    case kInnerProduct: return REPRO_TOPK_BATCH_LAUNCH(kInnerProduct);
    case kL2: return REPRO_TOPK_BATCH_LAUNCH(kL2);
    case kCosine: return REPRO_TOPK_BATCH_LAUNCH(kCosine);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_TOPK_BATCH_LAUNCH
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  corpus (n, d) and
// queries (qn, d) fp32; `mask` null (`mask_mode` 0), (n,) (1) or
// query-major (qn, n) (2) int8; `qvalid` null or (qn,) int8; `out_keys` /
// `out_ids` (qn, splits·k).  The plan (kernels/scan_topk.py `batch_plan`)
// gives the block shape by its queries per block `qt` (64 wide, 32 mid, 8
// narrow) and the splits of `rows_per_split` rows, a multiple of the
// shape's row tile.  `vec` only when d % 4 == 0 and both bases are 16-byte
// aligned.
extern "C" int scan_topk_batch_launch(
    const float* corpus, const float* queries, const int8_t* mask,
    int mask_mode, const int8_t* qvalid, float* out_keys, int* out_ids,
    int n, int d, int qn, int k, int metric, int qt, int rows_per_split,
    int splits, int vec, cudaStream_t stream) {
#define REPRO_TOPK_BATCH_SHAPE(S_)                                            \
  if (qt == S_::BQ)                                                           \
    return static_cast<int>(launch_metric<S_>(                                \
        metric, corpus, queries, mask, mask_mode, qvalid, out_keys, out_ids,  \
        n, d, qn, k, rows_per_split, splits, vec, stream));
  REPRO_TOPK_BATCH_SHAPE(Wide)
  REPRO_TOPK_BATCH_SHAPE(Mid)
  REPRO_TOPK_BATCH_SHAPE(Narrow)
#undef REPRO_TOPK_BATCH_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}
