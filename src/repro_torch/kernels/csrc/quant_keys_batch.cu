// Query-batched quantized order keys (distance + row predicate, no radius),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `quant_keys_batch_pallas`
// (src/repro/kernels/quant.py, body `_quant_keys_batch_kernel`): the masked
// order key of every (dequantized corpus row, query) pair, +inf where the
// row mask or the query's valid lane is 0, written query-major (Q, N).  The
// range path (kernels/quant.py) classifies rows against the radius with a
// per-row slack bound and replays the boundary band in exact fp32.
//
// Bound on the H100 at N = 1,000,000, D = 512, 100 live queries:
// operations, 2·N·D·Q = 102 GFLOP of fp32 FMAs, 1.528 ms at 67 TFLOP/s,
// against about 0.30 ms (int8) / 0.46 ms (bf16) to read the twin and the
// (Q, N) mask and write the (Q, N) keys once.  Design: PR 11's fp32 range
// kernel body (range_batch.cuh) without the radius test, with an int8 or
// bf16 row loader (fp32_tile.cuh) that widens each element (times its row
// scale for int8) as it is staged; query-major coalesced stores and 64-bit
// offsets.  Its launch plan is kernels/quant.py `keys_plan`.
#include "range_batch.cuh"

// Returns the launch's cudaError_t (0 on success).  `mode` is 0 for int8
// rows with (n,) fp32 `scales`, 1 for bf16 rows (`scales` not read).
// `out_keys` is (qn, n); `mask` is null for mask_mode 0, (n,) for 1 and
// query-major (qn, n) for 2; `qvalid` is null or (qn,); `qt` (queries per
// block) is 4, 16 or 64, with `splits` of `rows_per_split` rows.
extern "C" int quant_keys_batch_launch(
    const void* qcorpus, const float* scales, int mode, const float* queries,
    const int8_t* mask, int mask_mode, const int8_t* qvalid,
    float* out_keys, int n, int d, int qn, int metric, int qt,
    int rows_per_split, int splits, cudaStream_t stream) {
  using repro_range_batch::launch_any;
  if (mode == 0)
    return static_cast<int>(launch_any<false>(
        metric, qt,
        repro_tile::Int8Rows{static_cast<const int8_t*>(qcorpus), scales},
        queries, nullptr, mask, mask_mode, qvalid, out_keys, nullptr,
        nullptr, n, d, qn, rows_per_split, splits, stream));
  if (mode == 1)
    return static_cast<int>(launch_any<false>(
        metric, qt, repro_tile::Bf16Rows{static_cast<const uint16_t*>(qcorpus)},
        queries, nullptr, mask, mask_mode, qvalid, out_keys, nullptr,
        nullptr, n, d, qn, rows_per_split, splits, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}
