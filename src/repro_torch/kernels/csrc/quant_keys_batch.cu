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
// operations, 2·N·D·Q = 102 GFLOP of fp32 FMAs, 1.528 ms at 67 TFLOP/s
// (int8 rows are widened and scaled to fp32, never fed to an int8 dot,
// which would quantize the query and break the range path's slack bound),
// against about 0.30 ms (int8) / 0.46 ms (bf16) to read the twin and the
// (Q, N) mask and write the (Q, N) keys once.  At a few queries the twin's
// bytes bound it: 0.51 GB int8 (plus 4 MB of scales), 1.02 GB bf16.
//
// Design: range_scan_batch.cu's tile (range_tile.cuh: the same three block
// shapes and launch plan, kernels/range_scan.py `batch_plan`) with an int8
// or bf16 row loader and no radius.  A staging unit is 16 bytes of one twin
// row, 16 int8 or 8 bf16 columns, loaded two chunks ahead with the L2 line
// hint and dequantized to fp32 as it is stored (int8: times the row's
// scale, loaded once per tile); from the staging buffers on, the FMAs,
// norms and epilogue are the fp32 kernel's, keys only.  So the keys equal,
// bit for bit, range_scan_batch's on the dequantized corpus with every
// radius at +inf, and replay_keys.cu's on the dequantized rows.
#include "range_tile.cuh"

// Returns the launch's cudaError_t (0 on success).  `mode` is 0 for int8
// rows with (n,) fp32 `scales`, 1 for bf16 bit patterns (`scales` not
// read); `queries` (qn, d) fp32; `mask` null (`mask_mode` 0), (n,) (1) or
// query-major (qn, n) (2) int8; `qvalid` null or (qn,) int8; `out_keys`
// (qn, n).  `qt`, `rows_per_split` and `splits` as range_scan_batch_launch.
// `vec` only when d is a multiple of 16 / element size and the twin and
// query bases are 16-byte aligned; `vec_out` only when n % 4 == 0 and the
// key base is 16-byte aligned.
extern "C" int quant_keys_batch_launch(
    const void* qcorpus, const float* scales, int mode, const float* queries,
    const int8_t* mask, int mask_mode, const int8_t* qvalid,
    float* out_keys, int n, int d, int qn, int metric, int qt,
    int rows_per_split, int splits, int vec, int vec_out,
    cudaStream_t stream) {
  using namespace repro_range_tile;
  const Args a{queries, nullptr, mask, mask_mode, qvalid, out_keys, nullptr,
               nullptr, n, d, qn, rows_per_split, splits, vec, vec_out};
  if (mode == 0)
    return static_cast<int>(launch_any<Int8Rows, kKeys>(
        qt, metric, Int8Rows{static_cast<const int8_t*>(qcorpus), scales}, a,
        stream));
  if (mode == 1)
    return static_cast<int>(launch_any<Bf16Rows, kKeys>(
        qt, metric, Bf16Rows{static_cast<const uint16_t*>(qcorpus)}, a,
        stream));
  return static_cast<int>(cudaErrorInvalidValue);
}
