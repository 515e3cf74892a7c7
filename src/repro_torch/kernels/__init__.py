"""Kernels of the port: hand-written CUDA for Hopper, each with its plain
PyTorch version beside it.

* ``scan_topk.py`` — wrappers of the two fused scan + top-k kernels of the
  Q1 main path (``csrc/``), their plain versions, launch geometry;
* ``range_scan.py`` — wrappers of the two fused range-scan kernels of the
  Q2 and Q3 flat lowerings, their plain versions, launch geometry;
* ``distance.py`` — wrapper of the pairwise order-key kernel (a GEMM with a
  metric epilogue), its plain version, launch geometry;
* ``quant.py`` — wrappers of the two quantized scan kernels and the exact
  fp32 replay of ``EngineOptions.quant``, their plain versions, and the
  quantized paths' stage 2;
* ``ops.py`` — public contracts: mask layout, the stage-2 merges, the
  range compaction and ``pairwise_keys``;
* ``ref.py`` — pure-torch oracles;
* ``build.py`` — nvcc build at first use, ctypes loading.
"""
from .ops import (fused_range_scan, fused_range_scan_batch,
                  fused_range_topk_batch, fused_scan_topk,
                  fused_scan_topk_batch, pairwise_keys)
from .quant import fused_range_topk_batch_q, fused_scan_topk_batch_q

__all__ = ["fused_range_scan", "fused_range_scan_batch",
           "fused_range_topk_batch", "fused_range_topk_batch_q",
           "fused_scan_topk", "fused_scan_topk_batch",
           "fused_scan_topk_batch_q", "pairwise_keys"]
