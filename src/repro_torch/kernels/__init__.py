"""Kernels of the port: hand-written CUDA for Hopper, each with its plain
PyTorch version beside it.

* ``scan_topk.py`` — wrappers of the two fused scan + top-k kernels of the
  Q1 main path (``csrc/``), their plain versions, launch geometry;
* ``ops.py`` — public contracts: mask layout and the stage-2 merges;
* ``ref.py`` — pure-torch oracles;
* ``build.py`` — nvcc build at first use, ctypes loading.
"""
from .ops import fused_scan_topk, fused_scan_topk_batch

__all__ = ["fused_scan_topk", "fused_scan_topk_batch"]
