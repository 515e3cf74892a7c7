"""ANN index structures of the port: the exact flat scan, the IVF index
with CHASE's probes, and the live corpus's delta-segment scans."""
# the core package first: its physical layer imports these modules, which
# import its expressions
from .. import core  # noqa: F401
from .delta import delta_range_batch, delta_topk_batch
from .flat import FlatIndex, masked_topk, stable_smallest_k
from .ivf import (IVFIndex, ProbeConfig, build_ivf, ivf_from_numpy,
                  ivf_range, ivf_range_batch, ivf_range_category,
                  ivf_range_category_batch, ivf_topk, ivf_topk_batch)
from .kmeans import assign, kmeans

__all__ = ["FlatIndex", "masked_topk", "stable_smallest_k", "IVFIndex",
           "ProbeConfig", "build_ivf", "ivf_from_numpy", "ivf_range",
           "ivf_range_batch", "ivf_range_category",
           "ivf_range_category_batch", "ivf_topk", "ivf_topk_batch", "assign",
           "kmeans", "delta_range_batch", "delta_topk_batch"]
