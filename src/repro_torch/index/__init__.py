"""ANN index structures of the port: so far the exact flat scan (the IVF
index is the next slice, ROADMAP.md)."""
from .flat import FlatIndex, masked_topk, stable_smallest_k

__all__ = ["FlatIndex", "masked_topk", "stable_smallest_k"]
