"""Datasets of the port: the LAION-style synthetic catalog, and a catalog
built from numpy tables."""
from .laion import catalog_from_numpy, make_laion_catalog, selectivity_threshold

__all__ = ["catalog_from_numpy", "make_laion_catalog", "selectivity_threshold"]
