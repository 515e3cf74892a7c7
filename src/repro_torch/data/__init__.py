"""Datasets and mutations of the port: the LAION-style synthetic catalog, a
catalog built from numpy tables, and the live corpus (delta segment,
tombstones, WAL, snapshots, recovery, compaction)."""
from .laion import catalog_from_numpy, make_laion_catalog, selectivity_threshold
from .mutations import LiveCorpus, attach_live, recover

__all__ = ["catalog_from_numpy", "make_laion_catalog", "selectivity_threshold",
           "LiveCorpus", "attach_live", "recover"]
