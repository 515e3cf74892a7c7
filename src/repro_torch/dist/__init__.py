"""Distribution layer of the port: the sharded-corpus handles
(``sharding``: :class:`DistSpec`, the fingerprintable mesh description
that rides ``EngineOptions.dist``; :class:`ShardedCorpus`, the row-sharded
corpus the catalog registers) and the hybrid-query collectives
(``collectives``: per-shard fused scans and hierarchical top-k / range
merges, and the plain merge level the live corpus's delta merge uses).
The reference's logical-axis rules serve its model side, which the port
does not have yet."""
# the core package first: its physical layer imports the collectives,
# which import its schema
from .. import core  # noqa: F401
from . import collectives, sharding
from .collectives import merge_topk_level
from .sharding import DeviceCountError, DistSpec, ShardedCorpus, resolve_mesh

__all__ = ["collectives", "sharding", "merge_topk_level", "DistSpec",
           "ShardedCorpus", "resolve_mesh", "DeviceCountError"]
