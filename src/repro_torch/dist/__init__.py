"""Distribution layer of the port: the sharded-corpus handles
(``sharding``: :class:`DistSpec`, the fingerprintable mesh description
that rides ``EngineOptions.dist``; :class:`ShardedCorpus`, the row-sharded
corpus the catalog registers) and the hybrid-query collectives
(``collectives``: per-shard fused scans and hierarchical top-k / range
merges, and the plain merge level the live corpus's delta merge uses).
``sharding`` also holds the reference's logical-axis rules
(``logical_axis_rules``, ``constrain``) that the model code names."""
# the core package first: its physical layer imports the collectives,
# which import its schema
from .. import core  # noqa: F401
from . import collectives, sharding
from .collectives import merge_topk_level
from .sharding import (DeviceCountError, DistSpec, NamedSharding,
                       ShardedCorpus, constrain, current_mesh, current_rules,
                       logical_axis_rules, logical_to_spec, resolve_mesh)

__all__ = ["collectives", "sharding", "merge_topk_level", "DistSpec",
           "ShardedCorpus", "resolve_mesh", "DeviceCountError",
           "logical_axis_rules", "current_rules", "current_mesh",
           "logical_to_spec", "constrain", "NamedSharding"]
