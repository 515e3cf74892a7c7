"""Distribution layer of the port.  ``collectives.merge_topk_level`` is the
one piece ported so far (the live corpus's delta merge); the sharded scans
are a later slice."""
# the core package first: its physical layer imports the collectives,
# which import its schema
from .. import core  # noqa: F401
from . import collectives
from .collectives import merge_topk_level

__all__ = ["collectives", "merge_topk_level"]
