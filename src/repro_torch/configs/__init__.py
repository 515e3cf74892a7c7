"""Configurations of the port.

Only the paper's own workload config, :mod:`.chase_laion`, is here.  The
``--arch`` registry of model configs (``get_config``, ``get_shape``,
``cells``) comes with the model side of the port (ROADMAP.md queue 1 item
14 (a)).
"""
from . import chase_laion

__all__ = ["chase_laion"]
