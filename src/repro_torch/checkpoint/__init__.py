"""Checkpoints of the port: atomic, keep-last-k snapshots of a tree of host
arrays, on the reference's on-disk layout."""
from .checkpointer import Checkpointer, latest_step, restore, save

__all__ = ["Checkpointer", "latest_step", "restore", "save"]
