"""Fault-tolerance primitives of the training runtime (the JAX package's
``runtime/``; its ``compression.py`` is not ported yet, ROADMAP Queue 1
item 15)."""
from .fault_tolerance import Heartbeat, StragglerWatchdog, elastic_mesh

__all__ = ["Heartbeat", "StragglerWatchdog", "elastic_mesh"]
