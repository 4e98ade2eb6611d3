"""Production mesh topology, as (axis, size) pairs.

The port sizes per-device shards from the topology alone; nothing here
allocates devices.  A *mesh* is any object with ``.axis_names`` and a
``.shape`` mapping of axis name to size (``fleet.extract.MeshSpec``).
"""
from __future__ import annotations

import math


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> tuple[tuple[str, int], ...]:
    """(axis, size) pairs of the production mesh: 16x16 = 256 chips per
    pod, 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return (("pod", 2), ("data", 16), ("model", 16))
    return (("data", 16), ("model", 16))


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes that carry data parallelism."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))
