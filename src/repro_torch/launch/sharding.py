"""Sharding resolution: turn abstract partition specs (axis names
"data"/"model") into mesh-specific ones, replacing "data" with
("pod", "data") on multi-pod meshes and dropping axes that do not
divide the corresponding dimension (replicate instead of crash)."""
from __future__ import annotations

import math

from .mesh import dp_axes


class PartitionSpec(tuple):
    """One entry per array dimension: a mesh axis name, a tuple of axis
    names, or None (replicated).  The port's stand-in for
    ``jax.sharding.PartitionSpec``, as a plain tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return math.prod(mesh.shape[a] for a in entry)
    return mesh.shape[entry]


def resolve_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """Map abstract spec -> concrete spec for this mesh."""
    if not isinstance(spec, P):
        spec = P()
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        if e == "data":
            e = dp_axes(mesh) if len(dp_axes(mesh)) > 1 else "data"
        if e is not None and dim % _axis_size(mesh, e) != 0:
            # try just "data" before giving up
            if isinstance(e, tuple) and dim % mesh.shape["data"] == 0:
                e = "data"
            else:
                e = None
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return P(*out)
