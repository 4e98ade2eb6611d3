"""Carry descriptions across from the JAX package to the port.

The system has no weights: what crosses between the two packages is the
description of a design point (architecture, SAFs, workload, mapping)
and its packed parameter rows.  :func:`from_reference` turns the JAX
package's description objects into the port's equivalents by dataclass
field and enum member *name*, without importing the JAX package, so one
description can be fed through both (the tests do).  Packed rows cross
as numpy: ``core.arch.ArchParams.from_numpy`` and
``core.batched.WorkloadParams`` turn them into tensors on a device.
"""
from __future__ import annotations

import dataclasses
import enum

from .core.arch import Architecture, ArchParams, ComputeLevel, StorageLevel
from .core.engine import Design
from .core.mapping import Loop, LoopNest
from .core.taxonomy import (ActionSAF, RankFormat, SAFKind, SAFSpec,
                            TensorFormat)
from .core.workload import TensorSpec, Workload

#: the port's description classes, by the name they share with the JAX
#: package's
_CLASSES = {c.__name__: c for c in (
    Architecture, ArchParams, ComputeLevel, StorageLevel, Design, Loop,
    LoopNest, ActionSAF, SAFSpec, TensorFormat, TensorSpec, Workload)}
_ENUMS = {e.__name__: e for e in (RankFormat, SAFKind)}


def from_reference(obj):
    """The port's equivalent of a JAX-package description object.

    Dataclasses (``Design``, ``Architecture``, ``SAFSpec``, ``Workload``,
    ``LoopNest`` and the ones inside them) are rebuilt field by field,
    enums (``RankFormat``, ``SAFKind``) by member name; tuples, lists and
    dicts are converted element-wise, and anything else (numbers,
    strings, numpy arrays in density specs) is passed through.  Objects
    that already belong to the port pass through unchanged."""
    if isinstance(obj, enum.Enum):
        port = _ENUMS.get(type(obj).__name__)
        if port is None:
            raise TypeError(f"no port equivalent of enum "
                            f"{type(obj).__qualname__}")
        return port[obj.name]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        if type(obj).__module__.startswith(__package__ + "."):
            return obj
        port = _CLASSES.get(type(obj).__name__)
        if port is None:
            raise TypeError(f"no port equivalent of "
                            f"{type(obj).__qualname__}")
        return port(**{f.name: from_reference(getattr(obj, f.name))
                       for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {from_reference(k): from_reference(v)
                for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(from_reference(v) for v in obj)
    return obj
