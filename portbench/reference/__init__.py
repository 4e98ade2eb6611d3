"""The benchmark's reference: a frozen copy of the port's scalar
Sparseloop model (``core/engine.py`` and the modules it imports, with the
batched tensor forms taken out).

It imports nothing of the port, of the JAX package or of JAX: plain
Python, ``math`` and NumPy.  The benchmark builds its own designs and
workloads here from a configuration file and evaluates the mappings the
program was given (or chose) again, one at a time.  Kept frozen so that a
change to the program's model shows as a difference instead of moving
the yardstick with it.
"""
from __future__ import annotations

import dataclasses

from . import presets
from .arch import Architecture, ComputeLevel, StorageLevel
from .engine import Design, Sparseloop
from .mapping import Loop, LoopNest
from .precision import computed_in, real
from .workload import Workload, matmul

__all__ = ["Architecture", "ComputeLevel", "Design", "Loop", "LoopNest",
           "Sparseloop", "StorageLevel", "Workload", "computed_in",
           "design_in", "matmul", "presets", "real"]


def design_in(design: Design, kind) -> Design:
    """``design`` with every floating-point architecture scalar
    (capacities, bandwidths, energies, throughput) converted to ``kind``;
    integer fields (word bits, compute instances) stay as they are."""
    def cast(obj):
        changes = {f.name: kind(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)
                   if isinstance(getattr(obj, f.name), float)}
        return dataclasses.replace(obj, **changes)
    arch = design.arch
    arch = dataclasses.replace(
        arch, levels=tuple(cast(lv) for lv in arch.levels),
        compute=cast(arch.compute))
    return dataclasses.replace(design, arch=arch)
