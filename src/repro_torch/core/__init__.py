"""Sparseloop core: analytical modeling of sparse tensor accelerators.

The paper's three-step decoupled pipeline (Fig. 5):

  1. dataflow modeling  (dataflow.py)  — dense traffic from the mapping
  2. sparse modeling    (sparse.py)    — SAF filtering via statistical
                                          density models (density.py) and
                                          format models (formats.py)
  3. micro-architecture (microarch.py) — cycles & energy

plus the description language (workload / arch / taxonomy / mapping), the
mapspace search (mapper.py) and representative design presets
(presets.py).  The batched engine (batched.py) runs the same model over a
whole population of mappings as PyTorch tensors, on the CUDA card unless
``device="cpu"`` is asked for.
"""
from .arch import Architecture, ComputeLevel, StorageLevel
from .density import (ActualDataModel, BandedModel, DenseModel,
                      DensityModel, StructuredModel, UniformModel,
                      make_density_model)
from .engine import Design, Evaluation, Sparseloop
from .mapping import Loop, LoopNest, nest
from .microarch import EvalResult, evaluate_microarch
from .taxonomy import (ActionSAF, RankFormat, SAFKind, SAFSpec,
                       TensorFormat)
from .workload import TensorSpec, Workload, conv2d, dot, matmul, mv

#: lazily exported (PEP 562), as in the JAX package: scalar-only users
#: import nothing of the batched engine
_LAZY = {"BatchedModel", "BatchedUnsupported", "NestTemplate",
         "TemplateBucket", "BucketedModel", "BucketingPolicy"}


def __getattr__(name: str):
    if name in _LAZY:
        from . import batched
        return getattr(batched, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Architecture", "ComputeLevel", "StorageLevel",
    "BatchedModel", "BatchedUnsupported", "NestTemplate",
    "TemplateBucket", "BucketedModel", "BucketingPolicy",
    "ActualDataModel", "BandedModel", "DenseModel", "DensityModel",
    "StructuredModel", "UniformModel", "make_density_model",
    "Design", "Evaluation", "Sparseloop",
    "Loop", "LoopNest", "nest",
    "EvalResult", "evaluate_microarch",
    "ActionSAF", "RankFormat", "SAFKind", "SAFSpec", "TensorFormat",
    "TensorSpec", "Workload", "conv2d", "dot", "matmul", "mv",
]
