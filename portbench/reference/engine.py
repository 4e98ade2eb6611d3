"""Sparseloop engine: orchestrates the three decoupled modeling steps
(Fig. 5): dataflow modeling -> sparse modeling -> micro-architectural
modeling.

The decoupling is the paper's central modeling insight (Sec. 4.2):
dataflow is evaluated independent of SAFs, SAFs independent of
micro-architecture — which lets one infrastructure model both dense and
sparse designs.
"""
from __future__ import annotations

import dataclasses
import time

from .arch import Architecture
from .dataflow import DenseTraffic, analyze_dataflow
from .density import DensityModel, make_density_model
from .mapping import LoopNest
from .microarch import EvalResult, evaluate_microarch
from .sparse import SparseTraffic, analyze_sparse
from .taxonomy import SAFSpec
from .workload import Workload


@dataclasses.dataclass(frozen=True)
class Design:
    """A point in the design space: Architecture x SAFs (dataflow comes in
    as the mapping at evaluation time — Sec. 3.2: dataflow is orthogonal)."""

    arch: Architecture
    safs: SAFSpec
    name: str = ""

    @property
    def level_names(self) -> list[str]:
        """Innermost-first storage level names (mapping level indices)."""
        return [self.arch.level(s).name for s in range(self.arch.num_levels)]


@dataclasses.dataclass
class Evaluation:
    """Bundled result of one (design, workload, mapping) evaluation."""

    result: EvalResult
    dense: DenseTraffic
    sparse: SparseTraffic
    wall_seconds: float

    @property
    def cycles(self) -> float:
        return self.result.cycles

    @property
    def energy_pj(self) -> float:
        return self.result.energy_pj

    @property
    def edp(self) -> float:
        return self.result.edp


class Sparseloop:
    """The analytical model.  Fast because it is statistical: it never
    iterates the computation space (Sec. 6.2).

    ``evaluate`` scores one mapping at a time, in Python floats (or in
    the type :mod:`.precision` names).
    """

    def __init__(self, design: Design):
        self.design = design

    def evaluate(self, workload: Workload, nest: LoopNest,
                 models: dict[str, DensityModel] | None = None,
                 check_capacity: bool = True) -> Evaluation:
        t0 = time.perf_counter()
        if nest.num_levels != self.design.arch.num_levels:
            raise ValueError(
                f"mapping has {nest.num_levels} levels, architecture "
                f"{self.design.arch.name} has {self.design.arch.num_levels}")
        if models is None:
            models = {
                t.name: make_density_model(
                    workload.density_spec(t.name),
                    t.size(workload.rank_bounds))
                for t in workload.tensors
            }
        dense = analyze_dataflow(workload, nest)                 # step 1
        sparse = analyze_sparse(dense, self.design.safs,         # step 2
                                self.design.level_names, models)
        result = evaluate_microarch(self.design.arch, sparse,    # step 3
                                    check_capacity=check_capacity)
        return Evaluation(result=result, dense=dense, sparse=sparse,
                          wall_seconds=time.perf_counter() - t0)

