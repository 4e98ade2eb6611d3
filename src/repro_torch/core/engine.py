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
from typing import Iterable, Sequence

import numpy as np

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

    ``evaluate`` is the scalar reference oracle (one mapping at a time);
    ``evaluate_batch`` lowers a whole candidate population onto the
    batched PyTorch engine (core.batched) — same math, one program per
    loop-structure bucket.

    ``device`` is where the batched engine runs: the CUDA card when it
    is None, the CPU only when ``device="cpu"`` is asked for.  Every
    ``evaluate_*`` method also takes ``device=`` to override it for one
    call.  The scalar ``evaluate`` runs on the host either way.
    """

    def __init__(self, design: Design, device=None):
        self.design = design
        self.device = device

    def _device(self, device):
        from .device import resolve_device
        return resolve_device(self.device if device is None else device)

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

    # ------------------------------------------------------------------
    def batched_model(self, workload: Workload, template,
                      check_capacity: bool = True, caps=None,
                      device=None):
        """Batched evaluator for one loop-structure template
        (content-cached — facades for workloads with equal *structure*
        share the underlying program; ``caps`` forces common density
        capacities across a mixed-density sweep)."""
        from .batched import get_batched_model
        return get_batched_model(self.design, workload, template,
                                 check_capacity=check_capacity, caps=caps,
                                 device=self._device(device))

    def bucketed_model(self, workload: Workload, bucket,
                       check_capacity: bool = True, caps=None,
                       device=None):
        """Bucketed evaluator for one padded template family
        (content-cached — facades for workloads with equal *structure*
        share the underlying program; ``caps`` forces common density
        capacities across a mixed-density sweep)."""
        from .batched import get_bucketed_model
        return get_bucketed_model(self.design, workload, bucket,
                                  check_capacity=check_capacity, caps=caps,
                                  device=self._device(device))

    def evaluate_batch(self, workload: Workload,
                       nests: Sequence[LoopNest] | Iterable[LoopNest],
                       check_capacity: bool = True,
                       bucketed: bool = True,
                       caps=None, device=None) -> dict[str, np.ndarray]:
        """Evaluate a population of mappings in one (or a few) batched
        programs on ``device``.

        Candidates are grouped by *bucket* (padded template family,
        ``core.batched.TemplateBucket``): each bucket's candidates —
        whatever their loop order — are lowered onto one
        program, with per-candidate rank ids carrying the permutation as
        data.  A mixed-permutation population therefore costs a handful
        of programs (one per bucket) instead of one per loop structure;
        pass ``bucketed=False`` for the one-program-per-exact-template
        grouping.  Workload parameters (rank bounds, density
        models — actual-data included, via its tile-occupancy histogram)
        are program inputs, so layers of equal structure reuse programs
        across calls; ``caps`` (see ``batched.common_caps``)
        aligns the static density capacities of a mixed-density sweep.
        Returns per-candidate arrays aligned with the input order:
        cycles, energy_pj, edp, valid, compute_actual/gated/skipped.
        """
        return self._grouped_eval(workload, nests, check_capacity,
                                  bucketed, caps, [None], device)[0]

    def _grouped_eval(self, workload: Workload, nests, check_capacity,
                      bucketed, caps, arch_params_list, device=None
                      ) -> list[dict[str, np.ndarray]]:
        """Shared grouped dispatch of ``evaluate_batch`` /
        ``evaluate_designs``: lower the population once per group, then
        bind each entry of ``arch_params_list`` (None = the engine's
        own design) to the group's program.  Returns one
        result dict per entry, each aligned with the input order."""
        from .batched import group_by_bucket, group_by_template, lower_nests
        nests = list(nests)
        outs: list[dict[str, np.ndarray]] = [{}
                                             for _ in arch_params_list]

        def scatter(out, idxs, res):
            for k, v in res.items():
                v = np.asarray(v)
                if k not in out:
                    # some columns carry trailing axes (e.g. per-level
                    # occupancy is (C, S))
                    out[k] = np.zeros(
                        (len(nests),) + v.shape[1:],
                        dtype=bool if k == "valid" else np.float64)
                out[k][idxs] = v

        if not bucketed:
            for template, idxs in group_by_template(nests).items():
                model = self.batched_model(workload, template,
                                           check_capacity, caps=caps,
                                           device=device)
                bounds = np.stack([template.bounds_of(nests[i])
                                   for i in idxs])
                for out, ap in zip(outs, arch_params_list):
                    scatter(out, idxs,
                            model.evaluate(bounds, arch_params=ap))
            return outs

        ranks = tuple(workload.rank_bounds)
        for bucket, idxs in group_by_bucket(nests, ranks).items():
            model = self.bucketed_model(workload, bucket, check_capacity,
                                        caps=caps, device=device)
            bounds, ids, order = lower_nests(bucket, nests, idxs)
            for out, ap in zip(outs, arch_params_list):
                scatter(out, order,
                        model.evaluate(bounds, ids, arch_params=ap))
        return outs

    def evaluate_network(self, workloads: Sequence[Workload],
                         nests_per_workload,
                         check_capacity: bool = True,
                         bucketed: bool = True, device=None
                         ) -> list[dict[str, np.ndarray]]:
        """Evaluate one candidate population per network layer through
        *shared* programs.

        The common density capacities of all layers are computed up
        front, so structurally-identical layers — whatever their rank
        bounds or density kinds (uniform / structured / banded /
        actual-data mixed freely) — lower onto the same (arch, bucket)
        program: an N-layer sweep costs O(#buckets) programs,
        independent of N.  Returns one ``evaluate_batch``-shaped dict
        per layer, aligned with ``workloads``."""
        from .batched import common_caps
        workloads = list(workloads)
        nests_per_workload = list(nests_per_workload)
        if len(workloads) != len(nests_per_workload):
            raise ValueError(
                f"{len(workloads)} workloads but "
                f"{len(nests_per_workload)} nest populations")
        caps = common_caps(workloads)
        return [self.evaluate_batch(wl, nests,
                                    check_capacity=check_capacity,
                                    bucketed=bucketed, caps=caps,
                                    device=device)
                for wl, nests in zip(workloads, nests_per_workload)]

    def evaluate_designs(self, archs, workload: Workload, nests,
                         check_capacity: bool = True,
                         bucketed: bool = True,
                         caps=None, device=None
                         ) -> list[dict[str, np.ndarray]]:
        """Cross-product design sweep: evaluate one candidate population
        under every architecture in ``archs`` through *shared*
        programs.

        Architecture scalars (capacities, bandwidths, per-action
        energies, PE counts) are ``ArchParams`` inputs of the
        programs, which are keyed by canonical *topology key* (level
        names + SAF placement, ``arch.topology_key``).  ``archs`` mixes
        freely: ``Architecture``s (riding this engine's SAF spec) and
        ``Design``s carrying their OWN SAF specs — entries are grouped
        by topology key and each group binds its params to its group's
        programs, so a heterogeneous sweep builds O(topology groups x
        buckets) programs, independent of the number of design points.
        The candidate nests are shared across every entry, so level
        COUNTS must match this engine's (heterogeneous level counts
        need per-candidate nests, which the search layer provides).  Returns one
        ``evaluate_batch``-shaped dict per arch, aligned with
        ``archs``."""
        from .arch import pack_arch_params, topology_key
        base = self.design
        base_key = topology_key(base.arch, base.safs)
        members: dict[tuple, list[int]] = {}
        reps: dict[tuple, Design] = {}
        params: list = []
        for pos, a in enumerate(archs):
            d = a if isinstance(a, Design) \
                else dataclasses.replace(base, arch=a)
            if d.arch.num_levels != base.arch.num_levels:
                raise ValueError(
                    f"architecture {d.arch.name!r} has topology with "
                    f"{d.arch.num_levels} levels; the shared nest "
                    f"population is lowered for "
                    f"{base.arch.num_levels} — heterogeneous level "
                    f"counts need per-candidate nests")
            key = topology_key(d.arch, d.safs)
            members.setdefault(key, []).append(pos)
            reps.setdefault(key, d)
            params.append(pack_arch_params(d.arch))
        outs: list = [None] * len(params)
        for key, idxs in members.items():
            engine = self if key == base_key \
                else Sparseloop(reps[key], device=self.device)
            res = engine._grouped_eval(
                workload, nests, check_capacity, bucketed, caps,
                [params[i] for i in idxs], device)
            for pos, r in zip(idxs, res):
                outs[pos] = r
        return outs

    # ------------------------------------------------------------------
    def cphc(self, workload: Workload, nest: LoopNest,
             host_hz: float = 3.0e9, **kw) -> float:
        """Computes-simulated-per-host-cycle (the paper's speed metric,
        Sec. 6.2): dense computes modeled / host cycles spent modeling."""
        ev = self.evaluate(workload, nest, **kw)
        host_cycles = ev.wall_seconds * host_hz
        return ev.dense.dense_computes / max(1.0, host_cycles)
