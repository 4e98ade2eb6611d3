"""Fleet sweep driver: every config x sparsity option through shared
compiled programs.

This is the paper's DSE loop (Sec. 7) scaled from one accelerator and a
handful of workloads to the whole model fleet: every per-layer matmul of
every ``repro_torch/configs/`` architecture, prefill and decode, dense
vs each N:M compression option, evaluated through
``Sparseloop.evaluate_network`` on the port's batched engine (on the
CUDA card unless ``device="cpu"``), so the entire sweep builds
O(#options x #buckets) programs — *independent of config count, layer
count, and phase count*.  Three structural facts make that bound hold,
and :func:`compile_bound` computes it from them up front so a caller
can gate on ``programs <= bound``:

* ``advisor.tpu_mapping`` keeps unit-bound loops, so every matmul shape
  in the fleet lowers into ONE padded-template bucket per design;
* workload rank bounds and density parameters are program inputs, so
  different shapes bind the same program;
* uniform/structured density models need no static capacity padding
  (``DensityCaps(0,0,0)``), so *separate* ``evaluate_network`` calls —
  crossover grids, repeat sweeps, subset sweeps — still share programs.

Identical shapes are deduplicated before evaluation (`dedupe_shapes`):
the fleet's ~hundreds of per-layer entries collapse to the unique
(M, K, N) set, each evaluated once and fanned back out; the avoided
evaluations are counted in ``compile_stats.dedup_evals``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence

from .. import obs
from ..core import compile_stats
from ..core.advisor import tpu_mapping
from ..core.engine import Design, Sparseloop
from ..core.presets import dense_design, tpu_nm_design, tpu_v5e_arch
from ..core.workload import matmul

from .extract import (LayerMatmul, NetworkWorkloads, extract_fleet,
                      production_mesh_spec)

_EPS = 1e-9
#: a compression option must beat dense by this factor to win (ties and
#: numerical noise stay "dense")
WIN_MARGIN = 1.002


def nm_design_for_weights(n: int, m: int) -> Design:
    """The TPU N:M preset with its compression formats remapped from
    tensor A to tensor B — in the einsum convention here A is the (M,K)
    activation and B the (K,N) weight, and N:M pruning targets
    weights."""
    des = tpu_nm_design(n, m)
    fmts = {(lvl, "B"): f
            for (lvl, _t), f in des.safs.formats.items()}
    return Design(arch=des.arch,
                  safs=dataclasses.replace(des.safs, formats=fmts),
                  name=des.name)


@dataclasses.dataclass(frozen=True)
class SweepOption:
    """One design point of the sweep portfolio."""

    name: str
    design: Design
    #: densities dict applied to each workload (None = dense)
    densities: dict | None = None
    #: only meaningful for weight matmuls (param_instances > 0)?
    weights_only: bool = False


def dense_option() -> SweepOption:
    return SweepOption("dense", dense_design(tpu_v5e_arch()))


def nm_option(n: int, m: int) -> SweepOption:
    return SweepOption(f"nm-{n}:{m}", nm_design_for_weights(n, m),
                       densities={"B": ("structured", {"n": n, "m": m})},
                       weights_only=True)


def default_options(nm_options=((2, 4), (2, 8))) -> list[SweepOption]:
    return [dense_option()] + [nm_option(n, m) for n, m in nm_options]


# ----------------------------------------------------------------------
# dedup
# ----------------------------------------------------------------------

def dedupe_shapes(entries: Sequence[LayerMatmul]
                  ) -> tuple[list[tuple[int, int, int]], list[int]]:
    """Collapse entries to unique (M, K, N) shapes.

    Returns ``(unique, index)`` with ``unique[index[i]] ==
    entries[i].shape`` — evaluate each unique shape once, fan results
    back out through ``index``."""
    unique: list[tuple[int, int, int]] = []
    where: dict[tuple[int, int, int], int] = {}
    index = []
    for e in entries:
        if e.shape not in where:
            where[e.shape] = len(unique)
            unique.append(e.shape)
        index.append(where[e.shape])
    return unique, index


def _evaluate_shapes(option: SweepOption, shapes, *,
                     check_capacity: bool = False,
                     device=None) -> list[dict]:
    """One result dict per shape, via the batched network path (one
    single-candidate population per unique shape) on ``device``."""
    if not shapes:
        return []
    engine = Sparseloop(option.design, device=device)
    workloads = [matmul(M, K, N, densities=option.densities)
                 for M, K, N in shapes]
    nests = [[tpu_mapping(M, K, N)] for M, K, N in shapes]
    outs = engine.evaluate_network(workloads, nests,
                                   check_capacity=check_capacity)
    return [{"cycles": float(o["cycles"][0]),
             "energy_pj": float(o["energy_pj"][0]),
             "edp": float(o["edp"][0])} for o in outs]


def compile_bound(options: Sequence[SweepOption], entries,
                  *, check_capacity: bool = False) -> int:
    """The sweep's compile budget, from structure alone: one bucket
    count per distinct design (each design's programs are keyed by the
    padded-template bucket; tpu_mapping's structure-stable nests make
    this 1 bucket per design for any shape mix — so the bound equals
    the number of design points, independent of configs/layers)."""
    from ..core.batched import group_by_bucket
    del check_capacity
    ranks = tuple(matmul(2, 2, 2).rank_bounds)
    total = 0
    for opt in options:
        pool = [e for e in entries
                if e.param_instances > 0 or not opt.weights_only]
        nests = [tpu_mapping(*e.shape) for e in pool]
        if nests:
            total += len(group_by_bucket(nests, ranks))
    return total


# ----------------------------------------------------------------------
# report
# ----------------------------------------------------------------------

@dataclasses.dataclass
class LayerVerdict:
    """Per-(config, phase, layer-entry) advisor verdict."""

    config: str
    phase: str
    layer: str
    M: int
    K: int
    N: int
    count: int
    dense_cycles: float
    dense_energy_pj: float
    best_option: str
    best_cycles: float
    best_energy_ratio: float
    #: option name -> {cycles, energy_pj, edp}
    options: dict = dataclasses.field(default_factory=dict)

    @property
    def speedup(self) -> float:
        return self.dense_cycles / max(_EPS, self.best_cycles)

    @property
    def verdict(self) -> str:
        """"compress" when some option beats dense past WIN_MARGIN."""
        return "compress" if self.best_option != "dense" else "dense"

    @property
    def predicted_edp(self) -> float:
        return self.options.get(self.best_option, {}).get(
            "edp", self.dense_cycles * self.dense_energy_pj)


@dataclasses.dataclass
class FleetReport:
    """Fleet-wide sweep result + the compile accounting that CI gates."""

    rows: list[LayerVerdict]
    option_names: tuple[str, ...]
    #: "KxN" -> {option: largest M on the grid where compression still
    #: wins (the compress-vs-dense crossover), None if it never wins}
    crossover: dict = dataclasses.field(default_factory=dict)
    stats: dict = dataclasses.field(default_factory=dict)
    compile_bound: int = 0
    unique_shapes: int = 0
    total_entries: int = 0
    total_flops: float = 0.0
    total_dense_computes: float = 0.0
    wall_seconds: float = 0.0

    @property
    def compile_seconds(self) -> float:
        return float(self.stats.get("compile_seconds", 0.0))

    @property
    def eval_seconds(self) -> float:
        return float(self.stats.get("eval_seconds", 0.0))

    def summary(self) -> str:
        wins = sum(1 for r in self.rows if r.verdict == "compress")
        evals = (self.stats.get("batched_evals", 0)
                 + self.stats.get("dedup_evals", 0))
        lines = [
            f"fleet sweep: {self.total_entries} layer entries "
            f"({self.unique_shapes} unique shapes) x "
            f"{len(self.option_names)} options",
            f"  compiles {self.stats.get('compiles', '?')} "
            f"(bound {self.compile_bound}), "
            f"program shares {self.stats.get('program_shares', '?')}, "
            f"dedup-avoided evals {self.stats.get('dedup_evals', '?')}, "
            f"scalar evals {self.stats.get('scalar_evals', '?')}",
            f"  wall {self.wall_seconds:.2f} s: "
            f"{self.stats.get('compiles', 0)} compiles took "
            f"{self.compile_seconds:.2f} s, {evals} evals "
            f"({self.stats.get('dedup_evals', 0)} dedup'd) took "
            f"{self.eval_seconds:.2f} s",
            f"  verdicts: {wins} compress / "
            f"{len(self.rows) - wins} dense",
        ]
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "option_names": list(self.option_names),
            "compile_bound": self.compile_bound,
            "unique_shapes": self.unique_shapes,
            "total_entries": self.total_entries,
            "total_flops": self.total_flops,
            "total_dense_computes": self.total_dense_computes,
            "wall_seconds": self.wall_seconds,
            "stats": dict(self.stats),
            "crossover": {k: dict(v) for k, v in self.crossover.items()},
            "rows": [dict(dataclasses.asdict(r),
                          speedup=r.speedup, verdict=r.verdict)
                     for r in self.rows],
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=1, sort_keys=True)


# ----------------------------------------------------------------------
# the sweep
# ----------------------------------------------------------------------

def fleet_sweep(config_names=None, *, reduced: bool = False,
                phases=("prefill", "decode"),
                nm_options=((2, 4), (2, 8)),
                options: Sequence[SweepOption] | None = None,
                mesh="production", seq_len: int = 4096,
                batch: int | None = None,
                include_attention: bool = True,
                crossover: bool = False,
                crossover_grid=(8, 64, 512, 4096, 32768),
                check_capacity: bool = False,
                device=None) -> FleetReport:
    """Sweep the whole fleet through the batched engine on ``device``
    (the CUDA card unless ``device="cpu"``).

    ``mesh="production"`` shards every workload to per-device shapes
    under the 16x16 production topology (pass None for global shapes,
    or any MeshSpec).  N:M options apply to weight matmuls;
    attention (activation-activation) entries are evaluated dense and
    carry a "dense" verdict.  ``crossover=True`` additionally sweeps an
    M grid per unique weight (K, N) to locate the compress-vs-dense
    crossover token count — through the same compiled programs, adding
    zero compiles.
    """
    import time

    from ..configs import ARCH_NAMES
    from ..core.device import resolve_device
    device = resolve_device(device)
    if config_names is None:
        config_names = ARCH_NAMES
    if mesh == "production":
        mesh = production_mesh_spec()
    if options is None:
        options = default_options(nm_options)
    if not options or options[0].densities is not None:
        raise ValueError("options[0] must be the dense baseline")

    t0 = time.perf_counter()
    sweep_span = obs.span(
        "fleet.sweep", configs=len(tuple(config_names)),
        phases=list(phases), reduced=reduced)
    with sweep_span as sw, compile_stats.track() as st:
        with obs.span("fleet.extract", configs=len(tuple(config_names))):
            nets: list[NetworkWorkloads] = extract_fleet(
                config_names, reduced=reduced, phases=phases, mesh=mesh,
                seq_len=seq_len, batch=batch)
        entries = [(net, e) for net in nets for e in net.matmuls
                   if include_attention or e.param_instances > 0]
        flat = [e for _, e in entries]
        bound = compile_bound(options, flat,
                              check_capacity=check_capacity)

        per_option: dict[str, tuple[list[dict], list[int]]] = {}
        for opt in options:
            pool_ix = [i for i, e in enumerate(flat)
                       if e.param_instances > 0 or not opt.weights_only]
            unique, index = dedupe_shapes([flat[i] for i in pool_ix])
            compile_stats.record_dedup_evals(len(pool_ix) - len(unique))
            with obs.span("fleet.option", option=opt.name,
                          phase="evaluate", shapes=len(unique),
                          dedup=len(pool_ix) - len(unique)):
                res = _evaluate_shapes(opt, unique,
                                       check_capacity=check_capacity,
                                       device=device)
            fanned = {gi: res[index[j]]
                      for j, gi in enumerate(pool_ix)}
            per_option[opt.name] = fanned

        rows = []
        for i, (net, e) in enumerate(entries):
            dense = per_option["dense"][i]
            best = ("dense", dense["cycles"], 1.0)
            opt_results = {}
            for opt in options:
                r = per_option[opt.name].get(i)
                if r is None:
                    continue
                opt_results[opt.name] = r
                if (opt.name != "dense"
                        and r["cycles"] * WIN_MARGIN < best[1]):
                    best = (opt.name, r["cycles"],
                            r["energy_pj"] / dense["energy_pj"])
            rows.append(LayerVerdict(
                config=net.config, phase=net.phase, layer=e.name,
                M=e.M, K=e.K, N=e.N, count=e.count,
                dense_cycles=dense["cycles"],
                dense_energy_pj=dense["energy_pj"],
                best_option=best[0], best_cycles=best[1],
                best_energy_ratio=best[2], options=opt_results))

        cross: dict = {}
        if crossover:
            kns = sorted({(e.K, e.N) for e in flat
                          if e.param_instances > 0})
            grid = list(crossover_grid)
            shapes = [(m, K, N) for K, N in kns for m in grid]
            with obs.span("fleet.crossover", kn_shapes=len(kns),
                          grid=len(grid)):
                by_opt = {opt.name: _evaluate_shapes(
                    opt, shapes, check_capacity=check_capacity,
                    device=device)
                    for opt in options}
            for ki, (K, N) in enumerate(kns):
                here: dict = {}
                for opt in options:
                    if opt.name == "dense":
                        continue
                    last_win = None
                    for mi, m in enumerate(grid):
                        d = by_opt["dense"][ki * len(grid) + mi]
                        r = by_opt[opt.name][ki * len(grid) + mi]
                        if r["cycles"] * WIN_MARGIN < d["cycles"]:
                            last_win = m
                    here[opt.name] = last_win
                cross[f"{K}x{N}"] = here

        sw.set(entries=len(flat),
               unique_shapes=len(dedupe_shapes(flat)[0]),
               compile_bound=bound)

    total_computes = sum(e.M * e.K * e.N * e.count for e in flat)
    return FleetReport(
        rows=rows, option_names=tuple(o.name for o in options),
        crossover=cross, stats=st.as_dict(), compile_bound=bound,
        unique_shapes=len(dedupe_shapes(flat)[0]),
        total_entries=len(flat),
        total_flops=float(sum(e.flops for e in flat)),
        total_dense_computes=float(total_computes),
        wall_seconds=time.perf_counter() - t0)
