"""TPU sparsity advisor: Sparseloop applied to the fleet's own hardware
target.

For each weight matmul of an LM architecture (per-device shard sizes
under a data x model mesh), the advisor evaluates the TPU-v5e Sparseloop
preset with and without N:M weight compression and reports where
compression pays.  On that target the only SAF with a compute-side
payoff is the *format* (the matrix unit cannot skip), so the advisor's
decision boundary is exactly "is this matmul bound by memory traffic?".

The per-layer shapes come from ``fleet.extract`` (the parameter-exact
walk the fleet sweep uses) and the evaluations run on the port's
batched engine via ``fleet.sweep``: identical layer shapes dedupe to
one evaluation, and all shapes of all options lower onto O(#options)
programs.  For the fleet-wide report (every config, prefill + decode,
verdicts + EDP + crossover), use :func:`fleet_report` /
``fleet.sweep.fleet_sweep``.  The kernel that implements the advised
format is ``kernels.nm_spmm`` (K3).
"""
from __future__ import annotations

import dataclasses
import math

from .mapping import LoopNest, nest


def _div_floor(x: int, target: int) -> int:
    """Largest divisor of x that is <= target."""
    best = 1
    for d in range(1, int(math.isqrt(x)) + 1):
        if x % d == 0:
            if d <= target:
                best = max(best, d)
            if x // d <= target:
                best = max(best, x // d)
    return best


def tpu_mapping(M: int, K: int, N: int, *, bm: int = 2048, bn: int = 2048,
                bk: int = 1024, macs: int = 104448) -> LoopNest:
    """Canonical HBM->VMEM->REG/MXU mapping: (bm x bn) output tile spread
    spatially across the MXU, k streamed temporally with in-array (REG)
    accumulation; a k-spatial factor models the systolic depth so small-M
    decode matmuls still fill the array.

    Unit-bound loops are kept deliberately: every (M, K, N) yields the
    same 7-slot loop STRUCTURE, so all shapes fall into one padded-
    template bucket and the whole fleet shares one compiled program per
    design (the property the fleet-compile CI gate pins)."""
    bm = _div_floor(M, bm)
    bn = _div_floor(N, bn)
    bk = _div_floor(K, bk)
    # systolic depth: spend leftover parallelism on k
    ksp = _div_floor(bk, max(1, macs // max(1, bm * bn)))
    bk2 = bk // ksp
    mo, no, ko = M // bm, N // bn, K // bk
    return nest(
        3,
        ("m", mo, 2), ("n", no, 2), ("k", ko, 2),
        ("k", bk2, 1), ("m", bm, 1, "spatial"), ("n", bn, 1, "spatial"),
        ("k", ksp, 0, "spatial"),
    )


@dataclasses.dataclass
class LayerAdvice:
    layer: str
    M: int
    K: int
    N: int
    dense_cycles: float
    dense_bottleneck: str
    best_name: str
    best_cycles: float
    best_energy_ratio: float

    @property
    def speedup(self) -> float:
        return self.dense_cycles / self.best_cycles


def advise(cfg, *, tokens_per_device: int = 4096, tp: int = 16,
           nm_options: tuple[tuple[int, int], ...] = ((2, 4), (2, 8)),
           weight_density_model: str = "structured",
           device=None) -> list[LayerAdvice]:
    """Evaluate dense vs N:M-compressed weights for each weight matmul.

    Shapes are extracted by the fleet walk (so MoE experts, MLA
    projections, SSM projections and the LM head all appear) and
    sharded column/row-parallel over ``tp``; evaluation runs batched on
    ``device`` (the CUDA card unless ``device="cpu"``) — identical
    layers evaluate once, and the program count is bounded by the
    option count regardless of depth."""
    del weight_density_model  # structured N:M is the only model wired up
    from .. import obs
    from ..fleet.extract import MeshSpec, extract_network, shard_entries
    from ..fleet.sweep import (WIN_MARGIN, _evaluate_shapes,
                               dedupe_shapes, default_options)
    from . import compile_stats
    from .device import resolve_device
    device = resolve_device(device)

    with obs.span("advisor.advise", config=cfg.name, tp=tp,
                  phase="prefill") as sp:
        mesh = MeshSpec((("data", 1), ("model", tp)))
        net = shard_entries(
            extract_network(cfg, "prefill", seq_len=tokens_per_device,
                            batch=1), mesh)
        entries = net.weight_matmuls()
        options = default_options(tuple(nm_options))
        unique, index = dedupe_shapes(entries)
        compile_stats.record_dedup_evals(
            (len(entries) - len(unique)) * len(options))
        results = {}
        for opt in options:
            with obs.span("advisor.option", config=cfg.name,
                          option=opt.name, phase="prefill",
                          shapes=len(unique)):
                results[opt.name] = _evaluate_shapes(
                    opt, unique, check_capacity=False, device=device)
        sp.set(layers=len(entries), unique_shapes=len(unique),
               options=len(options))

    advices = []
    for e, ui in zip(entries, index):
        dense = results["dense"][ui]
        mapping = tpu_mapping(*e.shape)
        fanout = math.prod(lp.bound for lp in mapping.loops
                           if lp.spatial)
        compute_cycles = e.M * e.K * e.N / fanout
        # the TPU preset's only sub-compute-bandwidth level is HBM, so a
        # memory-bound matmul is HBM-bound by construction
        bottleneck = ("compute"
                      if dense["cycles"] <= compute_cycles * (1 + 1e-6)
                      else "HBM")
        best = ("dense", dense["cycles"], 1.0)
        for opt in options[1:]:
            r = results[opt.name][ui]
            if r["cycles"] * WIN_MARGIN < best[1]:
                best = (opt.name, r["cycles"],
                        r["energy_pj"] / dense["energy_pj"])
        advices.append(LayerAdvice(
            layer=e.name, M=e.M, K=e.K, N=e.N,
            dense_cycles=dense["cycles"], dense_bottleneck=bottleneck,
            best_name=best[0], best_cycles=best[1],
            best_energy_ratio=best[2]))
    return advices


def fleet_report(config_names=None, **kw):
    """Fleet-wide advisor report: every config, prefill + decode,
    per-layer verdicts, predicted EDP, compress-vs-dense crossover.
    Thin alias for :func:`repro_torch.fleet.sweep.fleet_sweep`."""
    from ..fleet.sweep import fleet_sweep
    return fleet_sweep(config_names, **kw)


def describe(advices: list[LayerAdvice]) -> str:
    lines = [f"{'layer':>20} {'M':>7} {'K':>6} {'N':>6} "
             f"{'bottleneck':>10} {'best':>14} {'speedup':>8}"]
    for a in advices:
        lines.append(f"{a.layer:>20} {a.M:>7} {a.K:>6} {a.N:>6} "
                     f"{a.dense_bottleneck:>10} {a.best_name:>14} "
                     f"{a.speedup:>7.2f}x")
    return "\n".join(lines)
