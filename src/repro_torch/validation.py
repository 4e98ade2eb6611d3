"""The paper's validation (Sec. 6.2-6.3 and Table 5) on the port: the
analytical model against the actual-data reference simulator
(:mod:`.refsim`), and the batched engine's speed against simulation.

The figure functions rebuild the JAX package's benchmark cells
(``benchmarks/bench_fig11_scnn.py``, ``bench_fig12_eyerissv2.py``,
``bench_fig13_dstc.py``: the same layers, densities, seeds and trial
counts) over this package's scalar model and refsim, and return the
errors those benchmarks print.  They are host-side model outputs: no
device is involved.  The Table-5 functions time the batched engine on a
device over ``TEMPLATE3`` tilings (``benchmarks/bench_table5_cphc.py``)
and refsim on the same mappings.

The module sits beside ``core`` rather than in it: ``core`` holds the
model, this module the paper's experiments over it.  Only relative
imports of the scalar model are made at module scope, so the figure
functions run over any package that provides the same ``core``
modules; the batched engine is imported where it is used.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from .core import refsim
from .core.density import ActualDataModel, DenseModel
from .core.engine import Sparseloop
from .core.mapping import LoopNest, nest
from .core.microarch import evaluate_microarch
from .core.presets import (dense_design, dstc_like, eyeriss_v2_like,
                           scnn_like, tc_arch, three_level_arch)
from .core.workload import matmul

#: host clock the paper's CPHC (computes simulated per host cycle)
#: divides by, as the JAX package's Table-5 benchmark does
HOST_HZ = 3.0e9

FIG11 = dict(M=32, K=16, N=32, dA=0.35, dB=0.5, trials=40, seed=11)
#: MobileNet-ish pointwise layers as GEMMs (name, M, K, N, dA, dB)
FIG12_LAYERS = (("pw1", 32, 16, 32, 0.45, 0.6), ("pw2", 16, 32, 32, 0.4, 0.5),
                ("pw3", 16, 32, 16, 0.35, 0.45), ("pw4", 8, 64, 16, 0.3, 0.4))
FIG12_SEED = 12
FIG13 = dict(side=32, densities=(0.1, 0.2, 0.3, 0.45, 0.6, 0.8, 1.0),
             trials=25, seed=13)


def _div_floor(x: int, target: int) -> int:
    best = 1
    for d in range(1, x + 1):
        if x % d == 0 and d <= target:
            best = d
    return best


def canonical_mapping(M: int, K: int, N: int, *, ns: int = 16,
                      bm: int = 16, bn: int = 16) -> LoopNest:
    """The generic two-level mapping of the JAX package's benchmarks."""
    bm = _div_floor(M, bm)
    bn = _div_floor(N, bn)
    ns = _div_floor(N // bn, ns)
    loops = []
    if M // bm > 1:
        loops.append(("m", M // bm, 1))
    if N // (bn * ns) > 1:
        loops.append(("n", N // (bn * ns), 1))
    if ns > 1:
        loops.append(("n", ns, 1, "spatial"))
    if bn > 1:
        loops.append(("n", bn, 0))
    loops.append(("k", K, 0))
    if bm > 1:
        loops.append(("m", bm, 0))
    return nest(2, *loops)


def mapping3(M: int, K: int, N: int) -> LoopNest:
    """The three-level mapping of the Table-5 / Fig. 11-12 benchmarks
    (``TEMPLATE3``'s structure)."""
    bm = _div_floor(M, 8)
    bn = _div_floor(N, 8)
    ns = _div_floor(N // bn, 8)
    loops = [("m", M // bm, 2)]
    if N // (bn * ns) > 1:
        loops.append(("n", N // (bn * ns), 1))
    if ns > 1:
        loops.append(("n", ns, 1, "spatial"))
    if bn > 1:
        loops.append(("n", bn, 0))
    loops.append(("k", K, 0))
    if bm > 1:
        loops.append(("m", bm, 0))
    return nest(3, *loops)


def _uniform(M, K, N, dA, dB):
    return matmul(M, K, N, densities={"A": ("uniform", dA),
                                      "B": ("uniform", dB)})


# ----------------------------------------------------------------------
# Fig. 11-13: model vs refsim errors
# ----------------------------------------------------------------------
def fig11_scnn() -> dict:
    """Fig. 11: SCNN per-component storage accesses (reads, fills,
    updates of A, B, Z at each level), the model against the mean of
    ``trials`` refsim runs over uniform-sparse data.  Components where
    both are below one access are skipped, as in the benchmark."""
    M, K, N, dA, dB = (FIG11[k] for k in ("M", "K", "N", "dA", "dB"))
    trials = FIG11["trials"]
    design = scnn_like(three_level_arch())
    wl = _uniform(M, K, N, dA, dB)
    mapping = mapping3(M, K, N)
    ev = Sparseloop(design).evaluate(wl, mapping, check_capacity=False)
    rng = np.random.default_rng(FIG11["seed"])
    acc: dict[tuple[str, int, str], float] = {}
    for _ in range(trials):
        arrays = {"A": (rng.random((M, K)) < dA).astype(np.float32),
                  "B": (rng.random((K, N)) < dB).astype(np.float32)}
        st = refsim.simulate(wl, mapping, design.safs, arrays,
                             design.level_names)
        for t in ("A", "B", "Z"):
            for s in range(3):
                tl = st.of(t, s)
                for what, val in (("reads", tl.reads.actual),
                                  ("fills", tl.fills.actual),
                                  ("updates", tl.updates.actual)):
                    acc[(t, s, what)] = acc.get((t, s, what), 0.0) \
                        + val / trials
    components = []
    for (t, s, what), ref in sorted(acc.items()):
        tl = ev.sparse.of(t, s)
        model = {"reads": tl.reads.actual, "fills": tl.fills.actual,
                 "updates": tl.updates.actual}[what]
        if ref < 1.0 and model < 1.0:
            continue
        components.append({"component": f"{t}.L{s}.{what}",
                           "model": model, "refsim": ref,
                           "err_pct": abs(model - ref) / max(ref, 1e-9)
                           * 100})
    errs = [c["err_pct"] for c in components]
    return {"max_err_pct": max(errs), "mean_err_pct": float(np.mean(errs)),
            "components": components}


def fig12_eyerissv2() -> dict:
    """Fig. 12: Eyeriss-V2 PE latency per layer, the uniform and the
    actual-data density models against refsim on the same arrays."""
    design = eyeriss_v2_like(three_level_arch())
    rng = np.random.default_rng(FIG12_SEED)
    layers = []
    for name, M, K, N, dA, dB in FIG12_LAYERS:
        mapping = mapping3(M, K, N)
        arrays = {"A": (rng.random((M, K)) < dA).astype(np.float32),
                  "B": (rng.random((K, N)) < dB).astype(np.float32)}
        wl = _uniform(M, K, N, dA, dB)
        st = refsim.simulate(wl, mapping, design.safs, arrays,
                             design.level_names)
        ref = evaluate_microarch(design.arch, st,
                                 check_capacity=False).cycles
        uni = Sparseloop(design).evaluate(
            wl, mapping, check_capacity=False).result.cycles
        models = {"A": ActualDataModel(arrays["A"]),
                  "B": ActualDataModel(arrays["B"]),
                  "Z": DenseModel(M * N)}
        act = Sparseloop(design).evaluate(
            wl, mapping, models=models,
            check_capacity=False).result.cycles
        layers.append({"layer": name, "refsim": ref, "uniform": uni,
                       "actual": act,
                       "uniform_err_pct": abs(uni - ref) / ref * 100,
                       "actual_err_pct": abs(act - ref) / ref * 100})
    return {"uniform_mean_err_pct": float(np.mean(
                [r["uniform_err_pct"] for r in layers])),
            "actual_mean_err_pct": float(np.mean(
                [r["actual_err_pct"] for r in layers])),
            "layers": layers}


def fig13_dstc() -> dict:
    """Fig. 13: DSTC latency normalized to a dense tensor core across
    operand densities, the model against the mean of ``trials`` refsim
    runs."""
    side = FIG13["side"]
    trials = FIG13["trials"]
    design = dstc_like()
    mapping = canonical_mapping(side, side, side)
    rng = np.random.default_rng(FIG13["seed"])
    dense = Sparseloop(dense_design(tc_arch("tc-dense"))).evaluate(
        matmul(side, side, side), mapping,
        check_capacity=False).result.cycles
    rows = []
    for d in FIG13["densities"]:
        wl = _uniform(side, side, side, d, d)
        model = Sparseloop(design).evaluate(
            wl, mapping, check_capacity=False).result.cycles / dense
        ref = 0.0
        for _ in range(trials):
            arrays = {"A": (rng.random((side, side)) < d).astype(
                np.float32),
                "B": (rng.random((side, side)) < d).astype(np.float32)}
            st = refsim.simulate(wl, mapping, design.safs, arrays,
                                 design.level_names)
            ref += evaluate_microarch(design.arch, st,
                                      check_capacity=False).cycles / trials
        ref /= dense
        rows.append({"density": d, "model": model, "refsim": ref,
                     "err_pct": abs(model - ref) / ref * 100})
    return {"avg_err_pct": float(np.mean([r["err_pct"] for r in rows])),
            "rows": rows}


# ----------------------------------------------------------------------
# Table 5: the batched engine's speed, and its speedup over refsim
# ----------------------------------------------------------------------
def template3():
    """The three-level template of ``mapping3`` (unit bounds allowed):
    the two-level spMspM template's slots (m, n, n spatial, n, k, m)
    with the outer m loop at level 2."""
    from .core.vmapper import SPMSPM_TEMPLATE
    return dataclasses.replace(
        SPMSPM_TEMPLATE, slots=(("m", 2, False),) + SPMSPM_TEMPLATE.slots[1:],
        num_levels=3)


def tilings(M: int, K: int, N: int, cap: int = 256) -> np.ndarray:
    """(C, 6) ``template3`` bounds: every (m2, m0) x (n1, ns, n0) tiling
    with k kept innermost and ns <= 8 (the two-level mapper's candidate
    set), capped at ``cap``."""
    from .core.vmapper import _to_bounds, candidate_factors
    return _to_bounds(candidate_factors(M, N, K, max_spatial=8), K)[:cap]


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def engine_cphc(layers, device=None, reps: int = 3) -> dict:
    """Table 5's batched CPHC: every ``tilings`` candidate of each layer
    (name, M, K, N, dA, dB) through the SCNN design's batched engine on
    ``device``, warm (one untimed call first), best of ``reps``.  CPHC =
    candidates x MACs / (seconds x ``HOST_HZ``)."""
    design = scnn_like(three_level_arch())
    model = Sparseloop(design, device=device)
    rows, total_c, total_t = [], 0.0, 0.0
    for name, M, K, N, dA, dB in layers:
        bm = model.batched_model(_uniform(M, K, N, dA, dB), template3(),
                                 check_capacity=False)
        cand = tilings(M, K, N)
        bm.evaluate(cand)
        best = math.inf
        for _ in range(reps):
            _sync(bm.device)
            t0 = time.perf_counter()
            bm.evaluate(cand)
            best = min(best, time.perf_counter() - t0)
        computes = len(cand) * float(M) * K * N
        rows.append({"layer": name, "candidates": len(cand),
                     "seconds": best,
                     "cphc": computes / (best * HOST_HZ)})
        total_c += computes
        total_t += best
    return {"cphc": total_c / (total_t * HOST_HZ), "layers": rows}


def refsim_speedup(sides=(32, 64), samples: int = 8, device=None,
                   reps: int = 3, seed: int = 0) -> dict:
    """The batched engine against refsim on the SAME mappings: at each
    cube side, every ``tilings`` candidate through the engine on
    ``device`` (warm, best of ``reps``, per mapping), and ``samples`` of
    them (evenly spaced) through refsim on uniform-sparse arrays (dA 0.3,
    dB 0.4, the SCNN design) and the shared micro-architecture step.
    Returns per-mapping seconds of each, the speedup, the model's error
    against refsim on the sampled mappings, and the speedup projected
    linearly in computes to ResNet50 conv2_x, as the JAX package's
    Table-5 benchmark projects it."""
    design = scnn_like(three_level_arch())
    model = Sparseloop(design, device=device)
    rng = np.random.default_rng(seed)
    rows = []
    for side in sides:
        wl = _uniform(side, side, side, 0.3, 0.4)
        bm = model.batched_model(wl, template3(), check_capacity=False)
        cand = tilings(side, side, side)
        got = bm.evaluate(cand)
        best = math.inf
        for _ in range(reps):
            _sync(bm.device)
            t0 = time.perf_counter()
            bm.evaluate(cand)
            best = min(best, time.perf_counter() - t0)
        pick = np.linspace(0, len(cand) - 1, min(samples, len(cand))
                           ).astype(int)
        t_ref, errs = 0.0, []
        for i in pick:
            mapping = bm.template.nest_with(cand[i])
            arrays = {"A": (rng.random((side, side)) < 0.3).astype(
                np.float32),
                "B": (rng.random((side, side)) < 0.4).astype(np.float32)}
            t0 = time.perf_counter()
            st = refsim.simulate(wl, mapping, design.safs, arrays,
                                 design.level_names)
            cyc = evaluate_microarch(design.arch, st,
                                     check_capacity=False).cycles
            t_ref += time.perf_counter() - t0
            errs.append(abs(got["cycles"][i] - cyc) / cyc * 100)
        per_engine = best / len(cand)
        per_ref = t_ref / len(pick)
        rows.append({"side": side, "mappings": len(cand),
                     "refsim_mappings": len(pick),
                     "engine_s_per_mapping": per_engine,
                     "refsim_s_per_mapping": per_ref,
                     "speedup": per_ref / per_engine,
                     "cycles_mean_err_pct": float(np.mean(errs))})
    out = {"rows": rows}
    if len(rows) > 1:
        a, b = rows[0], rows[-1]
        slope = (b["speedup"] - a["speedup"]) / (b["side"] ** 3
                                                 - a["side"] ** 3)
        resnet_conv = 3136 * 576 * 64
        out["projected_conv2_x"] = b["speedup"] + slope * (
            resnet_conv - b["side"] ** 3)
    return out
