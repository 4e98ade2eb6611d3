"""Chip smoke test of the PyTorch port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card (it exits non-zero, printing no result, without
one) and the CUDA toolkit's ``nvcc``; it imports nothing of JAX or of the
JAX package.  Phases, in order — any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the block-sparse kernels K1 (SKIP) and K2 (GATE) from
   ``src/repro_torch/kernels/block_mm/csrc`` with nvcc for sm_90a;
3. kernels: K1 and K2 against their plain PyTorch versions on the
   qwen2-0.5b full-width decode cells (batch 8: ffn_gate_up 8x896x9728
   and lm_head 8x896x151936, 64-wide blocks, density 0.25, seed 0) and
   one bf16 cell at the ffn_down shape (128x4864x896), with kernel,
   plain, library (torch.matmul) and bound times;
4. model: the whole mapspace of each of the four ResNet50 layers
   (833,400 candidates) searched on the card through ``mapper.search``;
   each winner re-validated by the scalar oracle, 512 sampled
   candidates per layer held to the scalar oracle, one program shared
   by the four layers;
5. agreement: the model's skip-time, gate-time and skip-vs-gate
   predictions against K1/K2 timed with CUDA events on the two qwen2
   cells.

Phases 4 and 5 are the main path: the kernels' launch counters are set
to 0 just before them and read just after.  The last lines are the
``kernels`` JSON object, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: qwen2-0.5b (hidden 896, intermediate 4864, vocab 151936), decode at
#: batch 8: the two largest weight matmuls, as (layer, M, K, N)
QWEN2_CELLS = (("ffn_gate_up", 8, 896, 9728), ("lm_head", 8, 896, 151936))
#: the bf16 case: the ffn_down shape at 128 rows
BF16_CELL = ("ffn_down", 128, 4864, 896)
BS, DENSITY, SEED = 64, 0.25, 0
#: ResNet50 layers as GEMMs (name, M, K, N, density A, density B), the
#: Table-5 densities of the repository's benchmark set
RESNET50_LAYERS = (
    ("conv2_x", 3136, 576, 64, 0.4, 0.55),
    ("conv3_x", 784, 1152, 128, 0.35, 0.5),
    ("conv4_x", 196, 2304, 256, 0.3, 0.45),
    ("conv5_x", 49, 4608, 512, 0.3, 0.4),
)
MAPSPACE_SIZES = {"conv2_x": 282_240, "conv3_x": 291_600,
                  "conv4_x": 204_120, "conv5_x": 55_440}
#: one loop order per level (0 = SPad, 1 = GLB, 2 = DRAM), the same for
#: every layer so the four searches share one bucket and one program
PERMUTATIONS = {0: ("n", "k", "m"), 1: ("m", "n", "k"), 2: ("m", "n", "k")}
SAMPLES = 512
F32_TOL = 1e-5          # max|kernel - plain| / max|plain|
BF16_TOL = 0.3          # atol = rtol of the JAX package's bf16 kernel test
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
L2_BYTES = 50 * 2 ** 20


def _root() -> Path:
    return Path(__file__).resolve().parent


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def time_ms(fn, sets, graph: bool, reps: int = 5) -> float:
    """Milliseconds per call: min over ``reps`` windows of back-to-back
    calls timed with CUDA events, after a warm-up.  The calls cycle over
    ``sets`` (argument tuples, at least ten calls) so that a working set
    smaller than the L2 cache is read cold, as a caller would find it.
    With ``graph`` the calls are captured once in a CUDA graph and each
    window is one replay: the device time, without the host's per-call
    work.  Without it (the plain versions, which copy host data on every
    call and cannot be captured) the calls are launched eagerly."""
    from repro_torch.fleet.validate import cuda_graph
    inner = max(10, len(sets))
    calls = iter(range(10 ** 9))

    def one():
        return fn(*sets[next(calls) % len(sets)])

    for _ in sets:
        one()
    run = cuda_graph(one, inner).replay if graph else \
        (lambda: [one() for _ in range(inner)])
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / inner)
    return best


def bound_ms(byte_count: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = byte_count / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
def phase_build() -> dict:
    from repro_torch.kernels.block_mm import ops
    t0 = time.perf_counter()
    ops._lib()
    dt = time.perf_counter() - t0
    print(f"[build] block_mm.cu -> {ops.build().name} in {dt:.2f} s")
    log = _root() / "chiprun_out" / "block_mm_ptxas.txt"
    log.parent.mkdir(exist_ok=True)
    log.write_text(ops.build_log)
    return {"seconds": dt}


def _cell_inputs(M, K, N, dtype, device):
    from repro_torch.fleet.validate import block_cell_inputs
    x = block_cell_inputs(M, K, N, density=DENSITY, bs=BS, seed=SEED,
                          device=device)
    for k in ("a", "w", "wm"):
        x[k] = x[k].to(dtype)
    x["mask_dev"] = torch.as_tensor(x["mask"].astype(np.int32),
                                    device=device)
    return x


def _compare(got, want, dtype) -> tuple[float, float, bool]:
    err = float((got - want).abs().max())
    rel = err / max(1e-30, float(want.abs().max()))
    if dtype == torch.float32:
        ok = rel <= F32_TOL
    else:
        ok = bool(((got - want).abs()
                   <= BF16_TOL + BF16_TOL * want.abs()).all())
    return err, rel, ok


def phase_kernels(device="cuda", cells=None, timed=True) -> dict:
    """K1 and K2 against their plain versions; returns per-kernel rows
    for every cell checked."""
    from repro_torch.kernels.block_mm.ops import (block_list, gated_mm,
                                                  gated_mm_plain, skip_mm,
                                                  skip_mm_plain)
    cells = cells or ([(n, M, K, N, torch.float32)
                       for n, M, K, N in QWEN2_CELLS]
                      + [(*BF16_CELL, torch.bfloat16)])
    rows = {"skip_mm": [], "gated_mm": []}
    for layer, M, K, N, dtype in cells:
        x = _cell_inputs(M, K, N, dtype, device)
        a, w, wm, mask = x["a"], x["w"], x["wm"], x["mask"]
        ks, js = x["nonzero"]
        blocks = block_list(ks, js, mask.shape, device)
        elt = a.element_size()
        nnzb, nblocks = int(mask.sum()), mask.size
        kw = dict(bm=BS, bk=BS, bn=BS)
        bm = min(BS, M)
        # K1 on the masked W, K2 on the unmasked W (the mask must be
        # honoured by the kernel, not by zeros in W)
        # per kernel: the W bytes it must read, its block-list or mask
        # bytes, and the blocks it multiplies
        checks = {
            "skip_mm": (lambda a_, w_: skip_mm(a_, w_, blocks, **kw),
                        lambda a_, w_: skip_mm_plain(a_, w_, ks, js, **kw),
                        wm, len(ks) * BS * BS * elt,
                        (len(ks) + N // BS + 1) * 4, len(ks)),
            "gated_mm": (lambda a_, w_: gated_mm(a_, w_, x["mask_dev"],
                                                 **kw),
                         lambda a_, w_: gated_mm_plain(a_, w_,
                                                       x["mask_dev"], **kw),
                         w, K * N * elt, nblocks * 4, nnzb),
        }
        for name, (kern, plain, w_in, w_bytes, index_bytes,
                   blocks_done) in checks.items():
            got, want = kern(a, w_in), plain(a, w_in)
            if device != "cpu":
                torch.cuda.synchronize()
            err, rel, ok = _compare(got, want, dtype)
            row = {"cell": layer, "shape": [M, K, N],
                   "dtype": str(dtype).replace("torch.", ""),
                   "bm_bk_bn": [bm, BS, BS], "nnzb": nnzb,
                   "blocks": nblocks, "max_abs_err": err, "rel_err": rel}
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on {layer}: {row}")
            if timed:
                byte_count = M * K * elt + w_bytes + M * N * 4 + index_bytes
                ops = 2.0 * M * BS * BS * blocks_done
                b_ms, b_by = bound_ms(byte_count, ops, dtype)
                # cycle over enough input copies to exceed the L2 cache
                per_set = (M * K + K * N) * elt
                n_sets = max(1, math.ceil(2 * L2_BYTES / per_set))
                sets = [(a.clone(), w_in.clone()) for _ in range(n_sets)]
                row.update(ms=time_ms(kern, sets, graph=True),
                           plain_ms=time_ms(plain, sets, graph=False))
                # the yardstick: one library call of the same function,
                # the dense product with the masked W
                sets = [(s[0], wm.clone()) for s in sets]
                row.update(library_ms=time_ms(torch.matmul, sets,
                                              graph=True),
                           bound_ms=b_ms, bound_by=b_by, bytes=byte_count,
                           ops=ops, input_sets=n_sets)
                del sets
            rows[name].append(row)
            print(f"[kernels] {name} {layer} {row}")
    return rows


def mapspace_size(M, K, N, spatial_n=8) -> int:
    from repro_torch.core.mapping import factor_splits
    return (len(list(factor_splits(M, 3))) * len(list(factor_splits(K, 3)))
            * len(list(factor_splits(N // spatial_n, 3))))


def lowered_mapspace(design, wl, cons):
    """The (template, bucket, bounds) population that
    ``mapper._search_lowered`` evaluates for a permutation-constrained
    search: every candidate of the budget, in the search's order."""
    from repro_torch.core.batched import bucket_for
    from repro_torch.core.mapper import _full_template, _split_combos
    levels = design.arch.num_levels
    template = _full_template(wl, levels, cons)
    combos = np.asarray(_split_combos(wl, levels, cons)[: cons.budget],
                        np.int64)
    ranks = list(wl.rank_bounds)
    bounds = np.ones((len(combos), template.num_slots), np.int64)
    for j, (r, lvl, sp) in enumerate(template.slots):
        bounds[:, j] = (cons.spatial.get(lvl, {}).get(r, 1) if sp
                        else combos[:, ranks.index(r), lvl])
    return template, bucket_for(template, tuple(ranks)), bounds


def phase_model(device="cuda", layers=RESNET50_LAYERS,
                sizes=MAPSPACE_SIZES, samples=SAMPLES) -> dict:
    """Whole-mapspace search of each ResNet50 layer on ``device``."""
    from repro_torch.core import Sparseloop, compile_stats, matmul
    from repro_torch.core.batched import clear_caches
    from repro_torch.core.mapper import MapspaceConstraints, search
    from repro_torch.core.presets import scnn_like, three_level_arch
    design = scnn_like(three_level_arch())
    clear_caches()
    out = {"layers": []}
    with compile_stats.track() as st:
        results = []
        for name, M, K, N, dA, dB in layers:
            size = mapspace_size(M, K, N)
            if sizes is not None and size != sizes[name]:
                raise AssertionError(f"{name}: mapspace has {size} "
                                     f"candidates, expected {sizes[name]}")
            wl = matmul(M, K, N, densities={"A": ("uniform", dA),
                                            "B": ("uniform", dB)},
                        name=name)
            cons = MapspaceConstraints(seed=0, spatial={1: {"n": 8}},
                                       permutations=PERMUTATIONS,
                                       budget=size)
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with compile_stats.track() as layer_st:
                res = search(design, wl, cons,
                             device=None if device == "cuda" else device)
            dt = time.perf_counter() - t0
            engine_s = layer_st.compile_seconds + layer_st.eval_seconds
            if res.evaluated != size or res.best is None:
                raise AssertionError(f"{name}: evaluated {res.evaluated} "
                                     f"of {size}, best {res.best}")
            results.append((name, wl, cons, size, res, dt, engine_s))
    if st.programs != 1 or st.program_shares < len(layers) - 1:
        raise AssertionError(f"expected one program shared by the "
                             f"layers: {st.as_dict()}")
    oracle = Sparseloop(design)
    label = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    for name, wl, cons, size, res, dt, engine_s in results:
        # the winner, re-validated by the scalar oracle
        again = oracle.evaluate(wl, res.best_nest)
        if not (res.best.result.valid and again.result.valid
                and again.edp == res.best.edp):
            raise AssertionError(f"{name}: winner not confirmed by the "
                                 f"scalar oracle")
        # sampled candidates through the same program vs the oracle
        template, bucket, bounds = lowered_mapspace(design, wl, cons)
        pick = np.random.default_rng(0).choice(len(bounds),
                                               min(samples, len(bounds)),
                                               replace=False)
        padded, ids = bucket.lower_population(template, bounds[pick])
        got = Sparseloop(design, device=device).bucketed_model(
            wl, bucket).evaluate(padded, ids)
        worst = 0.0
        for row, i in enumerate(pick):
            nest = template.nest_with(bounds[i])
            ev = oracle.evaluate(wl, nest)
            if bool(got["valid"][row]) != ev.result.valid:
                raise AssertionError(f"{name}: validity differs at {i}")
            if not ev.result.valid:
                # the oracle reports no metrics for a mapping that does
                # not fit; the engine's are held to its unchecked ones
                ev = oracle.evaluate(wl, nest, check_capacity=False)
            for key, ref in (("cycles", ev.cycles),
                             ("energy_pj", ev.energy_pj),
                             ("edp", ev.edp)):
                worst = max(worst, abs(got[key][row] - ref)
                            / max(abs(ref), 1e-300))
        if worst > 1e-6:
            raise AssertionError(f"{name}: sampled candidates differ from "
                                 f"the scalar oracle by {worst:.3e}")
        layer = {"layer": name, "device": label, "candidates": size,
                 "valid": res.valid,
                 "seconds": dt, "candidates_per_s": size / dt,
                 "engine_seconds": engine_s,
                 "best_edp": res.best.edp, "sampled": len(pick),
                 "max_rel_err_sampled": worst}
        out["layers"].append(layer)
        print(f"[model] {json.dumps(layer)}")
    out["compile_stats"] = st.as_dict()
    print(f"[model] compile_stats {json.dumps(st.as_dict())}")
    return out


def phase_profile(layer=RESNET50_LAYERS[0], device="cuda") -> dict:
    """Where one warm engine evaluation of a whole layer's mapspace goes
    on the card: wall seconds, device-busy seconds and kernel launches
    from a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Sparseloop, matmul
    from repro_torch.core.mapper import MapspaceConstraints
    from repro_torch.core.presets import scnn_like, three_level_arch
    name, M, K, N, dA, dB = layer
    design = scnn_like(three_level_arch())
    wl = matmul(M, K, N, densities={"A": ("uniform", dA),
                                    "B": ("uniform", dB)}, name=name)
    cons = MapspaceConstraints(seed=0, spatial={1: {"n": 8}},
                               permutations=PERMUTATIONS,
                               budget=mapspace_size(M, K, N))
    template, bucket, bounds = lowered_mapspace(design, wl, cons)
    padded, ids = bucket.lower_population(template, bounds)
    model = Sparseloop(design, device=device).bucketed_model(wl, bucket)
    model.evaluate(padded, ids)
    t0 = time.perf_counter()
    model.evaluate(padded, ids)
    warm = time.perf_counter() - t0
    activities = [ProfilerActivity.CPU]
    if device != "cpu":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        model.evaluate(padded, ids)
        traced = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    out = {"layer": name, "candidates": len(bounds), "warm_s": warm,
           "traced_s": traced, "device_busy_s": busy,
           "device_events": len(dev),
           "idle_share": 1.0 - busy / traced if traced else None}
    print(f"[profile] {json.dumps(out)}")
    return out


def phase_agreement(device="cuda", cells=QWEN2_CELLS, reps=5) -> list:
    from repro_torch.fleet.validate import (_measure_block_cell,
                                            _predict_block,
                                            agreement_summary, block_rows,
                                            kernel_cell)
    padded = [(layer, kernel_cell(M, K, N, bs=BS)) for layer, M, K, N
              in cells]
    shapes = [c for _, c in padded]
    pred = _predict_block(shapes, density=DENSITY,
                          device=None if device == "cuda" else device)
    rows = []
    for i, (layer, cell) in enumerate(padded):
        meas = _measure_block_cell(*cell, density=DENSITY, bs=BS,
                                   reps=reps, seed=SEED,
                                   device=None if device == "cuda"
                                   else device)
        if meas["rel_err"] > F32_TOL:
            raise AssertionError(f"agreement cell {layer}: kernel error "
                                 f"{meas['rel_err']:.3e} > {F32_TOL}")
        print(f"[agreement] {layer} {json.dumps(meas)}")
        rows += block_rows("qwen2-0.5b", layer, cell, meas,
                           pred["dense"][i], pred["skip"][i],
                           pred["gate"][i])
    for r in rows:
        print(f"[agreement] {json.dumps(r.as_dict())}")
    print(agreement_summary(rows))
    return rows


KERNELS = (
    ("skip_mm", "K1 SKIP block-sparse matmul",
     "src/repro/kernels/block_mm/kernel.py:95"),
    ("gated_mm", "K2 GATE block-sparse matmul",
     "src/repro/kernels/block_mm/kernel.py:49"),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(_root() / "src"))
    from repro_torch.kernels.block_mm import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    t_start = time.perf_counter()
    build = phase_build()
    kernel_rows = phase_kernels()

    # ---- the main path: counters from 0, read right after ----
    ops.skip_mm.launches = 0
    ops.gated_mm.launches = 0
    model = phase_model()
    rows = phase_agreement()
    launches = {"skip_mm": ops.skip_mm.launches,
                "gated_mm": ops.gated_mm.launches}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    disagree = [r.as_dict() for r in rows if not r.agree]
    profile = phase_profile()

    kernels = []
    for name, what, replaces in KERNELS:
        head = next(r for r in kernel_rows[name] if r["cell"] == "lm_head")
        kernels.append({
            "name": name, "what": what, "route": "cuda",
            "source": "src/repro_torch/kernels/block_mm/csrc/block_mm.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in kernel_rows[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "headline_cell": "lm_head",
            "cells": kernel_rows[name]})
    summary = {"build_s": build["seconds"], "model": model,
               "profile": profile,
               "disagreements": disagree,
               "total_s": time.perf_counter() - t_start}
    out_dir = _root() / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, **summary}, indent=1))
    print(f"[summary] {json.dumps(summary)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
