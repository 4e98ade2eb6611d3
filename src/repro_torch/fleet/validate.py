"""Advisor-verdict validation against the kernels measured on the card.

The analytical model predicts *which mechanism* pays on which matmul;
this harness checks the predictions' SIGN against the kernels K1-K3
running on the card, on matmul shapes drawn from the fleet's configs.
Three mechanisms, three kinds of claim:

* **skip** (``kernels.block_mm.skip_mm``, K1): block skipping visits only
  the nonzero W blocks, so the win is wall-clock.  The model (SKIP SAFs
  at the Buffer + compute, bitmask-conditioned on B) predicts ~1/density
  speedup; the measurement is the full vs nonzero-block kernel time.
* **gate** (``kernels.block_mm.gated_mm``, K2): gating predicates the
  MACs but walks (and loads) the full grid — GATE saves energy, not
  time.  The model (GATE SAFs) predicts ~1.0x time; the measurement
  confirms the *absence* of a wall-clock win, and skip-vs-gate ordering
  confirms skip strictly beats gate.
* **N:M** (``kernels.nm_spmm.nm_spmm``, K3): the weights are read
  compressed and decompressed on chip, so the win is memory traffic.
  The sign check is on the *weight-bytes ratio* of the actually-packed
  arrays (values + bit-packed offsets vs dense), which is what the
  advisor's verdict monetizes, plus the kernel's correctness against
  the dense product of the pruned weight.  The kernel's wall-clock
  against the dense product is recorded, not sign-gated.

Kernel times come from CUDA events on the card (:func:`_timeit`); a
measurement on CPU tensors runs the kernels' plain versions and its
times say nothing about the card.  Shapes are padded up to kernel- and
timing-legal sizes (:func:`kernel_cell`), and measurement cells are
deduplicated across configs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.engine import Design, Sparseloop
from ..core.mapping import LoopNest, nest
from ..core.presets import dense_design, two_level_arch
from ..core.taxonomy import (ActionSAF, RankFormat, SAFKind, SAFSpec,
                             TensorFormat)
from ..core.workload import matmul
from .extract import extract_network

#: a predicted/measured ratio beyond this is a "win"; the neutral band
#: between 1.0 and the threshold absorbs timing noise
WIN_THRESHOLD = 1.1
#: wider no-win band for the gate arm (gating adds mask-read overhead
#: that can swing timings either way)
GATE_NEUTRAL = 1.25

ALL_ARMS = ("skip-time", "gate-time", "skip-vs-gate",
            "nm-traffic", "nm-correct")
#: the arms measured on the block-sparse kernels K1/K2
BLOCK_ARMS = ("skip-time", "gate-time", "skip-vs-gate")
#: arms that are deterministic (no wall-clock) — what unit tests run
DETERMINISTIC_ARMS = ("nm-traffic", "nm-correct")


def edge_mapping(M: int, K: int, N: int, *, ns: int = 16, bm: int = 16,
                 bn: int = 16) -> LoopNest:
    """Structure-stable 2-level mapping (canonical_mapping with unit
    loops KEPT, so every shape shares one bucket/program)."""
    from ..core.advisor import _div_floor
    bm = _div_floor(M, bm)
    bn = _div_floor(N, bn)
    ns = _div_floor(N // bn, ns)
    return nest(
        2,
        ("m", M // bm, 1), ("n", N // (bn * ns), 1),
        ("n", ns, 1, "spatial"),
        ("n", bn, 0), ("k", K, 0), ("m", bm, 0),
    )


def block_skip_design(arch=None) -> Design:
    """Bitmask-compressed B with SKIP at the Buffer and compute: the
    mechanism skip_mm implements (only nonzero B blocks are visited)."""
    arch = arch or two_level_arch()
    fmts = {("DRAM", "B"): TensorFormat.of(RankFormat.B),
            ("Buffer", "B"): TensorFormat.of(RankFormat.B)}
    actions = (ActionSAF(SAFKind.SKIP, "Buffer", "A", ("B",)),
               ActionSAF(SAFKind.SKIP, "Buffer", "Z", ("B",)),
               ActionSAF(SAFKind.SKIP, "compute", "Z", ("B",)))
    return Design(arch=arch, safs=SAFSpec(formats=fmts, actions=actions),
                  name="block-skip")


def block_gate_design(arch=None) -> Design:
    """Bitmask B with GATE only: MACs are predicated off but the full
    grid is walked — energy savings, no time savings (gated_mm)."""
    arch = arch or two_level_arch()
    fmts = {("DRAM", "B"): TensorFormat.of(RankFormat.B),
            ("Buffer", "B"): TensorFormat.of(RankFormat.B)}
    actions = (ActionSAF(SAFKind.GATE, "Buffer", "A", ("B",)),
               ActionSAF(SAFKind.GATE, "compute", "Z", ("B",)))
    return Design(arch=arch, safs=SAFSpec(formats=fmts, actions=actions),
                  name="block-gate")


@dataclasses.dataclass
class AgreementRow:
    """One (config, arm, cell) sign-agreement check."""

    config: str
    layer: str
    arm: str
    M: int
    K: int
    N: int
    predicted: float
    measured: float
    pred_win: bool
    meas_win: bool
    agree: bool
    detail: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# ----------------------------------------------------------------------
# measurement
# ----------------------------------------------------------------------
def cuda_graph(fn: Callable, inner: int) -> torch.cuda.CUDAGraph:
    """``inner`` back-to-back calls of ``fn`` captured once in a CUDA
    graph (after a warm-up on a side stream, as capture requires).
    Replaying it launches the same kernels with no host work between
    them; launch counters see the captured calls, not the replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return graph


def _timeit(fn: Callable, reps: int, inner: int = 10) -> float:
    """Seconds per call, min over ``reps`` windows of ``inner`` calls,
    after a warm-up call.  On the card each window is one replay of the
    calls captured in a CUDA graph, timed with CUDA events: the device
    time of the kernels, without the host's per-call work (which is
    longer than the kernels themselves at the small cells).  On the CPU
    each call is timed with the host clock."""
    out = fn()
    if isinstance(out, torch.Tensor) and out.is_cuda:
        graph = cuda_graph(fn, inner)
        best = float("inf")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / inner)
        return best
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _pad_to(x: int, mult: int, floor: int) -> int:
    x = max(x, floor)
    return ((x + mult - 1) // mult) * mult


def kernel_cell(M: int, K: int, N: int, *, bs: int = 64,
                min_dim: int = 512) -> tuple[int, int, int]:
    """Pad a model shape up to a kernel- and timing-legal cell: K, N to
    block multiples >= min_dim, M to a multiple of 8 capped at 128 (the
    kernels clamp bm to min(bm, M), and one m-tile keeps the grid-size
    signal clean)."""
    Mk = min(128, _pad_to(M, 8, 8))
    return (Mk, _pad_to(K, bs, min_dim), _pad_to(N, bs, min_dim))


def block_cell_inputs(Mk: int, Kk: int, Nk: int, *, density: float,
                      bs: int, seed: int = 0, device=None) -> dict:
    """The inputs of one block cell, drawn from ``seed`` exactly as the
    JAX package draws them: A and W standard normal f32, a block mask of
    the given density with every column block present (``mask[0, :]``),
    W with its masked-off blocks zeroed, and the full and nonzero block
    lists."""
    from ..core.device import resolve_device
    from ..kernels.block_mm.ops import block_indices
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((Mk, Kk)).astype(np.float32)
    w = rng.standard_normal((Kk, Nk)).astype(np.float32)
    nb_k, nb_n = Kk // bs, Nk // bs
    mask = rng.random((nb_k, nb_n)) < density
    mask[0, :] = True          # every column block present
    wm = (w.reshape(nb_k, bs, nb_n, bs)
          * mask[:, None, :, None]).reshape(Kk, Nk)
    return {"a": torch.from_numpy(a).to(dev),
            "w": torch.from_numpy(w).to(dev),
            "wm": torch.from_numpy(wm).to(dev),
            "mask": mask,
            "full": block_indices(np.ones_like(mask)),
            "nonzero": block_indices(mask)}


def _measure_block_cell(Mk: int, Kk: int, Nk: int, *, density: float,
                        bs: int, reps: int, seed: int = 0,
                        device=None) -> dict:
    """Time the skip/gate kernels on one cell (on the card unless
    ``device="cpu"``, where the plain versions run).

    Returns times for the full grid (dense), the skipped nonzero-block
    grid and the gated full grid, the kernel's error against the oracle
    (absolute, as the JAX package reports it, and relative to the
    oracle's largest magnitude), and the block counts."""
    from ..kernels.block_mm.ops import (block_list, block_mm_ref, gated_mm,
                                        skip_mm)
    x = block_cell_inputs(Mk, Kk, Nk, density=density, bs=bs, seed=seed,
                          device=device)
    a, w, wm, mask = x["a"], x["w"], x["wm"], x["mask"]
    # block lists and mask go to the device once, as the metadata of a
    # stored sparse weight would: the timings are the kernels'
    full = block_list(*x["full"], mask.shape, a.device)
    nonzero = block_list(*x["nonzero"], mask.shape, a.device)
    mask_dev = torch.as_tensor(mask.astype(np.int32), device=a.device)
    t_full = _timeit(lambda: skip_mm(a, w, full, bm=bs, bk=bs, bn=bs),
                     reps)
    t_skip = _timeit(lambda: skip_mm(a, wm, nonzero, bm=bs, bk=bs, bn=bs),
                     reps)
    t_gate = _timeit(
        lambda: gated_mm(a, wm, mask_dev, bm=bs, bk=bs, bn=bs), reps)
    got = skip_mm(a, wm, nonzero, bm=bs, bk=bs, bn=bs)
    want = block_mm_ref(a, wm, mask_dev, bk=bs, bn=bs)
    err = float((got - want).abs().max())
    return {"t_full": t_full, "t_skip": t_skip, "t_gate": t_gate,
            "err": err,
            "rel_err": err / max(1e-30, float(want.abs().max())),
            "nnzb": int(mask.sum()), "blocks": int(mask.size)}


def _measure_nm_cell(Mk: int, Kk: int, Nk: int, *, n: int, m: int,
                     reps: int, bs: int = 64, seed: int = 0,
                     device=None) -> dict:
    """Pack an N:M-pruned weight and measure what the advisor monetizes:
    the weight-bytes ratio of the real packed arrays, plus the kernel's
    error against the dense product of the pruned W (relative to its
    largest magnitude) and, informational, the kernel's and the dense
    product's times.  On the card unless ``device="cpu"``, where the
    plain version runs; inputs are drawn from ``seed`` exactly as the
    JAX package draws them.

    ``bs`` block sizes are passed through to the kernel: cells are
    padded to ``bs`` multiples, which need not divide the kernel's
    default 128-wide blocks (``bs`` must be a multiple of ``m``)."""
    from ..core.device import resolve_device
    from ..kernels.nm_spmm import nm_spmm
    from ..sparsity.nm import nm_prune_dense, pack_nm, pack_offsets
    if bs % m:
        raise ValueError(f"bs={bs} is not a multiple of m={m}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(
        rng.standard_normal((Mk, Kk)).astype(np.float32)).to(dev)
    w = torch.from_numpy(
        rng.standard_normal((Kk, Nk)).astype(np.float32)).to(dev)
    w_nm = nm_prune_dense(w, n, m)
    vals, idx = pack_nm(w_nm, n, m)
    packed = pack_offsets(idx, m)
    sparse_bytes = vals.nbytes + packed.nbytes
    dense_bytes = w.nbytes
    t_dense = _timeit(lambda: a @ w, reps)
    t_nm = _timeit(lambda: nm_spmm(a, vals, idx, n=n, m=m, bk=bs, bn=bs),
                   reps)
    got = nm_spmm(a, vals, idx, n=n, m=m, bk=bs, bn=bs)
    want = a @ w_nm
    err = float((got - want).abs().max()) / max(
        1e-9, float(want.abs().max()))
    return {"bytes_ratio": sparse_bytes / dense_bytes,
            "t_dense": t_dense, "t_nm": t_nm, "err": err}


# ----------------------------------------------------------------------
# the model side
# ----------------------------------------------------------------------
def _predict_block(shapes, *, density: float, device=None) -> dict:
    """Model-predicted dense/skip/gate cycles per cell, via the batched
    network path (one program per design), on ``device``."""
    designs = {"dense": dense_design(two_level_arch()),
               "skip": block_skip_design(),
               "gate": block_gate_design()}
    dens = {"B": ("uniform", density)}
    out: dict = {name: [] for name in designs}
    for name, des in designs.items():
        engine = Sparseloop(des, device=device)
        d = None if name == "dense" else dens
        wls = [matmul(M, K, N, densities=d) for M, K, N in shapes]
        nests = [[edge_mapping(M, K, N)] for M, K, N in shapes]
        res = engine.evaluate_network(wls, nests, check_capacity=False)
        out[name] = [float(r["cycles"][0]) for r in res]
    return out


def block_rows(config: str, layer: str, cell: tuple[int, int, int],
               meas: dict, pd: float, ps: float, pg: float,
               arms: Sequence[str] = BLOCK_ARMS) -> list[AgreementRow]:
    """The skip-time, gate-time and skip-vs-gate rows of one cell, from
    its measurement (:func:`_measure_block_cell`) and the model's dense,
    skip and gate cycles (:func:`_predict_block`)."""
    M, K, N = cell
    rows: list[AgreementRow] = []
    if "skip-time" in arms:
        p, ms = pd / ps, meas["t_full"] / meas["t_skip"]
        pw, mw = p > WIN_THRESHOLD, ms > WIN_THRESHOLD
        rows.append(AgreementRow(
            config, layer, "skip-time", M, K, N, p, ms, pw, mw, pw == mw,
            f"nnzb={meas['nnzb']}/{meas['blocks']} "
            f"err={meas['err']:.2e}"))
    if "gate-time" in arms:
        p, ms = pd / pg, meas["t_full"] / meas["t_gate"]
        pw, mw = p > WIN_THRESHOLD, ms > GATE_NEUTRAL
        rows.append(AgreementRow(
            config, layer, "gate-time", M, K, N, p, ms, pw, mw, pw == mw,
            "gate walks the full grid: no time win"))
    if "skip-vs-gate" in arms:
        p, ms = pg / ps, meas["t_gate"] / meas["t_skip"]
        pw, mw = p > WIN_THRESHOLD, ms > WIN_THRESHOLD
        rows.append(AgreementRow(
            config, layer, "skip-vs-gate", M, K, N, p, ms, pw, mw,
            pw == mw, "SKIP saves time over GATE (taxonomy ordering)"))
    return rows


def validate_fleet(config_names=None, *, reduced: bool = True,
                   arms: Sequence[str] = ALL_ARMS,
                   density: float = 0.25, nm: tuple[int, int] = (2, 4),
                   bs: int = 64, min_dim: int = 512, reps: int = 5,
                   max_cells_per_config: int = 2,
                   seq_len: int = 256, batch: int = 8,
                   device=None) -> list[AgreementRow]:
    """Run the agreement harness: advisor/model verdict signs vs the
    kernels measured on ``device`` (the CUDA card unless
    ``device="cpu"``), on the decode shapes of each config's top weight
    matmuls by FLOPs.

    Returns one row per (config, arm, cell); a row with
    ``agree=False`` is a modeling claim contradicted by a measurement.
    Measurement cells are deduped globally across configs, so cost
    scales with unique padded shapes, not configs."""
    from ..configs import ARCH_NAMES, get_config
    from ..core.advisor import advise
    from ..core.device import resolve_device
    device = resolve_device(device)
    if config_names is None:
        config_names = ARCH_NAMES
    arms = tuple(arms)

    # ---- collect cells: top weight matmuls per config, padded ----
    per_config: list[tuple[str, str, tuple[int, int, int]]] = []
    for name in config_names:
        cfg = get_config(name, reduced=reduced)
        net = extract_network(cfg, "decode", seq_len=seq_len,
                              batch=batch)
        weights = sorted(net.weight_matmuls(),
                         key=lambda e: e.flops, reverse=True)
        for e in weights[:max_cells_per_config]:
            cell = kernel_cell(e.M, e.K, e.N, bs=bs, min_dim=min_dim)
            per_config.append((cfg.name, e.name, cell))

    cells = sorted({c for _, _, c in per_config})
    block_meas: dict = {}
    nm_meas: dict = {}
    needs_block = any(a in arms for a in BLOCK_ARMS)
    if needs_block:
        for c in cells:
            block_meas[c] = _measure_block_cell(
                *c, density=density, bs=bs, reps=reps, device=device)
    if "nm-traffic" in arms or "nm-correct" in arms:
        for c in cells:
            nm_meas[c] = _measure_nm_cell(*c, n=nm[0], m=nm[1],
                                          reps=reps, bs=bs, device=device)
    pred = (_predict_block(cells, density=density, device=device)
            if needs_block else {})
    cell_ix = {c: i for i, c in enumerate(cells)}

    # ---- advisor N:M verdicts per config (decode-like shard) ----
    nm_pred: dict = {}
    if "nm-traffic" in arms:
        for name in config_names:
            cfg = get_config(name, reduced=reduced)
            adv = advise(cfg, tokens_per_device=batch, tp=1,
                         nm_options=(nm,), device=device)
            nm_pred[cfg.name] = {a.layer: a for a in adv}

    rows: list[AgreementRow] = []
    for cfg_name, layer, cell in per_config:
        i = cell_ix[cell]
        M, K, N = cell
        if needs_block:
            rows += block_rows(cfg_name, layer, cell, block_meas[cell],
                               pred["dense"][i], pred["skip"][i],
                               pred["gate"][i], arms=arms)
        if "nm-traffic" in arms and cell in nm_meas:
            nmm = nm_meas[cell]
            adv = nm_pred.get(cfg_name, {}).get(layer)
            p = adv.speedup if adv else 1.0
            ms = 1.0 / nmm["bytes_ratio"]
            # the advisor only claims a win when compressed traffic is
            # lower; measured packed bytes must agree in sign
            pw, mw = p > 1.0 + 1e-6, ms > 1.0 + 1e-6
            rows.append(AgreementRow(
                cfg_name, layer, "nm-traffic", M, K, N, p, ms, pw, mw,
                (not pw) or mw,
                f"bytes_ratio={nmm['bytes_ratio']:.4f} "
                f"t_nm/t_dense={nmm['t_nm'] / nmm['t_dense']:.2f} "
                "(wall-clock informational)"))
        if "nm-correct" in arms and cell in nm_meas:
            err = nm_meas[cell]["err"]
            ok = err < 1e-3
            rows.append(AgreementRow(
                cfg_name, layer, "nm-correct", M, K, N, 0.0, err, ok,
                ok, ok, "kernel output vs dense product of pruned W"))
    return rows


def agreement_summary(rows: Sequence[AgreementRow]) -> str:
    bad = [r for r in rows if not r.agree]
    by_arm: dict = {}
    for r in rows:
        by_arm.setdefault(r.arm, []).append(r)
    lines = [f"advisor agreement: {len(rows) - len(bad)}/{len(rows)} "
             f"rows agree across {len(by_arm)} arms"]
    for arm, rs in sorted(by_arm.items()):
        ag = sum(1 for r in rs if r.agree)
        preds = ", ".join(f"{r.predicted:.2f}/{r.measured:.2f}"
                          for r in rs[:3])
        lines.append(f"  {arm:>14}: {ag}/{len(rs)} agree "
                     f"(pred/meas e.g. {preds})")
    for r in bad:
        lines.append(f"  DISAGREE {r.config} {r.layer} {r.arm} "
                     f"M{r.M} K{r.K} N{r.N}: predicted {r.predicted:.3f}"
                     f" measured {r.measured:.3f} ({r.detail})")
    return "\n".join(lines)
