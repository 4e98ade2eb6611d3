"""Model-verdict validation against the measured block-sparse kernels.

The analytical model predicts *which mechanism* pays on which matmul;
this harness checks the predictions' SIGN against the kernels running on
the card.  This module holds the block half of the JAX package's
harness — the two mechanisms the paper's taxonomy separates:

* **skip** (``kernels.block_mm.skip_mm``, K1): block skipping visits only
  the nonzero W blocks, so the win is wall-clock.  The model (SKIP SAFs
  at the Buffer + compute, bitmask-conditioned on B) predicts ~1/density
  speedup; the measurement is the full vs nonzero-block kernel time.
* **gate** (``kernels.block_mm.gated_mm``, K2): gating predicates the
  MACs but walks (and loads) the full grid — GATE saves energy, not
  time.  The model (GATE SAFs) predicts ~1.0x time; the measurement
  confirms the *absence* of a wall-clock win, and skip-vs-gate ordering
  confirms skip strictly beats gate.

Kernel times come from CUDA events on the card (:func:`_timeit`); a
measurement on CPU tensors runs the kernels' plain versions and its
times say nothing about the card.  The N:M arms, ``validate_fleet`` and
the config extraction they need come with a later slice of the port.
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

#: a predicted/measured ratio beyond this is a "win"; the neutral band
#: between 1.0 and the threshold absorbs timing noise
WIN_THRESHOLD = 1.1
#: wider no-win band for the gate arm (gating adds mask-read overhead
#: that can swing timings either way)
GATE_NEUTRAL = 1.25

ALL_ARMS = ("skip-time", "gate-time", "skip-vs-gate",
            "nm-traffic", "nm-correct")
#: the arms this module measures (the N:M arms need a later slice)
BLOCK_ARMS = ("skip-time", "gate-time", "skip-vs-gate")


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
