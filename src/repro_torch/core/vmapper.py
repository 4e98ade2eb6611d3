"""Vectorized two-level spMspM mapspace search — a thin preset wrapper
over the general batched engine (core.batched).

The batched engine evaluates the closed-form traffic/SAF/microarch
equations for arbitrary level counts, rank sets and ``SAFSpec``s, so
all that lives here is the preset: the template

    L1:  for m1, for n1, parallel-for ns
    L0:  for n0, for k0(=K), for m0      -> MACs

and the Fig.-1 design family knobs (:class:`VDesign`) lowered onto real
``Design`` objects (dense / bitmask / coordinate-list).  Results now match
the scalar engine *exactly* on sparse designs too (the old approximation
only preserved ranking).

``evaluate_batch`` returns per-candidate metric arrays; ``search``
arg-mins over the full factorization cross-product.  Both run the
batched engine on the CUDA card unless ``device="cpu"`` is asked for.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .arch import Architecture
from .batched import NestTemplate
from .device import resolve_device
from .engine import Design, Sparseloop
from .mapping import factorize
from .taxonomy import ActionSAF, RankFormat, SAFKind, SAFSpec, TensorFormat
from .workload import matmul

#: the Fig. 6/17 two-level spMspM loop structure; bounds order is
#: (m1, n1, ns, n0, k0, m0) — unit bounds are treated as absent loops
SPMSPM_TEMPLATE = NestTemplate(
    slots=(("m", 1, False), ("n", 1, False), ("n", 1, True),
           ("n", 0, False), ("k", 0, False), ("m", 0, False)),
    num_levels=2)


@dataclasses.dataclass(frozen=True)
class VDesign:
    """Fig.-1 design family knobs."""
    compress: bool = False      # compressed A/B (values move as nnz)
    meta_bits_per_nnz: float = 0.0   # CP/RLE-style metadata
    meta_bits_per_coord: float = 0.0  # B-style metadata (per dense coord)
    skip: bool = False          # Skip B<-A and Skip Z<-A&B at Buffer
    gate: bool = False          # Gate storage (B<-A) + Gate Compute

    def to_design(self, arch: Architecture) -> Design:
        """Lower the knobs onto a concrete SAF taxonomy Design (the
        dense / bitmask / coordinate-list designs of Fig. 1)."""
        fmts: dict[tuple[str, str], TensorFormat] = {}
        if self.compress or self.meta_bits_per_coord > 0:
            if self.meta_bits_per_coord > 0:
                fmt = TensorFormat.of(RankFormat.B, RankFormat.B)
            else:
                cb = int(self.meta_bits_per_nnz // 2) or 16
                fmt = TensorFormat.of(RankFormat.CP, RankFormat.CP,
                                      coord_bits=cb)
            for lvl in ("DRAM", "Buffer"):
                fmts[(lvl, "A")] = fmt
                fmts[(lvl, "B")] = fmt
        actions: tuple[ActionSAF, ...] = ()
        if self.skip:
            actions = (
                ActionSAF(SAFKind.SKIP, "Buffer", "B", ("A",)),
                ActionSAF(SAFKind.SKIP, "Buffer", "Z", ("A", "B")),
            )
            if self.gate:
                actions += (
                    ActionSAF(SAFKind.GATE, "compute", "Z", ("A", "B")),)
        elif self.gate:
            actions = (
                ActionSAF(SAFKind.GATE, "Buffer", "B", ("A",)),
                ActionSAF(SAFKind.GATE, "compute", "Z", ("A", "B")),
            )
        name = ("coordlist" if self.skip else
                "bitmask" if self.gate else "dense")
        return Design(arch=arch, safs=SAFSpec(formats=fmts,
                                              actions=actions), name=name)


def candidate_factors(M: int, N: int, K: int, max_spatial: int = 64
                      ) -> np.ndarray:
    """All (m1, m0, n1, ns, n0) factorizations (k stays at L0)."""
    out = []
    for m1, m0 in factorize(M):
        for n1, rest in factorize(N):
            for ns, n0 in factorize(rest):
                if ns <= max_spatial:
                    out.append((m1, m0, n1, ns, n0))
    return np.asarray(out, np.int64)


def _to_bounds(factors, K: int) -> np.ndarray:
    """(C, 5) (m1, m0, n1, ns, n0) factors -> (C, 6) template bounds."""
    f = np.asarray(factors, np.int64).reshape(-1, 5)
    m1, m0, n1, ns, n0 = (f[:, i] for i in range(5))
    k = np.full_like(m1, K)
    return np.stack([m1, n1, ns, n0, k, m0], axis=1)


@functools.lru_cache(maxsize=64)
def _model_for(M: int, N: int, K: int, dA: float, dB: float,
               arch: Architecture, design: VDesign, device=None):
    """Batched evaluator on ``device``, memoized so repeated calls
    (sweeps, benchmarks) reuse its program."""
    wl = matmul(M, K, N, densities={"A": ("uniform", dA),
                                    "B": ("uniform", dB)})
    return Sparseloop(design.to_design(arch), device=device).batched_model(
        wl, SPMSPM_TEMPLATE, check_capacity=False)


def evaluate_batch(factors, M: int, N: int, K: int, dA: float, dB: float,
                   arch: Architecture, design: VDesign, device=None
                   ) -> dict[str, np.ndarray]:
    """factors: (C, 5) int array -> dict of (C,) metric arrays.

    One batched evaluation over the whole candidate set on ``device``
    (the CUDA card when None, raising without CUDA); values match
    ``Sparseloop.evaluate`` on the equivalent Design exactly.
    """
    model = _model_for(M, N, K, dA, dB, arch, design,
                       resolve_device(device))
    out = model.evaluate(_to_bounds(factors, K))
    out.pop("valid", None)
    return out


def search(M, N, K, dA, dB, arch, design: VDesign,
           objective: str = "edp", device=None):
    cand = candidate_factors(M, N, K)
    metrics = evaluate_batch(cand, M, N, K, dA, dB, arch, design,
                             device=device)
    best = int(np.argmin(metrics[objective]))
    # per-candidate scalars only: columns with trailing axes (per-level
    # occupancy is (C, S)) aren't summary metrics
    return cand[best], {k: float(v[best]) for k, v in metrics.items()
                        if np.ndim(v[best]) == 0}, \
        len(cand)
