"""Legal mappings drawn from a seed, with which the benchmark's tests
hold the reference to the program's scalar model and batched engine.

A mapping of a layer onto an ``L``-level design is, per storage level, a
temporal bound for every rank and a loop order, plus the configuration's
fixed spatial loops.  Each rank's bound (after the spatial factors) is
split into its prime factors, and the primes are handed to levels: half
of the mappings split a rank's sorted primes between two random levels at
a random cut (one large block a level, the shape real tilings take), half
hand every prime to a level of its own drawing.  Every such split is a
legal factorisation, so every mapping is legal; whether its tiles fit is
what the model answers (``valid``).

The same mappings go to both sides: to the program as the bucket-relative
arrays its engine takes (:func:`bucket_arrays`), to the reference as loop
nests (:func:`loops`).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def prime_factors(n: int) -> list[int]:
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    if n > 1:
        out.append(n)
    return out


@dataclasses.dataclass(frozen=True)
class MappingSet:
    """``n`` mappings of one layer.

    ``ranks``: rank names in the workload's order; ``factors[c, r, l]``:
    the temporal bound of rank ``r`` at level ``l`` (innermost-first
    levels, as the model indexes them); ``order[c, l]``: the loop order
    at level ``l``, outermost first, as indices into ``ranks``;
    ``spatial``: ``{level: ((rank, bound), ...)}``, the same for all."""

    ranks: tuple[str, ...]
    factors: np.ndarray
    order: np.ndarray
    spatial: dict

    def __len__(self) -> int:
        return len(self.factors)

    @property
    def num_levels(self) -> int:
        return self.factors.shape[2]


def draw(rank_bounds: dict, num_levels: int, spatial: dict, n: int,
         rng: np.random.Generator) -> MappingSet:
    """``n`` legal mappings from ``rng`` (see the module docstring).
    ``spatial`` is ``{level: {rank: bound}}`` with innermost-first
    levels; every spatial bound must divide its rank's bound."""
    ranks = tuple(rank_bounds)
    R, L = len(ranks), num_levels
    residual = dict(rank_bounds)
    for lvl, d in spatial.items():
        for r, b in d.items():
            if residual[r] % b:
                raise ValueError(f"spatial bound {b} does not divide "
                                 f"rank {r} ({rank_bounds[r]})")
            residual[r] //= b
    factors = np.ones((n, R, L), np.int64)
    structured = rng.random(n) < 0.5
    for ri, r in enumerate(ranks):
        primes = np.asarray(prime_factors(residual[r]), np.int64)
        g = len(primes)
        if g == 0:
            continue
        la = rng.integers(0, L, n)
        lb = rng.integers(0, L, n)
        cut = rng.integers(0, g + 1, n)
        block = np.where(np.arange(g)[None, :] < cut[:, None],
                         la[:, None], lb[:, None])
        free = rng.integers(0, L, (n, g))
        level_of = np.where(structured[:, None], block, free)
        for lvl in range(L):
            factors[:, ri, lvl] = np.prod(
                np.where(level_of == lvl, primes[None, :], 1), axis=1)
    order = np.argsort(rng.random((n, L, R)), axis=2)
    spatial_t = {int(lvl): tuple((r, int(b)) for r, b in d.items() if b > 1)
                 for lvl, d in spatial.items()}
    return MappingSet(ranks=ranks, factors=factors, order=order,
                      spatial=spatial_t)


def bucket_arrays(ms: MappingSet) -> tuple[np.ndarray, np.ndarray]:
    """``(bounds, rank_ids)``, both ``(n, slots)``: the layout of the
    engine's padded bucket, levels outermost first, each level's ``R``
    temporal slots in its loop order followed by its spatial slots.
    Absent loops ride as bound 1."""
    n, R, L = ms.factors.shape
    ridx = {r: i for i, r in enumerate(ms.ranks)}
    cols_b, cols_i = [], []
    for lvl in range(L - 1, -1, -1):
        order = ms.order[:, lvl, :]
        cols_i.append(order)
        cols_b.append(np.take_along_axis(ms.factors[:, :, lvl], order,
                                         axis=1))
        for r, b in ms.spatial.get(lvl, ()):
            cols_i.append(np.full((n, 1), ridx[r], np.int64))
            cols_b.append(np.full((n, 1), b, np.int64))
    return np.concatenate(cols_b, axis=1), np.concatenate(cols_i, axis=1)


def bucket_shape(ms: MappingSet) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(temporal slots, spatial slots) per level, innermost-first: the
    bucket :func:`bucket_arrays` fills."""
    R, L = len(ms.ranks), ms.num_levels
    return ((R,) * L,
            tuple(len(ms.spatial.get(lvl, ())) for lvl in range(L)))


def loops(ms: MappingSet, c: int) -> list[tuple[str, int, int, bool]]:
    """Mapping ``c`` as ``(rank, bound, level, spatial)`` loops, outermost
    first, unit loops left out (a loop of bound 1 iterates nothing)."""
    out = []
    for lvl in range(ms.num_levels - 1, -1, -1):
        for ri in ms.order[c, lvl]:
            b = int(ms.factors[c, ri, lvl])
            if b > 1:
                out.append((ms.ranks[ri], b, lvl, False))
        for r, b in ms.spatial.get(lvl, ()):
            out.append((r, b, lvl, True))
    return out
