"""Mapping representation (Sparseloop Sec. 5.1 'Mapping').

A mapping is a loop nest (outermost first).  Each loop is bound to a
storage level: temporal loops at level s iterate over sub-tiles that are
delivered into level s-1 (coordinate-space tiling, Sec. 5.2 / Fig. 7a);
spatial loops at level s distribute sub-tiles across the fanout of
hardware instances *below* level s.

Levels use innermost-first indices: 0 = innermost storage (e.g. RF),
num_levels-1 = outermost (e.g. DRAM).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Iterable, Mapping as TMapping

from .workload import Workload


@dataclasses.dataclass(frozen=True)
class Loop:
    rank: str
    bound: int
    level: int            # storage level (innermost-first index) it lives at
    spatial: bool = False

    def describe(self) -> str:
        kind = "parallel-for" if self.spatial else "for"
        return f"{kind} {self.rank} in [0:{self.bound}) @L{self.level}"


@dataclasses.dataclass(frozen=True)
class LoopNest:
    """Ordered outermost -> innermost."""

    loops: tuple[Loop, ...]
    num_levels: int

    # ------------------------------------------------------------------
    def validate(self, workload: Workload) -> None:
        prod: dict[str, int] = {r: 1 for r in workload.rank_bounds}
        for lp in self.loops:
            if lp.rank not in prod:
                raise ValueError(f"loop over unknown rank {lp.rank}")
            if not (0 <= lp.level < self.num_levels):
                raise ValueError(f"loop level {lp.level} out of range")
            prod[lp.rank] *= lp.bound
        for r, b in workload.rank_bounds.items():
            if prod[r] != b:
                raise ValueError(
                    f"rank {r}: mapped product {prod[r]} != bound {b}")
        # loops must be grouped by non-increasing level (outermost first),
        # with spatial loops allowed anywhere within their level's group
        levels = [lp.level for lp in self.loops]
        if levels != sorted(levels, reverse=True):
            raise ValueError("loops must be ordered outermost level first")

    # ------------------------------------------------------------------
    def tile_bounds(self, level: int) -> dict[str, int]:
        """Per-rank extents of the tile RESIDENT at `level`.

        Includes every loop at levels <= level (its own temporal loops
        iterate sub-tiles *within* the resident tile, so they count), i.e.
        the data footprint needed to execute the whole sub-nest at or
        below this level.
        """
        out: dict[str, int] = {}
        for lp in self.loops:
            if lp.level <= level:
                out[lp.rank] = out.get(lp.rank, 1) * lp.bound
        return out

    def child_tile_bounds(self, level: int) -> dict[str, int]:
        """Per-rank extents of the unit transferred from `level` to below:
        the per-instance tile at level-1 (or the compute operand when
        level == 0)."""
        out: dict[str, int] = {}
        for lp in self.loops:
            if lp.level < level:
                out[lp.rank] = out.get(lp.rank, 1) * lp.bound
        return out

    def temporal_loops_at_or_above(self, level: int) -> tuple[Loop, ...]:
        """Temporal loops at levels >= level, outermost first."""
        return tuple(lp for lp in self.loops
                     if not lp.spatial and lp.level >= level)

    def spatial_loops_at(self, level: int) -> tuple[Loop, ...]:
        return tuple(lp for lp in self.loops
                     if lp.spatial and lp.level == level)

    def fanout_below(self, level: int) -> int:
        """Hardware instances of level-1 storage under one level instance."""
        return math.prod(lp.bound for lp in self.spatial_loops_at(level))

    def instances_of(self, level: int) -> int:
        """Total instances of `level` storage in the machine."""
        return math.prod(lp.bound for lp in self.loops
                         if lp.spatial and lp.level > level)

    def inner_temporal_loops(self, level: int) -> tuple[Loop, ...]:
        """Temporal loops strictly below `level`, outermost first."""
        return tuple(lp for lp in self.loops
                     if not lp.spatial and lp.level < level)

    def structure(self) -> tuple[tuple[str, int, bool], ...]:
        """(rank, level, spatial) slots with bounds stripped — the key the
        batched engine (core.batched.NestTemplate) groups candidates by."""
        return tuple((lp.rank, lp.level, lp.spatial) for lp in self.loops)

    def bounds(self) -> tuple[int, ...]:
        """Per-loop bounds, aligned with :meth:`structure`."""
        return tuple(lp.bound for lp in self.loops)

    def describe(self) -> str:
        lines, indent = [], 0
        cur = None
        for lp in self.loops:
            if cur is not None and lp.level != cur:
                lines.append("  " * indent + f"--- L{lp.level} ---")
            cur = lp.level
            lines.append("  " * indent + lp.describe())
            indent += 1
        return "\n".join(lines)


# ----------------------------------------------------------------------
# Convenience constructors
# ----------------------------------------------------------------------
def nest(num_levels: int, *specs: tuple) -> LoopNest:
    """Build a LoopNest from (rank, bound, level[, 'spatial']) tuples,
    listed outermost first."""
    loops = []
    for s in specs:
        rank, bound, level = s[0], s[1], s[2]
        spatial = len(s) > 3 and s[3] == "spatial"
        loops.append(Loop(rank=rank, bound=int(bound), level=int(level),
                          spatial=spatial))
    return LoopNest(loops=tuple(loops), num_levels=num_levels)


def factorize(n: int) -> list[tuple[int, int]]:
    """All (a, b) with a * b == n."""
    out = []
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            out.append((a, n // a))
            if a != n // a:
                out.append((n // a, a))
    return out


def factor_splits(n: int, parts: int) -> Iterable[tuple[int, ...]]:
    """All ordered tuples of `parts` factors whose product is n."""
    if parts == 1:
        yield (n,)
        return
    for a in sorted({a for a, _ in factorize(n)}):
        for rest in factor_splits(n // a, parts - 1):
            yield (a,) + rest
