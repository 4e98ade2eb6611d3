"""Step One: dataflow modeling (Sparseloop Sec. 5.2).

Derives the *dense traffic* — uncompressed data movement and dense compute —
implied by a mapping, using a Timeloop-style analytical reuse model:

  * the tile resident at storage level s covers all loops at levels <= s
    (coordinate-space tiling, Fig. 7a);
  * a tile is re-fetched from its parent once per iteration of the outer
    temporal loops, down to and including the innermost loop *relevant* to
    the tensor (trailing irrelevant loops give temporal reuse /
    stationarity — this is exactly the reuse structure that determines
    leader/follower intersection tiles in Fig. 10);
  * spatial loops whose rank is irrelevant to a tensor multicast the same
    data to all instances (parent reads it once);
  * output tensors flow upward: each level receives partial-sum updates
    from below, performs read-modify-write accumulation, and evicts /
    re-fetches partial tiles when outer reduction loops intervene.

All counts here are *dense*: Step Two (sparse.py) filters them into
actual / gated / skipped fine-grained actions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping as TMapping

from .mapping import Loop, LoopNest
from .workload import TensorSpec, Workload


# ----------------------------------------------------------------------
def fetch_counts(nest: LoopNest, child_level: int,
                 relevant_ranks: frozenset[str]) -> tuple[float, float]:
    """(rounds, distinct) tile-fetch counts into `child_level`.

    rounds   = product of temporal-loop bounds at levels > child_level,
               outermost down to the innermost relevant loop (inclusive).
    distinct = product of only the relevant bounds within that prefix.

    This is the scalar reuse-prefix rule the batched engine
    (core.batched) re-derives per candidate from ``bound > 1`` masks;
    keep the two in sync (the parity suite pins them against each other).
    """
    loops = [lp for lp in nest.loops
             if not lp.spatial and lp.level > child_level]
    last_rel = -1
    for i, lp in enumerate(loops):
        if lp.rank in relevant_ranks:
            last_rel = i
    if last_rel < 0:
        return 1.0, 1.0
    rounds, distinct = 1.0, 1.0
    for lp in loops[: last_rel + 1]:
        rounds *= lp.bound
        if lp.rank in relevant_ranks:
            distinct *= lp.bound
    return rounds, distinct


def _merge_bounds(base: dict[str, int], loops: tuple[Loop, ...],
                  relevant_ranks: frozenset[str]) -> dict[str, int]:
    out = dict(base)
    for lp in loops:
        if lp.rank in relevant_ranks:
            out[lp.rank] = out.get(lp.rank, 1) * lp.bound
    return out


@dataclasses.dataclass
class TensorLevelTraffic:
    """Dense traffic of one tensor at one storage level (per instance)."""

    tensor: str
    level: int
    tile_bounds: dict[str, int]
    tile_dims: tuple[int, ...]
    tile_size: int
    #: tile-fetch rounds into this level from the parent
    fill_rounds: float = 0.0
    fill_words: float = 0.0
    #: reads from this level serving the child below (or compute)
    read_rounds: float = 0.0
    read_words: float = 0.0
    #: per-round distinct words delivered downward (child tile + rel. spatial)
    read_round_words: float = 0.0
    read_round_dims: tuple[int, ...] = ()
    #: output flows
    update_words: float = 0.0        # partial-sum writes arriving from below
    rmw_read_words: float = 0.0      # local read-modify-write reads
    writeback_words: float = 0.0     # words sent up to the parent
    partial_fill_words: float = 0.0  # partial tiles re-fetched from parent
    instances: int = 1


@dataclasses.dataclass
class DenseTraffic:
    """Full Step-One result."""

    workload: Workload
    nest: LoopNest
    #: (tensor, level) -> traffic
    per_level: dict[tuple[str, int], TensorLevelTraffic]
    dense_computes: float
    compute_instances: int
    #: per-compute-instance operand reads (element granularity)
    compute_reads: dict[str, float]

    def of(self, tensor: str, level: int) -> TensorLevelTraffic:
        return self.per_level[(tensor, level)]


def analyze_dataflow(workload: Workload, nest: LoopNest) -> DenseTraffic:
    nest.validate(workload)
    S = nest.num_levels
    z = workload.output_tensor
    per_level: dict[tuple[str, int], TensorLevelTraffic] = {}

    total_temporal = math.prod(
        lp.bound for lp in nest.loops if not lp.spatial)
    total_spatial = math.prod(lp.bound for lp in nest.loops if lp.spatial)

    for t in workload.tensors:
        rel = t.ranks
        is_out = t.name == workload.output
        for s in range(S):
            tb = nest.tile_bounds(s)
            tile_dims = t.tile_dims(tb)
            tlt = TensorLevelTraffic(
                tensor=t.name, level=s, tile_bounds=tb,
                tile_dims=tile_dims, tile_size=math.prod(tile_dims),
                instances=nest.instances_of(s))

            # ---- fills into this level from the parent ----
            rounds, distinct = fetch_counts(nest, s, rel)
            if s < S - 1:  # outermost level holds the source data
                if not is_out:
                    tlt.fill_rounds = rounds
                    tlt.fill_words = rounds * tlt.tile_size
                else:
                    # partial-sum tiles re-fetched when outer reduction
                    # loops evict incomplete tiles
                    tlt.partial_fill_words = (rounds - distinct) * tlt.tile_size

            # ---- reads from this level serving the child below ----
            child = s - 1
            child_tb = nest.tile_bounds(child) if child >= 0 else {}
            c_rounds, c_distinct = fetch_counts(nest, child, rel)
            spatial_here = nest.spatial_loops_at(s)
            served_tb = _merge_bounds(child_tb, spatial_here, rel)
            served_dims = t.tile_dims(served_tb)
            served_words = math.prod(served_dims)
            if not is_out:
                tlt.read_rounds = c_rounds
                tlt.read_round_words = served_words
                tlt.read_round_dims = served_dims
                tlt.read_words = c_rounds * served_words
            else:
                # partial redistribution downward: partial tiles read from
                # this level to be continued in the child.  At s == 0 the
                # child is compute, whose re-accumulation is already the
                # local read-modify-write — no extra reads.
                tlt.read_rounds = c_rounds
                tlt.read_round_words = served_words
                tlt.read_round_dims = served_dims
                child_tile = t.tile_size(child_tb)
                spatial_rel = math.prod(
                    lp.bound for lp in spatial_here if lp.rank in rel)
                tlt.read_words = ((c_rounds - c_distinct) * child_tile
                                  * spatial_rel if s > 0 else 0.0)

            # ---- output update flows ----
            if is_out:
                fanout = nest.fanout_below(s) if s > 0 else math.prod(
                    lp.bound for lp in nest.spatial_loops_at(0))
                if s == 0:
                    temporal_here = math.prod(
                        lp.bound for lp in nest.loops if not lp.spatial)
                    tlt.update_words = temporal_here * max(1, fanout)
                else:
                    ce, cd = fetch_counts(nest, s - 1, rel)
                    child_tile = t.tile_size(nest.tile_bounds(s - 1))
                    tlt.update_words = fanout * ce * child_tile
                tlt.rmw_read_words = max(
                    0.0, tlt.update_words - distinct * tlt.tile_size
                    if s < S - 1 else
                    tlt.update_words - t.size(workload.rank_bounds) /
                    max(1, tlt.instances))
                if s < S - 1:
                    tlt.writeback_words = rounds * tlt.tile_size

            per_level[(t.name, s)] = tlt

    compute_reads = {}
    for t in workload.input_tensors:
        rounds, _ = fetch_counts(nest, -1, t.ranks)
        compute_reads[t.name] = rounds

    return DenseTraffic(
        workload=workload, nest=nest, per_level=per_level,
        dense_computes=float(total_temporal * total_spatial),
        compute_instances=total_spatial,
        compute_reads=compute_reads,
    )


# ----------------------------------------------------------------------
def leader_tile_bounds(nest: LoopNest, level: int, follower: TensorSpec,
                       leader: TensorSpec) -> dict[str, int]:
    """Leader-intersection tile for a SAF at `level` on `follower`.

    Per Sec. 5.3.4 / Fig. 10: when a follower tile is delivered from
    `level` to the child below, the leader data it will be used against is

      * the extent of all loops in the child's sub-nest (levels < level),
      * plus the *trailing* temporal loops at levels >= level that are
        irrelevant to the follower (the follower tile stays stationary
        across them while the leader streams).

    Returns per-rank bounds; project through the leader's TensorSpec to get
    the tile shape whose emptiness probability gates the elimination.
    """
    bounds: dict[str, int] = {}
    for lp in nest.loops:
        if lp.level < level:
            bounds[lp.rank] = bounds.get(lp.rank, 1) * lp.bound
    # trailing irrelevant temporal loops at levels >= level
    outer = [lp for lp in nest.loops
             if not lp.spatial and lp.level >= level]
    for lp in reversed(outer):
        if lp.rank in follower.ranks:
            break
        bounds[lp.rank] = bounds.get(lp.rank, 1) * lp.bound
    return bounds
