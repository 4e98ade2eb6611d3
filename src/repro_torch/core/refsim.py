"""Actual-data reference simulator.

Plays the role the design-specific cycle-level simulators play in the
paper's evaluation (Sec. 6.2-6.3): it walks the mapped loop nest over
*concrete* tensors, maintains per-level resident tiles under the same
buffering assumptions as the analytical model, applies each SAF exactly
(real intersection checks on real data), and counts every fine-grained
action.  It shares Step Three (microarch.py) with the analytical engine,
so any disagreement isolates the *statistical* approximation error — the
same decomposition the paper uses to attribute its 0.1%-8% errors.

It is intentionally data-iterating and therefore slow; the CPHC speedup
of the analytical engine over this simulator reproduces the paper's
>2000x speed claim in spirit (benchmarks/bench_table5_cphc.py).

Scope: non-projected tensors (dot / mv / matmul families) — the workloads
used by the paper's own intersection-heavy validations.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .dataflow import leader_tile_bounds
from .mapping import LoopNest
from .sparse import ActionBreakdown, SparseTensorLevel, SparseTraffic
from .taxonomy import SAFKind, SAFSpec
from .workload import TensorSpec, Workload
from .formats import analyze_tile_format
from .density import ActualDataModel


# ----------------------------------------------------------------------
def _temporal_grid(nest: LoopNest) -> tuple[np.ndarray, list]:
    """(iters x n_temporal) value grid in nested order + the loop list."""
    loops = [lp for lp in nest.loops if not lp.spatial]
    bounds = [lp.bound for lp in loops]
    total = math.prod(bounds) if bounds else 1
    if total > 4_000_000:
        raise ValueError(f"refsim iteration space too large: {total}")
    grid = np.indices(bounds).reshape(len(bounds), -1).T if bounds else \
        np.zeros((1, 0), dtype=np.int64)
    return grid.astype(np.int64), loops


def _strides(nest: LoopNest) -> dict[int, int]:
    """Per-loop stride: product of bounds of same-rank loops nested inside."""
    strides: dict[int, int] = {}
    for i, lp in enumerate(nest.loops):
        s = 1
        for inner in nest.loops[i + 1:]:
            if inner.rank == lp.rank:
                s *= inner.bound
        strides[i] = s
    return strides


def _run_starts(grid: np.ndarray, cols: list[int]) -> np.ndarray:
    """Boolean mask of rows where the selected columns change (tile fetch
    events under single-tile buffering)."""
    n = grid.shape[0]
    starts = np.zeros(n, dtype=bool)
    starts[0] = True
    if cols:
        sub = grid[:, cols]
        starts[1:] = (sub[1:] != sub[:-1]).any(axis=1)
    return starts


class _Integral:
    """O(1) nnz-in-slice queries for 1-D / 2-D boolean arrays."""

    def __init__(self, a: np.ndarray):
        nz = (np.asarray(a) != 0).astype(np.int64)
        if nz.ndim == 0:
            nz = nz.reshape(1)
        self.nd = nz.ndim
        if self.nd == 1:
            self.s = np.concatenate([[0], np.cumsum(nz)])
        elif self.nd == 2:
            s = np.zeros((nz.shape[0] + 1, nz.shape[1] + 1), dtype=np.int64)
            s[1:, 1:] = nz.cumsum(0).cumsum(1)
            self.s = s
        else:
            raise ValueError("refsim supports 1-D/2-D tensors")
        self.shape = nz.shape

    def nnz(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """Vectorized nnz of [lo, hi) boxes; lo/hi shape (n, nd)."""
        lo = np.clip(lo, 0, np.array(self.shape))
        hi = np.clip(hi, 0, np.array(self.shape))
        if self.nd == 1:
            return self.s[hi[:, 0]] - self.s[lo[:, 0]]
        return (self.s[hi[:, 0], hi[:, 1]] - self.s[lo[:, 0], hi[:, 1]]
                - self.s[hi[:, 0], lo[:, 1]] + self.s[lo[:, 0], lo[:, 1]])


@dataclasses.dataclass
class _TensorCtx:
    spec: TensorSpec
    data: np.ndarray
    integral: _Integral
    nnz_total: int


def _coords(grid: np.ndarray, loops: list, strides_all: dict,
            nest: LoopNest, level_gt: int, spec: TensorSpec) -> np.ndarray:
    """Tile-origin coordinates (per tensor dim) contributed by temporal
    loops at levels > level_gt, for every row of the grid."""
    nd = len(spec.projection)
    out = np.zeros((grid.shape[0], nd), dtype=np.int64)
    # map temporal-loop order -> global nest index for stride lookup
    tmap = [i for i, lp in enumerate(nest.loops) if not lp.spatial]
    for col, lp in enumerate(loops):
        if lp.level <= level_gt:
            continue
        for d, dim in enumerate(spec.projection):
            if lp.rank in dim:
                out[:, d] += grid[:, col] * strides_all[tmap[col]]
    return out


def _tile_extents(nest: LoopNest, level_le: int, spec: TensorSpec,
                  include_spatial_at: int | None = None) -> np.ndarray:
    bounds: dict[str, int] = {}
    for lp in nest.loops:
        if lp.level <= level_le or (
                include_spatial_at is not None and lp.spatial
                and lp.level == include_spatial_at
                and lp.rank in spec.ranks):
            bounds[lp.rank] = bounds.get(lp.rank, 1) * lp.bound
    return np.array(spec.tile_dims(bounds), dtype=np.int64).reshape(1, -1) \
        if spec.projection else np.zeros((1, 0), dtype=np.int64)


def simulate(workload: Workload, nest: LoopNest, safs: SAFSpec,
             arrays: dict[str, np.ndarray],
             arch_level_names: list[str]) -> SparseTraffic:
    """Exact simulation -> SparseTraffic (feed to evaluate_microarch)."""
    nest.validate(workload)
    for t in workload.tensors:
        if any(len(dim) > 1 for dim in t.projection):
            raise ValueError("refsim supports non-projected tensors only")
    S = nest.num_levels
    grid, tloops = _temporal_grid(nest)
    strides_all = _strides(nest)
    tmap = [i for i, lp in enumerate(nest.loops) if not lp.spatial]

    ctx: dict[str, _TensorCtx] = {}
    for t in workload.tensors:
        a = np.asarray(arrays.get(
            t.name, np.ones(t.dim_sizes(workload.rank_bounds))))
        ctx[t.name] = _TensorCtx(spec=t, data=a, integral=_Integral(a),
                                 nnz_total=int((a != 0).sum()))

    actions = safs.expand_double_sided()

    # ------------------------------------------------------------------
    # Per-iteration elimination masks per tensor, tagged with the SAF's
    # level: a SAF at level l eliminates the follower's transfers at every
    # level <= l (reads at l, fills at l-1, ... down to compute), but not
    # traffic above it.  Codes: 0=live, 1=gated, 2=skipped.
    # ------------------------------------------------------------------
    saf_masks: dict[str, list[tuple[int, int, np.ndarray]]] = {
        t.name: [] for t in workload.tensors}
    comp_gate = np.zeros(grid.shape[0], dtype=bool)
    comp_skip = np.zeros(grid.shape[0], dtype=bool)

    def elim_codes(tname: str, min_level: int) -> np.ndarray:
        """Per-iteration codes from SAFs at levels >= min_level."""
        out = np.zeros(grid.shape[0], dtype=np.int8)
        for lvl, code, m in saf_masks[tname]:
            if lvl >= min_level:
                np.maximum(out, np.where(m, code, 0).astype(np.int8),
                           out=out)
        return out

    def round_codes(codes: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Per-round code: a round survives if ANY iteration in it is live
        (min over the round's interval)."""
        if len(rows) == 0:
            return np.zeros(0, dtype=np.int8)
        return np.minimum.reduceat(codes, rows)

    def leader_empty_mask(level_idx: int, follower: TensorSpec,
                          leader_name: str) -> np.ndarray:
        leader = workload.tensor(leader_name)
        bounds = leader_tile_bounds(nest, level_idx, follower, leader)
        ext = np.array(leader.tile_dims(bounds), dtype=np.int64).reshape(1, -1)
        # origin contributed by loops OUTSIDE the leader window: temporal
        # loops at levels >= level_idx that are not in the trailing
        # irrelevant suffix — equivalently origin from all temporal loops,
        # snapped down to the window extents.
        orig = _coords(grid, tloops, strides_all, nest, -1, leader)
        orig = (orig // np.maximum(ext, 1)) * np.maximum(ext, 1)
        nnz = ctx[leader_name].integral.nnz(orig, orig + ext)
        return nnz == 0

    for saf in actions:
        if saf.level == "compute":
            # ineffectual if ANY checked operand is zero (Fig. 3)
            m = np.zeros(grid.shape[0], dtype=bool)
            for lname in saf.leaders:
                lv = _gather_values(ctx[lname], grid, tloops, strides_all,
                                    nest)
                m |= (lv == 0)
            if saf.kind == SAFKind.SKIP:
                comp_skip |= m
            else:
                comp_gate |= m
            continue
        lvl = arch_level_names.index(saf.level)
        fspec = workload.tensor(saf.follower)
        # eliminated if ANY leader tile is empty (Z <- A & B semantics)
        m = np.zeros(grid.shape[0], dtype=bool)
        for lname in saf.leaders:
            m |= leader_empty_mask(lvl, fspec, lname)
        code = 2 if saf.kind == SAFKind.SKIP else 1
        saf_masks[saf.follower].append((lvl, code, m))
        # propagation to compute: operand/output not delivered
        if saf.kind == SAFKind.SKIP:
            comp_skip |= m
        else:
            comp_gate |= m

    # ------------------------------------------------------------------
    # Count fine-grained actions per (tensor, level)
    # ------------------------------------------------------------------
    per_level: dict[tuple[str, int], SparseTensorLevel] = {}
    for t in workload.tensors:
        is_out = t.name == workload.output
        c = ctx[t.name]
        for s in range(S):
            fmt = safs.format_for(arch_level_names[s], t.name)
            # ---- fetch rounds into this level (fills) ----
            cols_fill = [i for i, lp in enumerate(tloops)
                         if lp.level > s and lp.rank in t.ranks]
            starts_fill = _run_starts(grid, cols_fill)
            ext_s = _tile_extents(nest, s, t)
            # ---- read rounds serving the child ----
            cols_read = [i for i, lp in enumerate(tloops)
                         if lp.level > s - 1 and lp.rank in t.ranks]
            starts_read = _run_starts(grid, cols_read)
            ext_c = _tile_extents(nest, s - 1, t,
                                  include_spatial_at=s)

            def tile_words(starts: np.ndarray, ext: np.ndarray,
                           level_gt: int) -> tuple[np.ndarray, np.ndarray]:
                rows = np.nonzero(starts)[0]
                orig = _coords(grid[rows], tloops, strides_all, nest,
                               level_gt, t)
                nnz = c.integral.nnz(orig, orig + ext)
                words = nnz if fmt.compressed else \
                    np.full(len(rows), int(np.prod(ext)))
                return rows, words.astype(np.float64)

            rows_f, words_f = tile_words(starts_fill, ext_s, s)
            rows_r, words_r = tile_words(starts_read, ext_c, s - 1)

            # reads OUT of this level: SAFs at levels >= s apply;
            # fills INTO this level: only SAFs strictly above (>= s+1)
            e_f = round_codes(elim_codes(t.name, s + 1), rows_f)
            e_r = round_codes(elim_codes(t.name, s), rows_r)

            inst = nest.instances_of(s)

            def breakdown(words: np.ndarray, e: np.ndarray,
                          scale: float = 1.0) -> ActionBreakdown:
                return ActionBreakdown(
                    actual=float(words[e == 0].sum()) * scale,
                    gated=float(words[e == 1].sum()) * scale,
                    skipped=float(words[e == 2].sum()) * scale)

            meta_per_word = 0.0
            fstats = None
            if fmt.rank_formats and (fmt.compressed or
                                     fmt.rank_formats[0].value in ("B", "UB")):
                tile_dims = tuple(int(x) for x in ext_s[0]) or (1,)
                fstats = analyze_tile_format(
                    fmt, tile_dims, ActualDataModel(c.data))
                # metadata words per *compressed* data word moved — same
                # convention as the analytical model
                meta_per_word = (fstats.metadata_bits_avg
                                 / max(1e-9, fstats.data_words_avg) / 16.0)

            if not is_out:
                fills = breakdown(words_f, e_f) \
                    if s < S - 1 else ActionBreakdown()
                # ext_c already includes the spatially-distinct extent
                reads = breakdown(words_r, e_r)
                updates = ActionBreakdown()
            else:
                # output: updates from below + writebacks upward + RMW +
                # partial-tile refetches when reduction loops evict
                # incomplete tiles
                def evict_stats(level: int, code_level: int
                                ) -> tuple[int, int, np.ndarray, np.ndarray]:
                    cols = [i for i, lp in enumerate(tloops)
                            if lp.level > level and lp.rank in t.ranks]
                    rows = np.nonzero(_run_starts(grid, cols))[0]
                    ids = grid[np.ix_(rows, cols)] if cols else \
                        np.zeros((len(rows), 0), dtype=np.int64)
                    uniq = len(np.unique(ids, axis=0)) if len(rows) else 1
                    codes = round_codes(elim_codes(t.name, code_level), rows)
                    return len(rows), uniq, rows, codes

                if s == 0:
                    # per-MAC updates: governed by the compute elimination
                    fan = math.prod(lp.bound
                                    for lp in nest.spatial_loops_at(0))
                    cc = np.where(comp_skip, 2,
                                  np.where(comp_gate, 1, 0)).astype(np.int8)
                    upd = ActionBreakdown(
                        actual=float((cc == 0).sum()) * fan,
                        gated=float((cc == 1).sum()) * fan,
                        skipped=float((cc == 2).sum()) * fan)
                else:
                    ce, cu, crows, ce_e = evict_stats(s - 1, s - 1)
                    fan = nest.fanout_below(s)
                    w = float(np.prod(_tile_extents(nest, s - 1, t))) * fan
                    upd = ActionBreakdown(
                        actual=float((ce_e == 0).sum()) * w,
                        gated=float((ce_e == 1).sum()) * w,
                        skipped=float((ce_e == 2).sum()) * w)

                ev_n, ev_u, ev_rows, ev_codes = evict_stats(s, s)
                tile_z = float(np.prod(ext_s))
                # writebacks upward: governed by SAFs at levels >= s
                wb = (ActionBreakdown(
                    actual=float((ev_codes == 0).sum()) * tile_z,
                    gated=float((ev_codes == 1).sum()) * tile_z,
                    skipped=float((ev_codes == 2).sum()) * tile_z)
                    if s < S - 1 else ActionBreakdown())
                # local RMW accumulation reads
                if s < S - 1:
                    distinct_words = ev_u * tile_z
                else:
                    distinct_words = t.size(workload.rank_bounds) / max(1, inst)
                rmw = max(0.0, upd.actual - distinct_words)
                # partial re-fetches from the parent (incomplete evictions)
                pf = (max(0, ev_n - ev_u) * tile_z if s < S - 1 else 0.0)
                # parent-side reads redistributing partials downward
                if s > 0:
                    cn, cuq, _, _ = evict_stats(s - 1, s - 1)
                    spatial_rel_z = math.prod(
                        lp.bound for lp in nest.spatial_loops_at(s)
                        if lp.rank in t.ranks)
                    pf_reads = (max(0, cn - cuq)
                                * float(np.prod(_tile_extents(nest, s - 1, t)))
                                * spatial_rel_z)
                else:
                    pf_reads = 0.0
                reads = ActionBreakdown(
                    actual=wb.actual + rmw + pf_reads,
                    gated=wb.gated, skipped=wb.skipped)
                fills = ActionBreakdown(actual=pf)
                updates = upd

            meta_reads = (reads.actual + reads.gated) * meta_per_word \
                if meta_per_word else 0.0
            meta_fills = (fills.actual + fills.gated) * meta_per_word \
                if meta_per_word else 0.0

            per_level[(t.name, s)] = SparseTensorLevel(
                tensor=t.name, level=s, reads=reads, fills=fills,
                updates=updates, metadata_read_words=meta_reads,
                metadata_fill_words=meta_fills,
                occupancy_words_avg=(fstats.footprint_words(16) if fstats
                                     else float(np.prod(ext_s))),
                occupancy_words_max=(fstats.footprint_words(16, worst=True)
                                     if fstats else float(np.prod(ext_s))),
                format_stats=fstats, instances=inst)

    # ------------------------------------------------------------------
    # Intersection-check overhead (mirrors sparse.py): each follower read
    # round at a SAF's level scans the leader's metadata
    # ------------------------------------------------------------------
    for saf in actions:
        if saf.level == "compute":
            continue
        lvl = arch_level_names.index(saf.level)
        fspec = workload.tensor(saf.follower)
        cols = [i for i, lp in enumerate(tloops)
                if lp.level > lvl - 1 and lp.rank in fspec.ranks]
        rounds = int(_run_starts(grid, cols).sum())
        for lname in saf.leaders:
            leader = workload.tensor(lname)
            bounds = leader_tile_bounds(nest, lvl, fspec, leader)
            tile_dims = leader.tile_dims(bounds)
            lfmt = safs.format_for(arch_level_names[lvl], lname)
            lstats = analyze_tile_format(
                lfmt, tile_dims, ActualDataModel(ctx[lname].data))
            bits = lstats.metadata_bits_avg
            if bits <= 0:
                bits = float(lstats.tile_size)
            per_level[(saf.follower, lvl)].metadata_read_words += \
                rounds * bits / 16.0

    # ------------------------------------------------------------------
    # Compute: exact per-MAC effectuality
    # ------------------------------------------------------------------
    spatial_total = math.prod(lp.bound for lp in nest.loops if lp.spatial)
    skipped = float(comp_skip.sum()) * spatial_total
    gated = float((comp_gate & ~comp_skip).sum()) * spatial_total
    dense_total = float(grid.shape[0]) * spatial_total
    actual = dense_total - skipped - gated
    compute = ActionBreakdown(actual=actual, gated=gated, skipped=skipped)

    return SparseTraffic(workload=workload, per_level=per_level,
                         compute=compute, compute_instances=spatial_total,
                         local_elims={})


def _gather_values(c: _TensorCtx, grid: np.ndarray, tloops: list,
                   strides_all: dict, nest: LoopNest) -> np.ndarray:
    """Element value per iteration (spatial loops at their 0 position —
    used for per-MAC effectuality of the temporal slice; spatial instances
    are statistically identical and accounted by the spatial multiplier)."""
    orig = _coords(grid, tloops, strides_all, nest, -1, c.spec)
    if c.data.ndim == 0:
        return np.full(grid.shape[0], c.data)
    idx = tuple(orig[:, d] % c.data.shape[d] for d in range(c.data.ndim))
    return c.data[idx]
