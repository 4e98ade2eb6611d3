"""Step Two: sparse modeling (Sparseloop Sec. 5.3).

Filters the dense traffic from Step One into *sparse traffic*: per-(tensor,
level) fine-grained action breakdowns {actual, gated, skipped} plus
metadata traffic, using

  * the Format Analyzer (Sec. 5.3.3)   — formats.py models per tile,
  * the Gating/Skipping Analyzer (Sec. 5.3.4) — leader-follower
    intersections whose leader-tile granularity comes from the mapping's
    reuse structure (dataflow.leader_tile_bounds, Fig. 10),
  * traffic post-processing (Sec. 5.3.5) — SAF interactions (skipped tiles
    do not move their metadata) and scaling of per-tile breakdowns by the
    number of tiles transferred.

Semantics of propagation (Sec. 3.1.2-3):

  * SKIP at level s removes the eliminated tiles from every level below
    and from compute (implicit skipping) — no cycles, no energy.
  * GATE at level s converts the corresponding accesses below into *gated*
    accesses (implicit gating): the hardware still spends the cycles but
    idles, so gated actions cost gated-energy and still occupy bandwidth.

Elimination probabilities are tracked per *leader tensor*.  Within one
leader, tiles checked at different levels are spatially nested, so the
union of their empty-events is the finest-granularity event (max prob);
across distinct leaders independence is assumed — the paper identifies
exactly this approximation as its dominant error source (Sec. 6.3.2).
"""
from __future__ import annotations

import dataclasses
import math

from .dataflow import DenseTraffic, leader_tile_bounds
from .density import DensityModel, make_density_model
from .formats import TileFormatStats, analyze_tile_format
from .precision import real
from .taxonomy import ActionSAF, SAFKind, SAFSpec
from .workload import Workload


@dataclasses.dataclass
class ActionBreakdown:
    """Fine-grained action counts for one access type (Sec. 5.3.4)."""

    actual: float = 0.0
    gated: float = 0.0
    skipped: float = 0.0

    @property
    def dense(self) -> float:
        return self.actual + self.gated + self.skipped

    @property
    def cycles_spent(self) -> float:
        """Gating stays idle for the cycle; skipping does not spend it."""
        return self.actual + self.gated


@dataclasses.dataclass
class SparseTensorLevel:
    """Sparse traffic of one tensor at one storage level (per instance)."""

    tensor: str
    level: int
    reads: ActionBreakdown
    fills: ActionBreakdown
    updates: ActionBreakdown
    metadata_read_words: float = 0.0
    metadata_fill_words: float = 0.0
    #: expected / worst-case resident footprint incl. metadata, in words
    occupancy_words_avg: float = 0.0
    occupancy_words_max: float = 0.0
    format_stats: TileFormatStats | None = None
    instances: int = 1


@dataclasses.dataclass
class SparseTraffic:
    """Full Step-Two result."""

    workload: Workload
    per_level: dict[tuple[str, int], SparseTensorLevel]
    compute: ActionBreakdown
    compute_instances: int
    #: diagnostics: per (tensor, level) [skip_frac, gate_frac] local SAFs
    local_elims: dict[tuple[str, int], tuple[float, float]]

    def of(self, tensor: str, level: int) -> SparseTensorLevel:
        return self.per_level[(tensor, level)]


# ----------------------------------------------------------------------
def _union(probs_by_leader: dict[str, float]) -> float:
    """P(any leader tile empty), independence across leaders."""
    keep = 1.0
    for p in probs_by_leader.values():
        keep *= (1.0 - p)
    return 1.0 - keep


def _merge_leader(dst: dict[str, float], leader: str, p: float) -> None:
    """Union within one leader = finest granularity event (nested tiles)."""
    dst[leader] = max(dst.get(leader, 0.0), p)


def analyze_sparse(dense: DenseTraffic, safs: SAFSpec,
                   arch_level_names: list[str],
                   models: dict[str, DensityModel] | None = None
                   ) -> SparseTraffic:
    """arch_level_names: storage level names, innermost-first (index-aligned
    with the mapping's level indices)."""
    workload = dense.workload
    S = dense.nest.num_levels
    expanded = safs.expand_double_sided()
    if models is None:
        models = {
            t.name: make_density_model(workload.density_spec(t.name),
                                       t.size(workload.rank_bounds))
            for t in workload.tensors
        }

    # ------------------------------------------------------------------
    # Gating/Skipping Analyzer: per-(follower, level) elimination events,
    # probabilities keyed by leader tensor.
    # ------------------------------------------------------------------
    skip_ev: dict[tuple[str, int], dict[str, float]] = {}
    gate_ev: dict[tuple[str, int], dict[str, float]] = {}
    # compute-level events, keyed by leader tensor
    comp_skip_ev: dict[str, float] = {}
    comp_gate_ev: dict[str, float] = {}

    def leader_prob(saf: ActionSAF, level_idx: int, lname: str) -> float:
        follower = workload.tensor(saf.follower)
        leader = workload.tensor(lname)
        bounds = leader_tile_bounds(dense.nest, level_idx, follower, leader)
        tile = max(1, leader.tile_size(bounds))
        return models[lname].prob_empty(tile)

    for saf in expanded:
        if saf.level == "compute":
            for lname in saf.leaders:
                p = 1.0 - models[lname].expected_density(1)
                dst = comp_skip_ev if saf.kind == SAFKind.SKIP else comp_gate_ev
                _merge_leader(dst, lname, p)
            continue
        lvl = arch_level_names.index(saf.level)
        key = (saf.follower, lvl)
        for lname in saf.leaders:
            p = leader_prob(saf, lvl, lname)
            dst = skip_ev if saf.kind == SAFKind.SKIP else gate_ev
            dst.setdefault(key, {})
            _merge_leader(dst[key], lname, p)

    local: dict[tuple[str, int], tuple[float, float]] = {}
    for t in workload.tensors:
        for s in range(S):
            sk = _union(skip_ev.get((t.name, s), {}))
            gt = max(0.0, _union({**gate_ev.get((t.name, s), {}),
                                  **skip_ev.get((t.name, s), {})}) - sk)
            local[(t.name, s)] = (sk, gt)

    # Output writebacks/evictions move whole tiles: a level-s eviction of
    # the output is eliminated only when its *entire* tile is ineffectual.
    # Re-evaluate the same SAF events with the leader window of the whole
    # level-s residency (loops <= s), i.e. leader_tile_bounds at s+1.
    zname = workload.output
    zspec = workload.output_tensor
    z_round: dict[int, tuple[float, float]] = {}
    for s in range(S):
        r_skip: dict[str, float] = {}
        r_gate: dict[str, float] = {}
        for saf in expanded:
            if saf.follower != zname or saf.level == "compute":
                continue
            for lname in saf.leaders:
                leader = workload.tensor(lname)
                bounds = leader_tile_bounds(dense.nest, s + 1, zspec, leader)
                tile = max(1, leader.tile_size(bounds))
                p = models[lname].prob_empty(tile)
                dst = r_skip if saf.kind == SAFKind.SKIP else r_gate
                _merge_leader(dst, lname, p)
        sk = _union(r_skip)
        gt = max(0.0, _union({**r_gate, **r_skip}) - sk)
        z_round[s] = (sk, gt)

    # ------------------------------------------------------------------
    # Propagation down the hierarchy: arriving-live / arriving-gated /
    # arriving-skipped fractions per (tensor, level).
    # ------------------------------------------------------------------
    # chain_* [t][s]: fractions of the dense traffic at level s
    live_frac: dict[tuple[str, int], float] = {}
    gated_from_above: dict[tuple[str, int], float] = {}
    for t in workload.tensors:
        not_skipped, live = 1.0, 1.0
        for s in range(S - 1, -1, -1):
            live_frac[(t.name, s)] = live
            gated_from_above[(t.name, s)] = not_skipped - live
            sk, gt = local[(t.name, s)]
            not_skipped *= (1.0 - sk)
            live *= max(0.0, 1.0 - sk - gt)
        # remember the fraction reaching compute
        live_frac[(t.name, -1)] = live
        gated_from_above[(t.name, -1)] = not_skipped - live

    # compute-level elimination fractions are needed for output updates
    # at the innermost level; compute them first (same math as below).
    impl_skip0: dict[str, float] = {}
    impl_gate0: dict[str, float] = {}
    for t in workload.tensors:
        for s in range(S):
            for lname, p in skip_ev.get((t.name, s), {}).items():
                _merge_leader(impl_skip0, lname, p)
            for lname, p in gate_ev.get((t.name, s), {}).items():
                _merge_leader(impl_gate0, lname, p)
    for lname, p in comp_skip_ev.items():
        _merge_leader(impl_skip0, lname, p)
    for lname, p in comp_gate_ev.items():
        _merge_leader(impl_gate0, lname, p)
    c_skip = _union(impl_skip0)
    c_gate = max(0.0, _union({**impl_gate0, **impl_skip0}) - c_skip)
    c_act = max(0.0, 1.0 - c_skip - c_gate)

    # ------------------------------------------------------------------
    # Format Analyzer + per-level assembly
    # ------------------------------------------------------------------
    per_level: dict[tuple[str, int], SparseTensorLevel] = {}
    for t in workload.tensors:
        model = models[t.name]
        is_out = t.name == workload.output
        for s in range(S):
            tl = dense.of(t.name, s)
            fmt = safs.format_for(arch_level_names[s], t.name)
            fstats = analyze_tile_format(fmt, tl.tile_dims, model)

            # fractions for transfers OUT of this level (reads serving the
            # child): chain from above + local SAF at this level
            live = live_frac[(t.name, s)]
            g_above = gated_from_above[(t.name, s)]
            sk, gt = local[(t.name, s)]
            act_f = live * max(0.0, 1.0 - sk - gt)
            gate_f = live * gt + g_above
            skip_f = max(0.0, 1.0 - act_f - gate_f)
            # fractions for transfers INTO this level (fills from parent):
            # governed by SAFs strictly above (incl. local at parent level)
            a_act = live
            a_gate = g_above
            a_skip = max(0.0, 1.0 - a_act - a_gate)

            # compression shrinks the words actually moved per access
            density_scale = (fstats.data_words_avg / max(1, fstats.tile_size)
                             if fmt.compressed else 1.0)

            def bd(dense_words: float, fr=None) -> ActionBreakdown:
                fa, fg, fs = fr if fr else (act_f, gate_f, skip_f)
                moved = dense_words * density_scale
                return ActionBreakdown(actual=moved * fa, gated=moved * fg,
                                       skipped=moved * fs)

            if is_out:
                # updates arriving from below: child-side elimination — per
                # MAC at s == 0, per child-tile eviction above
                if s == 0:
                    upd_fr = (c_act, c_gate, c_skip)
                else:
                    live_c = live_frac[(t.name, s - 1)]
                    g_c = gated_from_above[(t.name, s - 1)]
                    sk_c, gt_c = z_round[s - 1]
                    ac = live_c * max(0.0, 1.0 - sk_c - gt_c)
                    gc = live_c * gt_c + g_c
                    upd_fr = (ac, gc, max(0.0, 1.0 - ac - gc))
                updates = bd(tl.update_words, upd_fr)
                # read-modify-write accumulation: nonlinear in the update
                # survival — recomputed from the scaled updates
                distinct_words = tl.update_words - tl.rmw_read_words
                rmw = max(0.0, updates.actual - distinct_words)
                # writebacks/partial refetches move whole tiles: use the
                # round-granularity elimination fractions
                sk_r, gt_r = z_round[s]
                wa = live * max(0.0, 1.0 - sk_r - gt_r)
                wg = live * gt_r + g_above
                wb_fr = (wa, wg, max(0.0, 1.0 - wa - wg))
                wb = bd(tl.writeback_words, wb_fr)
                pf = bd(tl.partial_fill_words, wb_fr)
                reads = ActionBreakdown(actual=wb.actual + rmw,
                                        gated=wb.gated, skipped=wb.skipped)
                fills = pf
            else:
                reads = bd(tl.read_words)
                fills = bd(tl.fill_words, (a_act, a_gate, a_skip))
                updates = ActionBreakdown()

            # metadata moves with actual AND gated accesses (the check that
            # decides to gate reads the metadata); skipped tiles move none.
            # Convention: metadata words per *compressed* data word moved.
            has_meta = fstats.metadata_bits_avg > 0
            meta_per_word = (fstats.metadata_bits_avg
                             / max(1e-9, fstats.data_words_avg) / 16.0)
            meta_reads = ((reads.actual + reads.gated) * meta_per_word
                          if has_meta else 0.0)
            meta_fills = (((fills.actual + fills.gated
                            + updates.actual + updates.gated))
                          * meta_per_word if has_meta else 0.0)

            per_level[(t.name, s)] = SparseTensorLevel(
                tensor=t.name, level=s, reads=reads, fills=fills,
                updates=updates,
                metadata_read_words=meta_reads,
                metadata_fill_words=meta_fills,
                occupancy_words_avg=fstats.footprint_words(16),
                occupancy_words_max=fstats.footprint_words(16, worst=True),
                format_stats=fstats, instances=tl.instances)

    # ------------------------------------------------------------------
    # Intersection-check overhead (Sec. 3.1.3: "inefficient
    # implementations can lead to more overhead than savings"): every
    # follower access round at a SAF's level reads the LEADER's metadata
    # (or a bitmask generated from uncompressed data) to decide —
    # regardless of the outcome.  Charged as metadata reads on the
    # follower's level.
    # ------------------------------------------------------------------
    for saf in expanded:
        if saf.level == "compute":
            continue
        lvl = arch_level_names.index(saf.level)
        follower = workload.tensor(saf.follower)
        tl = dense.of(saf.follower, lvl)
        rounds = tl.read_rounds
        for lname in saf.leaders:
            leader = workload.tensor(lname)
            bounds = leader_tile_bounds(dense.nest, lvl, follower, leader)
            tile_dims = leader.tile_dims(bounds)
            lfmt = safs.format_for(arch_level_names[lvl], lname)
            lstats = analyze_tile_format(lfmt, tile_dims, models[lname])
            bits = lstats.metadata_bits_avg
            if bits <= 0:   # uncompressed leader: scan a 1-bit mask
                bits = real(lstats.tile_size)
            per_level[(saf.follower, lvl)].metadata_read_words += \
                rounds * bits / 16.0

    # ------------------------------------------------------------------
    # Compute breakdown: implicit (from operand/output delivery SAFs at any
    # level) + explicit compute SAFs — fractions computed above.
    # ------------------------------------------------------------------
    dense_macs = dense.dense_computes
    compute = ActionBreakdown(actual=dense_macs * c_act,
                              gated=dense_macs * c_gate,
                              skipped=dense_macs * c_skip)

    return SparseTraffic(workload=workload, per_level=per_level,
                         compute=compute,
                         compute_instances=dense.compute_instances,
                         local_elims=local)
