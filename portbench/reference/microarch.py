"""Step Three: micro-architectural modeling (Sparseloop Sec. 5.4).

Validates the mapping against storage capacities (using worst-case tile
footprints incl. metadata), then turns the sparse traffic into processing
speed and energy:

  * cycles are spent for *actual* and *gated* accesses/computes; skipped
    ones spend none.  Each level is throttled by its bandwidth; the design
    runs at the pace of its slowest level (bandwidth throttling).
  * energy combines each fine-grained action count with its per-action
    cost (Accelergy-style energy tables attached to the Architecture).
"""
from __future__ import annotations

import dataclasses
import math

from .arch import Architecture
from .sparse import SparseTraffic


@dataclasses.dataclass
class LevelResult:
    name: str
    read_actual: float
    read_gated: float
    write_actual: float
    write_gated: float
    metadata_words: float
    cycles: float
    energy_pj: float
    occupancy_words_max: float
    capacity_words: float
    instances: int

    @property
    def utilization(self) -> float:
        if math.isinf(self.capacity_words):
            return 0.0
        return self.occupancy_words_max / self.capacity_words


@dataclasses.dataclass
class EvalResult:
    """Final output of a Sparseloop evaluation."""

    valid: bool
    invalid_reason: str = ""
    cycles: float = 0.0
    energy_pj: float = 0.0
    compute_actual: float = 0.0
    compute_gated: float = 0.0
    compute_skipped: float = 0.0
    compute_cycles: float = 0.0
    levels: tuple[LevelResult, ...] = ()
    bottleneck: str = ""

    @property
    def edp(self) -> float:
        """Energy-delay product (Fig. 17 metric)."""
        return self.energy_pj * self.cycles

    @property
    def energy_uj(self) -> float:
        return self.energy_pj * 1e-6

    def describe(self) -> str:
        if not self.valid:
            return f"INVALID mapping: {self.invalid_reason}"
        lines = [f"cycles={self.cycles:.4g}  energy={self.energy_uj:.4g}uJ"
                 f"  EDP={self.edp:.4g}  bottleneck={self.bottleneck}"]
        lines.append(
            f"  compute: actual={self.compute_actual:.4g} "
            f"gated={self.compute_gated:.4g} "
            f"skipped={self.compute_skipped:.4g}")
        for lv in self.levels:
            lines.append(
                f"  {lv.name:>16}: rd={lv.read_actual:.4g} "
                f"wr={lv.write_actual:.4g} meta={lv.metadata_words:.4g} "
                f"cyc={lv.cycles:.4g} E={lv.energy_pj * 1e-6:.4g}uJ "
                f"occ={lv.occupancy_words_max:.0f}/{lv.capacity_words:.0f}")
        return "\n".join(lines)


def evaluate_microarch(arch: Architecture, traffic: SparseTraffic,
                       check_capacity: bool = True) -> EvalResult:
    S = arch.num_levels
    workload = traffic.workload

    # ---- mapping validity: worst-case footprints must fit (Sec. 5.4) ----
    if check_capacity:
        for s in range(S):
            lvl = arch.level(s)
            if math.isinf(lvl.capacity_words):
                continue
            occ = sum(traffic.of(t.name, s).occupancy_words_max
                      for t in workload.tensors)
            if occ > lvl.capacity_words:
                return EvalResult(
                    valid=False,
                    invalid_reason=(f"level {lvl.name}: worst-case tile "
                                    f"footprint {occ:.0f} words exceeds "
                                    f"capacity {lvl.capacity_words:.0f}"))

    # ---- per-level cycles & energy ----
    levels: list[LevelResult] = []
    total_energy = 0.0
    worst_cycles, bottleneck = 0.0, "compute"

    for s in range(S):
        lvl = arch.level(s)
        ra = rg = wa = wg = meta = 0.0
        occ_max = 0.0
        inst = 1
        for t in workload.tensors:
            st = traffic.of(t.name, s)
            inst = max(inst, st.instances)
            ra += st.reads.actual
            rg += st.reads.gated
            wa += st.fills.actual + st.updates.actual
            wg += st.fills.gated + st.updates.gated
            meta += st.metadata_read_words + st.metadata_fill_words
            occ_max += st.occupancy_words_max
        # traffic fields are per instance; energy is machine-wide
        e = inst * (ra * lvl.read_energy_pj + wa * lvl.write_energy_pj
                    + (rg + wg) * lvl.gated_energy_pj
                    + meta * lvl.metadata_read_energy_pj)
        total_energy += e
        # bandwidth throttling: actual+gated words (and metadata) per cycle
        words = ra + rg + wa + wg + meta
        cyc = words / lvl.bandwidth_words_per_cycle
        levels.append(LevelResult(
            name=lvl.name, read_actual=ra, read_gated=rg, write_actual=wa,
            write_gated=wg, metadata_words=meta, cycles=cyc, energy_pj=e,
            occupancy_words_max=occ_max, capacity_words=lvl.capacity_words,
            instances=inst))
        if cyc > worst_cycles:
            worst_cycles, bottleneck = cyc, lvl.name

    # ---- compute ----
    comp = traffic.compute
    pe = arch.compute
    n_inst = max(1, min(traffic.compute_instances, pe.instances))
    compute_cycles = (comp.actual + comp.gated) / (n_inst * pe.throughput)
    total_energy += (comp.actual * pe.mac_energy_pj
                     + comp.gated * pe.gated_energy_pj)
    if compute_cycles > worst_cycles:
        worst_cycles, bottleneck = compute_cycles, "compute"

    return EvalResult(
        valid=True, cycles=worst_cycles, energy_pj=total_energy,
        compute_actual=comp.actual, compute_gated=comp.gated,
        compute_skipped=comp.skipped, compute_cycles=compute_cycles,
        levels=tuple(levels), bottleneck=bottleneck)
