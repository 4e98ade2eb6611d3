"""Architecture specification (Sparseloop Sec. 5.1, Fig. 6 'Architecture').

An architecture is a linear hierarchy of storage levels (outermost, e.g.
DRAM, to innermost, e.g. register file) plus a set of compute units.  Each
storage level has a capacity, word width, access bandwidth and per-action
energy numbers (Accelergy-style, Sec. 5.4).

Levels are indexed the way the analyzers use them: 0 = innermost.

"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StorageLevel:
    name: str
    #: capacity in data words (inf for DRAM)
    capacity_words: float
    #: sustained words per cycle into/out of the level
    bandwidth_words_per_cycle: float
    #: energy per word read/write, pJ (Accelergy-style action cost)
    read_energy_pj: float
    write_energy_pj: float = -1.0
    #: energy of a *gated* access (clock/power-gated idle), pJ
    gated_energy_pj: float = 0.0
    #: per-word energy of metadata accesses (usually narrower words)
    metadata_read_energy_pj: float = -1.0
    #: bits per data word (used for compression-rate accounting)
    word_bits: int = 16

    def __post_init__(self):
        if self.write_energy_pj < 0:
            object.__setattr__(self, "write_energy_pj", self.read_energy_pj)
        if self.metadata_read_energy_pj < 0:
            object.__setattr__(self, "metadata_read_energy_pj",
                               0.25 * self.read_energy_pj)

    def canonical(self) -> tuple:
        """Post-``__post_init__`` field tuple — this level's cache-key
        identity.  The ``-1.0`` construction sentinels (write/metadata
        energies derived from the read energy) are resolved by the time
        this runs, so two levels that differ only at construction alias
        and any *real* field difference never does."""
        return tuple(getattr(self, f.name)
                     for f in dataclasses.fields(self))


@dataclasses.dataclass(frozen=True)
class ComputeLevel:
    name: str = "MAC"
    #: spatial compute instances
    instances: int = 1
    #: energy per effectual MAC, pJ
    mac_energy_pj: float = 1.0
    #: energy per gated (idle) MAC cycle, pJ
    gated_energy_pj: float = 0.05
    #: MACs per instance per cycle
    throughput: float = 1.0

    def canonical(self) -> tuple:
        """Field tuple — this compute unit's cache-key identity."""
        return tuple(getattr(self, f.name)
                     for f in dataclasses.fields(self))


@dataclasses.dataclass(frozen=True)
class Architecture:
    """Storage hierarchy listed OUTERMOST FIRST (DRAM ... RF) + compute."""

    name: str
    levels: tuple[StorageLevel, ...]
    compute: ComputeLevel = ComputeLevel()

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def level(self, idx_from_inner: int) -> StorageLevel:
        """Level by innermost-first index (0 = closest to compute)."""
        return self.levels[self.num_levels - 1 - idx_from_inner]

    def level_index(self, name: str) -> int:
        """Innermost-first index of a level by name."""
        for i in range(self.num_levels):
            if self.level(i).name == name:
                return i
        raise KeyError(name)

    def canonical(self) -> tuple:
        """Canonical post-init field tuples of the whole hierarchy —
        what content caches key on instead of the dataclass instances,
        so derived-default sentinels can never alias two distinct archs
        or split two equal ones."""
        return (self.name, tuple(lv.canonical() for lv in self.levels),
                self.compute.canonical())
