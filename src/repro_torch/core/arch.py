"""Architecture specification (Sparseloop Sec. 5.1, Fig. 6 'Architecture').

An architecture is a linear hierarchy of storage levels (outermost, e.g.
DRAM, to innermost, e.g. register file) plus a set of compute units.  Each
storage level has a capacity, word width, access bandwidth and per-action
energy numbers (Accelergy-style, Sec. 5.4).

Levels are indexed the way the analyzers use them: 0 = innermost.

Architecture-as-data
--------------------
The batched engine (core.batched) splits an architecture the same way it
splits a workload: the *topology* (:func:`arch_structure` — level names,
which the SAF specs reference, plus the compute-unit name) is the static
part a compiled program is keyed on, while every per-level scalar
(capacities, bandwidths, per-action energies, PE counts) packs into a
fixed-shape traced :class:`ArchParams` bound at evaluation time — so a
whole design sweep shares one compiled program per bucket, and a
co-search population can carry one design point per candidate.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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


# ----------------------------------------------------------------------
# Architecture-as-data: the traced scalar inputs of a compiled program
# ----------------------------------------------------------------------
#: ``ArchParams.storage`` column order (per level, innermost-first rows)
STORAGE_FIELDS = ("capacity_words", "bandwidth_words_per_cycle",
                  "read_energy_pj", "write_energy_pj", "gated_energy_pj",
                  "metadata_read_energy_pj")
#: ``ArchParams.compute`` entry order
COMPUTE_FIELDS = ("instances", "mac_energy_pj", "gated_energy_pj",
                  "throughput")


def arch_structure(arch: Architecture) -> tuple:
    """The *static* part of an architecture — the level-name topology
    (SAF specs resolve levels by name, so names shape the trace) and the
    compute-unit name.  Every scalar (capacity, bandwidth, energies, PE
    count) is traced :class:`ArchParams` data, so two designs with equal
    structure share compiled programs whatever their provisioning."""
    return (tuple(lv.name for lv in arch.levels), arch.compute.name)


def topology_key(arch: Architecture, safs=None) -> tuple:
    """The canonical *topology key* of a design: everything that shapes
    a compiled program's trace and nothing that doesn't.

    Without ``safs`` this is exactly :func:`arch_structure` — level
    names (outermost-first) plus the compute-unit name.  With a
    ``SAFSpec`` it extends to the *SAF placement*: which (level, tensor)
    pairs carry compressed formats and which gate/skip actions are
    attached.  Two ``Design``s with equal topology keys share compiled
    programs whatever their scalar provisioning; two designs with
    different keys (one more level, a SAF moved one level up) need
    distinct programs.  Heterogeneous-topology populations are grouped
    by this key the way bucketed dispatch groups by ``TemplateBucket``:
    O(topology groups) programs, not O(population).
    """
    key = arch_structure(arch)
    if safs is None:
        return key
    # formats: dict keyed by unique (level_name, tensor) str pairs ->
    # sorting the items is total and never compares the format values
    fmts = tuple(sorted((k, v) for k, v in safs.formats.items()))
    return key + (fmts, tuple(safs.actions))


@dataclasses.dataclass(frozen=True)
class ArchParams:
    """Traced architecture inputs of one compiled program — the design
    counterpart of ``batched.WorkloadParams``.

    ``storage`` holds one row per storage level (INNERMOST-first, the
    analyzers' indexing) with the :data:`STORAGE_FIELDS` columns;
    ``compute`` is the :data:`COMPUTE_FIELDS` vector.  Both may carry a
    leading candidate axis (``batched`` — see :meth:`stack`), in which
    case candidate ``i`` of a population evaluates under design ``i``:
    a mixed-design co-search population rides one compiled program.
    ``structure`` records the :func:`arch_structure` the rows were
    packed for, so binding them to a topologically different program is
    a loud error."""

    storage: np.ndarray
    compute: np.ndarray
    structure: tuple = ()

    @property
    def batched(self) -> bool:
        """True when a leading per-candidate axis is present."""
        return self.storage.ndim == 3

    @property
    def num_levels(self) -> int:
        return self.storage.shape[-2]

    def leaves(self) -> tuple:
        """The pytree handed to the jitted program."""
        return (self.storage, self.compute)

    @staticmethod
    def from_numpy(storage, compute, structure: tuple = (),
                   device=None) -> "ArchParams":
        """ArchParams whose rows are float64 tensors on ``device`` (the
        CUDA card unless ``device="cpu"``): numpy rows packed elsewhere,
        e.g. by the JAX package's ``pack_arch_params``, carried across
        unchanged.  ``storage`` is (S, F) or (C, S, F), ``compute`` (4,)
        or (C, 4)."""
        import torch

        from .device import resolve_device
        dev = resolve_device(device)
        return ArchParams(
            storage=torch.as_tensor(np.asarray(storage, np.float64),
                                    device=dev),
            compute=torch.as_tensor(np.asarray(compute, np.float64),
                                    device=dev),
            structure=tuple(structure))

    def take(self, idx) -> "ArchParams":
        """Candidate-axis gather of a batched params object."""
        if not self.batched:
            raise ValueError("take() needs batched (per-candidate) "
                             "arch params; see ArchParams.stack")
        return ArchParams(storage=self.storage[idx],
                          compute=self.compute[idx],
                          structure=self.structure)

    @staticmethod
    def stack(params: "list[ArchParams]") -> "ArchParams":
        """Stack per-design params into one batched (per-candidate)
        object; all inputs must share the same topology."""
        if not params:
            raise ValueError("cannot stack zero ArchParams")
        structure = params[0].structure
        for p in params:
            if p.batched:
                raise ValueError("stack() takes unbatched ArchParams")
            if p.structure != structure:
                raise ValueError(
                    f"cannot stack arch params of different topologies: "
                    f"{p.structure} != {structure}")
        return ArchParams(
            storage=np.stack([p.storage for p in params]),
            compute=np.stack([p.compute for p in params]),
            structure=structure)


def pack_arch_params(arch: Architecture) -> ArchParams:
    """Lower a concrete architecture to the traced scalar arrays of its
    compiled programs (rows innermost-first, matching ``arch.level``)."""
    storage = np.asarray(
        [[float(getattr(arch.level(s), f)) for f in STORAGE_FIELDS]
         for s in range(arch.num_levels)], np.float64)
    compute = np.asarray(
        [float(getattr(arch.compute, f)) for f in COMPUTE_FIELDS],
        np.float64)
    return ArchParams(storage=storage, compute=compute,
                      structure=arch_structure(arch))
