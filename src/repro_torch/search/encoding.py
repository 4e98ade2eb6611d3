"""Genome encoding for stochastic mapspace search.

A mapping candidate is flattened into an integer *genome* with two gene
families:

  * **factor genes** — one gene per prime-factor copy of each rank's
    (spatial-residual) bound, valued in ``[0, num_levels)``: the storage
    level that prime is assigned to.  The bound of rank ``r`` at level
    ``l`` is the product of r's primes assigned to l, so *every* genome
    decodes to a valid divisor split by construction — "repair" is just
    folding out-of-range genes back into range (mod), never a projection
    onto a divisor lattice.
  * **permutation genes** — one gene per level whose loop order is not
    pinned by :class:`MapspaceConstraints.permutations`, valued in
    ``[0, R!)``: an index into the lexicographic permutations of the rank
    list, fixing the temporal loop order within that level.

Spatial loops are taken verbatim from the constraints (they describe the
hardware fanout, not a search dimension), exactly as the enumerating
mapper does.

  * **design genes** (:class:`CoSearchEncoding` only) — one gene per
    :class:`DesignSpace` knob (a per-storage-level capacity / bandwidth
    step list), valued as an index into that knob's steps.  The genome
    then describes a joint (design, mapping) point — Fig. 17 co-design
    as a search dimension — and the design decodes to per-candidate
    :class:`~repro_torch.core.arch.ArchParams` rows, so a mixed-design
    population still evaluates through ONE bucket program.

Decoding has two forms.  ``decode_population`` produces
``(NestTemplate, bounds-row)`` pairs: genomes sharing permutation genes
share a template.  ``decode_bucketed`` — the fast path — emits
*bucket-relative* candidates instead: every genome of the encoding lives
in ONE :class:`core.batched.TemplateBucket` (each level slotted with all
ranks; unit bounds = absent loops, mirroring ``mapper._full_template``),
and the permutation genes decode to per-candidate ``rank_ids`` *data*
rather than per-template structure — so a whole free-permutation
population evaluates through a single ``BucketedModel`` program
instead of one program per loop order.

Every random draw takes an explicit ``torch.Generator`` (or an int
seed, which seeds a fresh one): the genomes live on the host as numpy,
so the generator is a CPU one whatever device evaluates them.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Mapping

import numpy as np
import torch

from ..core.arch import (COMPUTE_FIELDS, Architecture, ArchParams,
                         ComputeLevel, StorageLevel, pack_arch_params,
                         topology_key)
from ..core.batched import NestTemplate, TemplateBucket
from ..core.engine import Design
from ..core.mapper import (MapspaceConstraints, constrained_order,
                           spatial_residual)
from ..core.mapping import LoopNest
from ..core.taxonomy import ActionSAF, SAFKind, SAFSpec, TensorFormat
from ..core.workload import Workload


def generator(key) -> torch.Generator:
    """``key`` as a CPU ``torch.Generator``: an int seeds a fresh one, a
    generator is used (and advanced) as it is."""
    if isinstance(key, torch.Generator):
        return key
    if isinstance(key, (int, np.integer)):
        return torch.Generator().manual_seed(int(key))
    raise TypeError(f"key must be an int seed or a torch.Generator, "
                    f"got {type(key).__name__}")


def randint(key, shape, high) -> np.ndarray:
    """Uniform integers in ``[0, high)`` of ``shape`` (int64 numpy);
    ``high`` broadcasts against ``shape``, so each gene draws within its
    own cardinality."""
    high = np.broadcast_to(np.asarray(high, np.int64), shape)
    u = torch.rand(tuple(shape), generator=generator(key),
                   dtype=torch.float64).numpy()
    return np.minimum(np.floor(u * high).astype(np.int64), high - 1)


def prime_factors(n: int) -> list[int]:
    """Prime factorization with multiplicity, largest primes first (so
    single-gene mutations move the coarsest factors most often)."""
    out: list[int] = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return sorted(out, reverse=True)


class MapspaceEncoding:
    """Flat-genome view of one (workload, num_levels, constraints)
    mapspace slice."""

    def __init__(self, workload: Workload, num_levels: int,
                 cons: MapspaceConstraints | None = None):
        cons = cons or MapspaceConstraints()
        self.workload = workload
        self.num_levels = num_levels
        self.cons = cons
        self.ranks: list[str] = list(workload.rank_bounds)

        self.residual = spatial_residual(workload, cons.spatial)

        # factor genes: contiguous block of primes per rank
        self._gene_prime: list[int] = []
        self._rank_block: dict[str, slice] = {}
        for r in self.ranks:
            primes = prime_factors(self.residual[r])
            self._rank_block[r] = slice(len(self._gene_prime),
                                        len(self._gene_prime) + len(primes))
            self._gene_prime.extend(primes)
        self.num_factor_genes = len(self._gene_prime)

        # permutation genes: levels whose order is not pinned
        self.fixed_order: dict[int, tuple[str, ...]] = {}
        if cons.permutations:
            for lvl, order in cons.permutations.items():
                self.fixed_order[lvl] = constrained_order(self.ranks,
                                                          order)
        self.perm_levels = [lvl for lvl in range(num_levels)
                            if lvl not in self.fixed_order]
        self.perms: list[tuple[int, ...]] = list(
            itertools.permutations(range(len(self.ranks))))
        self.genome_size = self.num_factor_genes + len(self.perm_levels)

        #: per-gene cardinality (factor genes: levels; perm genes: R!)
        self.cardinality = np.asarray(
            [num_levels] * self.num_factor_genes
            + [len(self.perms)] * len(self.perm_levels), np.int64)
        #: per-gene crossover block id — factor-swap crossover exchanges
        #: whole rank blocks (and whole permutation genes) between parents
        self.gene_block = np.asarray(
            [i for i, r in enumerate(self.ranks)
             for _ in range(self._rank_block[r].stop
                            - self._rank_block[r].start)]
            + [len(self.ranks) + i for i in range(len(self.perm_levels))],
            np.int64)
        self.num_blocks = len(self.ranks) + len(self.perm_levels)

    # ------------------------------------------------------------------
    def repair(self, genomes: np.ndarray) -> np.ndarray:
        """Fold every gene into its valid range.  Because factor genes are
        level *assignments* of primes, any in-range genome is a valid
        divisor split — repair never has to reproject."""
        g = np.asarray(genomes, np.int64)
        return np.mod(g, self.cardinality)

    def random_population(self, key, n: int) -> np.ndarray:
        """(n, genome_size) uniform population drawn from ``key`` (a
        ``torch.Generator`` or an int seed)."""
        if self.genome_size == 0:
            return np.zeros((n, 0), np.int64)
        return randint(key, (n, self.genome_size), self.cardinality)

    def structured_population(self, key, n: int) -> np.ndarray:
        """Block-structured genomes: each rank's primes split between at
        most two levels at a random cut — the shape real tilings take
        (one large block per level).  Uniform per-prime assignment almost
        never produces such corners, so adaptive strategies seed their
        initial population from here (plus uniform genomes for
        diversity); see ``strategies.init_population``."""
        gen = generator(key)
        out = np.zeros((n, self.genome_size), np.int64)
        if self.genome_size == 0:
            return out
        for r in self.ranks:
            blk = self._rank_block[r]
            g = blk.stop - blk.start
            if g == 0:
                continue
            la = randint(gen, (n,), self.num_levels)
            lb = randint(gen, (n,), self.num_levels)
            cut = randint(gen, (n,), g + 1)
            cols = np.arange(g)
            out[:, blk] = np.where(cols[None, :] < cut[:, None],
                                   la[:, None], lb[:, None])
        if self.perm_levels:
            # explicit end index: subclasses may append further gene
            # families (e.g. the CoSearchEncoding design segment)
            out[:, self.num_factor_genes:
                self.num_factor_genes + len(self.perm_levels)] = \
                randint(gen, (n, len(self.perm_levels)), len(self.perms))
        return out

    # ------------------------------------------------------------------
    def _level_order(self, lvl: int, perm_genes: np.ndarray) -> tuple:
        if lvl in self.fixed_order:
            return self.fixed_order[lvl]
        g = int(perm_genes[self.perm_levels.index(lvl)])
        return tuple(self.ranks[i] for i in self.perms[g])

    def template_of(self, genome: np.ndarray) -> NestTemplate:
        """The loop structure this genome instantiates (bounds stripped;
        shared by all genomes with equal permutation genes)."""
        perm_genes = np.asarray(genome, np.int64)[self.num_factor_genes:]
        spatial = self.cons.spatial or {}
        slots: list[tuple[str, int, bool]] = []
        for lvl in range(self.num_levels - 1, -1, -1):
            slots += [(r, lvl, False)
                      for r in self._level_order(lvl, perm_genes)]
            slots += [(r, lvl, True)
                      for r, b in spatial.get(lvl, {}).items() if b > 1]
        return NestTemplate(slots=tuple(slots), num_levels=self.num_levels)

    def bounds_of(self, genomes: np.ndarray,
                  template: NestTemplate) -> np.ndarray:
        """(k, num_slots) per-slot bound matrix for genomes that share
        ``template`` (vectorized prime-product decode)."""
        g = np.atleast_2d(np.asarray(genomes, np.int64))
        spatial = self.cons.spatial or {}
        bounds = np.ones((len(g), template.num_slots), np.int64)
        for j, (r, lvl, sp) in enumerate(template.slots):
            if sp:
                bounds[:, j] = spatial.get(lvl, {}).get(r, 1)
                continue
            blk = self._rank_block[r]
            if blk.stop == blk.start:
                continue                      # unit-bound rank: stays 1
            primes = np.asarray(self._gene_prime[blk], np.int64)
            assigned = g[:, blk] == lvl
            bounds[:, j] = np.prod(np.where(assigned, primes, 1), axis=1)
        return bounds

    def decode_population(self, genomes: np.ndarray
                          ) -> list[tuple[NestTemplate, np.ndarray,
                                          np.ndarray]]:
        """Group a (n, G) population by template: list of
        ``(template, original-indices, bounds)`` triples."""
        g = self.repair(genomes)
        # slice ONLY the permutation genes: trailing gene families
        # (the CoSearchEncoding design segment) must not fragment the
        # template groups — the loop structure doesn't depend on them
        perm = g[:, self.num_factor_genes:
                 self.num_factor_genes + len(self.perm_levels)]
        groups: dict[tuple, list[int]] = {}
        for i, row in enumerate(perm):
            groups.setdefault(tuple(row.tolist()), []).append(i)
        out = []
        for _, idxs in sorted(groups.items()):
            idx = np.asarray(idxs, np.int64)
            template = self.template_of(g[idx[0]])
            out.append((template, idx, self.bounds_of(g[idx], template)))
        return out

    # ------------------------------------------------------------------
    @functools.cached_property
    def bucket(self) -> TemplateBucket:
        """The single padded bucket every genome of this encoding lowers
        into: each level carries all ranks as temporal slots (absent
        loops ride as unit bounds) plus the constraint-fixed spatial
        slots.  The whole mapspace slice — every permutation — evaluates
        through one ``BucketedModel`` program; and because the
        bucket depends only on rank *names* and the spatial shape (the
        bounds are per-candidate data, the rank bounds and density
        parameters traced ``WorkloadParams``), encodings of different
        network layers emit the same bucket and share that program."""
        spatial = self.cons.spatial or {}
        n_spatial = tuple(
            sum(1 for b in spatial.get(lvl, {}).values() if b > 1)
            for lvl in range(self.num_levels))
        return TemplateBucket(
            ranks=tuple(self.ranks),
            temporal_slots=(len(self.ranks),) * self.num_levels,
            spatial_slots=n_spatial)

    def decode_bucketed(self, genomes: np.ndarray
                        ) -> tuple[TemplateBucket, np.ndarray, np.ndarray]:
        """Bucket-relative decode of a (n, G) population: returns
        ``(bucket, bounds, rank_ids)`` with ``bounds`` and ``rank_ids``
        both (n, bucket.num_slots) — permutation indices become data
        (the rank-id gather), not structure, so the population needs no
        per-template grouping at all."""
        g = self.repair(genomes)
        n = len(g)
        R, L = len(self.ranks), self.num_levels
        ridx = {r: i for i, r in enumerate(self.ranks)}

        # per-(candidate, rank, level) temporal bound from the factor genes
        fb = np.ones((n, R, L), np.int64)
        for ri, r in enumerate(self.ranks):
            blk = self._rank_block[r]
            if blk.stop == blk.start:
                continue
            primes = np.asarray(self._gene_prime[blk], np.int64)
            for lvl in range(L):
                fb[:, ri, lvl] = np.prod(
                    np.where(g[:, blk] == lvl, primes, 1), axis=1)

        # per-(candidate, level) rank order (indices into self.ranks)
        order = np.empty((n, L, R), np.int64)
        perm_table = np.asarray(self.perms, np.int64).reshape(-1, R)
        for lvl in range(L):
            if lvl in self.fixed_order:
                order[:, lvl, :] = np.asarray(
                    [ridx[r] for r in self.fixed_order[lvl]], np.int64)
            else:
                gp = g[:, self.num_factor_genes
                       + self.perm_levels.index(lvl)]
                order[:, lvl, :] = perm_table[gp]

        bucket = self.bucket
        bounds = np.ones((n, bucket.num_slots), np.int64)
        ids = np.zeros((n, bucket.num_slots), np.int64)
        spatial = self.cons.spatial or {}
        j = 0
        for lvl in range(L - 1, -1, -1):
            ids[:, j: j + R] = order[:, lvl, :]
            bounds[:, j: j + R] = np.take_along_axis(
                fb[:, :, lvl], order[:, lvl, :], axis=1)
            j += R
            for r, b in spatial.get(lvl, {}).items():
                if b > 1:
                    ids[:, j] = ridx[r]
                    bounds[:, j] = b
                    j += 1
        return bucket, bounds, ids

    def nest_of(self, genome: np.ndarray) -> LoopNest:
        """Materialize the concrete LoopNest (unit loops dropped)."""
        g = self.repair(np.asarray(genome, np.int64).reshape(1, -1))[0]
        template = self.template_of(g)
        return template.nest_with(self.bounds_of(g, template)[0])

    # ------------------------------------------------------------------
    @property
    def mapspace_size(self) -> float:
        """|factor assignments| x |free permutations| (log-safe float)."""
        size = float(self.num_levels) ** self.num_factor_genes
        size *= float(len(self.perms)) ** len(self.perm_levels)
        return size

    def describe(self) -> str:
        return (f"{self.genome_size} genes ({self.num_factor_genes} factor"
                f" + {len(self.perm_levels)} permutation), "
                f"~{self.mapspace_size:.3g} mappings, "
                f"{math.prod(self.residual.values())} iteration points")


# ----------------------------------------------------------------------
# (design, mapping) co-search: the design side of the genome
# ----------------------------------------------------------------------
def _freeze_steps(steps) -> tuple:
    """Canonicalize a {level_name: values} mapping (or pre-frozen pair
    tuple) into ``((name, (float, ...)), ...)`` so DesignSpace stays a
    hashable frozen dataclass."""
    if isinstance(steps, Mapping):
        items = steps.items()
    else:
        items = tuple(steps)
    return tuple((str(name), tuple(float(v) for v in values))
                 for name, values in items)


#: sentinel "level name" marking a knob that steps a ``ComputeLevel``
#: scalar instead of a storage-level one (no storage level may collide
#: with it; compute units are resolved positionally, not by name)
COMPUTE_KNOB_LEVEL = "__compute__"


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """Architecture-provisioning search space: per-storage-level
    candidate *steps* for capacity and bandwidth (plus arbitrary extra
    ``StorageLevel`` scalar fields via ``extra_steps``, and
    ``ComputeLevel`` scalars — MAC energy, PE count, throughput width —
    via ``compute_steps``).

    Each (level, knob) entry contributes ONE design gene valued in
    ``[0, len(steps))``; the spec carries no base design, so the same
    space composes with any design whose level names match — decode
    with :meth:`arch_of` / :meth:`design_of`.  The provisioned scalars
    ride as ``ArchParams`` program inputs, so sweeping or co-searching the
    space never multiplies the program count (programs are keyed by
    topology, which every point of the space shares)."""

    #: {level_name: (capacity_words choices...)}
    capacity_steps: tuple = ()
    #: {level_name: (bandwidth_words_per_cycle choices...)}
    bandwidth_steps: tuple = ()
    #: {(level_name, field_name): (choices...)} for any other
    #: StorageLevel scalar (e.g. read_energy_pj) — heterogeneous
    #: Flexagon-style design points beyond pure provisioning
    extra_steps: tuple = ()
    #: {field_name: (choices...)} for ``ComputeLevel`` scalars
    #: (``instances``, ``mac_energy_pj``, ``gated_energy_pj``,
    #: ``throughput``) — one gene per field, applied to the base
    #: design's compute unit
    compute_steps: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "capacity_steps",
                           _freeze_steps(self.capacity_steps))
        object.__setattr__(self, "bandwidth_steps",
                           _freeze_steps(self.bandwidth_steps))
        extra = self.extra_steps
        if isinstance(extra, Mapping):
            extra = extra.items()
        object.__setattr__(self, "extra_steps", tuple(
            ((str(lvl), str(field)), tuple(float(v) for v in values))
            for (lvl, field), values in extra))
        object.__setattr__(self, "compute_steps",
                           _freeze_steps(self.compute_steps))
        valid_compute = set(COMPUTE_FIELDS)
        for field, _ in self.compute_steps:
            if field not in valid_compute:
                raise ValueError(
                    f"unknown ComputeLevel field {field!r}; compute "
                    f"knobs must be one of {sorted(valid_compute)}")
        for field, lvl, steps in self.knobs:
            if not steps:
                raise ValueError(f"empty step list for {field} of "
                                 f"level {lvl!r}")

    @property
    def knobs(self) -> tuple[tuple[str, str, tuple[float, ...]], ...]:
        """(field_name, level_name, steps) per gene — capacity genes
        first, then bandwidth, then extras, then compute knobs (with
        the :data:`COMPUTE_KNOB_LEVEL` sentinel as their level name), in
        construction order."""
        return tuple(
            [("capacity_words", n, s) for n, s in self.capacity_steps]
            + [("bandwidth_words_per_cycle", n, s)
               for n, s in self.bandwidth_steps]
            + [(field, lvl, s)
               for (lvl, field), s in self.extra_steps]
            + [(field, COMPUTE_KNOB_LEVEL, s)
               for field, s in self.compute_steps])

    @property
    def num_genes(self) -> int:
        return len(self.knobs)

    @property
    def cardinality(self) -> np.ndarray:
        return np.asarray([len(s) for _, _, s in self.knobs], np.int64)

    @property
    def size(self) -> int:
        """Number of distinct design points."""
        return int(np.prod(self.cardinality, initial=1))

    def all_genes(self):
        """Every design-gene row of the cross product, lexicographic."""
        for combo in itertools.product(
                *[range(len(s)) for _, _, s in self.knobs]):
            yield np.asarray(combo, np.int64)

    # ------------------------------------------------------------------
    def arch_of(self, base: Architecture, genes, *,
                missing_ok: bool = False) -> Architecture:
        """Apply a design-gene row to a base architecture.  Level names
        must all exist in it unless ``missing_ok`` — the heterogeneous-
        topology escape: one DesignSpace composes with EVERY topology of
        a :class:`TopologySpace`, so a knob naming a level a particular
        topology dropped is simply inert there (its gene still occupies
        the genome slot, keeping the layout topology-independent)."""
        genes = np.asarray(genes, np.int64).reshape(-1)
        if len(genes) != self.num_genes:
            raise ValueError(f"expected {self.num_genes} design genes, "
                             f"got {len(genes)}")
        overrides: dict[str, dict[str, float]] = {}
        compute_ov: dict[str, float | int] = {}
        names = {lv.name for lv in base.levels}
        for g, (field, lvl, steps) in zip(genes, self.knobs):
            if lvl == COMPUTE_KNOB_LEVEL:
                v = steps[int(g)]
                # ComputeLevel.instances is an int field; steps are
                # canonicalized to float, so cast it back
                compute_ov[field] = int(v) if field == "instances" else v
                continue
            if lvl not in names:
                if missing_ok:
                    continue
                raise ValueError(f"DesignSpace level {lvl!r} not in "
                                 f"architecture {base.name!r} "
                                 f"({sorted(names)})")
            overrides.setdefault(lvl, {})[field] = steps[int(g)]
        levels = tuple(
            self._replace_level(lv, overrides[lv.name])
            if lv.name in overrides else lv for lv in base.levels)
        compute = (dataclasses.replace(base.compute, **compute_ov)
                   if compute_ov else base.compute)
        return dataclasses.replace(base, levels=levels, compute=compute)

    @staticmethod
    def _replace_level(lv, ov: dict) -> "StorageLevel":
        """``dataclasses.replace`` that keeps DERIVED defaults derived:
        when ``read_energy_pj`` is stepped and the base level's write /
        metadata energies still equal their documented derivations
        (write = read, metadata = 0.25 x read) — i.e. they were
        defaults, not explicit choices — they are re-derived from the
        NEW read energy instead of staying frozen at the base value, so
        a decoded design point matches a directly-constructed level
        with the same provisioning.  Explicitly stepped fields always
        win."""
        if "read_energy_pj" in ov:
            if ("write_energy_pj" not in ov
                    and lv.write_energy_pj == lv.read_energy_pj):
                ov = {**ov, "write_energy_pj": -1.0}
            if ("metadata_read_energy_pj" not in ov
                    and lv.metadata_read_energy_pj
                    == 0.25 * lv.read_energy_pj):
                ov = {**ov, "metadata_read_energy_pj": -1.0}
        return dataclasses.replace(lv, **ov)

    def design_of(self, base: Design, genes, *,
                  missing_ok: bool = False) -> Design:
        """Apply a design-gene row to a base Design (same SAFs; the
        name grows a gene-tuple suffix for log/bench readability)."""
        genes = np.asarray(genes, np.int64).reshape(-1)
        suffix = ".".join(str(int(g)) for g in genes)
        return dataclasses.replace(
            base, arch=self.arch_of(base.arch, genes,
                                    missing_ok=missing_ok),
            name=f"{base.name or base.arch.name}@{suffix}")

    def describe(self) -> str:
        return (f"{self.num_genes} design genes, {self.size} design "
                f"points: " + ", ".join(
                    f"{lvl}.{field}x{len(s)}"
                    for field, lvl, s in self.knobs))


class CoSearchEncoding(MapspaceEncoding):
    """Joint (design, mapping) genome: the mapping genes of
    :class:`MapspaceEncoding` followed by one design gene per
    :class:`DesignSpace` knob.

    Everything the strategies touch (``cardinality``, ``gene_block`` —
    each design gene is its own crossover block, so recombination can
    exchange a provisioning decision wholesale — ``random_population``,
    ``structured_population``, ``repair``) covers the design segment,
    and the bucket-relative decode is unchanged: the mapping genes
    lower exactly as before, while :meth:`arch_params_of` turns the
    design genes into per-candidate traced ``ArchParams`` rows — so a
    mixed-design population evaluates through the SAME single
    bucket program as a mapping-only one."""

    def __init__(self, workload: Workload, num_levels: int,
                 cons: MapspaceConstraints | None,
                 space: DesignSpace, base: Design):
        super().__init__(workload, num_levels, cons)
        if space.num_genes == 0:
            raise ValueError("DesignSpace has no knobs — use plain "
                             "MapspaceEncoding for mapping-only search")
        self.space = space
        self.base_design = base
        # fail fast on level-name mismatches (decode would raise later)
        space.arch_of(base.arch, np.zeros(space.num_genes, np.int64))
        self.num_map_genes = self.genome_size
        self.genome_size += space.num_genes
        self.cardinality = np.concatenate(
            [self.cardinality, space.cardinality])
        self.gene_block = np.concatenate(
            [self.gene_block,
             self.num_blocks + np.arange(space.num_genes)])
        self.num_blocks += space.num_genes

    # ------------------------------------------------------------------
    def structured_population(self, key, n: int) -> np.ndarray:
        """Block-structured mapping genes + uniform design genes (no
        provisioning corner is a-priori better, so the design segment
        starts diverse)."""
        gen = generator(key)
        out = super().structured_population(gen, n)
        out[:, self.num_map_genes:] = randint(
            gen, (n, self.space.num_genes), self.space.cardinality)
        return out

    # ------------------------------------------------------------------
    def design_genes(self, genomes: np.ndarray) -> np.ndarray:
        """(n, num_design_genes) repaired design segment."""
        return self.repair(np.atleast_2d(np.asarray(genomes, np.int64))
                           )[:, self.num_map_genes:]

    def design_of(self, genome: np.ndarray) -> Design:
        """Materialize one genome's concrete Design."""
        return self.space.design_of(self.base_design,
                                    self.design_genes(genome)[0])

    def arch_params_of(self, genomes: np.ndarray) -> ArchParams:
        """Batched (per-candidate) traced arch rows of a population —
        each distinct design point packs once, then gathers."""
        g = self.design_genes(genomes)
        uniq, inverse = np.unique(g, axis=0, return_inverse=True)
        inverse = np.asarray(inverse).reshape(-1)   # numpy 2.0 kept dims
        packed = [pack_arch_params(
            self.space.arch_of(self.base_design.arch, row))
            for row in uniq]
        return ArchParams(
            storage=np.stack([p.storage for p in packed])[inverse],
            compute=np.stack([p.compute for p in packed])[inverse],
            structure=packed[0].structure)

    # ------------------------------------------------------------------
    @property
    def mapspace_size(self) -> float:
        return super().mapspace_size * float(self.space.size)

    def describe(self) -> str:
        return (super().describe() + f"; co-search x "
                + self.space.describe())


# ----------------------------------------------------------------------
# topology-as-data: level count + SAF placement as genome data
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SAFOption:
    """One catalog entry of sparse acceleration features attachable to
    a storage level: per-tensor compressed formats plus gate/skip
    actions anchored at that level.  Options are written level-name-
    free so the same catalog composes with any :class:`LevelSlot`;
    :meth:`attach` binds one to a concrete level name.

    ``formats`` is ``((tensor, TensorFormat), ...)``; ``actions`` is
    ``((SAFKind, follower, (leaders...)), ...)``."""

    name: str
    formats: tuple = ()
    actions: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "formats", tuple(
            (str(t), f) for t, f in self.formats))
        object.__setattr__(self, "actions", tuple(
            (SAFKind(k), str(fo), tuple(str(x) for x in le))
            for k, fo, le in self.actions))
        for _, f in self.formats:
            if not isinstance(f, TensorFormat):
                raise ValueError(f"SAFOption {self.name!r}: format "
                                 f"values must be TensorFormat, got "
                                 f"{type(f).__name__}")

    def attach(self, level_name: str) -> tuple[dict, tuple]:
        """Bind this option to a level: ``(formats, actions)`` in
        :class:`~repro_torch.core.taxonomy.SAFSpec` shape."""
        fmts = {(level_name, t): f for t, f in self.formats}
        acts = tuple(ActionSAF(kind=k, level=level_name, follower=fo,
                               leaders=le)
                     for k, fo, le in self.actions)
        return fmts, acts


#: the empty catalog entry: keep the level dense, attach nothing
SAF_NONE = SAFOption("none")


@dataclasses.dataclass(frozen=True)
class LevelSlot:
    """One composable block of a :class:`TopologySpace` — a storage
    level that is either always present or gated by a presence gene,
    with an optional per-slot SAF catalog (one SAF gene choosing which
    entry, if any, attaches to the level)."""

    level: StorageLevel
    optional: bool = False
    saf_options: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "saf_options",
                           tuple(self.saf_options))
        for opt in self.saf_options:
            if not isinstance(opt, SAFOption):
                raise ValueError(f"slot {self.level.name!r}: "
                                 f"saf_options must be SAFOption "
                                 f"entries, got {type(opt).__name__}")
        names = [opt.name for opt in self.saf_options]
        if len(set(names)) != len(names):
            raise ValueError(f"slot {self.level.name!r}: duplicate "
                             f"SAFOption names {names}")


@dataclasses.dataclass(frozen=True)
class TopologySpace:
    """Topology search space: the memory hierarchy as a sequence of
    composable :class:`LevelSlot` blocks (outermost first), LiteX-style
    — architectures are *composed* from parameterized blocks, never
    hand-written monoliths.

    Genes: one **presence** gene (cardinality 2) per optional slot,
    then one **SAF** gene per slot that carries a catalog (cardinality
    = catalog size).  Every in-range gene row decodes to a valid
    ``(Architecture, SAFSpec)`` *by construction*: the level count is
    always within ``[min_levels, max_levels]`` (required slots have no
    gene) and SAFs only ever attach to levels that exist (an absent
    slot's SAF gene is inert — decode, name, and topology key ignore
    it), so repair is a plain mod and never a projection.

    Distinct decoded topologies are identified by their canonical
    :func:`~repro_torch.core.arch.topology_key`; a mixed-topology population
    groups by that key and rides O(groups) programs, exactly
    as bucketed dispatch groups by ``TemplateBucket``."""

    #: LevelSlot blocks, outermost-first (like ``Architecture.levels``)
    slots: tuple
    compute: ComputeLevel = ComputeLevel()
    #: ActionSAFs always present, anchored at "compute" or a REQUIRED
    #: level's name (optional levels take actions via their catalog)
    base_actions: tuple = ()
    name: str = "topo"

    def __post_init__(self):
        object.__setattr__(self, "slots", tuple(self.slots))
        object.__setattr__(self, "base_actions",
                           tuple(self.base_actions))
        if not any(not s.optional for s in self.slots):
            raise ValueError("TopologySpace needs at least one "
                             "required (non-optional) LevelSlot")
        names = [s.level.name for s in self.slots]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate level names {names}")
        anchors = {s.level.name for s in self.slots
                   if not s.optional} | {"compute"}
        for a in self.base_actions:
            if a.level not in anchors:
                raise ValueError(
                    f"base action {a.describe()!r} anchored at "
                    f"{a.level!r}, which is not 'compute' or a "
                    f"required level ({sorted(anchors)}) — attach "
                    f"optional-level SAFs via the slot's catalog")

    # ------------------------------------------------------------------
    @property
    def min_levels(self) -> int:
        return sum(1 for s in self.slots if not s.optional)

    @property
    def max_levels(self) -> int:
        return len(self.slots)

    @property
    def stable_inner_levels(self) -> int:
        """Length of the contiguous REQUIRED suffix of slots: level
        indices-from-inner below this bind to the same physical level
        in every decoded topology (spatial constraints must stay inside
        it)."""
        n = 0
        for s in reversed(self.slots):
            if s.optional:
                break
            n += 1
        return n

    @property
    def knobs(self) -> tuple:
        """(kind, slot_index, cardinality) per gene: presence genes
        for the optional slots first (slot order), then SAF genes for
        the catalog-carrying slots (slot order)."""
        pres = [("presence", i, 2)
                for i, s in enumerate(self.slots) if s.optional]
        safg = [("saf", i, len(s.saf_options))
                for i, s in enumerate(self.slots) if s.saf_options]
        return tuple(pres + safg)

    @property
    def num_genes(self) -> int:
        return len(self.knobs)

    @property
    def cardinality(self) -> np.ndarray:
        return np.asarray([c for _, _, c in self.knobs], np.int64)

    @property
    def size(self) -> int:
        """Gene-row count (an upper bound on distinct topologies —
        absent slots make their SAF genes inert)."""
        return int(np.prod(self.cardinality, initial=1))

    # ------------------------------------------------------------------
    def repair(self, genes) -> np.ndarray:
        g = np.asarray(genes, np.int64).reshape(-1)
        if len(g) != self.num_genes:
            raise ValueError(f"expected {self.num_genes} topology "
                             f"genes, got {len(g)}")
        return np.mod(g, self.cardinality)

    def decode(self, genes) -> tuple[Architecture, SAFSpec]:
        """Gene row -> (Architecture, SAFSpec).  Always valid: levels
        are the present slots outermost-first, SAFs attach only to
        present levels, and absent slots' SAF genes are ignored."""
        g = self.repair(genes)
        choice = {i: int(v) for (kind, i, _), v
                  in zip(self.knobs, g) if kind == "presence"}
        saf = {i: int(v) for (kind, i, _), v
               in zip(self.knobs, g) if kind == "saf"}
        levels, formats = [], {}
        actions = list(self.base_actions)
        tags = []
        for i, s in enumerate(self.slots):
            if s.optional and choice[i] == 0:
                continue
            levels.append(s.level)
            opt = (s.saf_options[saf[i]] if s.saf_options
                   else SAF_NONE)
            if opt.formats or opt.actions:
                fmts, acts = opt.attach(s.level.name)
                formats.update(fmts)
                actions.extend(acts)
            tags.append(s.level.name if opt is SAF_NONE
                        else f"{s.level.name}+{opt.name}")
        arch = Architecture(name=f"{self.name}[" + "/".join(tags) + "]",
                            levels=tuple(levels), compute=self.compute)
        return arch, SAFSpec(formats=formats, actions=tuple(actions))

    def design_of(self, genes) -> Design:
        arch, safs = self.decode(genes)
        return Design(arch=arch, safs=safs, name=arch.name)

    def topology_key_of(self, genes) -> tuple:
        """Canonical key of the decoded topology — equal across
        derivation-equal gene rows (inert-gene differences included)."""
        arch, safs = self.decode(genes)
        return topology_key(arch, safs)

    def full_design(self) -> Design:
        """Every slot present, catalog entry 0 — the representative
        design evaluators use for capability probing and logging."""
        genes = np.zeros(self.num_genes, np.int64)
        for j, (kind, _, _) in enumerate(self.knobs):
            if kind == "presence":
                genes[j] = 1
        return self.design_of(genes)

    def enumerate_designs(self) -> list[tuple[tuple, Design]]:
        """All DISTINCT topologies of the space as (topology_key,
        Design) pairs, first-seen gene order — ``len()`` of this is the
        program-count bound for a mixed-topology population."""
        out: dict[tuple, Design] = {}
        for combo in itertools.product(
                *[range(c) for _, _, c in self.knobs]):
            d = self.design_of(np.asarray(combo, np.int64))
            out.setdefault(topology_key(d.arch, d.safs), d)
        return list(out.items())

    def describe(self) -> str:
        return (f"{self.num_genes} topology genes, "
                f"{len(self.enumerate_designs())} distinct topologies "
                f"({self.min_levels}-{self.max_levels} levels)")


@dataclasses.dataclass
class _TopoGroup:
    """One topology group of a mixed population: its canonical key,
    the decoded base Design, and the sub-encoding whose mapping genome
    the master genome folds into."""

    key: tuple
    design: Design
    enc: MapspaceEncoding


class TopologyCoSearchEncoding(MapspaceEncoding):
    """Joint (topology, design, mapping) genome — the last
    "structure is not data" gap closed.

    Layout: ``[factor genes (cardinality max_levels)] [max_levels
    permutation genes] [design genes] [topology genes]``.  The mapping
    segment is written against the DEEPEST topology; for an L-level
    group the factor genes fold ``mod L`` and the first L permutation
    genes apply — so one strategy kernel mutates one flat genome while
    every candidate stays decodable under its own topology.

    Populations do not share a bucket program across topologies (the
    level count shapes the trace), so the master ``decode_bucketed``
    raises: callers group with :meth:`group_by_topology` and decode
    each group through its own sub-encoding (:meth:`sub_genomes` ->
    ``group.enc.decode_bucketed``), paying O(topology groups) programs
    exactly like bucketed dispatch pays O(buckets)."""

    def __init__(self, workload: Workload,
                 cons: MapspaceConstraints | None,
                 topo: TopologySpace,
                 space: DesignSpace | None = None):
        cons = cons or MapspaceConstraints()
        if cons.permutations:
            raise ValueError(
                "topology co-search needs free permutations: "
                "cons.permutations pins loop orders by level index, "
                "which is ambiguous across level counts")
        stable = topo.stable_inner_levels
        bad = sorted(lvl for lvl in (cons.spatial or {})
                     if lvl >= stable)
        if bad:
            raise ValueError(
                f"spatial constraints at level(s) {bad} exceed the "
                f"stable inner suffix ({stable} required innermost "
                f"slot(s)) — those indices bind to different physical "
                f"levels in different topologies")
        super().__init__(workload, topo.max_levels, cons)
        self.topo = topo
        self.space = space
        num_design = space.num_genes if space is not None else 0
        if space is not None and num_design == 0:
            raise ValueError("DesignSpace has no knobs — pass "
                             "space=None for (topology, mapping) "
                             "search without scalar knobs")
        if space is not None:
            # fail fast on knobs no topology of the space can resolve
            full = topo.full_design()
            space.arch_of(full.arch,
                          np.zeros(space.num_genes, np.int64),
                          missing_ok=True)
            known = ({lv.name for s in topo.slots
                      for lv in (s.level,)} | {COMPUTE_KNOB_LEVEL})
            missing = sorted({lvl for _, lvl, _ in space.knobs}
                             - known)
            if missing:
                raise ValueError(f"DesignSpace level(s) {missing} "
                                 f"exist in NO slot of the "
                                 f"TopologySpace")
        self.num_map_genes = self.genome_size
        self.design_off = self.num_map_genes
        self.topo_off = self.num_map_genes + num_design
        self.genome_size = self.topo_off + topo.num_genes
        card = [self.cardinality]
        if space is not None:
            card.append(space.cardinality)
        card.append(topo.cardinality)
        self.cardinality = np.concatenate(card)
        trailing = num_design + topo.num_genes
        self.gene_block = np.concatenate(
            [self.gene_block, self.num_blocks + np.arange(trailing)])
        self.num_blocks += trailing
        self._groups: dict[tuple, _TopoGroup] = {}

    # ------------------------------------------------------------------
    def structured_population(self, key, n: int) -> np.ndarray:
        """Block-structured mapping genes + uniform design and
        topology genes (every topology starts represented in
        expectation)."""
        gen = generator(key)
        out = super().structured_population(gen, n)
        trailing = self.genome_size - self.design_off
        if trailing:
            out[:, self.design_off:] = randint(
                gen, (n, trailing), self.cardinality[self.design_off:])
        return out

    # ------------------------------------------------------------------
    def design_genes(self, genomes: np.ndarray) -> np.ndarray:
        """(n, num_design_genes) repaired design segment."""
        return self.repair(np.atleast_2d(np.asarray(genomes, np.int64))
                           )[:, self.design_off:self.topo_off]

    def topo_genes(self, genomes: np.ndarray) -> np.ndarray:
        """(n, num_topology_genes) repaired topology segment."""
        return self.repair(np.atleast_2d(np.asarray(genomes, np.int64))
                           )[:, self.topo_off:]

    def group_for(self, tkey: tuple) -> _TopoGroup:
        """The cached :class:`_TopoGroup` for a topology key seen by
        :meth:`group_by_topology`."""
        return self._groups[tkey]

    def _group_of_row(self, row: np.ndarray) -> _TopoGroup:
        design = self.topo.design_of(row)
        tkey = topology_key(design.arch, design.safs)
        grp = self._groups.get(tkey)
        if grp is None:
            grp = _TopoGroup(
                key=tkey, design=design,
                enc=MapspaceEncoding(self.workload,
                                     design.arch.num_levels,
                                     self.cons))
            self._groups[tkey] = grp
        return grp

    def group_by_topology(self, genomes: np.ndarray
                          ) -> list[tuple[_TopoGroup, np.ndarray]]:
        """Group a (n, G) population by canonical topology key:
        ``(group, original-indices)`` pairs ordered by each group's
        first member (deterministic; topology keys themselves are not
        orderable — they carry TensorFormat entries)."""
        tg = self.topo_genes(genomes)
        uniq, inverse = np.unique(tg, axis=0, return_inverse=True)
        inverse = np.asarray(inverse).reshape(-1)
        by_key: dict[tuple, list] = {}
        for u, row in enumerate(uniq):
            grp = self._group_of_row(row)
            by_key.setdefault(grp.key, []).append(u)
        out = []
        for tkey, us in by_key.items():
            idx = np.flatnonzero(np.isin(inverse, us))
            out.append((self._groups[tkey], idx))
        out.sort(key=lambda t: int(t[1][0]))
        return out

    def sub_genomes(self, genomes: np.ndarray,
                    grp: _TopoGroup) -> np.ndarray:
        """Fold master mapping genes into ``grp``'s sub-encoding
        genome: factor genes mod L, first L permutation genes."""
        g = self.repair(np.atleast_2d(np.asarray(genomes, np.int64)))
        L = grp.enc.num_levels
        F = self.num_factor_genes
        fac = np.mod(g[:, :F], L)
        perm = g[:, F:F + L]
        return np.concatenate([fac, perm], axis=1)

    # ------------------------------------------------------------------
    def design_of(self, genome: np.ndarray) -> Design:
        """Materialize one genome's concrete Design: decoded topology
        plus its design genes (knobs on absent levels are inert)."""
        g = self.repair(np.asarray(genome, np.int64).reshape(1, -1))
        base = self._group_of_row(g[0, self.topo_off:]).design
        if self.space is None:
            return base
        return self.space.design_of(base, g[0, self.design_off:
                                            self.topo_off],
                                    missing_ok=True)

    def group_arch_params(self, genomes: np.ndarray,
                          grp: _TopoGroup) -> ArchParams | None:
        """Per-candidate traced arch rows under ``grp``'s topology
        (None when there is no DesignSpace — the group's base rows
        bind instead)."""
        if self.space is None:
            return None
        g = self.design_genes(genomes)
        uniq, inverse = np.unique(g, axis=0, return_inverse=True)
        inverse = np.asarray(inverse).reshape(-1)
        packed = [pack_arch_params(
            self.space.arch_of(grp.design.arch, row, missing_ok=True))
            for row in uniq]
        return ArchParams(
            storage=np.stack([p.storage for p in packed])[inverse],
            compute=np.stack([p.compute for p in packed])[inverse],
            structure=packed[0].structure)

    def representative_design(self) -> Design:
        """The full (deepest) topology — capability probe + log
        metadata stand-in for "the" design of a topology search."""
        return self.topo.full_design()

    def nest_of(self, genome: np.ndarray) -> LoopNest:
        g = self.repair(np.asarray(genome, np.int64).reshape(1, -1))
        grp = self._group_of_row(g[0, self.topo_off:])
        return grp.enc.nest_of(self.sub_genomes(g, grp)[0])

    # ------------------------------------------------------------------
    def decode_bucketed(self, genomes):
        raise NotImplementedError(
            "mixed-topology populations have no single bucket "
            "program: group with group_by_topology() and decode each "
            "group via sub_genomes() -> group.enc.decode_bucketed()")

    def decode_population(self, genomes):
        raise NotImplementedError(
            "group with group_by_topology() and decode each group "
            "via sub_genomes() -> group.enc.decode_population()")

    def template_of(self, genome):
        raise NotImplementedError(
            "per-topology templates: use nest_of / group_by_topology")

    # ------------------------------------------------------------------
    @property
    def mapspace_size(self) -> float:
        size = super().mapspace_size * float(self.topo.size)
        if self.space is not None:
            size *= float(self.space.size)
        return size

    def describe(self) -> str:
        out = super().describe() + "; topology x " + self.topo.describe()
        if self.space is not None:
            out += "; co-search x " + self.space.describe()
        return out
