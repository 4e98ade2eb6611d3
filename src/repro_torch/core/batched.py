"""Batched mapspace evaluation: the three-step Sparseloop model (dataflow
-> sparse -> micro-architecture) written over a whole *population* of
loop nests as float64 PyTorch tensors with a leading candidate dimension.

This is the port of the JAX package's ``core/batched.py``, where the same
model was one ``jnp`` program under ``vmap`` and ``jit``.  Here every
per-candidate scalar is a ``(C,)`` tensor, every rank-keyed quantity a
``(C, R)`` tensor, and the program runs eagerly on one device (the CUDA
card unless the caller passes ``device="cpu"``).  There is no hand
kernel: each step is a few hundred small elementwise torch operations.

The lowering contract
---------------------
A :class:`NestTemplate` is the loop structure with the bounds stripped.
Bound-1 slots are *allowed* and treated exactly as if the loop were absent
(the scalar mapper never emits unit loops; reuse-prefix and leader-window
boundaries are therefore recomputed per candidate from ``bound > 1``
masks, keeping batched results bit-comparable with the scalar engine's
dropped-unit-loop semantics).

Bucketed lowering (one program per *family* of templates)
---------------------------------------------------------
A :class:`TemplateBucket` is the padded superset of a template family: per
storage level it carries the *maximum* slot count over the family, absent
loops ride as unit bounds, and the slot->rank assignment is per-candidate
data (a rank one-hot built from ``rank_ids``) instead of a constant.
:class:`BatchedModel` passes a constant one-hot (exact template),
:class:`BucketedModel` derives it per candidate, so every permutation of
every layer of a network evaluates through the *same* program.

Workload- and architecture-as-data
----------------------------------
A :class:`WorkloadParams` packs what a layer contributes to the math —
rank bounds plus per-tensor density kind ids, parameter rows and
tile-occupancy histograms — and an :class:`~.arch.ArchParams` packs every
per-level architecture scalar.  Programs are cached by workload
*structure*, arch *topology* + SAF placement, static
:class:`~.density.DensityCaps` and template or bucket (``_init_program``),
never by bounds, densities or architecture scalars, so the layers of a
network and the points of a design sweep share programs.  Architecture
rows are per candidate, so a mixed-design population shares one program.

``BatchedModel.evaluate`` matches scalar ``Sparseloop.evaluate`` to
float64 round-off (the port's tests hold it to <= 1e-6 relative); the
scalar engine remains the per-candidate reference oracle.

Each evaluation makes one host-to-device copy (bounds, rank ids and any
per-candidate arch rows packed into one float64 array) and one
device-to-host copy (all metrics packed into one array); workload params
and an unbatched design's rows are copied once per device and cached.
Every program construction and every first evaluation of a (program,
device, shape) triple is counted by :mod:`.compile_stats`.

Population sharding
-------------------
``evaluate(..., mesh=)`` with a :class:`~.device.PopulationMesh` of more
than one shard splits the candidate axis over the mesh's devices, as the
JAX package's ``shard_map`` of the vmapped program does: the population
is padded to a multiple of the shard count by repeating its last
candidate, each shard's columns go to its device in one copy, the
workload params and an unbatched design's rows are bound once per
device, every shard is issued before the first device-to-host copy, and
the results are concatenated in candidate order with the padding
stripped.  The engine works per candidate with no reduction across
candidates, so a shard's metrics equal the same candidates' unsharded
metrics.  The calling thread issues the shards in turn: the devices run
them at once, but the host pays every shard's launches (a worker thread
per card was tried first and was slower still on four H100s: the
threads' Python dispatch contends for one interpreter lock).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time

import numpy as np
import torch

from .. import obs
from . import compile_stats
from .arch import (COMPUTE_FIELDS, STORAGE_FIELDS, ArchParams,
                   Architecture, arch_structure, pack_arch_params,
                   topology_key)
from .density import (ACTUAL_ID, BatchedDensityUnsupported, DensityCaps,
                      DensityModel, TracedDensityStats, caps_for_models,
                      make_density_model)
from .device import PopulationMesh, resolve_device
from .mapping import Loop, LoopNest
from .taxonomy import RankFormat, SAFSpec, SAFKind
from .workload import TensorSpec, Workload

WORD_BITS = 16.0  # metadata accounting word width (matches sparse.py)
F64 = torch.float64


class BatchedUnsupported(NotImplementedError):
    """The (design, workload) pair has no batched path; use the scalar
    engine instead."""


# ----------------------------------------------------------------------
# Workload-as-data: the tensor inputs of a program
# ----------------------------------------------------------------------
def workload_structure(workload: Workload) -> tuple:
    """The *static* part of a workload — ordered rank names, tensor
    projections and the output tensor.  Everything else (rank bound
    values, density parameters) is :class:`WorkloadParams` data, so two
    layers with equal structure share programs."""
    return (tuple(workload.rank_bounds), workload.tensors,
            workload.output)


@dataclasses.dataclass(frozen=True)
class WorkloadParams:
    """Workload inputs of one program, as numpy rows.

    ``rank_bounds`` is the (R,) bound vector in ``workload.ranks``
    order; per tensor (in ``workload.tensors`` order) ``model_ids``
    holds the density-model kind, ``density_params`` the fixed-shape
    parameter rows and ``hist`` the ``(3, caps.hist)`` tile-occupancy
    histograms (zero-width when no actual-data tensor exists).  ``caps``
    is the static padding the arrays were built against — it must match
    the program's caps — and ``structure`` records which workload
    structure the arrays were packed for, so binding them to the wrong
    program is a loud error.  :meth:`device_leaves` turns the rows into
    tensors on a device, once per device."""

    rank_bounds: np.ndarray
    model_ids: np.ndarray
    density_params: np.ndarray
    hist: np.ndarray
    caps: DensityCaps
    structure: tuple = ()

    def leaves(self) -> tuple:
        return (self.rank_bounds, self.model_ids, self.density_params,
                self.hist)

    def device_leaves(self, device) -> tuple:
        """``(rank_bounds, model_ids, density_params, hist, kinds)``:
        the four rows as tensors on ``device`` (float64, int64 ids),
        cached per device because the params are immutable, plus the
        host tuple of kind ids the density selection evaluates."""
        device = resolve_device(device)
        key = str(device)
        cache = self.__dict__.get("_device_leaves")
        if cache is not None and key in cache:
            return cache[key]
        with _CACHE_LOCK:
            cache = self.__dict__.get("_device_leaves")
            if cache is None:
                cache = {}
                object.__setattr__(self, "_device_leaves", cache)
            if key in cache:
                return cache[key]
            rb, mids, dp, hist = self.leaves()
            cache[key] = (
                torch.as_tensor(np.asarray(rb, np.float64), device=device),
                torch.as_tensor(np.asarray(mids, np.int64), device=device),
                torch.as_tensor(np.asarray(dp, np.float64), device=device),
                torch.as_tensor(np.asarray(hist, np.float64),
                                device=device),
                tuple(int(k) for k in mids))
            return cache[key]


def _density_models(workload: Workload) -> list[DensityModel]:
    return [make_density_model(workload.density_spec(t.name),
                               t.size(workload.rank_bounds))
            for t in workload.tensors]


def pack_workload_params(workload: Workload,
                         caps: DensityCaps | None = None
                         ) -> WorkloadParams:
    """Lower a concrete workload to the numpy rows of its program.  ``caps`` pins the static padding — pass
    :func:`common_caps` of all layers of a sweep so every layer packs
    into (and therefore shares) the same program."""
    models = _density_models(workload)
    if caps is None:
        caps = caps_for_models(models)
    else:
        # exact (unrounded) requirement: any caps that fit the real
        # tables/scans are acceptable, pow2 rounding is only a
        # program-sharing heuristic
        need = caps_for_models(models, round_pow2=False)
        if not caps.covers(need):
            raise ValueError(f"caps {caps} do not cover the workload's "
                             f"required {need}")
    for t, m in zip(workload.tensors, models):
        if not m.batched:
            raise BatchedUnsupported(
                f"density model for tensor {t.name!r} "
                f"({type(m).__name__}) has no traced parametric form")
        if m.kind_id == ACTUAL_ID and m.tensor_size == 0:
            raise ValueError(f"actual-data tensor {t.name!r} is empty")
    rank_bounds = np.asarray(list(workload.rank_bounds.values()),
                             np.float64)
    model_ids = np.asarray([m.kind_id for m in models], np.int32)
    density_params = np.stack([np.asarray(m.params(), np.float64)
                               for m in models])
    hist = np.zeros((len(models), 3, caps.hist))
    for i, m in enumerate(models):
        table = m.hist_table()
        hist[i, :, : table.shape[1]] = table
    return WorkloadParams(rank_bounds=rank_bounds, model_ids=model_ids,
                          density_params=density_params, hist=hist,
                          caps=caps, structure=workload_structure(workload))


def common_caps(workloads) -> DensityCaps:
    """The joint :class:`DensityCaps` of several layers — pack every
    layer's :class:`WorkloadParams` against this so they share
    programs."""
    caps = DensityCaps()
    for wl in workloads:
        caps = caps.merge(caps_for_models(_density_models(wl)))
    return caps



# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NestTemplate:
    """Loop structure shared by a mapspace slice.

    ``slots`` are (rank, level, spatial) triples, outermost-first — a
    :class:`LoopNest` with the bounds stripped.  All candidates evaluated
    together instantiate this structure with per-slot bounds >= 1.
    """

    slots: tuple[tuple[str, int, bool], ...]
    num_levels: int

    @staticmethod
    def of_nest(nest: LoopNest) -> "NestTemplate":
        return NestTemplate(slots=nest.structure(),
                            num_levels=nest.num_levels)

    @property
    def num_slots(self) -> int:
        return len(self.slots)

    def bounds_of(self, nest: LoopNest) -> np.ndarray:
        """Per-slot bounds of a nest with this structure."""
        if NestTemplate.of_nest(nest) != self:
            raise ValueError("nest structure does not match template")
        return np.asarray(nest.bounds(), np.int64)

    def nest_with(self, bounds) -> LoopNest:
        """Instantiate a concrete LoopNest (unit loops dropped, matching
        what the scalar mapper would have generated)."""
        loops = [Loop(rank=r, bound=int(b), level=lvl, spatial=sp)
                 for (r, lvl, sp), b in zip(self.slots, bounds)
                 if int(b) > 1]
        return LoopNest(loops=tuple(loops), num_levels=self.num_levels)


def template_of(nest: LoopNest) -> NestTemplate:
    return NestTemplate.of_nest(nest)


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TemplateBucket:
    """Padded superset of a family of :class:`NestTemplate`s.

    The bucket fixes only the *shape* of the nest: how many temporal and
    spatial slots each storage level has (``temporal_slots[lvl]`` /
    ``spatial_slots[lvl]``, innermost-first indices) over a rank
    vocabulary ``ranks``.  Which rank each slot iterates is per-candidate
    data (``rank_ids``), and absent loops are unit bounds — so one
    compiled :class:`BucketedModel` evaluates every template the bucket
    :meth:`fits`, across permutations and layers alike.
    """

    ranks: tuple[str, ...]
    temporal_slots: tuple[int, ...]
    spatial_slots: tuple[int, ...]

    def __post_init__(self):
        if len(self.temporal_slots) != len(self.spatial_slots):
            raise ValueError("temporal/spatial slot counts disagree on "
                             "the number of levels")

    @property
    def num_levels(self) -> int:
        return len(self.temporal_slots)

    @property
    def num_slots(self) -> int:
        return sum(self.temporal_slots) + sum(self.spatial_slots)

    def slot_layout(self) -> tuple[tuple[int, bool], ...]:
        """(level, spatial) per slot, outermost level first — each
        level's temporal slots followed by its spatial slots (slot order
        within a level is the loop order; spatial position within the
        level is immaterial to the model)."""
        layout: list[tuple[int, bool]] = []
        for lvl in range(self.num_levels - 1, -1, -1):
            layout += [(lvl, False)] * self.temporal_slots[lvl]
            layout += [(lvl, True)] * self.spatial_slots[lvl]
        return tuple(layout)

    def _offsets(self) -> dict[int, tuple[int, int]]:
        """level -> (first temporal slot, first spatial slot) indices."""
        out: dict[int, tuple[int, int]] = {}
        j = 0
        for lvl in range(self.num_levels - 1, -1, -1):
            out[lvl] = (j, j + self.temporal_slots[lvl])
            j += self.temporal_slots[lvl] + self.spatial_slots[lvl]
        return out

    def fits(self, template: NestTemplate) -> bool:
        """True when every level of ``template`` has no more slots than
        the bucket provides and every rank is in the vocabulary."""
        if template.num_levels != self.num_levels:
            return False
        t = [0] * self.num_levels
        s = [0] * self.num_levels
        for r, lvl, sp in template.slots:
            if r not in self.ranks:
                return False
            (s if sp else t)[lvl] += 1
        return all(t[lvl] <= self.temporal_slots[lvl]
                   and s[lvl] <= self.spatial_slots[lvl]
                   for lvl in range(self.num_levels))

    def lower(self, template: NestTemplate) -> np.ndarray:
        """Bucket slot index of each template slot (order within each
        level preserved; unused bucket slots are left for unit-bound
        padding)."""
        if not self.fits(template):
            raise ValueError(f"template {template} does not fit bucket "
                             f"{self}")
        offs = self._offsets()
        used_t = [0] * self.num_levels
        used_s = [0] * self.num_levels
        out = np.empty(template.num_slots, np.int64)
        for i, (_, lvl, sp) in enumerate(template.slots):
            if sp:
                out[i] = offs[lvl][1] + used_s[lvl]
                used_s[lvl] += 1
            else:
                out[i] = offs[lvl][0] + used_t[lvl]
                used_t[lvl] += 1
        return out

    def lower_population(self, template: NestTemplate, bounds
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Embed a (C, template.num_slots) bound matrix into the bucket:
        returns ``(padded_bounds, rank_ids)``, both (C, num_slots).
        Padding slots carry bound 1 (inert by the lowering contract) and
        rank id 0 (immaterial at bound 1)."""
        bounds = np.atleast_2d(np.asarray(bounds, np.int64))
        slot_map = self.lower(template)
        ridx = {r: i for i, r in enumerate(self.ranks)}
        padded = np.ones((len(bounds), self.num_slots), np.int64)
        padded[:, slot_map] = bounds
        ids = np.zeros(self.num_slots, np.int64)
        ids[slot_map] = [ridx[r] for r, _, _ in template.slots]
        return padded, np.broadcast_to(ids, padded.shape).copy()


@dataclasses.dataclass(frozen=True)
class BucketingPolicy:
    """How templates map to buckets.

    ``pad_temporal_to_ranks`` (the default) pads every level's temporal
    slot count up to the workload's rank count — the shape the genome
    encoding emits — so all free-permutation templates of one workload
    land in ONE bucket and the compile count of a sweep is bounded by the
    number of distinct (workload, spatial shape, num_levels) triples
    rather than the number of loop orders."""

    pad_temporal_to_ranks: bool = True


DEFAULT_BUCKETING = BucketingPolicy()


def bucket_for(template: NestTemplate, ranks,
               policy: BucketingPolicy = DEFAULT_BUCKETING
               ) -> TemplateBucket:
    """The bucket a template lowers into under ``policy``."""
    ranks = tuple(ranks)
    t = [0] * template.num_levels
    s = [0] * template.num_levels
    for r, lvl, sp in template.slots:
        if r not in ranks:
            raise ValueError(f"template rank {r!r} not in {ranks}")
        (s if sp else t)[lvl] += 1
    if policy.pad_temporal_to_ranks:
        t = [max(c, len(ranks)) for c in t]
    return TemplateBucket(ranks=ranks, temporal_slots=tuple(t),
                          spatial_slots=tuple(s))


def group_by_bucket(nests, ranks,
                    policy: BucketingPolicy = DEFAULT_BUCKETING
                    ) -> dict[TemplateBucket, list[int]]:
    """Stable grouping of candidate nests by bucket (the padded analogue
    of :func:`group_by_template`)."""
    groups: dict[TemplateBucket, list[int]] = {}
    for i, nest in enumerate(nests):
        b = bucket_for(template_of(nest), ranks, policy)
        groups.setdefault(b, []).append(i)
    return groups


def lower_nests(bucket: TemplateBucket, nests, idxs
                ) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """Lower the nests at ``idxs`` into ``bucket``: returns
    ``(bounds, rank_ids, order)`` where the two (len(idxs), num_slots)
    arrays are row-aligned with ``order`` (the input indices, regrouped
    by exact template so each template's rows embed in one vectorized
    ``lower_population`` call).  The shared front half of every bucketed
    dispatch (``Sparseloop.evaluate_batch``, ``mapper._search_batched``)."""
    per_template: dict[NestTemplate, list[int]] = {}
    for i in idxs:
        per_template.setdefault(template_of(nests[i]), []).append(i)
    all_bounds, all_ids, order = [], [], []
    for template, t_idxs in per_template.items():
        rows = np.stack([template.bounds_of(nests[i]) for i in t_idxs])
        pb, pi = bucket.lower_population(template, rows)
        all_bounds.append(pb)
        all_ids.append(pi)
        order.extend(t_idxs)
    return np.concatenate(all_bounds), np.concatenate(all_ids), order


# ----------------------------------------------------------------------
# Elementwise helpers: per-candidate values are (C,) tensors, but parts
# of the model stay Python floats where a static structure makes them
# constant (no spatial loop at a level, an uncompressed format, ...).
# ----------------------------------------------------------------------
def _prod(xs):
    out = 1.0
    for x in xs:
        out = out * x
    return out


def _max(a, b):
    """``max`` of tensors and Python floats.  On the gradient path a tie
    splits the gradient in half between the two sides, as
    ``torch.maximum`` and the JAX package's ``jnp.maximum`` do (a Python
    float side takes its half with it); off it, a float side is one
    ``torch.clamp``, which would pass the whole gradient at a tie."""
    if isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor):
            if not a.requires_grad:
                return torch.clamp(a, min=b)
            b = torch.full_like(a, b)
        return torch.maximum(a, b)
    if isinstance(b, torch.Tensor):
        return _max(b, a)
    return max(a, b)


def _min(a, b):
    """``min`` of tensors and Python floats, with :func:`_max`'s tie
    rule."""
    if isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor):
            if not a.requires_grad:
                return torch.clamp(a, max=b)
            b = torch.full_like(a, b)
        return torch.minimum(a, b)
    if isinstance(b, torch.Tensor):
        return _min(b, a)
    return min(a, b)


def _where(cond, a, b):
    """``torch.where`` that also takes a Python bool condition (a static
    structure, e.g. a format without metadata)."""
    if not isinstance(cond, torch.Tensor):
        return a if cond else b
    return torch.where(cond, a, b)


def _suffix_any(mask):
    """suffix_any[..., j] = any(mask[..., j:]) — the reuse-boundary scan
    over the slot (last) axis."""
    return torch.flip(torch.cumsum(torch.flip(mask, (-1,)).to(torch.int32),
                                   -1), (-1,)) > 0


def _union_b(probs_by_leader: dict):
    keep = 1.0
    for p in probs_by_leader.values():
        keep = keep * (1.0 - p)
    return 1.0 - keep


def _merge_b(dst: dict, leader: str, p) -> None:
    dst[leader] = _max(dst.get(leader, 0.0), p)


@dataclasses.dataclass
class _Breakdown:
    actual: object = 0.0
    gated: object = 0.0
    skipped: object = 0.0


#: metric columns of one evaluation, in the order of the packed
#: device-to-host copy; per-level ``occupancy`` columns follow them
_METRICS = ("cycles", "energy_pj", "edp", "valid", "compute_actual",
            "compute_gated", "compute_skipped", "dense_computes")


# ----------------------------------------------------------------------
# Shared program registry.  A "program" is keyed by (arch TOPOLOGY + SAF
# structure, workload STRUCTURE, caps, template-or-bucket,
# check_capacity) — never by rank bounds, density values, architecture
# scalars or device, which ride in as WorkloadParams / ArchParams
# tensors.  Model facades (BatchedModel / BucketedModel) bind a concrete
# (workload, design, device)'s params to a shared program.
# ----------------------------------------------------------------------
@dataclasses.dataclass
class _ProgramRecord:
    """One program: the batched function plus its compile bookkeeping,
    shared by every facade whose structure key matches."""

    kind: str
    fn: object                         # (batch_args, wp) -> metric dict
    compiled: set = dataclasses.field(default_factory=set)

    def note_compile(self, shape_key) -> bool:
        """The first evaluation at a (device, shape) is the "compile"
        call (it pays device context and allocator warm-up, as XLA's
        compile did in the JAX package).  Returns True on that first
        sighting so the caller attributes its wall-clock to compile time
        instead of warm-eval time."""
        with _CACHE_LOCK:
            if shape_key not in self.compiled:
                self.compiled.add(shape_key)
                compile_stats.record_compile(self.kind)
                return True
            return False


_PROGRAM_CACHE: dict = {}
_PROGRAM_CACHE_CAP = 128

#: guards _PROGRAM_CACHE / _MODEL_CACHE lookup-and-insert, the
#: per-record compile bookkeeping and the per-device caches (constants,
#: workload leaves, arch rows), which a service's evaluator thread and
#: direct callers may fill at once (an RLock because a facade
#: constructor under _CACHE_LOCK re-enters _init_program)
_CACHE_LOCK = threading.RLock()


class _TracedNestModel:
    """Shared three-step program over a static slot *shape*.

    The per-candidate inputs are the slot bounds ``b`` (C, num_slots) and
    a per-slot rank one-hot ``oh`` — (num_slots, R) for an exact template
    or (C, num_slots, R) for a bucket.  Everything rank-keyed in the
    scalar model (tile bounds, relevance, leader windows) becomes a
    (C, R) tensor masked by ``oh``; unit-bound slots are inert regardless
    of their rank id, which is what makes bucket padding free.
    """

    kind = "program"

    def __init__(self, design, workload: Workload,
                 slot_levels: tuple[int, ...],
                 slot_spatial: tuple[bool, ...], num_levels: int,
                 check_capacity: bool = True,
                 caps: DensityCaps | None = None, device=None):
        arch: Architecture = design.arch
        if num_levels != arch.num_levels:
            raise ValueError(
                f"nest shape has {num_levels} levels, architecture "
                f"{arch.name} has {arch.num_levels}")
        self.device = resolve_device(device)
        self.design = design
        self.arch = arch
        self.safs: SAFSpec = design.safs
        self.workload = workload
        self.slot_levels = tuple(slot_levels)
        self.slot_spatial = tuple(slot_spatial)
        self.num_slots = len(slot_levels)
        self.check_capacity = check_capacity
        self.level_names = [arch.level(s).name
                            for s in range(arch.num_levels)]
        self.ranks: tuple[str, ...] = tuple(workload.rank_bounds)
        self._ridx = {r: i for i, r in enumerate(self.ranks)}
        self._rel = {
            t.name: np.asarray([r in t.ranks for r in self.ranks])
            for t in workload.tensors
        }
        self._tidx = {t.name: i for i, t in enumerate(workload.tensors)}
        # this facade's workload inputs (kind ids, parameter vectors,
        # histograms, rank bounds) — the per-layer data bound to the
        # structure-shared program at evaluation time
        self.workload_params = pack_workload_params(workload, caps)
        self.caps = self.workload_params.caps
        # ... and its architecture inputs (capacities, bandwidths,
        # energies, PE counts) — the per-design data bound the same way
        self.arch_params = pack_arch_params(arch)
        self.arch_key = arch_structure(arch)
        self._stats = TracedDensityStats(self.caps)
        self._consts: dict = {}
        self._prog: _ProgramRecord | None = None
        self.program_shared = False

    # ------------------------------------------------------------------
    def _init_program(self, token) -> None:
        """Fetch or create the shared program.  ``token`` completes the
        structural identity (the exact template for BatchedModel — its
        rank one-hot is a constant — or the bucket for BucketedModel).

        The record's function is bound to a *detached* shallow copy of
        this facade with the per-layer/per-design state stripped: the
        program only reads structural attributes (slot shape, rel masks,
        stats, one-hot), so the cache must not pin this facade's
        workload_params / arch_params for the program's lifetime."""
        key = (topology_key(self.design.arch, self.safs),
               workload_structure(self.workload),
               self.caps, self.check_capacity, token)
        with _CACHE_LOCK:
            rec = _PROGRAM_CACHE.get(key)
            if rec is None:
                with obs.span("engine.program", kind=self.kind,
                              workload=self.workload.name):
                    host = copy.copy(self)
                    host.workload_params = None  # drop the heavy arrays
                    host.arch_params = None
                    host._prog = None
                    host._consts = {}
                    rec = _ProgramRecord(kind=self.kind, fn=host._batched)
                compile_stats.record_program(self.kind)
                if len(_PROGRAM_CACHE) >= _PROGRAM_CACHE_CAP:
                    _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))
                _PROGRAM_CACHE[key] = rec
            else:
                compile_stats.record_program_share(rec.kind)
                self.program_shared = True
            self._prog = rec

    def _const(self, dev, key, make):
        """A structural constant (mask, index vector) as a tensor on
        ``dev``, made once per device so evaluations copy nothing."""
        k = (str(dev), key)
        out = self._consts.get(k)
        if out is None:
            with _CACHE_LOCK:
                out = self._consts.get(k)
                if out is None:
                    out = self._consts[k] = make()
        return out

    def _check_params(self, workload_params: WorkloadParams | None
                      ) -> WorkloadParams:
        """Validate the workload params (the facade's own by default)."""
        wp = workload_params or self.workload_params
        if wp.caps != self.caps:
            raise ValueError(
                f"workload_params caps {wp.caps} != program caps "
                f"{self.caps}; pack with the program's caps "
                f"(common_caps of the sweep)")
        if wp.structure and wp.structure != workload_structure(
                self.workload):
            raise ValueError(
                "workload_params were packed for a different workload "
                "structure (rank names / projections / output) than "
                "this program's — metrics would be silently wrong")
        if len(wp.rank_bounds) != len(self.ranks) or \
                len(wp.model_ids) != len(self.workload.tensors):
            raise ValueError("workload_params shape does not match the "
                             "program's workload structure")
        return wp

    def _bind_params(self, workload_params: WorkloadParams | None
                     ) -> tuple:
        """Validate the workload params and return their leaves on this
        facade's device."""
        return self._check_params(workload_params).device_leaves(
            self.device)

    def _bind_arch(self, arch_params: ArchParams | None,
                   n: int) -> ArchParams:
        """Validate arch params against the program's topology: one
        unbatched params object binds one design to the whole population
        (the facade's own arch by default), a batched one binds one
        design point per candidate (mixed-design co-search)."""
        ap = arch_params or self.arch_params
        if ap.structure and ap.structure != self.arch_key:
            raise ValueError(
                "arch_params were packed for a different architecture "
                "topology (level names / compute) than this program's "
                f"({ap.structure} != {self.arch_key}) — metrics would "
                "be silently wrong")
        S = self.arch.num_levels
        if tuple(ap.storage.shape[-2:]) != (S, len(STORAGE_FIELDS)):
            raise ValueError(
                f"arch_params storage shape {tuple(ap.storage.shape)} "
                f"does not match the program's {S} storage levels")
        if ap.batched and len(ap.storage) != n:
            raise ValueError(
                f"batched arch_params carry {len(ap.storage)} candidate "
                f"rows, population has {n}")
        return ap

    def _upload(self, cols, ap: ArchParams, n: int, dev=None):
        """One host-to-device copy per evaluation (or shard): the (C, k)
        integer columns (bounds, rank ids) and any host-side
        per-candidate arch rows, packed into one float64 array and
        copied to ``dev`` (this facade's device by default).  Returns
        the column blocks as device tensors plus the per-candidate
        ``(storage (C, S, F), compute (C, 4))`` rows."""
        dev = self.device if dev is None else dev
        S, F = self.arch.num_levels, len(STORAGE_FIELDS)
        host = [np.asarray(c, np.float64).reshape(n, -1) for c in cols]
        arch_on_host = ap.batched and not isinstance(ap.storage,
                                                     torch.Tensor)
        if arch_on_host:
            host += [np.asarray(ap.storage, np.float64).reshape(n, S * F),
                     np.asarray(ap.compute, np.float64).reshape(n, -1)]
        packed = torch.from_numpy(np.ascontiguousarray(
            np.concatenate(host, axis=1))).to(dev)
        widths = [h.shape[1] for h in host]
        parts = list(torch.split(packed, widths, dim=1))
        if arch_on_host:
            comp = parts.pop()
            storage = parts.pop().reshape(n, S, F)
        elif ap.batched:
            storage = torch.as_tensor(ap.storage, dtype=F64, device=dev)
            comp = torch.as_tensor(ap.compute, dtype=F64, device=dev)
        else:
            storage, comp = _device_arch_rows(ap, dev)
            storage = storage.expand(n, S, F)
            comp = comp.expand(n, comp.shape[-1])
        return parts, (storage, comp)

    def _run(self, fn, batch_args, wp, shape_key,
             n: int) -> dict[str, np.ndarray]:
        """Invoke the program and attribute its wall-clock.

        The first (program, device, shape) sighting is the "compile"
        call (``note_compile``): its seconds go to
        ``compile_stats.compile_seconds`` and span ``engine.compile``,
        every later call at the shape to ``eval_seconds`` and span
        ``engine.eval``.  The packed device-to-host copy waits for the
        device, so the interval is host->device->host inclusive."""
        is_new = self._prog.note_compile((str(self.device),)
                                         + tuple(shape_key))
        t0 = time.perf_counter()
        with obs.span("engine.compile" if is_new else "engine.eval",
                      kind=self.kind, workload=self.workload.name,
                      candidates=n, shape=shape_key):
            packed, layout = _pack(fn(batch_args, wp), n)
            packed = packed.cpu().numpy()
        _record_seconds(is_new, time.perf_counter() - t0)
        return _unpack(packed, layout)

    def _evaluate(self, cols, ap: ArchParams, workload_params,
                  mesh: PopulationMesh | None) -> dict[str, np.ndarray]:
        """The shared body of ``evaluate``: bind, count, then run the
        program on this facade's device, or sharded over ``mesh``."""
        n = len(cols[0])
        if mesh is not None and mesh.devices[0] != self.device:
            raise ValueError(f"mesh {mesh} does not start at this "
                             f"model's device {self.device}")
        wp = self._check_params(workload_params)
        ap = self._bind_arch(ap, n)
        # count only after the params bound — a rejected population
        # must not inflate the counters
        compile_stats.record_batched_evals(n, shared=self.program_shared)
        if mesh is None or mesh.size <= 1:
            parts, ap_rows = self._upload(cols, ap, n)
            return self._run(self._prog.fn, (*parts, ap_rows),
                             wp.device_leaves(self.device),
                             tuple(np.shape(cols[0])), n)
        return self._run_sharded(cols, ap, wp, n, mesh)

    def _run_sharded(self, cols, ap: ArchParams, wp: WorkloadParams,
                     n: int, mesh: PopulationMesh) -> dict[str, np.ndarray]:
        """The program over ``mesh``: pad to a multiple of its size by
        repeating the last candidate, one copy and one program per
        shard on its device, every shard issued in turn before the
        first device-to-host copy, the results concatenated in
        candidate order and the padding stripped.  One
        ``engine.compile`` / ``engine.eval`` span carries ``shards``;
        the first sighting of (sharded, size, padded shape) is the
        compile call, as the JAX package keys it."""
        m = mesh.size
        total = n + (-n) % m
        k = total // m
        take = np.minimum(np.arange(total), n - 1)
        cols = [np.asarray(c)[take] for c in cols]
        if ap.batched:
            ap = ap.take(torch.as_tensor(take) if isinstance(
                ap.storage, torch.Tensor) else take)
        shape_key = ("sharded", m, (total,) + tuple(cols[0].shape[1:]))
        is_new = self._prog.note_compile(shape_key)

        def issue(i):
            dev = mesh.devices[i]
            sl = slice(i * k, (i + 1) * k)
            shard_ap = ap.take(sl) if ap.batched else ap
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                parts, ap_rows = self._upload([c[sl] for c in cols],
                                              shard_ap, k, dev)
                return _pack(self._prog.fn((*parts, ap_rows),
                                           wp.device_leaves(dev)), k)

        t0 = time.perf_counter()
        with obs.span("engine.compile" if is_new else "engine.eval",
                      kind=self.kind, workload=self.workload.name,
                      candidates=n, shape=shape_key, shards=m):
            packs = [issue(i) for i in range(m)]
            layout = packs[0][1]
            packed = np.concatenate([p.cpu().numpy() for p, _ in packs])
        _record_seconds(is_new, time.perf_counter() - t0)
        return _unpack(packed[:n], layout)

    # ------------------------------------------------------------------
    # The batched program.  Mirrors analyze_dataflow / analyze_sparse /
    # evaluate_microarch line by line; any change to the scalar model
    # must be reflected here (the parity tests pin it).
    # ------------------------------------------------------------------
    def _single(self, b, oh, wp, ap):
        wl = self.workload
        levels = self.slot_levels
        S = self.arch.num_levels
        R = len(self.ranks)
        expanded = self.safs.expand_double_sided()
        zname = wl.output
        C = b.shape[0]
        dev = b.device

        # workload data: rank bounds + per-tensor density params
        rb, mids, dparams, hists, kinds = wp
        # architecture data: per-candidate level rows (STORAGE_FIELDS
        # columns, innermost-first) + compute rows (COMPUTE_FIELDS)
        storage, comp = ap
        stats = self._stats
        tidx = self._tidx
        rel_of = {name: self._const(dev, ("rel", name),
                                    lambda v=v: torch.as_tensor(
                                        v, device=dev))
                  for name, v in self._rel.items()}

        def idx(js):
            return self._const(dev, ("idx", tuple(js)),
                               lambda: torch.as_tensor(
                                   js, dtype=torch.int64, device=dev))

        def d_pe(name, tile):
            i = tidx[name]
            return stats.prob_empty(mids[i], dparams[i], hists[i], tile,
                                    kinds=(kinds[i],))

        def d_ed(name, tile):
            i = tidx[name]
            return stats.expected_density(mids[i], dparams[i], hists[i],
                                          tile, kinds=(kinds[i],))

        def d_mx(name, tile):
            i = tidx[name]
            return stats.max_nnz(mids[i], dparams[i], hists[i], tile,
                                 kinds=(kinds[i],))

        def total_size(t: TensorSpec):
            """``t.size(rank_bounds)`` from the bounds vector."""
            return _prod(
                sum(rb[self._ridx[r]] for r in dim) - (len(dim) - 1)
                for dim in t.projection)

        temporal = [j for j in range(self.num_slots)
                    if not self.slot_spatial[j]]
        spatial = [j for j in range(self.num_slots) if self.slot_spatial[j]]

        def spatial_at(level):
            return [j for j in spatial if levels[j] == level]

        def instances_of(level):
            return _prod(b[:, j] for j in spatial if levels[j] > level)

        def rank_is(j, rel_vec):
            """Is slot j's rank relevant to ``rel_vec``? (per candidate)"""
            return (oh[..., j, :] & rel_vec).any(-1)

        def masked_prod(js):
            """(C, R) per-rank bound product over a static slot subset:
            the tensor form of the rank-keyed tile-bound dicts."""
            if not js:
                return torch.ones(R, dtype=F64, device=dev)
            sel = idx(js)
            return torch.where(oh[..., sel, :], b[:, sel, None],
                               1.0).prod(-2)

        # ---------------- step 1: dataflow (dense traffic) ----------------
        def fetch_counts(child_level, rel_vec):
            """(rounds, distinct) tile-fetch counts into child_level; the
            reuse prefix ends at the innermost relevant *non-unit* loop."""
            js = [j for j in temporal if levels[j] > child_level]
            if not js:
                return 1.0, 1.0
            sel = idx(js)
            bs = b[:, sel]
            rel_arr = (oh[..., sel, :] & rel_vec).any(-1)
            in_prefix = _suffix_any(rel_arr & (bs > 1))
            rounds = torch.where(in_prefix, bs, 1.0).prod(-1)
            distinct = torch.where(in_prefix & rel_arr, bs, 1.0).prod(-1)
            return rounds, distinct

        # per-level resident-tile bounds as (C, R) tensors — independent
        # of the tensor, so hoisted out of the per-tensor loop
        tbv = [masked_prod([j for j in range(self.num_slots)
                            if levels[j] <= s]) for s in range(S)]
        ones_r = torch.ones(R, dtype=F64, device=dev)

        def tile_dims(t: TensorSpec, tb):
            return tuple(
                sum(tb[..., self._ridx[r]] for r in dim) - (len(dim) - 1)
                for dim in t.projection)

        def tile_size(t: TensorSpec, tb):
            return _prod(tile_dims(t, tb))

        total_temporal = _prod(b[:, j] for j in temporal)
        total_spatial = _prod(b[:, j] for j in spatial)
        dense_computes = total_temporal * total_spatial

        dense: dict[tuple[str, int], dict] = {}
        for t in wl.tensors:
            rel = rel_of[t.name]
            is_out = t.name == zname
            for s in range(S):
                tb = tbv[s]
                tdims = tile_dims(t, tb)
                tsize = _prod(tdims)
                tl = dict(tile_dims=tdims, tile_size=tsize,
                          fill_words=0.0, partial_fill_words=0.0,
                          read_words=0.0, read_rounds=1.0,
                          update_words=0.0, rmw_read_words=0.0,
                          writeback_words=0.0,
                          instances=instances_of(s))

                rounds, distinct = fetch_counts(s, rel)
                if s < S - 1:
                    if not is_out:
                        tl["fill_words"] = rounds * tsize
                    else:
                        tl["partial_fill_words"] = (rounds - distinct) * tsize

                child = s - 1
                child_tb = tbv[child] if child >= 0 else ones_r
                c_rounds, c_distinct = fetch_counts(child, rel)
                served_tb = child_tb
                for j in spatial_at(s):
                    served_tb = served_tb * torch.where(
                        oh[..., j, :] & rel, b[:, j, None], 1.0)
                served_words = tile_size(t, served_tb)
                tl["read_rounds"] = c_rounds
                if not is_out:
                    tl["read_words"] = c_rounds * served_words
                else:
                    child_tile = tile_size(t, child_tb)
                    spatial_rel = _prod(
                        torch.where(rank_is(j, rel), b[:, j], 1.0)
                        for j in spatial_at(s))
                    tl["read_words"] = ((c_rounds - c_distinct) * child_tile
                                        * spatial_rel if s > 0 else 0.0)

                if is_out:
                    fanout = _prod(b[:, j] for j in spatial_at(s))
                    if s == 0:
                        tl["update_words"] = (total_temporal
                                              * _max(1.0, fanout))
                    else:
                        ce, _cd = fetch_counts(s - 1, rel)
                        child_tile = tile_size(t, tbv[s - 1])
                        tl["update_words"] = fanout * ce * child_tile
                    if s < S - 1:
                        tl["rmw_read_words"] = _max(
                            0.0, tl["update_words"] - distinct * tsize)
                        tl["writeback_words"] = rounds * tsize
                    else:
                        tl["rmw_read_words"] = _max(
                            0.0, tl["update_words"]
                            - total_size(t)
                            / _max(1.0, tl["instances"]))

                dense[(t.name, s)] = tl

        # ---------------- step 2: sparse filtering ----------------
        def leader_window_bounds(level, follower_rel):
            """Per-rank leader-intersection window (dataflow.
            leader_tile_bounds), with unit loops treated as absent."""
            bounds = masked_prod([j for j in range(self.num_slots)
                                  if levels[j] < level])
            outer = [j for j in temporal if levels[j] >= level]
            if outer:
                sel = idx(outer)
                bs = b[:, sel]
                rels = (oh[..., sel, :] & follower_rel).any(-1)
                include = ~_suffix_any(rels & (bs > 1))
                bounds = bounds * torch.where(
                    oh[..., sel, :] & include[..., None], bs[..., None],
                    1.0).prod(-2)
            return bounds

        def leader_prob(follower: TensorSpec, level_idx, lname: str):
            leader = wl.tensor(lname)
            bounds = leader_window_bounds(level_idx, rel_of[follower.name])
            tile = _max(1.0, tile_size(leader, bounds))
            return d_pe(lname, tile)

        skip_ev: dict[tuple[str, int], dict] = {}
        gate_ev: dict[tuple[str, int], dict] = {}
        comp_skip_ev: dict[str, float] = {}
        comp_gate_ev: dict[str, float] = {}

        for saf in expanded:
            if saf.level == "compute":
                for lname in saf.leaders:
                    p = 1.0 - d_ed(lname, 1.0)
                    dst = (comp_skip_ev if saf.kind == SAFKind.SKIP
                           else comp_gate_ev)
                    _merge_b(dst, lname, p)
                continue
            lvl = self.level_names.index(saf.level)
            key = (saf.follower, lvl)
            follower = wl.tensor(saf.follower)
            for lname in saf.leaders:
                p = leader_prob(follower, lvl, lname)
                dst = skip_ev if saf.kind == SAFKind.SKIP else gate_ev
                dst.setdefault(key, {})
                _merge_b(dst[key], lname, p)

        local: dict[tuple[str, int], tuple] = {}
        for t in wl.tensors:
            for s in range(S):
                sk = _union_b(skip_ev.get((t.name, s), {}))
                gt = _max(
                    0.0, _union_b({**gate_ev.get((t.name, s), {}),
                                   **skip_ev.get((t.name, s), {})}) - sk)
                local[(t.name, s)] = (sk, gt)

        z_round: dict[int, tuple] = {}
        for s in range(S):
            r_skip: dict[str, object] = {}
            r_gate: dict[str, object] = {}
            for saf in expanded:
                if saf.follower != zname or saf.level == "compute":
                    continue
                for lname in saf.leaders:
                    leader = wl.tensor(lname)
                    bounds = leader_window_bounds(s + 1, rel_of[zname])
                    tile = _max(1.0, tile_size(leader, bounds))
                    p = d_pe(lname, tile)
                    dst = r_skip if saf.kind == SAFKind.SKIP else r_gate
                    _merge_b(dst, lname, p)
            sk = _union_b(r_skip)
            gt = _max(0.0, _union_b({**r_gate, **r_skip}) - sk)
            z_round[s] = (sk, gt)

        live_frac: dict[tuple[str, int], object] = {}
        gated_from_above: dict[tuple[str, int], object] = {}
        for t in wl.tensors:
            not_skipped, live = 1.0, 1.0
            for s in range(S - 1, -1, -1):
                live_frac[(t.name, s)] = live
                gated_from_above[(t.name, s)] = not_skipped - live
                sk, gt = local[(t.name, s)]
                not_skipped = not_skipped * (1.0 - sk)
                live = live * _max(0.0, 1.0 - sk - gt)
            live_frac[(t.name, -1)] = live
            gated_from_above[(t.name, -1)] = not_skipped - live

        impl_skip0: dict[str, object] = {}
        impl_gate0: dict[str, object] = {}
        for t in wl.tensors:
            for s in range(S):
                for lname, p in skip_ev.get((t.name, s), {}).items():
                    _merge_b(impl_skip0, lname, p)
                for lname, p in gate_ev.get((t.name, s), {}).items():
                    _merge_b(impl_gate0, lname, p)
        for lname, p in comp_skip_ev.items():
            _merge_b(impl_skip0, lname, p)
        for lname, p in comp_gate_ev.items():
            _merge_b(impl_gate0, lname, p)
        c_skip = _union_b(impl_skip0)
        c_gate = _max(
            0.0, _union_b({**impl_gate0, **impl_skip0}) - c_skip)
        c_act = _max(0.0, 1.0 - c_skip - c_gate)

        # ---- format analyzer (formats.analyze_tile_format, batched) ----
        def fmt_stats(fmt, dims, tname: str):
            dims = list(dims) or [1.0]
            nfr = len(fmt.rank_formats)
            if len(dims) < nfr:
                dims = [1.0] * (nfr - len(dims)) + dims
            elif len(dims) > nfr:
                head = _prod(dims[: len(dims) - nfr + 1])
                dims = [head] + dims[len(dims) - nfr + 1:]
            tsize = _prod(dims)
            payload = [_prod(dims[i + 1:]) for i in range(len(dims))]

            meta_avg = meta_max = 0.0
            fibers_avg, fibers_max = 1.0, 1.0
            for i, (rf, d, sz) in enumerate(
                    zip(fmt.rank_formats, dims, payload)):
                coords_avg = fibers_avg * d
                coords_max = fibers_max * d
                p_ne = 1.0 - d_pe(tname, _max(1.0, sz))
                n_blocks = _prod(dims[: i + 1])
                occ_avg = _min(coords_avg, n_blocks * p_ne)
                occ_max = _max(0.0, _min(
                    coords_max,
                    torch.ceil(d_mx(tname, tsize) / _max(1.0, sz))))

                cb = float(fmt.coord_bits)
                if rf == RankFormat.U:
                    bits_avg = bits_max = 0.0
                    occ_avg, occ_max = coords_avg, coords_max
                elif rf in (RankFormat.B, RankFormat.UB):
                    bits_avg = fibers_avg * d
                    bits_max = fibers_max * d
                    if rf == RankFormat.UB:
                        occ_avg, occ_max = coords_avg, coords_max
                elif rf in (RankFormat.CP, RankFormat.RLE):
                    bits_avg = occ_avg * cb
                    bits_max = occ_max * cb
                elif rf == RankFormat.UOP:
                    bits_avg = fibers_avg * 2.0 * cb
                    bits_max = fibers_max * 2.0 * cb
                else:  # pragma: no cover
                    raise BatchedUnsupported(f"rank format {rf}")
                meta_avg = meta_avg + bits_avg
                meta_max = meta_max + bits_max
                fibers_avg, fibers_max = occ_avg, occ_max

            if fmt.is_uncompressed:
                data_avg = data_max = tsize * 1.0
            else:
                data_avg = _min(tsize * 1.0, d_ed(tname, tsize) * tsize)
                data_max = _min(tsize * 1.0, d_mx(tname, tsize))
            return dict(meta_avg=meta_avg, meta_max=meta_max,
                        data_avg=data_avg, data_max=data_max,
                        tile_size=tsize)

        # ---- per-(tensor, level) sparse assembly ----
        sparse: dict[tuple[str, int], dict] = {}
        for t in wl.tensors:
            is_out = t.name == zname
            for s in range(S):
                tl = dense[(t.name, s)]
                fmt = self.safs.format_for(self.level_names[s], t.name)
                fs = fmt_stats(fmt, tl["tile_dims"], t.name)

                live = live_frac[(t.name, s)]
                g_above = gated_from_above[(t.name, s)]
                sk, gt = local[(t.name, s)]
                act_f = live * _max(0.0, 1.0 - sk - gt)
                gate_f = live * gt + g_above
                skip_f = _max(0.0, 1.0 - act_f - gate_f)
                a_act = live
                a_gate = g_above
                a_skip = _max(0.0, 1.0 - a_act - a_gate)

                density_scale = (fs["data_avg"]
                                 / _max(1.0, fs["tile_size"])
                                 if fmt.compressed else 1.0)

                def bd(dense_words, fr=None,
                       _fr0=(act_f, gate_f, skip_f), _ds=density_scale):
                    fa, fg, fsk = fr if fr else _fr0
                    moved = dense_words * _ds
                    return _Breakdown(actual=moved * fa, gated=moved * fg,
                                      skipped=moved * fsk)

                if is_out:
                    if s == 0:
                        upd_fr = (c_act, c_gate, c_skip)
                    else:
                        live_c = live_frac[(t.name, s - 1)]
                        g_c = gated_from_above[(t.name, s - 1)]
                        sk_c, gt_c = z_round[s - 1]
                        ac = live_c * _max(0.0, 1.0 - sk_c - gt_c)
                        gc = live_c * gt_c + g_c
                        upd_fr = (ac, gc, _max(0.0, 1.0 - ac - gc))
                    updates = bd(tl["update_words"], upd_fr)
                    distinct_words = (tl["update_words"]
                                      - tl["rmw_read_words"])
                    rmw = _max(0.0, updates.actual - distinct_words)
                    sk_r, gt_r = z_round[s]
                    wa = live * _max(0.0, 1.0 - sk_r - gt_r)
                    wg = live * gt_r + g_above
                    wb_fr = (wa, wg, _max(0.0, 1.0 - wa - wg))
                    wb = bd(tl["writeback_words"], wb_fr)
                    pf = bd(tl["partial_fill_words"], wb_fr)
                    reads = _Breakdown(actual=wb.actual + rmw,
                                       gated=wb.gated, skipped=wb.skipped)
                    fills = pf
                else:
                    reads = bd(tl["read_words"])
                    fills = bd(tl["fill_words"], (a_act, a_gate, a_skip))
                    updates = _Breakdown()

                meta_per_word = (fs["meta_avg"]
                                 / _max(1e-9, fs["data_avg"])
                                 / WORD_BITS)
                has_meta = fs["meta_avg"] > 0
                meta_reads = _where(
                    has_meta, (reads.actual + reads.gated) * meta_per_word,
                    0.0)
                meta_fills = _where(
                    has_meta,
                    (fills.actual + fills.gated
                     + updates.actual + updates.gated) * meta_per_word,
                    0.0)

                sparse[(t.name, s)] = dict(
                    reads=reads, fills=fills, updates=updates,
                    meta_reads=meta_reads, meta_fills=meta_fills,
                    occ_max=fs["data_max"] + fs["meta_max"] / WORD_BITS,
                    instances=tl["instances"])

        # ---- intersection-check overhead (leader metadata scans) ----
        for saf in expanded:
            if saf.level == "compute":
                continue
            lvl = self.level_names.index(saf.level)
            follower = wl.tensor(saf.follower)
            rounds = dense[(saf.follower, lvl)]["read_rounds"]
            for lname in saf.leaders:
                leader = wl.tensor(lname)
                bounds = leader_window_bounds(lvl, rel_of[follower.name])
                ldims = tile_dims(leader, bounds)
                lfmt = self.safs.format_for(self.level_names[lvl], lname)
                ls = fmt_stats(lfmt, ldims, lname)
                bits = _where(ls["meta_avg"] > 0, ls["meta_avg"],
                              ls["tile_size"] * 1.0)
                sparse[(saf.follower, lvl)]["meta_reads"] = (
                    sparse[(saf.follower, lvl)]["meta_reads"]
                    + rounds * bits / WORD_BITS)

        compute_actual = dense_computes * c_act
        compute_gated = dense_computes * c_gate
        compute_skipped = dense_computes * c_skip

        # ---------------- step 3: micro-architecture ----------------
        valid = torch.ones(C, dtype=torch.bool, device=dev)
        energy = 0.0
        worst_cycles = 0.0
        occupancies = []
        for s in range(S):
            cap, bw, e_read, e_write, e_gated, e_meta = (
                storage[:, s, c] for c in range(len(STORAGE_FIELDS)))
            ra = rg = wa = wg = meta = occ = 0.0
            inst = 1.0
            for t in wl.tensors:
                st = sparse[(t.name, s)]
                inst = _max(inst, st["instances"])
                ra = ra + st["reads"].actual
                rg = rg + st["reads"].gated
                wa = wa + st["fills"].actual + st["updates"].actual
                wg = wg + st["fills"].gated + st["updates"].gated
                meta = meta + st["meta_reads"] + st["meta_fills"]
                occ = occ + st["occ_max"]
            occupancies.append(occ * torch.ones(C, dtype=F64, device=dev))
            if self.check_capacity:
                # an infinite level passes trivially, matching the
                # scalar engine's skip-inf-levels behavior
                valid = valid & (occ <= cap)
            energy = energy + inst * (
                ra * e_read + wa * e_write + (rg + wg) * e_gated
                + meta * e_meta)
            cyc = (ra + rg + wa + wg + meta) / bw
            worst_cycles = _max(worst_cycles, cyc)

        pe_inst, pe_mac_e, pe_gated_e, pe_throughput = (
            comp[:, c] for c in range(len(COMPUTE_FIELDS)))
        n_inst = torch.minimum(
            torch.clamp(total_spatial * torch.ones(C, dtype=F64,
                                                   device=dev), min=1.0),
            pe_inst)
        compute_cycles = ((compute_actual + compute_gated)
                          / (n_inst * pe_throughput))
        energy = energy + (compute_actual * pe_mac_e
                           + compute_gated * pe_gated_e)
        cycles = _max(worst_cycles, compute_cycles)

        def col(x):
            return x * torch.ones(C, dtype=F64, device=dev)

        return {
            "cycles": col(cycles),
            "energy_pj": col(energy),
            "edp": col(cycles * energy),
            "valid": valid,
            "compute_actual": col(compute_actual),
            "compute_gated": col(compute_gated),
            "compute_skipped": col(compute_skipped),
            "dense_computes": col(dense_computes),
            # per-storage-level words held at peak (innermost-first):
            # what the capacity check compares against
            "occupancy": torch.stack(occupancies, 1),
        }


def _pack(res: dict, n: int) -> tuple:
    """A program's metric dict as one (n, w) float64 device tensor (the
    one device-to-host copy) and its layout: ``(key, per-candidate
    shape)`` of every block after the scalar metrics."""
    # any further per-candidate outputs (the arch gradient's loss and
    # gradient rows) ride in the same copy
    extra = [k for k in res if k not in _METRICS and k != "occupancy"]
    blocks = [torch.stack([res[k].to(F64) for k in _METRICS], 1),
              res["occupancy"]] + [res[k].to(F64).reshape(n, -1)
                                   for k in extra]
    layout = [(k, tuple(res[k].shape[1:])) for k in ["occupancy"] + extra]
    return torch.cat(blocks, dim=1), layout


def _unpack(packed: np.ndarray, layout) -> dict[str, np.ndarray]:
    """:func:`_pack`'s array, copied to the host, as the metric dict."""
    n = len(packed)
    out = {k: packed[:, i].copy() for i, k in enumerate(_METRICS)}
    out["valid"] = out["valid"] != 0
    j = len(_METRICS)
    for k, shape in layout:
        width = int(np.prod(shape, dtype=np.int64))
        out[k] = packed[:, j: j + width].reshape((n,) + shape).copy()
        j += width
    return out


def _record_seconds(is_new: bool, dt: float) -> None:
    if is_new:
        compile_stats.record_compile_seconds(dt)
    else:
        compile_stats.record_eval_seconds(dt)


def _device_arch_rows(ap: ArchParams, dev) -> tuple:
    """An unbatched design's (storage (S, F), compute (4,)) rows on
    ``dev``, copied once per params object and device."""
    key = str(dev)
    cache = ap.__dict__.get("_device_rows")
    if cache is not None and key in cache:
        return cache[key]
    with _CACHE_LOCK:
        cache = ap.__dict__.get("_device_rows")
        if cache is None:
            cache = {}
            object.__setattr__(ap, "_device_rows", cache)
        if key not in cache:
            cache[key] = (
                torch.as_tensor(ap.storage, dtype=F64, device=dev),
                torch.as_tensor(ap.compute, dtype=F64, device=dev))
        return cache[key]


def _check_bounds(bounds, num_slots: int) -> np.ndarray:
    bounds = np.asarray(bounds)
    if bounds.ndim != 2 or bounds.shape[1] != num_slots:
        raise ValueError(
            f"bounds must be (C, {num_slots}), got {bounds.shape}")
    return bounds


class BatchedModel(_TracedNestModel):
    """Batched evaluator for one (design, workload, template, device).

    ``evaluate(bounds)`` takes an (C, num_slots) integer array of per-slot
    loop bounds and returns per-candidate metric arrays.  Reuse the
    instance across calls (``Sparseloop.evaluate_batch`` and
    ``mapper.search`` do, through the content cache).
    """

    kind = "template"

    def __init__(self, design, workload: Workload, template: NestTemplate,
                 check_capacity: bool = True,
                 caps: DensityCaps | None = None, device=None):
        super().__init__(
            design, workload,
            slot_levels=tuple(lvl for _, lvl, _ in template.slots),
            slot_spatial=tuple(sp for _, _, sp in template.slots),
            num_levels=template.num_levels,
            check_capacity=check_capacity, caps=caps, device=device)
        self.template = template
        for r, _, _ in template.slots:
            if r not in self._ridx:
                raise ValueError(f"template rank {r!r} not in workload "
                                 f"ranks {self.ranks}")
        self._onehot = np.asarray(
            [[rr == r for rr in self.ranks] for r, _, _ in template.slots],
            dtype=bool).reshape(self.num_slots, len(self.ranks))
        self._init_program(("template", template))

    def _batched(self, args, wp):
        b, ap = args
        oh = self._const(b.device, "onehot",
                         lambda: torch.as_tensor(self._onehot,
                                                 device=b.device))
        return self._single(b, oh, wp, ap)

    # ------------------------------------------------------------------
    def evaluate(self, bounds, mesh: PopulationMesh | None = None,
                 workload_params: WorkloadParams | None = None,
                 arch_params: ArchParams | None = None
                 ) -> dict[str, np.ndarray]:
        """bounds: (C, num_slots) -> dict of (C,) arrays (``occupancy``
        is (C, S)).

        ``workload_params`` binds a different layer's inputs to the
        shared program (defaults to this facade's own workload);
        ``arch_params`` binds a different design's scalars — one design
        for the whole population, or (batched params) one per
        candidate.  With a :class:`~.device.PopulationMesh` of more than
        one shard (its first device this facade's), the candidate axis
        is split over the mesh's devices (arch rows shard with their
        candidates, workload params are bound once per device); the
        population is padded by repeating its last candidate to a
        multiple of the shard count and the padding is stripped from
        the returned arrays."""
        bounds = _check_bounds(bounds, self.num_slots)
        return self._evaluate([bounds], arch_params, workload_params,
                              mesh)


def surrogate_loss(out: dict, storage, metric: str, tau: float):
    """The smooth per-candidate loss the hybrid ES+SGD step descends:
    ``log(metric)`` plus a softplus capacity barrier per storage level,
    ``z = (occupancy - capacity) / (tau * capacity)``, the
    differentiable stand-in for the hard validity mask.  An infinite
    level contributes ``softplus(-30)`` ~ 0; the double ``where`` keeps
    its gradient free of ``0 * inf``."""
    cap = storage[..., STORAGE_FIELDS.index("capacity_words")]
    finite = torch.isfinite(cap)
    safe = torch.where(finite, cap, 1.0)
    z = torch.where(finite, (out["occupancy"] - safe) / (tau * safe),
                    -30.0)
    return (torch.log(_max(out[metric], 1e-300))
            + torch.logaddexp(z, torch.zeros_like(z)).sum(-1))


def _check_rank_ids(bounds, rank_ids, n_ranks: int) -> np.ndarray:
    rank_ids = np.asarray(rank_ids)
    if rank_ids.shape != bounds.shape:
        raise ValueError(
            f"rank_ids shape {rank_ids.shape} != bounds shape "
            f"{bounds.shape}")
    if rank_ids.min(initial=0) < 0 or \
            rank_ids.max(initial=0) >= n_ranks:
        raise ValueError(f"rank_ids out of range [0, {n_ranks})")
    return rank_ids


class BucketedModel(_TracedNestModel):
    """Batched evaluator for one (design, workload, bucket, device).

    Like :class:`BatchedModel`, but the slot->rank assignment is
    per-candidate data: ``evaluate(bounds, rank_ids)`` takes matching
    (C, num_slots) arrays of loop bounds and rank indices (into
    ``bucket.ranks``), so candidates with *different loop orders* — or
    entire different templates the bucket fits — evaluate through this
    one program.  Unit-bound slots are inert whatever their rank id,
    which is what makes the padding free.
    """

    kind = "bucket"

    def __init__(self, design, workload: Workload, bucket: TemplateBucket,
                 check_capacity: bool = True,
                 caps: DensityCaps | None = None, device=None):
        layout = bucket.slot_layout()
        super().__init__(
            design, workload,
            slot_levels=tuple(lvl for lvl, _ in layout),
            slot_spatial=tuple(sp for _, sp in layout),
            num_levels=bucket.num_levels,
            check_capacity=check_capacity, caps=caps, device=device)
        if tuple(bucket.ranks) != self.ranks:
            raise ValueError(
                f"bucket ranks {bucket.ranks} != workload ranks "
                f"{self.ranks}")
        self.bucket = bucket
        self._init_program(("bucket", bucket))

    def _batched(self, args, wp):
        b, ids, ap = args
        ar = self._const(b.device, "arange",
                         lambda: torch.arange(len(self.ranks),
                                              device=b.device))
        oh = ids.long()[..., None] == ar
        return self._single(b, oh, wp, ap)

    # ------------------------------------------------------------------
    def traced_single(self, b, rank_ids, wp_leaves, ap_rows) -> dict:
        """The shared program's step on device tensors, for composing it
        into a larger device program: ``search.fused`` runs it inside
        one captured generation.  ``b`` (C, num_slots) float64 bounds and
        ``rank_ids`` (C, num_slots) integer rank ids, ``wp_leaves`` the
        bound workload leaves (:meth:`_bind_params`), ``ap_rows`` the
        per-candidate ``(storage (C, S, F), compute (C, 4))`` rows.
        Returns the metric dict as device tensors: no host copy, no
        synchronization."""
        return self._prog.fn((b, rank_ids, ap_rows), wp_leaves)

    def evaluate_with_arch_grad(self, bounds, rank_ids,
                                arch_params: ArchParams | None = None, *,
                                metric: str = "edp",
                                surrogate: bool = False,
                                tau: float = 0.05,
                                workload_params: WorkloadParams
                                | None = None) -> dict[str, np.ndarray]:
        """Like :meth:`evaluate`, plus the gradient of a per-candidate
        loss with respect to the arch scalar rows, from one
        ``torch.autograd`` pass.

        ``surrogate=False``: the loss is the raw ``metric``, whose
        gradients match central finite differences of the scalar
        oracle.  ``surrogate=True``: the loss is :func:`surrogate_loss`
        (``log(metric)`` plus a softplus capacity barrier at temperature
        ``tau``), the stand-in for the hard validity mask that the
        hybrid ES+SGD step descends.  Returns the :meth:`evaluate` dict
        plus ``loss`` (C,), ``grad_storage`` (C, S, F) and
        ``grad_compute`` (C, 4).  The gradient flows from fresh
        per-candidate leaves; no cached row is written."""
        bounds = _check_bounds(bounds, self.num_slots)
        rank_ids = _check_rank_ids(bounds, rank_ids, len(self.ranks))
        n = len(bounds)
        wp = self._bind_params(workload_params)
        ap = self._bind_arch(arch_params, n)
        compile_stats.record_batched_evals(n, shared=self.program_shared)
        (b, ids), (storage, comp) = self._upload([bounds, rank_ids], ap, n)
        storage = storage.detach().clone().requires_grad_()
        comp = comp.detach().clone().requires_grad_()

        def flat(args, w):
            with torch.enable_grad():
                out = self._prog.fn(args, w)
                loss = (surrogate_loss(out, storage, metric, tau)
                        if surrogate else out[metric])
                gs, gc = torch.autograd.grad(
                    loss.sum(), (storage, comp), allow_unused=True)
            return {**{k: v.detach() for k, v in out.items()},
                    "loss": loss.detach(),
                    "grad_storage": (torch.zeros_like(storage)
                                     if gs is None else gs),
                    "grad_compute": (torch.zeros_like(comp)
                                     if gc is None else gc)}

        return self._run(flat, (b, ids, (storage, comp)), wp,
                         ("arch_grad", metric, surrogate, tau)
                         + tuple(bounds.shape), n)

    # ------------------------------------------------------------------
    def evaluate(self, bounds, rank_ids,
                 mesh: PopulationMesh | None = None,
                 workload_params: WorkloadParams | None = None,
                 arch_params: ArchParams | None = None
                 ) -> dict[str, np.ndarray]:
        """(bounds, rank_ids): matching (C, num_slots) arrays -> dict of
        (C,) metric arrays.  ``workload_params`` / ``arch_params`` bind
        another layer's or design's inputs exactly as in
        :meth:`BatchedModel.evaluate`; batched arch params put one design
        point per candidate on this one program; ``mesh`` shards the
        candidate axis exactly as in :meth:`BatchedModel.evaluate`."""
        bounds = _check_bounds(bounds, self.num_slots)
        rank_ids = _check_rank_ids(bounds, rank_ids, len(self.ranks))
        return self._evaluate([bounds, rank_ids], arch_params,
                              workload_params, mesh)


# ----------------------------------------------------------------------
# Content-keyed facade cache.  Facades are cheap (they pack WorkloadParams
# and bind a shared program to a device); the programs live in
# _PROGRAM_CACHE keyed by workload *structure*, so facades for different
# layers of a network share programs.
# ----------------------------------------------------------------------
_MODEL_CACHE: dict = {}
_MODEL_CACHE_CAP = 128


def _freeze(x):
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    if isinstance(x, np.ndarray):
        return ("ndarray", id(x))
    return x


def _cache_key(design, workload: Workload, shape_key,
               check_capacity: bool, caps, device):
    # the arch is keyed by its CANONICAL post-__post_init__ field tuples
    # (Architecture.canonical), not the dataclass instances: the -1.0
    # derived-default sentinels (write/metadata energies) resolve before
    # keying, so two archs that agree after derivation alias and any
    # real scalar difference (e.g. gated_energy_pj) never reuses a
    # facade built for another design's defaults
    return (design.arch.canonical(), _freeze(design.safs.formats),
            design.safs.actions,
            workload.name, tuple(workload.rank_bounds.items()),
            workload.tensors, workload.output, _freeze(workload.densities),
            shape_key, check_capacity, caps, str(device))


def _get_model(cls, design, workload: Workload, shape, check_capacity,
               caps=None, device=None):
    device = resolve_device(device)
    key = _cache_key(design, workload, shape, check_capacity, caps,
                     device)
    with _CACHE_LOCK:
        model = _MODEL_CACHE.get(key)
        if model is None:
            model = cls(design, workload, shape,
                        check_capacity=check_capacity, caps=caps,
                        device=device)
            if len(_MODEL_CACHE) >= _MODEL_CACHE_CAP:
                _MODEL_CACHE.pop(next(iter(_MODEL_CACHE)))
            _MODEL_CACHE[key] = model
        else:
            compile_stats.record_cache_hit()
        return model


def get_batched_model(design, workload: Workload, template: NestTemplate,
                      check_capacity: bool = True,
                      caps: DensityCaps | None = None,
                      device=None) -> BatchedModel:
    """Memoized :class:`BatchedModel` constructor.  ``caps`` forces the
    static density capacities (pass :func:`common_caps` of a sweep so
    mixed-density layers share one program); ``device`` is the CUDA
    card unless ``"cpu"`` is asked for."""
    return _get_model(BatchedModel, design, workload, template,
                      check_capacity, caps, device)


def get_bucketed_model(design, workload: Workload, bucket: TemplateBucket,
                       check_capacity: bool = True,
                       caps: DensityCaps | None = None,
                       device=None) -> BucketedModel:
    """Memoized :class:`BucketedModel` constructor.  ``caps`` forces the
    static density capacities (pass :func:`common_caps` of a sweep so
    mixed-density layers share one program); ``device`` is the CUDA
    card unless ``"cpu"`` is asked for."""
    return _get_model(BucketedModel, design, workload, bucket,
                      check_capacity, caps, device)


#: cache-clear callbacks of downstream modules whose caches hold
#: references into _PROGRAM_CACHE records (the fused-search program
#: cache), cleared together so clear_caches() leaves no program alive
#: through them
_EXTRA_CACHE_CLEARERS: list = []


def register_cache_clearer(fn) -> None:
    """Register a zero-argument callback to run inside
    :func:`clear_caches` (idempotent per function object)."""
    with _CACHE_LOCK:
        if fn not in _EXTRA_CACHE_CLEARERS:
            _EXTRA_CACHE_CLEARERS.append(fn)


def clear_caches() -> None:
    """Drop the facade and program caches (a testing hook:
    exact compile-count assertions otherwise depend on process-global
    cache state).  ``compile_stats`` counters are left untouched."""
    with _CACHE_LOCK:
        _MODEL_CACHE.clear()
        _PROGRAM_CACHE.clear()
        for fn in _EXTRA_CACHE_CLEARERS:
            fn()


def group_by_template(nests) -> dict[NestTemplate, list[int]]:
    """Stable grouping of candidate nests by loop structure."""
    groups: dict[NestTemplate, list[int]] = {}
    for i, nest in enumerate(nests):
        groups.setdefault(template_of(nest), []).append(i)
    return groups


def batched_supported(design, workload: Workload) -> bool:
    """True when every tensor's density model has a traceable form.

    Every Table-4 model now does — actual-data lowers through its
    tile-occupancy histogram — so this only rejects unknown density
    specs (and stays as the dispatch guard for future model kinds)."""
    try:
        for t in workload.tensors:
            m = make_density_model(workload.density_spec(t.name),
                                   t.size(workload.rank_bounds))
            if not m.batched:
                return False
    except (BatchedDensityUnsupported, ValueError):
        return False
    return True
