"""Search runner: drives an ask/tell strategy over the batched engine.

Each generation the strategy proposes a genome population; the runner
decodes it *bucket-relative* (`encoding.decode_bucketed`) and evaluates
the whole population — mixed permutations included — as ONE batched
bucketed evaluation (`core.batched.BucketedModel`) on the run's device
(the CUDA card unless ``device="cpu"`` is asked for): the loop order
rides as per-candidate rank-id data, so a free-permutation population
costs one program for the whole run instead of one per loop order.
Genomes stay on the host as numpy; each generation makes one
host-to-device copy (bounds, rank ids and any per-candidate arch rows,
packed) and one device-to-host copy (the metrics, packed).

Dispatch is controlled by :class:`SearchConfig`: ``bucketed`` toggles
the bucket route, and ``batch_threshold`` — overridable via the
``REPRO_SEARCH_BATCH_THRESHOLD`` environment variable so CI smoke can
force either path deterministically — is the smallest group handed to a
batched program (groups below it run scalar; dispatch depends only on
group sizes, never on cache state, so a run stays bit-reproducible from
its seed).  ``REPRO_SEARCH_*`` values are validated at ``SearchConfig``
construction: malformed integers raise, non-canonical booleans and
unknown ``REPRO_SEARCH_*`` names warn instead of silently falling back
to defaults.  Every density model has a batched form (actual-data
lowers to a tile-occupancy histogram), and workload parameters are
program inputs, so mixed-density populations and searches over
different layers share programs instead of falling back to the scalar
path.  Scalar-path candidates are counted in
``repro_torch.core.compile_stats`` so tests can assert "this search ran
fully batched".

The returned :class:`mapper.SearchResult` carries the winning mapping
*validated through the scalar oracle*: the runner keeps a small archive
of the best genomes seen and walks it best-first through
``Sparseloop.evaluate`` until the reference model confirms validity, so
batched/scalar drift can never leak a mapping the oracle rejects.

(design, mapping) co-search (``run_search(..., design_space=)``): with a
:class:`encoding.DesignSpace`, genomes grow a design segment (one gene
per provisioning knob), the strategies propose joint points, and the
evaluator decodes the design genes to per-candidate
``repro_torch.core.arch.ArchParams`` rows — a MIXED-DESIGN population
still evaluates through one bucket program, because architecture
scalars are program inputs and programs are keyed by topology.  The
archive walk then validates each candidate under its own design, and
the winner's design is returned as ``SearchResult.best_design``.

Population sharding (``run_search(mesh=)``): with a
:class:`~repro_torch.core.device.PopulationMesh` of more than one shard
every batched evaluation splits its candidate axis over the mesh's
devices (``BucketedModel.evaluate(..., mesh=)``).  :func:`population_mesh`
builds one: every visible card when there are two or more, a simulated
mesh of ``REPRO_SEARCH_DEVICES`` shards on one device, else None (the
single-device path).  The default, ``mesh="auto"`` (:func:`auto_mesh`),
takes only the simulated mesh: sharding over real cards is asked for
with ``mesh=population_mesh()``, since on four H100s it lost to one card
at every population measured (PERF.md).  Sharding changes no number: the
logs of a sharded and an unsharded run are identical.

Two other routes: ``fused=True`` runs an eligible ES device-resident
(``search.fused``: one captured CUDA graph per generation, replayed for
a chunk of generations, on one device), and ``service=`` sends every
batched evaluation through a ``repro_torch.dse`` evaluation service,
which owns the mesh.

Spans (``repro_torch.obs``): ``search.run`` covers a whole call, with
the children ``search.prepare`` (strategy, encoding, evaluator and, on
the fused path, program and initial carry), one ``search.generation``
(host loop) or ``search.chunk`` (fused, with ``search.fold`` for the
host's fold of the chunk) at a time, and ``search.validate`` (the
scalar-oracle walk).
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings

import numpy as np
import torch

from .. import obs
from ..core import compile_stats
from ..core.batched import batched_supported
from ..core.device import PopulationMesh, resolve_device
from ..core.engine import Sparseloop
from ..core.mapper import MapspaceConstraints, SearchResult, _validated_result
from ..core.workload import Workload
from .encoding import (CoSearchEncoding, DesignSpace, MapspaceEncoding,
                       TopologyCoSearchEncoding, TopologySpace, generator)
from .log import GenerationRecord, SearchLog
from .strategies import EvolutionStrategy, Strategy, make_strategy

METRICS = ("edp", "cycles", "energy_pj")

#: archive depth for the final scalar-oracle validation walk
ARCHIVE_SIZE = 32


def population_mesh(min_devices: int = 2,
                    device=None) -> PopulationMesh | None:
    """A mesh to shard populations over (``run_search(mesh=)``).

    ``REPRO_SEARCH_DEVICES=n`` gives n simulated shards on ``device``
    (the counterpart of the JAX package's forced host devices);
    otherwise, on a CUDA ``device`` with at least ``min_devices`` cards
    visible, a mesh over every card, ``device`` first; otherwise None,
    the single-device path.  ``device`` None is the CUDA card, and
    raises without CUDA, as every entry point does."""
    dev = resolve_device(device)
    n = _env_int("REPRO_SEARCH_DEVICES", 0)
    if n:
        if n < 1:
            raise ValueError(f"REPRO_SEARCH_DEVICES must be >= 1, got {n}")
        return PopulationMesh((dev,) * n) if n >= min_devices else None
    if dev.type != "cuda" or torch.cuda.device_count() < min_devices:
        return None
    others = [torch.device("cuda", i)
              for i in range(torch.cuda.device_count()) if i != dev.index]
    return PopulationMesh((dev, *others))


def auto_mesh(device=None) -> PopulationMesh | None:
    """What ``mesh="auto"`` resolves to: :func:`population_mesh`'s
    simulated mesh when ``REPRO_SEARCH_DEVICES`` is set, else None.  A
    mesh over real cards is not taken by default: on four H100s the
    sharded engine lost to one card at every population measured
    (PERF.md), so it is asked for with ``mesh=population_mesh()``.
    ``device`` None is the CUDA card, and raises without CUDA."""
    dev = resolve_device(device)
    if not _env_int("REPRO_SEARCH_DEVICES", 0):
        return None
    return population_mesh(device=dev)


#: default for ``SearchConfig.batch_threshold``: the smallest group
#: handed to a batched program.  A batched evaluation pays a fixed cost
#: of a few hundred device operations while a scalar evaluation costs
#: ~a millisecond, so tiny groups run scalar.
#: With bucketed dispatch the whole population is one group, so the
#: threshold only matters for the legacy per-template route and for
#: pathologically small populations.
BATCH_THRESHOLD = 32


#: REPRO_SEARCH_* variables this package understands — anything else
#: with the prefix is almost certainly a typo and gets a warning
KNOWN_SEARCH_ENV = {
    "REPRO_SEARCH_BATCH_THRESHOLD":
        "smallest group worth a compile (SearchConfig.batch_threshold)",
    "REPRO_SEARCH_BUCKETED":
        "bucketed dispatch toggle (SearchConfig.bucketed)",
    "REPRO_SEARCH_DEVICES":
        "simulated shard count of population_mesh (run_search's mesh)",
    "REPRO_SEARCH_FUSED":
        "device-resident fused ES toggle (SearchConfig.fused)",
    "REPRO_SEARCH_FUSED_CHUNK":
        "generations per fused chunk (SearchConfig.fused_chunk)",
}

_TRUE_WORDS = frozenset({"1", "true", "yes", "on"})
_FALSE_WORDS = frozenset({"0", "false", "no", "off", ""})


def validate_search_env() -> list[str]:
    """Warning messages for unknown ``REPRO_SEARCH_*`` environment
    variables (returned, and emitted as ``warnings.warn``).  Run at
    every :class:`SearchConfig` construction so a typo'd variable never
    silently no-ops an entire CI run."""
    msgs = [f"unknown environment variable {name} — known REPRO_SEARCH_* "
            f"variables: {sorted(KNOWN_SEARCH_ENV)}"
            for name in sorted(os.environ)
            if name.startswith("REPRO_SEARCH_")
            and name not in KNOWN_SEARCH_ENV]
    for msg in msgs:
        warnings.warn(msg, stacklevel=3)
    return msgs


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError as e:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from e


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    word = raw.strip().lower()
    if word in _TRUE_WORDS:
        return True
    if word in _FALSE_WORDS:
        return False
    warnings.warn(
        f"{name}={raw!r} is not a recognized boolean "
        f"(use one of {sorted(_TRUE_WORDS | _FALSE_WORDS - {''})}); "
        f"treating it as true", stacklevel=3)
    return True


@dataclasses.dataclass
class SearchConfig:
    """Dispatch knobs for population evaluation.

    Defaults read the environment once at construction, so CI can force
    either path without touching call sites:

    * ``REPRO_SEARCH_BATCH_THRESHOLD`` — smallest group worth a compile
      (huge value => everything scalar; 0/1 => everything batched).
    * ``REPRO_SEARCH_BUCKETED`` — "0"/"false" disables the bucketed
      route (population falls back to per-template grouping).
    * ``REPRO_SEARCH_FUSED`` — "1"/"true" turns on the device-resident
      fused ES (``search.fused``) for eligible runs; the host ask/tell
      loop stays the default and the fallback.
    * ``REPRO_SEARCH_FUSED_CHUNK`` — generations per fused chunk (graph
      replays between two device-to-host copies).

    Values are validated rather than silently defaulted: a malformed
    integer raises, a non-canonical boolean warns (and is treated as
    true), and any other ``REPRO_SEARCH_*`` variable in the environment
    warns as a probable typo (see :func:`validate_search_env`).
    """

    batch_threshold: int = dataclasses.field(
        default_factory=lambda: _env_int("REPRO_SEARCH_BATCH_THRESHOLD",
                                         BATCH_THRESHOLD))
    bucketed: bool = dataclasses.field(
        default_factory=lambda: _env_bool("REPRO_SEARCH_BUCKETED", True))
    fused: bool = dataclasses.field(
        default_factory=lambda: _env_bool("REPRO_SEARCH_FUSED", False))
    fused_chunk: int = dataclasses.field(
        default_factory=lambda: _env_int("REPRO_SEARCH_FUSED_CHUNK", 16))

    def __post_init__(self) -> None:
        validate_search_env()


class PopulationEvaluator:
    """Fitness function over genome populations.

    Default route: bucket-relative decode -> ONE batched evaluation on
    ``device`` for the entire population, permutations as data and every
    density kind (actual-data included) batched.  Fallbacks:
    per-template grouping (``config.bucketed=False``) and the
    per-candidate scalar path for groups below
    ``config.batch_threshold``.  ``mesh`` (a ``PopulationMesh`` whose
    first device is ``device``) shards each batched evaluation's
    candidate axis.  With ``service`` (a ``repro_torch.dse``
    ``ServiceClient`` or ``EvaluationService``) batched evaluations are
    submitted as population requests instead of run inline, so
    concurrent searches coalesce into shared program invocations.
    """

    def __init__(self, design, workload: Workload, enc: MapspaceEncoding,
                 mesh: PopulationMesh | None = None,
                 check_capacity: bool = True,
                 config: SearchConfig | None = None, device=None,
                 service=None):
        self.device = resolve_device(device)
        if mesh is not None and mesh.devices[0] != self.device:
            raise ValueError(f"mesh {mesh} does not start at the "
                             f"search's device {self.device}")
        self.model = Sparseloop(design, device=self.device)
        self.workload = workload
        self.enc = enc
        self.mesh = mesh
        self.check_capacity = check_capacity
        self.config = config or SearchConfig()
        self.service = service
        self.batched = batched_supported(design, workload)
        #: (design, mapping) co-search: the genome carries design genes
        #: that decode to per-candidate ArchParams rows, so a mixed-design
        #: population STILL rides one program
        self.cosearch = isinstance(enc, CoSearchEncoding)
        #: (topology, design, mapping) co-search: the genome also
        #: carries topology genes — the population groups by canonical
        #: topology key and rides O(topology groups) programs
        self.topology = isinstance(enc, TopologyCoSearchEncoding)
        #: per-topology-group engines (topology co-search only)
        self._group_engines: dict[tuple, Sparseloop] = {}
        #: scalar-path oracle per distinct design-gene row (co-search
        #: populations repeat a handful of design points; don't rebuild
        #: a Design + engine per candidate per generation)
        self._scalar_models: dict[bytes, Sparseloop] = {}

    def _scalar_model(self, genome) -> Sparseloop:
        if self.topology:
            g = np.asarray(genome, np.int64).reshape(1, -1)
            key = self.enc.repair(g)[0, self.enc.design_off:].tobytes()
        elif self.cosearch:
            key = self.enc.design_genes(genome)[0].tobytes()
        else:
            return self.model
        model = self._scalar_models.get(key)
        if model is None:
            model = Sparseloop(self.enc.design_of(genome),
                               device=self.device)
            self._scalar_models[key] = model
        return model

    def _group_engine(self, grp) -> Sparseloop:
        engine = self._group_engines.get(grp.key)
        if engine is None:
            engine = Sparseloop(grp.design, device=self.device)
            self._group_engines[grp.key] = engine
        return engine

    def _eval_scalar(self, genomes: np.ndarray, idx, nests,
                     out: dict) -> None:
        """The per-candidate scalar oracle for ``genomes[idx]`` at
        ``nests`` (a mapping that does not lower stays invalid)."""
        compile_stats.record_scalar_evals(len(idx))
        for i, nest in zip(idx, nests):
            model = self._scalar_model(genomes[i])
            try:
                ev = model.evaluate(self.workload, nest,
                                    check_capacity=self.check_capacity)
            except ValueError:
                continue
            out["cycles"][i] = ev.cycles
            out["energy_pj"][i] = ev.energy_pj
            out["edp"][i] = ev.edp
            out["valid"][i] = ev.result.valid

    def _eval_topology(self, genomes: np.ndarray, out: dict,
                       threshold: int) -> dict[str, np.ndarray]:
        """Mixed-topology population dispatch: group by canonical
        topology key, decode each group through its OWN sub-encoding,
        and evaluate it through its group's bucket program.

        Every group is padded (by repeating its last candidate) to the
        FULL population size before dispatch, so each topology sees
        exactly one input shape per run no matter how the
        per-generation group mix shifts — the program count is
        O(topology groups x buckets), independent of population size
        and of how evenly the strategy samples the topologies."""
        n = len(genomes)
        if not (self.batched and self.config.bucketed
                and n >= threshold):
            self._eval_scalar(genomes, range(n),
                              [self.enc.nest_of(g) for g in genomes], out)
            return out

        for grp, idx in self.enc.group_by_topology(genomes):
            k = len(idx)
            sel = idx if k == n else np.concatenate(
                [idx, np.repeat(idx[-1:], n - k)])
            sub = self.enc.sub_genomes(genomes[sel], grp)
            bucket, bounds, ids = grp.enc.decode_bucketed(sub)
            ap = self.enc.group_arch_params(genomes[sel], grp)
            bm = self._group_engine(grp).bucketed_model(
                self.workload, bucket,
                check_capacity=self.check_capacity)
            res = self._batched(bm, bounds, ids, ap)
            for m in METRICS:
                out[m][idx] = res[m][:k]
            out["valid"][idx] = res["valid"][:k]
        return out

    def _batched(self, bm, bounds, ids, ap) -> dict[str, np.ndarray]:
        """One batched evaluation, inline or through the service
        (``ids`` None for an exact-template model)."""
        if self.service is not None:
            return self.service.evaluate(bm, bounds, rank_ids=ids,
                                         arch_params=ap)
        if ids is None:
            return bm.evaluate(bounds, mesh=self.mesh, arch_params=ap)
        return bm.evaluate(bounds, ids, mesh=self.mesh, arch_params=ap)

    def __call__(self, genomes: np.ndarray) -> dict[str, np.ndarray]:
        n = len(genomes)
        out = {k: np.full(n, np.inf) for k in METRICS}
        out["valid"] = np.zeros(n, dtype=bool)
        threshold = max(1, self.config.batch_threshold)

        if self.topology:
            return self._eval_topology(genomes, out, threshold)

        if (self.batched and self.config.bucketed and n >= threshold):
            bucket, bounds, ids = self.enc.decode_bucketed(genomes)
            bm = self.model.bucketed_model(
                self.workload, bucket, check_capacity=self.check_capacity)
            ap = (self.enc.arch_params_of(genomes)
                  if self.cosearch else None)
            res = self._batched(bm, bounds, ids, ap)
            for k in METRICS:
                out[k][:] = res[k]
            out["valid"][:] = res["valid"]
            return out

        ap_all = (self.enc.arch_params_of(genomes)
                  if self.cosearch and self.batched else None)
        for template, idx, bounds in self.enc.decode_population(genomes):
            if self.batched and len(idx) >= threshold:
                bm = self.model.batched_model(
                    self.workload, template,
                    check_capacity=self.check_capacity)
                ap = ap_all.take(idx) if ap_all else None
                res = self._batched(bm, bounds, None, ap)
                for k in METRICS:
                    out[k][idx] = res[k]
                out["valid"][idx] = res["valid"]
            else:           # small group or scalar-only density model
                self._eval_scalar(genomes, idx,
                                  [template.nest_with(b) for b in bounds],
                                  out)
        return out


def _run_host(evaluate: PopulationEvaluator, enc, strat, key,
              generations: int, metric: str, log: SearchLog):
    """The host ask/tell generation loop: per-generation numpy strategy
    step + one batched evaluation.  Returns the archive and counters the
    oracle-validation walk consumes."""
    state = strat.init(key, enc)
    archive_fit: list[float] = []
    archive_gen: list[np.ndarray] = []
    seen: set[bytes] = set()
    best = {"fitness": np.inf, "cycles": np.inf, "energy_pj": np.inf,
            "edp": np.inf}
    n_eval = n_valid = 0
    for gen in range(generations):
        t_gen0 = time.perf_counter()
        with obs.span("search.generation", generation=gen) as sp:
            genomes = enc.repair(strat.ask(state, enc))
            res = evaluate(genomes)
            fitness = np.where(res["valid"], res[metric], np.inf)
            strat.tell(state, enc, genomes, fitness)

            n_eval += len(genomes)
            n_valid += int(res["valid"].sum())
            i = int(np.argmin(fitness))
            if fitness[i] < best["fitness"]:
                best = {"fitness": float(fitness[i]),
                        "cycles": float(res["cycles"][i]),
                        "energy_pj": float(res["energy_pj"][i]),
                        "edp": float(res["edp"][i])}
            for j in np.argsort(fitness,
                                kind="stable")[:ARCHIVE_SIZE]:
                if not np.isfinite(fitness[j]):
                    break
                b = genomes[j].tobytes()
                if b not in seen:
                    seen.add(b)
                    archive_fit.append(float(fitness[j]))
                    archive_gen.append(genomes[j].copy())
            if len(archive_fit) > 4 * ARCHIVE_SIZE:
                order = np.argsort(archive_fit,
                                   kind="stable")[:ARCHIVE_SIZE]
                archive_fit = [archive_fit[k] for k in order]
                archive_gen = [archive_gen[k] for k in order]
            sp.set(evaluations=len(genomes),
                   best_fitness=best["fitness"])

        log.append(GenerationRecord(
            generation=gen, evaluations=n_eval, valid=n_valid,
            best_fitness=best["fitness"], best_cycles=best["cycles"],
            best_energy_pj=best["energy_pj"], best_edp=best["edp"],
            wall_time_s=time.perf_counter() - t_gen0))
    return archive_fit, archive_gen, n_eval, n_valid


def _fused_setup(evaluate: PopulationEvaluator, enc, strat, key,
                 metric: str, check_capacity: bool, sgd_lr: float,
                 sgd_tau: float) -> tuple:
    """The device-resident path's program, initial carry and host fold
    (``search.fused``)."""
    from .fused import ChunkAbsorber, get_fused_program

    bm = evaluate.model.bucketed_model(
        evaluate.workload, enc.bucket, check_capacity=check_capacity)
    # device-resident archive: the step carries a top-K (fitness,
    # genome) buffer and emits per-generation scalars, so the host fold
    # ingests K rows per chunk instead of pop_size per generation
    fp = get_fused_program(bm, enc, strat, metric=metric,
                           sgd_lr=sgd_lr, sgd_tau=sgd_tau,
                           archive_k=ARCHIVE_SIZE)
    return fp, fp.init_carry(key), ChunkAbsorber(
        metric, ARCHIVE_SIZE, pop_size=strat.pop_size)


def _run_fused(fp, carry, absorber, pop_size: int, generations: int,
               config: SearchConfig, service, log: SearchLog):
    """The device-resident path: generation chunks run as graph replays
    (``search.fused``); the host only absorbs each chunk's outputs.
    Returns the same state as :func:`_run_host` plus the chunk-timing
    rows for ``log.timing``."""
    chunks: list[dict] = []
    done = 0
    while done < generations:
        c = min(max(1, config.fused_chunk), generations - done)
        t0 = time.perf_counter()
        with obs.span("search.chunk", start=done, length=c,
                      pop_size=pop_size) as sp:
            if service is not None:
                carry, ys = service.run_fused(
                    lambda carry=carry, c=c: fp.invoke_chunk(carry, c))
            else:
                carry, ys = fp.invoke_chunk(carry, c)
            with obs.span("search.fold"):
                absorber.absorb(ys, log)
            sp.set(evaluations=absorber.n_eval,
                   best_fitness=absorber.best["fitness"])
        chunks.append({"start": done, "generations": c,
                       "wall_s": time.perf_counter() - t0})
        done += c
    return (absorber.archive_fit, absorber.archive_gen,
            absorber.n_eval, absorber.n_valid, chunks)


def run_search(design, workload: Workload,
               cons: MapspaceConstraints | None = None,
               strategy: "str | Strategy" = "es", *,
               key: "int | torch.Generator" = 0,
               generations: int | None = None,
               metric: str = "edp",
               mesh="auto",
               check_capacity: bool = True,
               config: SearchConfig | None = None,
               batch_threshold: int | None = None,
               log_to: SearchLog | None = None,
               design_space: DesignSpace | None = None,
               topology_space: TopologySpace | None = None,
               service=None,
               fused: bool | None = None,
               sgd_lr: float = 0.0,
               sgd_tau: float = 0.05,
               device=None,
               **strategy_options) -> SearchResult:
    """Stochastic mapspace search.  Returns a ``SearchResult`` whose
    ``log`` attribute holds the per-generation trajectory.

    ``key`` is an int seed or a ``torch.Generator`` — the whole run is
    bit-reproducible from a seed.  ``generations`` defaults to
    ``cons.budget // pop_size`` so enumeration and stochastic search are
    comparable at equal evaluation budget.  ``device`` is where the
    batched engine runs: the CUDA card when None (raising without
    CUDA), the CPU only for ``device="cpu"``; strategy steps, decoding
    and the winner's re-validation run on the host.  ``config`` (a
    :class:`SearchConfig`) controls dispatch; ``batch_threshold`` is a
    convenience override of its field of the same name.

    ``mesh`` shards every batched evaluation's candidate axis over a
    :class:`~repro_torch.core.device.PopulationMesh`; ``"auto"`` (the
    default) is :func:`auto_mesh` on ``device``: ``REPRO_SEARCH_DEVICES``
    simulated shards where that is set, else None, the single-device
    path, also on a machine with several cards (pass
    ``mesh=population_mesh()`` to shard over them; it was slower on four
    H100s at every size measured).  With only ``mesh`` given the run's
    device is its first
    device; a ``device`` that is not raises.  A ``service`` owns the
    devices and forces the mesh to None.  The log does not depend on
    the mesh.

    ``design_space`` (a :class:`DesignSpace`) turns the run into
    (design, mapping) CO-SEARCH: genomes grow one gene per provisioning
    knob, strategies propose joint points, mixed-design populations
    evaluate through one bucket program (per-candidate ``ArchParams``
    rows), and the returned result's winner — validated by the scalar
    oracle *under its own design* — carries that design in
    ``SearchResult.best_design``.

    ``topology_space`` (a :class:`TopologySpace`) goes one further:
    (topology, design, mapping) co-search.  Pass ``design=None`` — the
    designs are decoded from the genome's topology (+ design) genes,
    and there is no single base design.  The population groups by
    canonical topology key and rides O(topology groups) programs per
    run (each group padded to the full population size so its program
    sees ONE shape); the archive walk validates every candidate under
    its *own* decoded ``Design``, which rides out as
    ``SearchResult.best_design``.  Composes with ``design_space`` (knobs
    naming levels a topology dropped are inert there).

    ``service`` (a ``repro_torch.dse`` ``ServiceClient`` or
    ``EvaluationService``) routes every batched population evaluation
    through a persistent evaluation service: concurrent searches
    sharing one service coalesce their generations into shared program
    invocations.

    ``fused`` (or ``REPRO_SEARCH_FUSED=1``) runs eligible searches
    device-resident: the whole ask -> decode -> evaluate -> tell
    generation is one captured CUDA graph on the card (eager steps on
    the CPU), replayed ``config.fused_chunk`` times between two
    device-to-host copies (``search.fused``), on one device: the fused
    path ignores the mesh.  Eligible = an
    EvolutionStrategy on the bucketed batched path with device-decoded
    design knobs; anything else (hillclimb/annealing, sub-threshold
    populations, knobs on static fields, topology co-search) takes the
    host loop — with a warning when ``fused=True`` was explicit.
    ``sgd_lr > 0`` adds the hybrid ES+SGD step on co-search design
    genes inside the generation (log-space Lamarckian nudge against the
    smooth capacity-surrogate loss, temperature ``sgd_tau``).
    """
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
    with obs.span("search.run", metric=metric,
                  workload=workload.name) as run_span:
        with obs.span("search.prepare"):
            if service is not None:
                mesh = None        # the service owns the devices
            elif isinstance(mesh, str):
                if mesh != "auto":
                    raise ValueError(f"mesh must be a PopulationMesh, None "
                                     f"or 'auto', got {mesh!r}")
                mesh = auto_mesh(device)
            if mesh is not None and device is None:
                device = mesh.devices[0]
            config = config or SearchConfig()
            if batch_threshold is not None:
                config = dataclasses.replace(
                    config, batch_threshold=batch_threshold)
            cons = cons or MapspaceConstraints()
            strat = make_strategy(strategy, **strategy_options)
            if topology_space is not None:
                if design is not None:
                    raise ValueError(
                        "topology co-search decodes designs from the "
                        "TopologySpace genome; pass design=None (the base "
                        "levels live in the space's slots)")
                enc: MapspaceEncoding = TopologyCoSearchEncoding(
                    workload, cons, topology_space, design_space)
                design = enc.representative_design()
            elif design_space is not None:
                enc = CoSearchEncoding(workload, design.arch.num_levels,
                                       cons, design_space, design)
            else:
                enc = MapspaceEncoding(workload, design.arch.num_levels,
                                       cons)
            evaluate = PopulationEvaluator(
                design, workload, enc, mesh=mesh,
                check_capacity=check_capacity, config=config,
                device=device, service=service)

            seed = int(key) if isinstance(key, (int, np.integer)) else None
            key = generator(key)
            if generations is None:
                # honour cons.budget as a hard cap: shrink the population
                # when it exceeds the whole budget, then spend it in full
                # generations
                if strat.pop_size > cons.budget > 0:
                    strat = make_strategy(strat, pop_size=cons.budget)
                generations = max(1, cons.budget // max(1, strat.pop_size))

            from .fused import fused_supported
            want_fused = config.fused if fused is None else fused
            use_fused = (want_fused
                         and isinstance(strat, EvolutionStrategy)
                         and evaluate.batched and config.bucketed
                         and enc.genome_size > 0
                         and strat.pop_size >= max(1,
                                                   config.batch_threshold)
                         and fused_supported(enc))
            if fused and not use_fused:
                warnings.warn(
                    "fused=True requested but this run is not "
                    "fused-eligible (needs an EvolutionStrategy on the "
                    "bucketed batched path with device-decoded design "
                    "knobs); using the host loop", stacklevel=2)

            log = log_to or SearchLog(
                strategy=strat.name, metric=metric, workload=workload.name,
                design=design.name or design.arch.name, seed=seed)

            t_run0 = time.perf_counter()
            if use_fused:
                fused_state = _fused_setup(
                    evaluate, enc, strat, key if seed is None else seed,
                    metric, check_capacity, sgd_lr, sgd_tau)
        run_span.set(strategy=strat.name, generations=generations,
                     pop_size=strat.pop_size, fused=use_fused)
        with compile_stats.track() as st:
            if use_fused:
                archive_fit, archive_gen, n_eval, n_valid, chunks = \
                    _run_fused(*fused_state, strat.pop_size, generations,
                               config, service, log)
            else:
                archive_fit, archive_gen, n_eval, n_valid = _run_host(
                    evaluate, enc, strat, key, generations, metric, log)
        # run-level wall-clock attribution: where the search's seconds
        # went (first-call vs warm evaluation, from compile_stats'
        # counters)
        log.timing = {
            "wall_s": time.perf_counter() - t_run0,
            "compile_s": st.compile_seconds,
            "eval_s": st.eval_seconds,
            "compiles": st.compiles,
        }
        if use_fused:
            # chunk-level attribution: per-generation wall_time_s is None
            # inside a chunk of replays, the measurable unit is the chunk
            log.timing["fused"] = True
            log.timing["chunks"] = chunks

        with obs.span("search.validate"):
            # scalar-oracle validation of the winner (best-first archive
            # walk); co-search candidates validate under THEIR OWN design,
            # and the winner's design rides out on the result
            order = np.argsort(archive_fit, kind="stable")[:ARCHIVE_SIZE]
            model_at = None
            if design_space is not None or topology_space is not None:
                # reuse the evaluator's per-design oracle cache: archive
                # rows repeat a handful of (topology, design) points, and
                # each candidate validates under its OWN decoded Design
                model_at = (lambda i:
                            evaluate._scalar_model(archive_gen[order[i]]))
            result = _validated_result(
                evaluate.model, workload,
                lambda i: enc.nest_of(archive_gen[order[i]]),
                edp=np.asarray([archive_fit[k] for k in order]),
                valid=np.ones(len(order), dtype=bool),
                n_eval=n_eval, check_capacity=check_capacity,
                model_at=model_at)
    result.valid = n_valid
    result.log = log
    return result
