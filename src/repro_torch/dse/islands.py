"""Async island-ES: N concurrent searches sharing one evaluation service.

The first real client of :class:`repro_torch.dse.EvaluationService`.
Each island is an independent ask/tell search (its own strategy state,
its own seed drawn from the run's seed) running in its own thread; all
islands evaluate through ONE shared service, so their generations
coalesce into shared program invocations — N islands over the same
(design, workload) cost one program and one first call per bucket
*total*, not one per island — and every island shows up as its own
tenant in the service's ``dse.client.island<i>.*`` metrics.

Periodically (every ``migrate_every`` generations) an island publishes
its ``n_migrants`` best (genome, fitness) pairs to a board and adopts
the latest emigrants of its ring neighbor by simply ``tell``-ing them to
its strategy — the (mu + lambda) survivor selection folds good
immigrants in and discards bad ones, so migration is strategy-agnostic
and never needs a barrier: islands drift apart on different basins and
re-seed each other asynchronously.

The winner contract matches ``search.run_search``: every island keeps a
best-first archive, each island's winner is re-validated through the
scalar oracle (``mapper._validated_result``), and the returned
:class:`IslandResult` carries the globally best validated winner plus
the per-island results/logs.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings

import numpy as np
import torch

from .. import obs
from ..core.mapper import (MapspaceConstraints, SearchResult,
                           _validated_result)
from ..core.workload import Workload
from ..search.encoding import (CoSearchEncoding, DesignSpace,
                               MapspaceEncoding, generator)
from ..search.log import GenerationRecord, SearchLog
from ..search.runner import (ARCHIVE_SIZE, METRICS, PopulationEvaluator,
                             SearchConfig)
from ..search.strategies import EvolutionStrategy, make_strategy
from .service import EvaluationService


class _MigrantBoard:
    """Latest emigrants per island, read asynchronously by the ring
    neighbor (island i pulls from island i-1).  Lock-protected; reads
    never block on writers beyond the copy."""

    def __init__(self, n_islands: int):
        self._slots: list[tuple[np.ndarray, np.ndarray] | None] = \
            [None] * n_islands
        self._lock = threading.Lock()

    def publish(self, island: int, genomes: np.ndarray,
                fitness: np.ndarray) -> None:
        with self._lock:
            self._slots[island] = (np.asarray(genomes).copy(),
                                   np.asarray(fitness).copy())

    def take_for(self, island: int
                 ) -> tuple[np.ndarray, np.ndarray] | None:
        with self._lock:
            slot = self._slots[(island - 1) % len(self._slots)]
            return None if slot is None else (slot[0].copy(),
                                              slot[1].copy())


@dataclasses.dataclass
class IslandResult:
    """Outcome of one multi-island run."""

    #: globally best validated winner (scalar-oracle confirmed)
    best: SearchResult
    #: each island's own validated winner, index-aligned with islands
    per_island: list[SearchResult]
    #: each island's generation-by-generation trajectory
    logs: list[SearchLog]
    #: the shared service's counters (coalescing effectiveness)
    service_stats: dict
    #: total candidate evaluations across all islands
    evaluations: int = 0
    #: wall-clock of the whole run (threads started -> joined)
    wall_s: float = 0.0


def _island_worker(island: int, key, enc, evaluate: PopulationEvaluator,
                   strat, generations: int, metric: str,
                   board: _MigrantBoard, migrate_every: int,
                   n_migrants: int, out: dict) -> None:
    """One island's ask/tell loop (runs on its own thread)."""
    log = SearchLog(strategy=strat.name, metric=metric,
                    workload=evaluate.workload.name,
                    design=(evaluate.model.design.name
                            or evaluate.model.design.arch.name))
    archive_fit: list[float] = []
    archive_gen: list[np.ndarray] = []
    seen: set[bytes] = set()
    best = {"fitness": np.inf, "cycles": np.inf, "energy_pj": np.inf,
            "edp": np.inf}
    n_eval = n_valid = 0
    state = strat.init(key, enc)
    with obs.span("dse.island", island=island, strategy=strat.name,
                  generations=generations):
        for gen in range(generations):
            t0 = time.perf_counter()
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
            for j in np.argsort(fitness, kind="stable")[:ARCHIVE_SIZE]:
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
            # ---- asynchronous ring migration -------------------------
            if migrate_every > 0 and (gen + 1) % migrate_every == 0:
                fin = np.isfinite(fitness)
                if fin.any():
                    order = np.argsort(
                        np.where(fin, fitness, np.inf),
                        kind="stable")[:n_migrants]
                    board.publish(island, genomes[order],
                                  fitness[order])
                migrants = board.take_for(island)
                if migrants is not None:
                    mg, mf = migrants
                    strat.tell(state, enc, mg, mf)
            log.append(GenerationRecord(
                generation=gen, evaluations=n_eval, valid=n_valid,
                best_fitness=best["fitness"], best_cycles=best["cycles"],
                best_energy_pj=best["energy_pj"], best_edp=best["edp"],
                wall_time_s=time.perf_counter() - t0))
    out["log"] = log
    out["archive"] = (archive_fit, archive_gen)
    out["n_eval"] = n_eval
    out["n_valid"] = n_valid


def _island_worker_fused(island: int, key, enc,
                         evaluate: PopulationEvaluator, fp, strat,
                         generations: int, metric: str,
                         board: _MigrantBoard, migrate_every: int,
                         n_migrants: int, chunk: int, out: dict) -> None:
    """One island's fused loop: whole generation chunks run as graph
    replays routed through the shared service's evaluator thread
    (``ServiceClient.run_fused``).  The carry stays on the device across
    chunks; ring migration happens at chunk boundaries by folding the
    neighbor's emigrants into the carry (``FusedProgram.inject`` — the
    same (mu + lambda) fold the host path gets from ``strategy.tell``)."""
    from ..search.fused import ChunkAbsorber

    log = SearchLog(strategy=strat.name, metric=metric,
                    workload=evaluate.workload.name,
                    design=(evaluate.model.design.name
                            or evaluate.model.design.arch.name))
    absorber = ChunkAbsorber(metric, ARCHIVE_SIZE)
    carry = fp.init_carry(key)
    done = 0
    with obs.span("dse.island", island=island, strategy=strat.name,
                  generations=generations, fused=True):
        while done < generations:
            c = min(chunk, generations - done)
            carry, ys = evaluate.service.run_fused(
                lambda carry=carry, c=c: fp.invoke_chunk(carry, c))
            absorber.absorb(ys, log)
            done += c
            if migrate_every > 0 and done < generations:
                genomes = ys["genomes"][-1]
                fitness = ys["fitness"][-1]
                fin = np.isfinite(fitness)
                if fin.any():
                    order = np.argsort(
                        np.where(fin, fitness, np.inf),
                        kind="stable")[:n_migrants]
                    board.publish(island, genomes[order],
                                  fitness[order])
                migrants = board.take_for(island)
                if migrants is not None:
                    carry = fp.inject(carry, *migrants)
    out["log"] = log
    out["archive"] = (absorber.archive_fit, absorber.archive_gen)
    out["n_eval"] = absorber.n_eval
    out["n_valid"] = absorber.n_valid


def island_seeds(key, n_islands: int) -> list[int]:
    """Each island's seed: ``n_islands`` draws from a ``torch.Generator``
    seeded with ``key`` (an int, or a generator used as it is)."""
    return [int(s) for s in torch.randint(
        0, 2 ** 62, (n_islands,), generator=generator(key))]


def run_islands(design, workload: Workload,
                cons: MapspaceConstraints | None = None, *,
                n_islands: int = 4,
                strategy: str = "es",
                key: int = 0,
                generations: int = 8,
                metric: str = "edp",
                migrate_every: int = 4,
                n_migrants: int = 2,
                check_capacity: bool = True,
                config: SearchConfig | None = None,
                design_space: DesignSpace | None = None,
                service: EvaluationService | None = None,
                fused: bool = False,
                sgd_lr: float = 0.0,
                sgd_tau: float = 0.05,
                device=None,
                **strategy_options) -> IslandResult:
    """Run ``n_islands`` concurrent ask/tell searches through one shared
    :class:`EvaluationService`.

    Each island is one service client (``island0`` .. ``islandN-1``)
    with its own strategy state and seed (drawn for each island from a
    ``torch.Generator`` seeded with ``key``); their per-generation
    populations coalesce inside the service, so the whole fleet of
    searches runs one program per bucket total.  Migration is
    asynchronous (see :class:`_MigrantBoard`); pass ``migrate_every=0``
    to disable it.  When ``service`` is None, a private one is created
    and closed on exit.  ``device`` is where the engine runs: the CUDA
    card unless ``device="cpu"`` is asked for.

    ``fused=True`` runs each eligible island device-resident: one
    ``FusedProgram`` (one captured graph on the card) is SHARED by every
    island — islands differ only in their carry — each island's chunks
    serialize through the service's evaluator thread, and ring
    migration folds emigrants into the device carry at chunk
    boundaries.  Ineligible setups (non-ES strategies, knobs on static
    fields) fall back to the host workers with a warning.  ``sgd_lr`` /
    ``sgd_tau`` are the hybrid ES+SGD knobs (see ``run_search``).
    """

    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got "
                         f"{metric!r}")
    if n_islands < 1:
        raise ValueError(f"n_islands must be >= 1, got {n_islands}")
    cons = cons or MapspaceConstraints()
    if design_space is not None:
        enc: MapspaceEncoding = CoSearchEncoding(
            workload, design.arch.num_levels, cons, design_space, design)
    else:
        enc = MapspaceEncoding(workload, design.arch.num_levels, cons)
    config = config or SearchConfig()
    seeds = island_seeds(key, n_islands)

    strats = [make_strategy(strategy, **strategy_options)
              for _ in range(n_islands)]
    own_service = service is None
    if own_service:
        # fixed batch capacity = the whole fleet's per-generation
        # population: every coalesced invocation shares one shape, so
        # N islands cost one first call per bucket TOTAL
        service = EvaluationService(
            batch_slots=n_islands * strats[0].pop_size)
    board = _MigrantBoard(n_islands)
    evaluators = [
        PopulationEvaluator(design, workload, enc, mesh=None,
                            check_capacity=check_capacity, config=config,
                            device=device,
                            service=service.client(f"island{i}"))
        for i in range(n_islands)
    ]
    from ..search.fused import fused_supported, get_fused_program
    use_fused = (fused
                 and all(isinstance(s, EvolutionStrategy) for s in strats)
                 and evaluators[0].batched and config.bucketed
                 and enc.genome_size > 0
                 and strats[0].pop_size >= max(1, config.batch_threshold)
                 and fused_supported(enc))
    if fused and not use_fused:
        warnings.warn(
            "fused=True requested but this island run is not "
            "fused-eligible (needs an EvolutionStrategy on the bucketed "
            "batched path with device-decoded design knobs); using the "
            "host ask/tell workers", stacklevel=2)
    fp = None
    if use_fused:
        # ONE FusedProgram for the whole fleet: islands differ only in
        # their carry (their population + key), so they share its graph
        # the way host islands share the bucket program
        bm = evaluators[0].model.bucketed_model(
            workload, enc.bucket, check_capacity=check_capacity)
        fp = get_fused_program(bm, enc, strats[0], metric=metric,
                               sgd_lr=sgd_lr, sgd_tau=sgd_tau)
    chunk = (migrate_every if migrate_every > 0
             else max(1, config.fused_chunk))

    outs: list[dict] = [{} for _ in range(n_islands)]
    threads = []
    t0 = time.perf_counter()
    try:
        with obs.span("dse.islands", islands=n_islands,
                      strategy=strategy, generations=generations,
                      fused=use_fused):
            for i in range(n_islands):
                strat = strats[i]
                if use_fused:
                    args = (i, seeds[i], enc,
                            evaluators[i], fp, strat, generations,
                            metric, board, migrate_every, n_migrants,
                            chunk, outs[i])
                    target = _island_worker_fused
                else:
                    args = (i, seeds[i], enc,
                            evaluators[i], strat, generations, metric,
                            board, migrate_every, n_migrants, outs[i])
                    target = _island_worker
                th = threading.Thread(
                    target=target, name=f"dse-island{i}", args=args)
                th.start()
                threads.append(th)
            for th in threads:
                th.join()
    finally:
        if own_service:
            service.close()
    wall_s = time.perf_counter() - t0
    for i, out in enumerate(outs):
        if "archive" not in out:
            raise RuntimeError(f"island {i} died without a result")

    # scalar-oracle validation, per island (the per-tenant winner
    # contract) — co-search candidates validate under their own design
    per_island: list[SearchResult] = []
    for i, out in enumerate(outs):
        archive_fit, archive_gen = out["archive"]
        order = np.argsort(archive_fit, kind="stable")[:ARCHIVE_SIZE]
        model_at = None
        if design_space is not None:
            ev = evaluators[i]
            model_at = (lambda j, ev=ev, ag=archive_gen, o=order:
                        ev._scalar_model(ag[o[j]]))
        result = _validated_result(
            evaluators[i].model, workload,
            lambda j, ag=archive_gen, o=order: enc.nest_of(ag[o[j]]),
            edp=np.asarray([archive_fit[k] for k in order]),
            valid=np.ones(len(order), dtype=bool),
            n_eval=out["n_eval"], check_capacity=check_capacity,
            model_at=model_at)
        result.valid = out["n_valid"]
        result.log = out["log"]
        per_island.append(result)

    best = min(
        (r for r in per_island if r.best is not None),
        key=lambda r: r.best.edp,
        default=per_island[0])
    return IslandResult(
        best=best, per_island=per_island,
        logs=[out["log"] for out in outs],
        service_stats=service.stats(),
        evaluations=sum(out["n_eval"] for out in outs),
        wall_s=wall_s)
