"""Mapspace search (Sparseloop Sec. 5.1 'Mapspace Constraints').

Characterizing a design requires finding its best mapping for each
workload; this module enumerates/samples the mapspace (loop-bound
factorizations x permutations) under user constraints and evaluates
candidates with the analytical engine.

Candidates are dispatched to the batched PyTorch engine (core.batched)
in *bucket* groups — padded template families that carry the loop order
as per-candidate data, so mixed-permutation slices cost one program per
bucket instead of one per loop structure — while the
scalar ``Sparseloop.evaluate`` remains the per-candidate reference
oracle (the winning mapping is always re-evaluated through it).
Workload parameters (rank bounds, density models — actual-data via its
tile-occupancy histogram) are inputs of those programs, so searches over
different layers of a network share programs.  ``use_batched="auto"``
batches only groups large enough to amortize the batched engine's first
call; custom objectives (which need the full per-candidate
``Evaluation``) fall back to the scalar loop.  The batched engine runs
on the CUDA card unless ``search(..., device="cpu")`` asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
from typing import TYPE_CHECKING, Callable, Iterable, Sequence

import numpy as np

from .engine import Design, Evaluation, Sparseloop
from .mapping import Loop, LoopNest, factor_splits
from .workload import Workload

if TYPE_CHECKING:        # core.batched loads lazily at dispatch
    from .batched import NestTemplate

#: smallest template group worth a batched evaluation under
#: use_batched="auto" (a first batched call pays device warm-up; scalar
#: evaluations are ~a millisecond)
MIN_BATCH_GROUP = 64


@dataclasses.dataclass
class MapspaceConstraints:
    """Partial constraints: which ranks may be tiled at which level, loop
    order templates, and spatial rank assignment per level."""

    #: rank -> number of levels it may split across (default: all levels)
    max_factors: int | None = None
    #: per-level allowed permutation templates; None = try all orders
    permutations: dict[int, Sequence[str]] | None = None
    #: {level: {rank: bound}} forced spatial loops
    spatial: dict[int, dict[str, int]] | None = None
    #: cap on candidates evaluated
    budget: int = 2000
    seed: int = 0


@dataclasses.dataclass
class SearchResult:
    best: Evaluation | None
    best_nest: LoopNest | None
    evaluated: int
    valid: int
    #: per-generation trajectory (repro_torch.search.SearchLog) when the
    #: result came from a stochastic strategy; None for enumeration
    log: object | None = None
    #: the winning Design when the search also proposed design points
    #: ((design, mapping) co-search); None for mapping-only searches
    best_design: object | None = None

    @property
    def cycles(self) -> float:
        return self.best.cycles if self.best else float("inf")


def spatial_residual(workload: Workload,
                     spatial: dict[int, dict[str, int]] | None
                     ) -> dict[str, int]:
    """Per-rank bounds left to tile temporally after dividing out the
    forced spatial factors.  Shared by the enumerating candidate
    generator and the genome encoding (search package) so both describe
    the identical mapspace slice."""
    residual = dict(workload.rank_bounds)
    for lvl, d in (spatial or {}).items():
        for r, b in d.items():
            if residual[r] % b:
                raise ValueError(f"spatial bound {b} does not divide {r}")
            residual[r] //= b
    return residual


def constrained_order(ranks: Sequence[str],
                      order: Sequence[str]) -> tuple[str, ...]:
    """All of ``ranks`` sorted by a (possibly partial) permutation
    constraint; unmentioned ranks go last in their original order.
    Shared by ``_full_template`` and the genome encoding."""
    key = {r: i for i, r in enumerate(order)}
    return tuple(sorted(ranks, key=lambda r: key.get(r, len(order) + 99)))


def _split_combos(workload: Workload, num_levels: int,
                  cons: MapspaceConstraints) -> list[tuple]:
    """Shared candidate enumeration: the shuffled cross-product of
    per-rank factor splits (combo[i][lvl] = temporal bound of rank i at
    level lvl, innermost level first).  Both the scalar nest generator
    and the array-lowering fast path consume this, so candidate sets and
    ordering are identical across dispatch modes."""
    ranks = list(workload.rank_bounds)
    residual = spatial_residual(workload, cons.spatial)

    per_rank_splits = {
        r: list(factor_splits(residual[r], num_levels)) for r in ranks
    }
    combos = list(itertools.product(*[per_rank_splits[r] for r in ranks]))
    random.Random(cons.seed).shuffle(combos)
    return combos


def _nests(workload: Workload, num_levels: int,
           cons: MapspaceConstraints) -> Iterable[LoopNest]:
    """Generate candidate nests: factor each rank across levels, then
    order loops within each level (sampled permutations)."""
    rng = random.Random(cons.seed)
    ranks = list(workload.rank_bounds)
    spatial = cons.spatial or {}
    combos = _split_combos(workload, num_levels, cons)

    emitted = 0
    for combo in combos:
        if emitted >= cons.budget:
            return
        # combo[i][lvl] = temporal bound of rank i at level lvl
        # (index 0 = innermost level)
        level_loops: list[list[Loop]] = [[] for _ in range(num_levels)]
        for i, r in enumerate(ranks):
            for lvl in range(num_levels):
                b = combo[i][lvl]
                if b > 1:
                    level_loops[lvl].append(Loop(r, b, lvl))
        for lvl, d in spatial.items():
            for r, b in d.items():
                if b > 1:
                    level_loops[lvl].append(Loop(r, b, lvl, spatial=True))

        # order within level: honour permutation template or sample
        def ordered(lvl: int) -> list[list[Loop]]:
            loops = level_loops[lvl]
            temporal = [lp for lp in loops if not lp.spatial]
            spat = [lp for lp in loops if lp.spatial]
            if cons.permutations and lvl in cons.permutations:
                order = {r: i for i, r in enumerate(cons.permutations[lvl])}
                temporal.sort(key=lambda lp: order.get(lp.rank, 99))
                return [temporal + spat]
            if len(temporal) <= 3:
                return [list(p) + spat
                        for p in itertools.permutations(temporal)]
            rng.shuffle(temporal)
            return [temporal + spat]

        for per_level in itertools.product(
                *[ordered(lvl) for lvl in range(num_levels)]):
            loops: list[Loop] = []
            for lvl in range(num_levels - 1, -1, -1):
                loops.extend(per_level[lvl])
            emitted += 1
            yield LoopNest(loops=tuple(loops), num_levels=num_levels)
            if emitted >= cons.budget:
                return


def search(design: Design, workload: Workload,
           cons: MapspaceConstraints | None = None,
           objective: Callable[[Evaluation], float] | str | None = None,
           use_batched: bool | str = "auto",
           strategy: object | None = None,
           device=None,
           **strategy_kw) -> SearchResult:
    """Find the best valid mapping.  Default objective: EDP.

    ``strategy``: ``None`` (default) enumerates ``cons.budget``
    candidates.  A strategy name (``"es"``, ``"hillclimb"``,
    ``"annealing"``, ``"random"``) or a ``repro_torch.search`` Strategy
    instance instead runs stochastic search over the same mapspace slice
    at the same evaluation budget (``repro_torch.search.run_search``);
    extra keyword arguments (``key=``, ``generations=``, ``pop_size=``,
    ``design_space=`` — a ``repro_torch.search.DesignSpace`` turns the
    run into (design, mapping) co-search, winner in
    ``result.best_design``, ...) pass through, and the returned result
    carries its trajectory in ``result.log``.

    ``device``: where the batched engine runs — the CUDA card when None,
    the CPU only for ``device="cpu"``.  The scalar loop and the winner's
    re-validation run on the host.

    ``use_batched``: ``"auto"`` (default) dispatches to the batched
    engine only when a slice is big enough to amortize its first call
    (>= ``MIN_BATCH_GROUP`` candidates — the whole budget when every
    level's permutation is constrained, else per loop-structure group);
    ``True`` batches everything regardless of size; ``False`` forces the
    scalar loop.  A custom ``objective`` (which needs the full
    per-candidate ``Evaluation``) always uses the scalar loop; every
    density model (actual-data included) batches.
    """
    if use_batched not in (False, True, "auto"):
        raise ValueError(f"use_batched must be False, True or 'auto', "
                         f"got {use_batched!r}")
    if strategy is not None:
        if objective is not None and not isinstance(objective, str):
            raise ValueError(
                "strategy search optimizes a metric name ('edp', "
                "'cycles' or 'energy_pj'); callable objectives need the "
                "enumerating path (strategy=None)")
        from ..search.runner import run_search
        if use_batched != "auto" and "batch_threshold" not in strategy_kw:
            # honour the dispatch override: True = batch every group,
            # False = force the scalar loop
            strategy_kw["batch_threshold"] = 0 if use_batched else 10 ** 18
        return run_search(design, workload, cons=cons, strategy=strategy,
                          metric=objective or "edp", device=device,
                          **strategy_kw)
    if strategy_kw:
        raise TypeError(f"unexpected arguments {sorted(strategy_kw)} "
                        f"(only valid with strategy=)")
    if isinstance(objective, str):
        if objective not in ("edp", "cycles", "energy_pj"):
            raise ValueError(f"objective must be 'edp', 'cycles' or "
                             f"'energy_pj' (or a callable), "
                             f"got {objective!r}")
        metric = objective
        # "edp" is the built-in default; other metrics become accessors
        # (and take the scalar loop, like any custom objective)
        objective = (None if metric == "edp"
                     else (lambda ev: getattr(ev, metric)))
    cons = cons or MapspaceConstraints()
    model = Sparseloop(design, device=device)

    if use_batched is not False and objective is None:
        from .batched import batched_supported
        if batched_supported(design, workload):
            min_group = 0 if use_batched is True else MIN_BATCH_GROUP
            template = _full_template(workload, design.arch.num_levels,
                                      cons)
            if template is not None:
                res = _search_lowered(model, workload, cons, template,
                                      min_candidates=min_group)
                if res is not None:
                    return res
            else:
                return _search_batched(
                    model, workload,
                    list(_nests(workload, design.arch.num_levels, cons)),
                    min_group)

    objective = objective or (lambda ev: ev.edp)
    best, best_nest, best_obj = None, None, float("inf")
    n_eval = n_valid = 0
    for nest in _nests(workload, design.arch.num_levels, cons):
        try:
            ev = model.evaluate(workload, nest)
        except ValueError:
            continue
        n_eval += 1
        if not ev.result.valid:
            continue
        n_valid += 1
        obj = objective(ev)
        if obj < best_obj:
            best, best_nest, best_obj = ev, nest, obj
    return SearchResult(best=best, best_nest=best_nest,
                        evaluated=n_eval, valid=n_valid)


def _full_template(workload: Workload, num_levels: int,
                   cons: MapspaceConstraints) -> "NestTemplate | None":
    """When every level's permutation is constrained, ALL candidates embed
    into one template (absent loops become unit bounds) — a single
    program covers the whole mapspace slice.  Returns None otherwise."""
    if not cons.permutations:
        return None
    if any(lvl not in cons.permutations for lvl in range(num_levels)):
        return None
    from .batched import NestTemplate
    ranks = list(workload.rank_bounds)
    spatial = cons.spatial or {}
    slots: list[tuple[str, int, bool]] = []
    for lvl in range(num_levels - 1, -1, -1):
        slots += [(r, lvl, False)
                  for r in constrained_order(ranks,
                                             cons.permutations[lvl])]
        slots += [(r, lvl, True)
                  for r, b in spatial.get(lvl, {}).items() if b > 1]
    return NestTemplate(slots=tuple(slots), num_levels=num_levels)


def _search_lowered(model: Sparseloop, workload: Workload,
                    cons: MapspaceConstraints, template: "NestTemplate",
                    min_candidates: int = 0) -> SearchResult | None:
    """Array-lowering fast path: the candidate population is generated
    *directly* as a dense (C, num_slots) bound matrix — no LoopNest
    objects until the winner is materialized.  One batched evaluation
    covers the entire budget; only the best mapping goes back through
    the scalar oracle.  Returns None when the budget is below
    ``min_candidates`` (not worth a batched call — caller falls back to
    the scalar loop)."""
    from .batched import bucket_for
    ranks = list(workload.rank_bounds)
    spatial = cons.spatial or {}
    combos = _split_combos(workload, template.num_levels, cons)
    combos = combos[: cons.budget]
    if min_candidates and len(combos) < min_candidates:
        return None
    if not combos:
        return SearchResult(best=None, best_nest=None, evaluated=0, valid=0)
    # combo[i][lvl] = temporal bound of rank i at level lvl
    arr = np.asarray(combos, np.int64)
    bounds = np.ones((len(combos), template.num_slots), np.int64)
    for j, (r, lvl, sp) in enumerate(template.slots):
        if sp:
            bounds[:, j] = spatial.get(lvl, {}).get(r, 1)
        else:
            bounds[:, j] = arr[:, ranks.index(r), lvl]
    # lower through the template's bucket: a permutation-constrained
    # search then shares its program with every other loop order
    # of the same workload (free-permutation searches included)
    bucket = bucket_for(template, tuple(ranks))
    padded, ids = bucket.lower_population(template, bounds)
    res = model.bucketed_model(workload, bucket).evaluate(padded, ids)
    return _validated_result(model, workload,
                             lambda i: template.nest_with(bounds[i]),
                             edp=res["edp"], valid=res["valid"],
                             n_eval=len(combos))


def _search_batched(model: Sparseloop, workload: Workload,
                    nests: list[LoopNest], min_group: int) -> SearchResult:
    """Grouped dispatch: per-bucket batched EDP ranking (mixed loop
    orders share one program), scalar oracle for small groups
    and for the final winner."""
    from . import compile_stats
    from .batched import group_by_bucket, lower_nests
    C = len(nests)
    edp = np.full(C, np.inf)
    valid = np.zeros(C, dtype=bool)
    n_eval = 0
    scalar_idxs: list[int] = []
    ranks = tuple(workload.rank_bounds)

    for bucket, idxs in group_by_bucket(nests, ranks).items():
        if len(idxs) < max(1, min_group):
            scalar_idxs.extend(idxs)
            continue
        bm = model.bucketed_model(workload, bucket)
        bounds, ids, order = lower_nests(bucket, nests, idxs)
        res = bm.evaluate(bounds, ids)
        edp[order] = res["edp"]
        valid[order] = res["valid"]
        n_eval += len(idxs)

    compile_stats.record_scalar_evals(len(scalar_idxs))
    for i in scalar_idxs:
        try:
            ev = model.evaluate(workload, nests[i])
        except ValueError:
            continue
        n_eval += 1
        if ev.result.valid:
            edp[i] = ev.edp
            valid[i] = True

    return _rank_batched(model, workload, nests, edp, valid, n_eval)


def _rank_batched(model: Sparseloop, workload: Workload,
                  nests: Sequence[LoopNest], edp, valid,
                  n_eval: int) -> SearchResult:
    return _validated_result(model, workload, lambda i: nests[i],
                             edp=edp, valid=valid, n_eval=n_eval)


def _validated_result(model: Sparseloop, workload: Workload,
                      nest_at: Callable[[int], LoopNest], edp, valid,
                      n_eval: int,
                      check_capacity: bool = True,
                      model_at: "Callable[[int], Sparseloop] | None" = None
                      ) -> SearchResult:
    """Materialize the winner of a batched ranking, *validated through
    the scalar oracle*: walk candidates best-EDP-first (stable order —
    matches the scalar loop's tie-breaking) and return the first one the
    reference model confirms valid.  Guards against batched/scalar drift
    leaking a mapping the reference model rejects; a scalar-rejected
    candidate is dropped from the valid count.

    ``model_at`` supplies a per-candidate oracle for (design, mapping)
    co-search rankings — each candidate is re-validated under ITS OWN
    design, and the winning design rides out as
    ``SearchResult.best_design``."""
    valid = np.asarray(valid, dtype=bool)
    n_valid = int(valid.sum())
    if n_valid == 0:
        return SearchResult(best=None, best_nest=None,
                            evaluated=n_eval, valid=0)
    order = np.argsort(np.where(valid, edp, np.inf), kind="stable")
    for idx in order[:n_valid]:
        nest = nest_at(int(idx))
        m = model_at(int(idx)) if model_at is not None else model
        try:
            best = m.evaluate(workload, nest,
                              check_capacity=check_capacity)
        except ValueError:
            n_valid -= 1
            continue
        if best.result.valid:
            return SearchResult(
                best=best, best_nest=nest, evaluated=n_eval,
                valid=n_valid,
                best_design=m.design if model_at is not None else None)
        n_valid -= 1
    return SearchResult(best=None, best_nest=None,
                        evaluated=n_eval, valid=0)


def best_of(design: Design, workload: Workload, budget: int = 500,
            spatial: dict[int, dict[str, int]] | None = None,
            seed: int = 0) -> SearchResult:
    return search(design, workload,
                  MapspaceConstraints(budget=budget, spatial=spatial,
                                      seed=seed))
