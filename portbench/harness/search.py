"""A closed loop of architects' searches: one ``run_search`` after
another, search ``i`` on layer ``i mod L`` with a key drawn from the
seed, until the window's time is up.  The window closes when the search
running at that moment ends, so the rate is all the candidates scored
over all the time taken.

Traffic keys: ``strategy``, ``fused``, ``pop_size``, ``generations``,
``chunk`` (generations per fused chunk), ``trace_searches`` (searches
under the profiler in a ``--trace 1`` run), and what the judge samples:
each search is sampled with probability ``judge_share`` (drawn from the
seed), at most ``judge_searches`` a run, and of a sampled search one
chunk (fused) or one generation (host loop), drawn from the seed, is
kept (:class:`Tap`); ``judge_rows`` is how many candidates of the
population a fused chunk hands on are judged."""
from __future__ import annotations

import math
import sys
import time

import numpy as np

from . import stats
from .judge import Generation, Row


def loops_of(nest) -> tuple:
    return tuple((lp.rank, int(lp.bound), int(lp.level), bool(lp.spatial))
                 for lp in nest.loops)


class Tap:
    """Keeps the program's own per-candidate answers of the sampled
    searches, as the timed path produced them: it wraps the host loop's
    population evaluation (``PopulationEvaluator.__call__``) and the
    fused chunk (``FusedProgram.invoke_chunk``) for the window's length
    and copies what a sampled call returned.  The mappings are decoded
    (by the program's ``enc.nest_of``) and judged after the window."""

    def __init__(self, seed: int, traffic: dict, gens: int):
        self.seed = seed
        self.share = float(traffic.get("judge_share", 0.0))
        self.cap = int(traffic.get("judge_searches", 0))
        self.rows_per = int(traffic.get("judge_rows", 64))
        self.fused = bool(traffic["fused"])
        chunk = max(1, int(traffic.get("chunk", 16)))
        self.calls_per_search = math.ceil(gens / chunk) if self.fused else gens
        self.kept: list = []
        self.target = None

    def begin(self, i: int, layer: int) -> None:
        """Search ``i`` (on ``layer``) starts."""
        self.i, self.layer, self.calls, self.prev = i, layer, 0, None
        self.target = None
        if (len(self.kept) < self.cap
                and stats.rng(self.seed, 3, i).random() < self.share):
            lo = 0 if self.fused else min(1, self.calls_per_search - 1)
            self.target = int(stats.rng(self.seed, 4, i).integers(
                lo, self.calls_per_search))

    def __enter__(self):
        from repro_torch.search import fused, runner
        self._real = (runner.PopulationEvaluator.__call__,
                      fused.FusedProgram.invoke_chunk)
        real_eval, real_chunk = self._real
        names = fused._CARRY
        tap = self

        def evaluate(ev, genomes):
            out = real_eval(ev, genomes)
            if tap.target is not None:
                if tap.calls == tap.target:
                    tap.kept.append(("host", tap.i, tap.layer, ev.enc,
                                     np.array(genomes),
                                     {k: np.array(v) for k, v in out.items()},
                                     tap.prev))
                tap.prev = np.array(genomes) if tap.calls + 1 == tap.target \
                    else None
            tap.calls += 1
            return out

        def invoke_chunk(fp, carry, length):
            new, ys = real_chunk(fp, carry, length)
            if tap.target is not None and tap.calls == tap.target:
                c_in, c_out = dict(zip(names, carry)), dict(zip(names, new))
                tap.kept.append(("fused", tap.i, tap.layer, fp.enc,
                                 c_in["pending"].cpu().numpy(),
                                 c_out["pop"].cpu().numpy(),
                                 c_out["fit"].cpu().numpy(),
                                 c_out["pending"].cpu().numpy(),
                                 int(ys["valid_count"][0]),
                                 float(ys["best_fitness"][0])))
            tap.calls += 1
            return new, ys

        runner.PopulationEvaluator.__call__ = evaluate
        fused.FusedProgram.invoke_chunk = invoke_chunk
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.search import fused, runner
        (runner.PopulationEvaluator.__call__,
         fused.FusedProgram.invoke_chunk) = self._real

    def judged(self) -> tuple[list[Row], list[Generation], int]:
        """The kept answers as the judge's rows and generations, and how
        many sampled steps handed their population on unchanged."""
        rows, gens, stalled = [], [], 0
        for kind, i, layer, enc, *rest in self.kept:
            if kind == "host":
                genomes, out, prev = rest
                if prev is not None and np.array_equal(prev, genomes):
                    stalled += 1
                for c, g in enumerate(genomes):
                    rows.append(Row(
                        f"search {i} layer {layer} candidate {c}", layer,
                        loops_of(enc.nest_of(g)), {"evaluation": (
                            bool(out["valid"][c]), float(out["cycles"][c]),
                            float(out["energy_pj"][c]), float(out["edp"][c]))}))
                continue
            pending, pop, fit, pending_out, count, best = rest
            if np.array_equal(pending, pending_out):
                stalled += 1
            gens.append(Generation(
                f"search {i} layer {layer} chunk children", layer,
                [loops_of(enc.nest_of(g)) for g in pending], count, best))
            # an infinite fitness is an invalid child or a placeholder of
            # the first fold, never scored: the generation's count judges
            # validity, these rows the scores
            scored = np.flatnonzero(np.isfinite(fit))
            pick = stats.rng(self.seed, 6, i).choice(
                scored, size=min(len(scored), self.rows_per), replace=False)
            for c in sorted(pick):
                f = float(fit[c])
                rows.append(Row(
                    f"search {i} layer {layer} handed on {c}", layer,
                    loops_of(enc.nest_of(pop[c])),
                    {"fitness": (True, None, None, f)}))
        return rows, gens, stalled


class SearchDriver:
    def __init__(self, cfg, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.pop = int(traffic["pop_size"])
        self.gens = int(traffic["generations"])

    def setup(self) -> None:
        from repro_torch.core.mapper import MapspaceConstraints
        from repro_torch.search import SearchConfig
        self.design = self.cfg.program_design()
        self.workloads = [self.cfg.program_workload(lay)
                          for lay in self.cfg.layers]
        self.cons = MapspaceConstraints(spatial=self.cfg.spatial(self.design),
                                        budget=self.pop * self.gens)
        self.config = SearchConfig(fused_chunk=int(self.traffic.get("chunk", 16)))
        # one whole search a layer: every bucket program, every graph
        # capture and every shape the window meets
        for i in range(len(self.workloads)):
            self._search(i, stats.key(self.seed, 1, i))

    def _search(self, layer: int, key: int):
        from repro_torch.search import run_search
        return run_search(
            self.design, self.workloads[layer], self.cons,
            strategy=self.traffic.get("strategy", "es"), key=key,
            generations=self.gens, pop_size=self.pop,
            fused=bool(self.traffic["fused"]), config=self.config,
            check_capacity=self.cfg.check_capacity, mesh=None,
            device=self.device)

    def window(self, seconds: float, tracer=None) -> dict:
        """Searches until ``seconds`` have passed; with ``tracer``, the
        first ``trace_searches`` run under it."""
        traced = int(self.traffic.get("trace_searches", 2)) if tracer else 0
        rows, failed, candidates, i = [], 0, 0, 0
        tap = Tap(self.seed, self.traffic, self.gens)
        took = []
        t_traced = None
        with tap:
            if traced:
                tracer.start()
            t0 = time.perf_counter()
            while True:
                layer = i % len(self.workloads)
                ts = time.perf_counter()
                tap.begin(i, layer)
                try:
                    res = self._search(layer, stats.key(self.seed, 0, i))
                except Exception as exc:  # noqa: BLE001 — a failed search is counted
                    print(f"search {i} failed: {exc!r}", file=sys.stderr)
                    res = None
                if res is not None:
                    candidates += res.evaluated
                if res is None or res.best is None:
                    failed += 1
                else:
                    rows.append(_row(i, layer, res))
                took.append(time.perf_counter() - ts)
                i += 1
                if traced and i == traced:
                    tracer.stop()
                    t_traced = time.perf_counter()
                if time.perf_counter() - t0 >= seconds and i > traced:
                    break
            t1 = time.perf_counter()
        sampled, gens, stalled = tap.judged()
        return {"attempted": i, "failed": failed, "candidates": candidates,
                "t0": t0, "t1": t1, "wall_s": t1 - t0,
                "rows": rows + sampled, "generations": gens,
                "stalled": stalled, "traced_generations": traced * self.gens,
                "untraced": (t_traced or t0, t1), "search_s": took}


def _row(i: int, layer: int, res) -> Row:
    """What search ``i`` claims: its validated winner (the program's
    scalar model) and its log's best (the batched engine)."""
    last = res.log.records[-1]
    return Row(f"search {i} layer {layer}", layer, loops_of(res.best_nest), {
        "winner": (bool(res.best.result.valid), float(res.best.cycles),
                   float(res.best.energy_pj), float(res.best.edp)),
        "log_best": (True, float(last.best_cycles),
                     float(last.best_energy_pj), float(last.best_edp))})
