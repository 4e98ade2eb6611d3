"""How ``correct`` is decided: the program's answers held to the frozen
reference (``portbench.reference``), which works each one out again from
the mapping alone.

The program's answers come in two kinds:

* a *row*: one mapping with what the program claimed for it, as
  ``{source: (valid, cycles, energy_pj, edp)}`` (``None`` where the
  source claims no such number).  Rows are each search's winner (the
  program's scalar re-validation and its log's best) and a sample, drawn
  from the seed, of the per-candidate answers of the timed searches: a
  host-loop generation's whole population as its evaluation returned it,
  or the population a fused chunk hands on, with its fitness;
* a *generation*: the whole population one generation scored, with the
  count of valid candidates and the best fitness the program reported
  for it (the fused graph's per-generation outputs).

The numbers compared, each with its limit (:data:`LIMITS`):

* ``missing``: searches that raised or found nothing;
* ``illegal``: judged mappings that are no legal factorisation of their
  layer under the configuration's spatial constraint;
* ``stalled``: sampled generations whose population the step handed on
  unchanged (a search that has stopped searching);
* ``valid_mismatch``: rows whose validity (the tiles fit) the program
  and the reference disagree on, and generations whose best is finite on
  one side only;
* ``valid_count_gap``: over the judged generations, the sum of the gaps
  between the valid candidates the program counted and the reference's;
* ``metric_gap``: the widest relative gap, over the rows both call valid
  and the generations' bests, between a claimed number and the
  reference's.

The control (:func:`control`) puts the reference itself in the program's
place, computed in float32 (``reference.computed_in``), the precision
below the configuration's float64.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .. import reference as ref

#: ``metric_gap``'s two readings: the program's widest on the card over
#: both cells' runs, and the float32 control's narrowest over the
#: configurations the tests hold (the STC one's: structured and dense
#: operands, where only float32's rounding shows, not the jump that
#: float32 ``lgamma`` of a large tensor makes in the cells)
METRIC_GAP_READINGS = (2.44e-9, 6.46e-8)

#: each number's limit; PERF.md gives the readings each was set from.
#: ``metric_gap``'s is the geometric middle of its two readings
LIMITS = {"missing": 0, "illegal": 0, "stalled": 0, "valid_mismatch": 0,
          "valid_count_gap": 0, "metric_gap": 1.26e-8}

METRICS = ("cycles", "energy_pj", "edp")


@dataclasses.dataclass
class Row:
    """One mapping (``loops``: ``(rank, bound, level, spatial)``,
    outermost first) of layer ``layer`` and the program's claims about
    it: ``{source: (valid, cycles, energy_pj, edp)}``."""

    label: str
    layer: int
    loops: tuple
    claims: dict


@dataclasses.dataclass
class Generation:
    """A population of layer ``layer`` (``children``: one loop tuple a
    candidate) and what the program reported for it: how many were
    valid and the best (least) fitness, by :data:`FITNESS`."""

    label: str
    layer: int
    children: list
    valid_count: int
    best: float


#: the searches' fitness: the metric they minimise
FITNESS = "edp"


class Reference:
    """The reference's design and workloads for one configuration, with
    evaluations cached by (layer, mapping)."""

    def __init__(self, cfg, precision=float):
        self.cfg = cfg
        self.precision = precision
        design = cfg.reference_design()
        self.design = (design if precision is float
                       else ref.design_in(design, precision))
        self.model = ref.Sparseloop(self.design)
        self.workloads = [cfg.reference_workload(lay) for lay in cfg.layers]
        self.spatial = cfg.spatial(design)
        self._cache: dict = {}

    def evaluate(self, layer: int, loops) -> tuple:
        """``(valid, cycles, energy_pj, edp)`` of a mapping."""
        k = (layer, tuple(loops))
        hit = self._cache.get(k)
        if hit is None:
            n = self.design.arch.num_levels
            nest = ref.LoopNest(tuple(ref.Loop(r, int(b), int(lvl), bool(sp))
                                      for r, b, lvl, sp in loops), n)
            with ref.computed_in(self.precision):
                ev = self.model.evaluate(self.workloads[layer], nest,
                                         check_capacity=self.cfg.check_capacity)
            r = ev.result
            hit = ((True, float(r.cycles), float(r.energy_pj), float(r.edp))
                   if r.valid else (False, math.inf, math.inf, math.inf))
            self._cache[k] = hit
        return hit

    def legal(self, layer: int, loops) -> bool:
        """Is ``loops`` a legal factorisation of the layer, with exactly
        the configuration's spatial loops?"""
        bounds = self.workloads[layer].rank_bounds
        n = self.design.arch.num_levels
        prod = {r: 1 for r in bounds}
        seen, spatial, last = set(), set(), n
        for r, b, lvl, sp in loops:
            if r not in prod or not 0 <= lvl < n or lvl > last or b < 1:
                return False
            last = lvl
            prod[r] *= b
            if sp:
                spatial.add((lvl, r, b))
            elif (lvl, r) in seen:
                return False
            else:
                seen.add((lvl, r))
        want = {(lvl, r, b) for lvl, d in self.spatial.items()
                for r, b in d.items() if b > 1}
        return prod == dict(bounds) and spatial == want

    def generation(self, gen: Generation) -> tuple[int, float, int]:
        """``(valid count, best fitness, illegal children)`` of a
        population by the reference."""
        col = 1 + METRICS.index(FITNESS)
        count, best, illegal = 0, math.inf, 0
        for loops in gen.children:
            if not self.legal(gen.layer, loops):
                illegal += 1
                continue
            got = self.evaluate(gen.layer, loops)
            if got[0]:
                count += 1
                best = min(best, got[col])
        return count, best, illegal


def control(rows, gens, cfg) -> tuple[list[Row], list[Generation]]:
    """``rows`` and ``gens`` with every claim replaced by the float32
    reference's answer for the same mappings: the control."""
    low = Reference(cfg, precision=np.float32)
    out = []
    for row in rows:
        got = low.evaluate(row.layer, row.loops)
        out.append(dataclasses.replace(
            row, claims={k: got for k in row.claims}))
    out_g = []
    for gen in gens:
        count, best, _ = low.generation(gen)
        out_g.append(dataclasses.replace(gen, valid_count=count, best=best))
    return out, out_g


def _gap(got: float, want: float) -> float:
    return abs(float(got) - want) / abs(want) if math.isfinite(got) else math.inf


def readings(rows, cfg, missing: int = 0, gens=(), stalled: int = 0,
             reference: Reference | None = None) -> dict:
    """The numbers compared, over ``rows`` and ``gens``."""
    reference = reference or Reference(cfg)
    out = {"missing": int(missing), "illegal": 0, "stalled": int(stalled),
           "valid_mismatch": 0, "valid_count_gap": 0, "metric_gap": 0.0}
    worst = None

    def widen(gap, where):
        nonlocal worst
        if gap > out["metric_gap"]:
            out["metric_gap"] = gap
            worst = where

    for row in rows:
        if not reference.legal(row.layer, row.loops):
            out["illegal"] += 1
            continue
        want = reference.evaluate(row.layer, row.loops)
        for source, got in row.claims.items():
            if bool(got[0]) != want[0]:
                out["valid_mismatch"] += 1
                continue
            if not want[0]:
                continue
            for name, g, w in zip(METRICS, got[1:], want[1:]):
                if g is not None:
                    widen(_gap(g, w), (row.label, source, name, float(g), w))
    for gen in gens:
        count, best, illegal = reference.generation(gen)
        out["illegal"] += illegal
        out["valid_count_gap"] += abs(int(gen.valid_count) - count)
        if math.isfinite(best) != math.isfinite(gen.best):
            out["valid_mismatch"] += 1
        elif math.isfinite(best):
            widen(_gap(gen.best, best),
                  (gen.label, "generation best", FITNESS, float(gen.best), best))
    out["rows"] = len(rows)
    out["children"] = sum(len(g.children) for g in gens)
    out["worst"] = worst
    return out


def verdict(read: dict) -> tuple[bool, list[tuple[str, float, float]]]:
    """``(correct, [(name, value, limit), ...])``."""
    checks = [(k, read[k], LIMITS[k]) for k in LIMITS]
    ok = all(v <= lim for _, v, lim in checks)
    return ok, checks
