"""Stochastic mapspace search strategies (SparseMap-style, arXiv
2508.12906): ask/tell loops over genome populations.

All strategies share one interface:

  * ``init(key, enc)``  -> opaque mutable state (holds the generator)
  * ``ask(state, enc)``  -> (pop_size, genome_size) int population
  * ``tell(state, enc, genomes, fitness)`` -> update state

Fitness is minimized; invalid candidates carry ``+inf``.  Every random
draw comes from the ``torch.Generator`` held by the state (an int key
seeds a fresh one), so a run is bit-reproducible from its seed alone —
same seed, same trajectory (`tests/test_torch_search.py` pins this).
The distributions are the JAX package's; the random stream is not.

Mutation/crossover kernels operate on the genome encoding of
``encoding.MapspaceEncoding``: factor genes move a prime factor to a
different storage level; permutation genes reseat a level's loop order;
factor-swap crossover exchanges whole per-rank factor blocks between
parents (swapping a rank's entire tiling, the recombination move that
respects divisor validity by construction).

The kernels are encoding-agnostic: they read only ``cardinality``,
``gene_block`` and the population constructors, so the (design,
mapping) co-search genome (``encoding.CoSearchEncoding`` — mapping
genes followed by one design gene per ``DesignSpace`` knob) works
unchanged.  Every strategy then proposes JOINT (design, mapping) points:
mutation resamples a provisioning decision the way it reseats a loop
order, and each design gene is its own crossover block, so
recombination can graft one parent's buffer sizing onto the other's
tiling.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np
import torch

from .encoding import MapspaceEncoding, generator, randint


def _bernoulli(key, p: float, shape) -> np.ndarray:
    """Independent True w.p. ``p`` of ``shape`` (bool numpy)."""
    return torch.rand(tuple(shape), generator=generator(key),
                      dtype=torch.float64).numpy() < p


def _uniform(key, shape) -> np.ndarray:
    return torch.rand(tuple(shape), generator=generator(key),
                      dtype=torch.float64).numpy()


def mutate(key, genomes: np.ndarray, enc: MapspaceEncoding,
           rate: float) -> np.ndarray:
    """Resample each gene independently w.p. ``rate`` (factor genes pick a
    uniform level, permutation genes a uniform order), forcing at least
    one resampled gene per genome so no proposal wastes an evaluation."""
    gen = generator(key)
    g = np.asarray(genomes, np.int64)
    if g.shape[1] == 0:
        return g.copy()
    flip = _bernoulli(gen, rate, g.shape)
    forced = randint(gen, (len(g),), g.shape[1])
    flip[np.arange(len(g)), forced] = True
    fresh = randint(gen, g.shape, enc.cardinality)
    return np.where(flip, fresh, g)


def init_population(key, enc: MapspaceEncoding, n: int) -> np.ndarray:
    """Initial population for adaptive strategies: half block-structured
    genomes (the corners good tilings live in), half uniform (diversity).
    RandomSearch keeps pure uniform sampling — it is the baseline."""
    gen = generator(key)
    half = n // 2
    return np.concatenate([enc.structured_population(gen, n - half),
                           enc.random_population(gen, half)])


def crossover(key, pa: np.ndarray, pb: np.ndarray,
              enc: MapspaceEncoding) -> np.ndarray:
    """Factor-swap crossover: each child takes every gene *block* (one
    rank's whole factor assignment, or one level's permutation gene) from
    parent A or B uniformly."""
    pa = np.asarray(pa, np.int64)
    pb = np.asarray(pb, np.int64)
    if pa.shape[1] == 0:
        return pa.copy()
    pick = _bernoulli(key, 0.5, (len(pa), enc.num_blocks))
    return np.where(pick[:, enc.gene_block], pa, pb)


class Strategy(Protocol):
    name: str
    pop_size: int

    def init(self, key, enc: MapspaceEncoding): ...
    def ask(self, state, enc: MapspaceEncoding) -> np.ndarray: ...
    def tell(self, state, enc: MapspaceEncoding, genomes: np.ndarray,
             fitness: np.ndarray) -> None: ...


@dataclasses.dataclass
class _KeyState:
    #: the run's ``torch.Generator``; every draw advances it
    key: torch.Generator


# ----------------------------------------------------------------------
@dataclasses.dataclass
class RandomSearch:
    """Uniform i.i.d. sampling — the baseline every other strategy must
    beat at equal evaluation budget."""

    pop_size: int = 64
    name: str = "random"

    def init(self, key, enc):
        return _KeyState(key=generator(key))

    def ask(self, state, enc):
        return enc.random_population(state.key, self.pop_size)

    def tell(self, state, enc, genomes, fitness):
        pass


# ----------------------------------------------------------------------
@dataclasses.dataclass
class _HillState(_KeyState):
    best: np.ndarray | None = None
    best_fit: float = float("inf")


@dataclasses.dataclass
class HillClimb:
    """Batched steepest-ascent: propose ``pop_size`` mutations of the
    incumbent per generation, adopt the best if it improves."""

    pop_size: int = 32
    mutation_rate: float = 0.15
    name: str = "hillclimb"

    def init(self, key, enc):
        return _HillState(key=generator(key))

    def ask(self, state, enc):
        if state.best is None:
            return init_population(state.key, enc, self.pop_size)
        return mutate(state.key,
                      np.tile(state.best, (self.pop_size, 1)),
                      enc, self.mutation_rate)

    def tell(self, state, enc, genomes, fitness):
        i = int(np.argmin(fitness))
        if state.best is None or fitness[i] < state.best_fit:
            state.best = np.asarray(genomes[i], np.int64).copy()
            state.best_fit = float(fitness[i])


# ----------------------------------------------------------------------
@dataclasses.dataclass
class _AnnealState(_KeyState):
    cur: np.ndarray | None = None
    cur_fit: np.ndarray | None = None
    gen: int = 0


@dataclasses.dataclass
class SimulatedAnnealing:
    """``pop_size`` independent Metropolis chains on log-fitness with a
    geometric cooling schedule (EDP spans orders of magnitude, so the
    acceptance test uses log-ratios: accept w.p.
    ``exp(-(ln f' - ln f) / T)``)."""

    pop_size: int = 32
    mutation_rate: float = 0.15
    t0: float = 0.5
    cooling: float = 0.92
    name: str = "annealing"

    def init(self, key, enc):
        return _AnnealState(key=generator(key))

    def ask(self, state, enc):
        if state.cur is None:
            return init_population(state.key, enc, self.pop_size)
        return mutate(state.key, state.cur, enc, self.mutation_rate)

    def tell(self, state, enc, genomes, fitness):
        fitness = np.asarray(fitness, np.float64)
        if state.cur is None:
            state.cur = np.asarray(genomes, np.int64).copy()
            state.cur_fit = fitness.copy()
            state.gen = 1
            return
        temp = max(1e-9, self.t0 * self.cooling ** state.gen)
        delta = (np.log(np.clip(fitness, 1e-300, 1e300))
                 - np.log(np.clip(state.cur_fit, 1e-300, 1e300)))
        u = _uniform(state.key, (len(fitness),))
        accept = (fitness < state.cur_fit) \
            | (u < np.exp(np.clip(-delta / temp, -700.0, 0.0)))
        state.cur = np.where(accept[:, None], genomes, state.cur)
        state.cur_fit = np.where(accept, fitness, state.cur_fit)
        state.gen += 1


# ----------------------------------------------------------------------
@dataclasses.dataclass
class _ESState(_KeyState):
    pop: np.ndarray | None = None
    fit: np.ndarray | None = None


@dataclasses.dataclass
class EvolutionStrategy:
    """SparseMap-style (mu + lambda) evolution: tournament selection,
    factor-swap crossover, per-gene mutation; survivors are the best
    ``pop_size`` of parents + children (elitism for free).  A slice of
    each generation (``immigrants``) is fresh uniform genomes, keeping
    enough diversity to escape permutation-plateau local optima."""

    pop_size: int = 32
    tournament: int = 3
    crossover_rate: float = 0.6
    mutation_rate: float = 0.15
    immigrants: float = 0.25
    name: str = "es"

    def init(self, key, enc):
        return _ESState(key=generator(key))

    def _select(self, key, fit: np.ndarray, n: int) -> np.ndarray:
        """Tournament selection: n winners, each the fittest of
        ``tournament`` uniform draws."""
        draws = randint(key, (n, self.tournament), len(fit))
        return draws[np.arange(n), np.argmin(fit[draws], axis=1)]

    def ask(self, state, enc):
        gen = state.key
        if state.pop is None:
            return init_population(gen, enc, self.pop_size)
        pa = state.pop[self._select(gen, state.fit, self.pop_size)]
        pb = state.pop[self._select(gen, state.fit, self.pop_size)]
        do_cross = _bernoulli(gen, self.crossover_rate, (self.pop_size,))
        children = np.where(do_cross[:, None],
                            crossover(gen, pa, pb, enc), pa)
        children = mutate(gen, children, enc, self.mutation_rate)
        n_imm = int(round(self.immigrants * self.pop_size))
        if n_imm:
            children[-n_imm:] = enc.random_population(gen, n_imm)
        return children

    def tell(self, state, enc, genomes, fitness):
        genomes = np.asarray(genomes, np.int64)
        fitness = np.asarray(fitness, np.float64)
        if state.pop is None:
            pop, fit = genomes, fitness
        else:
            pop = np.concatenate([state.pop, genomes])
            fit = np.concatenate([state.fit, fitness])
        order = np.argsort(fit, kind="stable")[: self.pop_size]
        state.pop, state.fit = pop[order].copy(), fit[order].copy()


STRATEGIES: dict[str, type] = {
    "random": RandomSearch,
    "hillclimb": HillClimb,
    "annealing": SimulatedAnnealing,
    "es": EvolutionStrategy,
}


def make_strategy(spec: "str | Strategy", **overrides) -> Strategy:
    """'es' / 'hillclimb' / 'annealing' / 'random' or a ready instance."""
    if isinstance(spec, str):
        try:
            cls = STRATEGIES[spec]
        except KeyError:
            raise ValueError(
                f"unknown strategy {spec!r}; pick one of "
                f"{sorted(STRATEGIES)} or pass a Strategy instance"
            ) from None
        return cls(**overrides)
    if overrides:
        return dataclasses.replace(spec, **overrides)
    return spec
