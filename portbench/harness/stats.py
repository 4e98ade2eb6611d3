"""The benchmark's arithmetic: percentiles, spreads, seeds."""
from __future__ import annotations

import math
import statistics

import numpy as np


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``:
    the smallest value with at least ``q`` percent of the values at or
    below it."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def spread(values) -> float:
    """Interquartile distance as a share of the median, by
    ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def key(seed: int, *stream: int) -> int:
    """A 62-bit key for ``stream`` of ``seed`` (any non-negative int)."""
    a, b = np.random.SeedSequence([int(seed), *map(int, stream)]
                                  ).generate_state(2, np.uint32)
    return (int(a) << 30) ^ int(b)


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed), *map(int, stream)]))
