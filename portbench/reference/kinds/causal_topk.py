"""A top-k selection inside the causal attention map as a density kind:
the attention map of a learned sparse attention (DeepSeek-V3.2's DSA,
whose lightning indexer keeps 2,048 keys a query).  Row ``i`` of a ``rows x
cols`` tensor has the support ``S_i = {j < cols : i - window < j <= i}``, of
``n_i`` columns, and exactly ``k_i = min(k, n_i)`` of them are nonzero,
drawn uniformly without replacement, the rows independent.  A ``k`` of at
least the window is the causal map.

Keys: ``window`` and ``k``, whole numbers >= 1 (``rows`` and ``cols`` come
from the tensor's shape in the layer).  Tiles are the causal kind's: a
tile of ``t`` elements is ``tr x tc``, ``tr`` the largest divisor of ``t``
at most ``sqrt(t)``, ``tc = t // tr``, on the aligned grid of ``nr = max(1,
rows // tr)`` by ``nc = max(1, cols // tc)`` tiles, each holding ``hh x kk
= min(tr, rows) x min(tc, cols)`` of the tensor.  With ``m_i`` the columns
of ``S_i`` inside a tile:

* ``prob_empty``: the mean over the tiles of ``prod_i C(n_i - m_i, k_i) /
  C(n_i, k_i)``;
* ``expected_density``: ``sum_i k_i |S_i inside the grid's columns| / n_i``
  over ``nr nc t``;
* ``max_nnz``: ``max`` over the tiles of ``sum_i min(k, m_i)``.

The work is over the rows and the row-strips at once, in NumPy, with no
loop over tiles or elements: a strip's tiles outside its run of nonempty
ones are empty for sure, the tiles all of whose rows hold every column
share one value, and the others, where a row's support starts or ends,
are at most two at either end of the run.  ``log C(x, k)`` is the sum of
``-log1p(-k / y)`` over ``y = k + 1 .. x``.  Answers are memoised per tile
size.  Imports ``math`` and NumPy only.
"""
import functools
import math

import numpy as np


def grid(rows, cols, t):
    """``(t, tr, tc, nr, nc, hh, kk)`` of a tile of ``t`` elements."""
    t = max(1, int(t))
    tr = math.isqrt(t)
    while t % tr:
        tr -= 1
    tc = t // tr
    return (t, tr, tc, max(1, rows // tr), max(1, cols // tc), min(tr, rows),
            min(tc, cols))


@functools.lru_cache(maxsize=8)
def support(rows, cols, window, k):
    """Per row ``(lo, hi, n, kept, log_inv)``: ``S_i = [lo, hi]`` of ``n``
    columns, ``kept = min(k, n)``, and ``log_inv[x] = -log C(x, k)`` (0
    for ``x <= k``)."""
    i = np.arange(rows)
    lo = np.maximum(i - window + 1, 0)
    hi = np.minimum(i, cols - 1)
    n = np.maximum(hi - lo + 1, 0)
    x = np.arange(int(n.max()) + 1, dtype=np.float64)
    step = np.where(x > k, -k / np.maximum(x, 1.0), 0.0)
    return lo, hi, n, np.minimum(n, k), np.cumsum(np.log1p(step))


@functools.lru_cache(maxsize=4096)
def tile_stats(rows, cols, window, k, t):
    """``(prob_empty, expected_density, max_nnz)`` at tile size ``t``."""
    lo, hi, n, kept, log_inv = support(rows, cols, window, k)
    t, tr, tc, nr, nc, hh, kk = grid(rows, cols, t)
    g = nr * hh
    inside = np.maximum(np.minimum(hi[:g], nc * tc - 1) - lo[:g] + 1, 0)
    share = np.where(n[:g] > 0, kept[:g] * inside / np.maximum(n[:g], 1),
                     0.0)
    lo, hi, n, kept = (v[:g].reshape(nr, hh) for v in (lo, hi, n, kept))
    top = np.arange(nr)[:, None] * tr
    # the strip's nonempty tiles are the columns [first, last]
    last = np.minimum((top + hh - 1) // tc, nc - 1)
    first = np.maximum(-((window + kk - 2 - top) // tc), 0)
    # every row holds all kk columns of the tiles [full_lo, full_hi]
    full_lo = -(-np.maximum(top + hh - window, 0) // tc)
    full_hi = np.minimum((np.minimum(top, cols - 1) - kk + 1) // tc, nc - 1)
    full = np.maximum(full_hi - full_lo + 1, 0)
    before = np.where(full > 0, full_lo, last + 1)
    after = np.where(full > 0, full_hi, first + 1)

    def log_p_miss(m):
        """log P(every row of the strip misses its m columns)."""
        sure = m > n - kept
        return np.where(sure, -np.inf,
                        log_inv[n] - log_inv[np.maximum(n - m, 0)]).sum(
                            1, keepdims=True)

    p_empty = full * np.exp(log_p_miss(np.full_like(n, kk)))
    most = np.where(full > 0, hh * min(k, kk), 0)
    for b, ok in ((first, first < before), (first + 1, first + 1 < before),
                  (last - 1, last - 1 > after), (last, last > after)):
        c0 = b * tc
        m = np.maximum(np.minimum(hi + 1, c0 + kk) - np.maximum(lo, c0), 0)
        p_empty = p_empty + np.where(ok, np.exp(log_p_miss(m)), 0.0)
        most = np.maximum(most, np.where(
            ok, np.minimum(m, k).sum(1, keepdims=True), 0))
    nonempty = int(np.maximum(last - first + 1, 0).sum())
    return ((nr * nc - nonempty + float(p_empty.sum())) / (nr * nc),
            float(share.sum()) / (nr * nc * t), min(t, int(most.max())))


class CausalTopk:
    def __init__(self, rows, cols, window, k):
        self.rows, self.cols, self.k = rows, cols, k
        self.w = min(window, rows)
        self.tensor_size = rows * cols
        self.density = (float(support(rows, cols, self.w, k)[3].sum())
                        / self.tensor_size)

    def prob_empty(self, tile_size):
        return tile_stats(self.rows, self.cols, self.w, self.k,
                          int(tile_size))[0]

    def expected_density(self, tile_size):
        return tile_stats(self.rows, self.cols, self.w, self.k,
                          int(tile_size))[1]

    def max_nnz(self, tile_size):
        return tile_stats(self.rows, self.cols, self.w, self.k,
                          int(tile_size))[2]


def _whole(x):
    return isinstance(x, int) and not isinstance(x, bool)


def model(params, tensor_size):
    for key in ("window", "k"):
        if key not in params:
            raise ValueError(f"causal_topk takes a {key}")
        if not (_whole(params[key]) and params[key] >= 1):
            raise ValueError(f"causal_topk {key} {params[key]!r} is not a "
                             f"whole number >= 1")
    rows, cols = params["rows"], params["cols"]
    if rows * cols != tensor_size:
        raise ValueError(f"causal_topk {rows} x {cols} is not {tensor_size} "
                         f"elements")
    extra = set(params) - {"window", "k", "rows", "cols"}
    if extra:
        raise ValueError(f"causal_topk takes window and k; unknown "
                         f"{sorted(extra)}")
    return CausalTopk(rows, cols, params["window"], params["k"])
