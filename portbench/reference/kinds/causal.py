"""The causal attention map as a density kind: element (i, j) of a
``rows x cols`` tensor is nonzero iff ``i - window < j <= i`` (a window
of at least ``rows``: the full causal mask).

Keys: ``window``, a whole number >= 1 (``rows`` and ``cols`` come from
the tensor's shape in the layer).  Tiles: a tile of ``t`` elements is
``tr x tc``, ``tr`` the largest divisor of ``t`` at most ``sqrt(t)``, ``tc
= t // tr``, on the aligned grid of ``nr = max(1, rows // tr)`` by ``nc =
max(1, cols // tc)`` tiles from the origin; rows and columns past the grid
are left out, and a tile larger than the tensor holds the tensor's part
of it, ``hh x kk = min(tr, rows) x min(tc, cols)`` elements, its density
taken over all ``t``.

Every answer is an exact integer count in closed form: no loop over
rows, tiles or elements.  A tile whose row origin less column origin is
``d`` holds ``band(hh, kk, -d, w - 1 - d)`` nonzeros, which is symmetric
and unimodal in ``d`` about ``(kk + w - hh - 1) / 2``; the tiles whose
``d`` lies in a range are a sum of floors over the row-strips.
Imports ``math`` only.
"""
import math


def _tri(m, c):
    """sum_{u=1..m} min(c, u), for m, c >= 0."""
    s = min(m, c)
    return s * (s + 1) // 2 + (m - s) * c


def _at_least(R, C, n):
    """#{(x, y) in [0, R) x [0, C) : x - y >= n}."""
    if n >= 0:
        return _tri(max(R - n, 0), C)
    return R * C - _tri(max(C + n - 1, 0), R)


def band(R, C, lo, hi):
    """#{(x, y) in [0, R) x [0, C) : lo <= x - y <= hi}."""
    return _at_least(R, C, lo) - _at_least(R, C, hi + 1)


def floor_sum(n, m, a, b):
    """sum_{i < n} floor((a i + b) / m), n >= 0, m >= 1, a, b >= 0."""
    total = 0
    while True:
        if a >= m:
            total += n * (n - 1) // 2 * (a // m)
            a %= m
        if b >= m:
            total += n * (b // m)
            b %= m
        y = a * n + b
        if y < m:
            return total
        n, b = divmod(y, m)
        m, a = a, m


def tiles_between(tr, tc, nr, nc, lo, hi):
    """#{(a, b) in [0, nr) x [0, nc) : lo <= a tr - b tc <= hi}."""
    if lo > hi:
        return 0
    first = max(0, -(-lo // tr))
    end = min(nr, (hi + (nc - 1) * tc) // tr + 1)
    if end <= first:
        return 0
    capped = min(max((lo + nc * tc - 1) // tr + 1, first), end)
    top = (floor_sum(capped - first, tc, tr, first * tr - lo)
           + (end - capped) * (nc - 1))
    positive = min(max(-(-(hi + 1) // tr), first), end)
    bottom = floor_sum(end - positive, tc, tr, positive * tr - hi + tc - 1)
    return top - bottom + (end - first)


class Causal:
    def __init__(self, rows, cols, window):
        self.rows, self.cols = rows, cols
        self.w = min(window, rows)
        self.tensor_size = rows * cols
        self.density = band(rows, cols, 0, self.w - 1) / self.tensor_size

    def _grid(self, tile_size):
        t = max(1, int(tile_size))
        tr = math.isqrt(t)
        while t % tr:
            tr -= 1
        tc = t // tr
        return (t, tr, tc, max(1, self.rows // tr), max(1, self.cols // tc),
                min(tr, self.rows), min(tc, self.cols))

    def prob_empty(self, tile_size):
        t, tr, tc, nr, nc, hh, kk = self._grid(tile_size)
        full = tiles_between(tr, tc, nr, nc, 1 - hh, self.w + kk - 2)
        return (nr * nc - full) / (nr * nc)

    def expected_density(self, tile_size):
        t, tr, tc, nr, nc, _, _ = self._grid(tile_size)
        return band(min(nr * tr, self.rows), min(nc * tc, self.cols), 0,
                    self.w - 1) / (nr * nc * t)

    def max_nnz(self, tile_size):
        t, tr, tc, nr, nc, hh, kk = self._grid(tile_size)
        c2 = kk + self.w - hh - 1
        # the least |2d - c2| over the tiles' offsets d, by bisection
        lo, hi = 0, 2 * max((nr - 1) * tr, (nc - 1) * tc) + abs(c2)
        while lo < hi:
            mid = (lo + hi) // 2
            if tiles_between(tr, tc, nr, nc, -((mid - c2) // 2),
                             (c2 + mid) // 2):
                hi = mid
            else:
                lo = mid + 1
        d = (c2 + lo) // 2
        return min(t, band(hh, kk, -d, self.w - 1 - d))


def _whole(x):
    return isinstance(x, int) and not isinstance(x, bool)


def model(params, tensor_size):
    if "window" not in params:
        raise ValueError("causal takes a window")
    window = params["window"]
    if not (_whole(window) and window >= 1):
        raise ValueError(f"causal window {window!r} is not a whole number "
                         f">= 1")
    rows, cols = params["rows"], params["cols"]
    if rows * cols != tensor_size:
        raise ValueError(f"causal {rows} x {cols} is not {tensor_size} "
                         f"elements")
    extra = set(params) - {"window", "rows", "cols"}
    if extra:
        raise ValueError(f"causal takes window; unknown {sorted(extra)}")
    return Causal(rows, cols, window)
