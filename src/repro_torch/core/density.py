"""Statistical density models (Sparseloop Sec. 5.3.2, Table 4).

Each model characterizes the distribution of nonzero locations in a tensor
and answers the two questions the analyzers need about a *fiber/tile* of a
given shape (Fig. 9 of the paper):

  * ``expected_density(tile_size)``  — E[nnz(tile)] / tile_size
  * ``prob_empty(tile_size)``        — P(tile is all zeros)
  * ``expected_nnz / max_nnz``       — for format-overhead & capacity checks

Supported models (Table 4):

  dense            : density 1 everywhere.
  uniform          : nnz placed uniformly at random (hypergeometric tiles).
                     Coordinate independent.
  structured (N:M) : exactly N nonzeros per aligned block of M along one
                     axis (2:4 STC-style).  Coordinate independent,
                     deterministic at granularity M.
  banded           : nonzeros within +/- half_band of the diagonal of a 2-D
                     tensor.  Coordinate *dependent*.
  actual           : wraps a concrete numpy array; exact empirical tile
                     statistics.  Coordinate dependent, non-statistical.
  causal           : a one-sided band, the causal attention map: element
                     (i, j) is nonzero iff i - window < j <= i.  Coordinate
                     dependent; exact counts in closed form.
  causal_topk      : a top-k selection inside the causal band, the map of a
                     learned sparse attention (DeepSeek's DSA): row i keeps
                     min(k, n_i) of its n_i band entries, drawn uniformly
                     without replacement, rows independent.  Coordinate
                     dependent; hypergeometric rows on the causal grid.
  causal_block_topk: a top-k selection of whole key blocks inside the
                     causal map, the map of a block-sparse attention
                     (MiniMax-M3's MSA): row i keeps its first ``init``
                     and last ``local`` causal blocks of ``block`` columns
                     and min(k, n_i) of its n_i other causal blocks,
                     drawn uniformly without replacement, rows
                     independent.  Hypergeometric rows over blocks.

The scalar models (``DensityModel`` and its subclasses) are a copy of the
JAX package's, except the three causal kinds, which the JAX package
lacks; all prob/expectation math is done in log-space (lgamma).

Tensor parametric interface (workload-as-data)
----------------------------------------------
Every model also lowers to a *fixed-shape parameter vector*
(:meth:`DensityModel.params`, ``NUM_DENSITY_PARAMS`` floats) plus a
small integer ``kind_id``, and each statistic has a tensor form
``<kind>_<stat>_t(params, hist, tile_size)`` written in torch: ``params``
is a (4,) float64 tensor, ``hist`` the ``(3, H)`` tile-occupancy
histogram (read only by the actual-data kind) and ``tile_size`` a tensor
of any shape (a leading candidate dimension in the batched engine); the
result has the shape of ``tile_size``.  :class:`TracedDensityStats`
bundles them behind one selection on the model id: it evaluates the
kinds present and picks with ``torch.where``, so the kind itself is
workload data.

The ``actual``-data model lowers through a per-tensor *tile-occupancy
histogram* (:meth:`ActualDataModel.hist_table`): ``(3, tensor_size)``
exact ``(prob_empty, expected_density, max_nnz)`` rows for every aligned
1-D tile size, precomputed once from the array and gathered by tile size
at evaluation time.  The two top-k kinds lower the same way through a
per-tensor *statistics table* (:func:`stat_table`): their forms
evaluated once at every tile size the engine can ask of the tensor, the
products ``d e`` of its dims' divisors, and looked up by tile size at
evaluation time.  Shape-dependent statistics (banded row scans,
histogram and statistics tables) are padded to static
:class:`DensityCaps` so programs stay shape-stable across layers.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import numbers
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import obs

#: density-model kind ids (the selection index of TracedDensityStats);
#: a new kind takes the next id, so the ids of programs built before it
#: stay as they were
DENSE_ID, UNIFORM_ID, STRUCTURED_ID, BANDED_ID, ACTUAL_ID, CAUSAL_ID, \
    CAUSAL_TOPK_ID, CAUSAL_BLOCK_TOPK_ID = range(8)
MODEL_KINDS = ("dense", "uniform", "structured", "banded", "actual",
               "causal", "causal_topk", "causal_block_topk")

#: fixed length of every model's traced parameter vector
NUM_DENSITY_PARAMS = 4


def _log_comb(n: float, k: float) -> float:
    """log C(n, k); -inf when invalid."""
    if k < 0 or k > n or n < 0:
        return -math.inf
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1))


def _log_comb_b(n, k):
    """Tensor log C(n, k); -inf when invalid."""
    valid = (k >= 0) & (k <= n) & (n >= 0)
    out = (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
           - torch.lgamma(n - k + 1.0))
    return torch.where(valid, out, -math.inf)


class BatchedDensityUnsupported(NotImplementedError):
    """Raised when a density model has no closed-form batched (tensor) path.

    Every Table-4 model (actual-data included, via its tile-occupancy
    histogram) now has a traced form, so this is only raised for unknown
    specs; it is kept for API compatibility with callers that still
    guard the batched dispatch.
    """


# ----------------------------------------------------------------------
# Static capacities for the shape-dependent traced statistics
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DensityCaps:
    """Static padding capacities of a traced density program.

    Traced programs need static array shapes; coordinate-dependent
    statistics don't have any.  The caps bound them: ``coord`` >= the
    row count of any banded or causal tensor (row-scan length), ``div``
    >= the isqrt of any such tensor's size (tile-shape divisor scan),
    ``hist`` >= the size of any actual-data tensor (histogram table
    length), and ``tiles`` >= the distinct tile sizes a causal_topk or
    causal_block_topk tensor can be asked at (the width of its
    statistics table, :func:`stat_table`).  Zero means
    "no tensor of that family" and prunes the corresponding branches of
    the kind selection entirely.  Caps are part of a
    compiled program's cache key; :func:`caps_for_models` rounds them up
    to powers of two so layers of similar size land on the same program.
    """

    coord: int = 0
    div: int = 0
    hist: int = 0
    tiles: int = 0

    def merge(self, other: "DensityCaps") -> "DensityCaps":
        return DensityCaps(coord=max(self.coord, other.coord),
                           div=max(self.div, other.div),
                           hist=max(self.hist, other.hist),
                           tiles=max(self.tiles, other.tiles))

    def covers(self, need: "DensityCaps") -> bool:
        return (self.coord >= need.coord and self.div >= need.div
                and self.hist >= need.hist and self.tiles >= need.tiles)


def _pow2_cap(n: int) -> int:
    return 1 << (int(n) - 1).bit_length() if n > 0 else 0


def caps_for_models(models: Sequence["DensityModel"],
                    round_pow2: bool = True) -> DensityCaps:
    """The smallest :class:`DensityCaps` covering ``models`` (rounded up
    to powers of two by default, so similarly-sized layers share)."""
    coord = div = hist = tiles = 0
    for m in models:
        if isinstance(m, (BandedModel, CausalModel, CausalBlockTopkModel)):
            coord = max(coord, m.rows)
            div = max(div, max(1, math.isqrt(max(1, m.rows * m.cols))))
        elif isinstance(m, ActualDataModel):
            hist = max(hist, m.tensor_size)
        if isinstance(m, (CausalTopkModel, CausalBlockTopkModel)):
            tiles = max(tiles, _divisor_products(m.rows, m.cols))
    if round_pow2:
        coord, div, hist, tiles = (_pow2_cap(coord), _pow2_cap(div),
                                   _pow2_cap(hist), _pow2_cap(tiles))
    return DensityCaps(coord=coord, div=div, hist=hist, tiles=tiles)


@functools.lru_cache(maxsize=64)
def _tile_sizes(rows: int, cols: int) -> tuple[int, ...]:
    """``{d e : d | rows, e | cols}``, sorted: every tile, leader window
    and format fiber the engine asks of a tensor whose two dims are
    single ranks is such a product (a factor gene decodes to a divisor
    split, and a spatial factor divides its rank), so these are the
    sizes of its statistics table."""
    def divisors(n: int) -> list[int]:
        low = [d for d in range(1, math.isqrt(n) + 1) if n % d == 0]
        return low + [n // d for d in low]
    return tuple(sorted({d * e for d in divisors(rows)
                         for e in divisors(cols)}))


def _divisor_products(rows: int, cols: int) -> int:
    """``|{d e : d | rows, e | cols}|``, the bound on the distinct tile
    sizes of any stack of the tensor's statistics."""
    return len(_tile_sizes(rows, cols))


# ----------------------------------------------------------------------
# Tensor statistics: <kind>_<stat>_t(params, hist, tile_size).
# ``params`` is the model's NUM_DENSITY_PARAMS vector, ``hist`` its
# (3, H) tile-occupancy histogram (only read by the actual-data kind),
# ``tile_size`` a tensor of any shape (or a float).  The single source of
# truth for both the instance ``*_b`` wrappers and TracedDensityStats.
# ----------------------------------------------------------------------
def _tile(p, t):
    """``t`` as float64 on the device of the params (when they are a
    tensor).  A Python number becomes a fill on the device, not a
    host-to-device copy, so the statistics can run inside a captured
    CUDA graph."""
    dev = p.device if isinstance(p, torch.Tensor) else None
    if isinstance(t, (int, float)):
        return torch.full((), float(t), dtype=torch.float64, device=dev)
    return torch.as_tensor(t, dtype=torch.float64, device=dev)


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def dense_prob_empty_t(p, h, t):
    del h
    return torch.zeros_like(_tile(p, t))


def dense_expected_density_t(p, h, t):
    del h
    return torch.ones_like(_tile(p, t))


def dense_max_nnz_t(p, h, t):
    del h
    return _tile(p, t)


def uniform_prob_empty_t(p, h, t):
    """params: [tensor_size, nnz, density, -]."""
    del h
    S, N = p[0], p[1]
    T = torch.minimum(_tile(p, t), S)
    return torch.exp(_log_comb_b(S - N, T) - _log_comb_b(S, T))


def uniform_expected_density_t(p, h, t):
    del h
    return torch.ones_like(_tile(p, t)) * p[2]


def uniform_max_nnz_t(p, h, t):
    del h
    return torch.minimum(_tile(p, t), p[1])


def structured_prob_empty_t(p, h, t):
    """params: [tensor_size, n, m, -]."""
    del h
    n, m = p[1], p[2]
    tt = _tile(p, t)
    lp = _log_comb_b(m - n, tt) - _log_comb_b(m, tt)
    return torch.where(tt >= m - n + 1, 0.0, torch.exp(lp))


def structured_expected_density_t(p, h, t):
    del h
    return torch.ones_like(_tile(p, t)) * (p[1] / p[2])


def structured_max_nnz_t(p, h, t):
    del h
    n, m = p[1], p[2]
    tt = _tile(p, t)
    full = torch.floor(tt / m)
    rem = tt - full * m
    return torch.minimum(tt, full * n + torch.minimum(rem, n))


# Integer counts of the two band kinds.  Each takes Python ints (the
# scalar models: exact) or int64 tensors of one shape (the tensor forms).
def _clamp0(x):
    return x.clamp(min=0) if isinstance(x, torch.Tensor) else max(x, 0)


def _tri(m, c):
    """sum_{u=1..m} min(c, u), for m, c >= 0."""
    s = torch.minimum(m, c) if isinstance(m, torch.Tensor) else min(m, c)
    return s * (s + 1) // 2 + (m - s) * c


def _diag_ge(R, C, n):
    """#{(x, y) in [0, R) x [0, C) : x - y >= n}."""
    below = _tri(_clamp0(R - n), C)                 # n >= 0
    above = R * C - _tri(_clamp0(C + n - 1), R)     # n < 0
    if isinstance(n, torch.Tensor):
        return torch.where(n >= 0, below, above)
    return below if n >= 0 else above


def _band_count(R, C, lo, hi):
    """#{(x, y) in [0, R) x [0, C) : lo <= x - y <= hi}, R, C >= 0: the
    nonzeros of an R x C rectangle of a band, in closed form (triangle
    numbers).  ``banded`` is the band (-w, w) and ``causal`` (0, w - 1)
    from the rectangle's corner; a rectangle at offset r0 - c0 = d
    shifts the band by -d."""
    return _diag_ge(R, C, lo) - _diag_ge(R, C, hi + 1)


def _scan_dtype(caps: DensityCaps) -> torch.dtype:
    """The integer type of the causal kind's (candidate, scan) tensors:
    int32 where every value they hold (offsets up to ``8 (div + 1)^2 +
    8 coord (div + 1)``, for tiles no larger than the tensor) fits, which
    halves their bytes and keeps their divisions 32-bit; int64 past
    that."""
    big = 8 * (caps.div + 1) ** 2 + 8 * caps.coord * (caps.div + 1)
    return torch.int32 if big < 2 ** 31 else torch.int64


def _band_grid_t(p, t, caps: DensityCaps, scan=torch.int64):
    """Tensor mirror of ``BandedModel._tile_shape`` + aligned-grid setup
    with the band geometry as params [size, rows, cols, w] (both band
    kinds).

    ``tr`` is the largest divisor of the tile size <= floor(sqrt(t))
    (what the scalar decrement loop finds), found by scanning the static
    divisor range ``1..caps.div`` along a trailing axis, in ``scan``'s
    integer type (tiles no larger than the tensor fit it)."""
    rows = torch.round(p[1]).long()
    cols = torch.round(p[2]).long()
    ti = torch.clamp(torch.round(_tile(p, t)), min=1.0).long()
    d = torch.arange(1, caps.div + 1, dtype=scan, device=ti.device)
    root = torch.floor(torch.sqrt(ti.double())).to(scan)
    ts = ti if scan == torch.int64 else ti.clamp(max=2 ** 31 - 1).to(scan)
    ok = (torch.remainder(ts[..., None], d) == 0) & (d <= root[..., None])
    tr = torch.where(ok, d, 1).amax(-1).long()
    tc = _floordiv(ti, tr)
    nr = torch.clamp(_floordiv(rows, tr), min=1)
    nc = torch.clamp(_floordiv(cols, tc), min=1)
    return ti, tr, tc, nr, nc, rows, cols


def banded_prob_empty_t(p, h, t, caps: DensityCaps):
    del h
    _, tr, tc, nr, nc, rows, _cols = _band_grid_t(p, t, caps)
    w = torch.round(p[3]).long()
    ti = torch.arange(caps.coord, dtype=torch.int64, device=tr.device)
    tr_, tc_ = tr[..., None], tc[..., None]
    r0 = ti * tr_
    hh = torch.minimum(tr_, rows - r0)
    # nonempty tiles of row-strip ti: the band's column footprint
    # [r0 - w, r0 + hh - 1 + w] must meet [tj*tc, (tj+1)*tc - 1]
    tj_hi = torch.minimum(nc[..., None] - 1,
                          _floordiv(r0 + hh - 1 + w, tc_))
    tj_lo = torch.clamp(-_floordiv(-(r0 - w - tc_ + 1), tc_), min=0)
    nonempty = torch.minimum(torch.clamp(tj_hi - tj_lo + 1, min=0),
                             nc[..., None])
    total = torch.where(ti < nr[..., None], nonempty, 0).sum(-1)
    return (nr * nc - total).double() / (nr * nc).double()


def banded_expected_density_t(p, h, t, caps: DensityCaps):
    del h
    ti, tr, tc, nr, nc, rows, _cols = _band_grid_t(p, t, caps)
    w = torch.round(p[3]).long()
    covered_rows = torch.minimum(nr * tr, rows)
    covered_cols = nc * tc          # c1 is never clamped to cols
    nnz = _band_count(covered_rows, covered_cols, -w, w)
    return nnz.double() / ((nr * nc).double() * ti.double())


def banded_max_nnz_t(p, h, t, caps: DensityCaps):
    del h
    ti, tr, tc, nr, _nc, rows, cols = _band_grid_t(p, t, caps)
    w = torch.round(p[3]).long()
    i = torch.arange(caps.coord, dtype=torch.int64, device=tr.device)
    tix = _floordiv(i, tr[..., None])
    r0 = tix * tr[..., None]
    # the densest aligned tile sits on the diagonal: slide each
    # row-strip's column window to hug the band
    c0 = torch.minimum(torch.clamp(r0 - w, min=0),
                       torch.clamp(cols - tc, min=0)[..., None])
    ln = torch.clamp(torch.minimum(c0 + tc[..., None], i + w + 1)
                     - torch.maximum(c0, i - w), min=0)
    ln = torch.where(i < torch.minimum(nr * tr, rows)[..., None], ln, 0)
    # segment sum of each row's band length into its row-strip: one
    # index_add_ over the flattened (candidate, strip) axis
    batch = ln.shape[:-1]
    nb = math.prod(batch)
    seg = (tix.expand(ln.shape).reshape(nb, caps.coord)
           + caps.coord * torch.arange(nb, device=ln.device)[:, None])
    per_tile = torch.zeros(nb * caps.coord, dtype=ln.dtype,
                           device=ln.device)
    per_tile.index_add_(0, seg.reshape(-1), ln.reshape(-1))
    best = per_tile.view(nb, caps.coord).amax(-1).view(batch)
    root = torch.floor(torch.sqrt(ti.double())).long()
    fallback = torch.minimum(ti, (2 * w + 1) * root + 1)
    return torch.where(best > 0, torch.minimum(ti, best), fallback).double()


def _causal_geometry_t(p, t, caps: DensityCaps):
    """The aligned grid of a causal tensor (``_band_grid_t``), the
    window ``w`` and a tile's extent inside the tensor ``hh x kk``."""
    ti, tr, tc, nr, nc, rows, cols = _band_grid_t(p, t, caps,
                                                  _scan_dtype(caps))
    w = torch.round(p[3]).long()
    return (ti, tr, tc, nr, nc, rows, cols, w, torch.minimum(tr, rows),
            torch.minimum(tc, cols))


def _strips(caps: DensityCaps, *per_tile):
    """The row-strip index ``a`` (``caps.coord`` of them) and each
    per-tile tensor with a trailing axis, in the scan's integer type."""
    scan = _scan_dtype(caps)
    a = torch.arange(caps.coord, dtype=scan, device=per_tile[0].device)
    return (a,) + tuple(x.to(scan)[..., None] for x in per_tile)


def causal_prob_empty_t(p, h, t, caps: DensityCaps):
    """params: [tensor_size, rows, cols, window].  Tile (a, b) is
    nonempty iff its offset a*tr - b*tc lies in [1 - hh, w + kk - 2]:
    per row-strip a contiguous run of b, summed in one masked
    O(caps.coord) reduction."""
    del h
    _, tr, tc, nr, nc, _, _, w, hh, kk = _causal_geometry_t(p, t, caps)
    a, tr_, tc_, nr_, last, top, bottom = _strips(
        caps, tr, tc, nr, nc - 1, hh - 1, w + kk - 2)
    r0 = a * tr_
    b_hi = torch.minimum(_floordiv(r0 + top, tc_), last)
    b_lo = torch.clamp(-_floordiv(bottom - r0, tc_), min=0)
    run = torch.where(a < nr_, torch.clamp(b_hi - b_lo + 1, min=0),
                      0).sum(-1)
    return (nr * nc - run).double() / (nr * nc).double()


def causal_expected_density_t(p, h, t, caps: DensityCaps):
    """The band's nonzeros in the grid's rectangle, in closed form."""
    del h
    ti, tr, tc, nr, nc, rows, cols, w, _, _ = _causal_geometry_t(p, t, caps)
    nnz = _band_count(torch.minimum(nr * tr, rows),
                      torch.minimum(nc * tc, cols), 0, w - 1)
    return nnz.double() / ((nr * nc).double() * ti.double())


def causal_max_nnz_t(p, h, t, caps: DensityCaps):
    """A tile's nonzeros fall as its offset leaves the centre
    ``c2 / 2``: per row-strip the offset nearest the centre is one of
    two, the least distance over the strips is one masked
    O(caps.coord) reduction, and the count at that offset is closed
    form."""
    del h
    ti, tr, tc, nr, nc, _, _, w, hh, kk = _causal_geometry_t(p, t, caps)
    c2 = kk + w - hh - 1
    far = 2 * (nr * tr + nc * tc) + torch.abs(c2)
    a, tr_, tc_, nr_, last, c2_, far_ = _strips(caps, tr, tc, nr, nc - 1,
                                                c2, far)
    r0 = a * tr_
    b1 = _floordiv(2 * r0 - c2_, 2 * tc_)
    e = far_
    for b in (b1, b1 + 1):
        d = torch.abs(2 * (r0 - torch.clamp(torch.minimum(b, last), min=0)
                           * tc_) - c2_)
        e = torch.minimum(e, d)
    e = torch.where(a < nr_, e, far_).amin(-1).long()
    off = _floordiv(c2 + e, 2)
    return torch.minimum(ti, _band_count(hh, kk, -off, w - 1 - off)).double()


# The causal_topk kind.  Row i's support is the causal band's columns
# [lo_i, hi_i], lo_i = max(0, i - w + 1), hi_i = min(i, cols - 1), n_i of
# them; min(k, n_i) are nonzero.  The row misses m given support columns
# with probability C(n_i - m, k) / C(n_i, k) = exp(A(n_i) - A(n_i - m)),
# A(x) = sum_{y=k+1..x} log1p(-k / y) = -log C(x, k), and for sure not
# where n_i - m < min(k, n_i).  On the causal grid a strip's nonempty
# tiles are a run of columns (the causal kind's); every row of a strip
# meets the tiles of one sub-run in all their columns (the full tiles,
# one value a strip), and the rest of the run, the tiles a row's support
# starts or ends in, are at most two at either end.
#
#: exp(-2**_TOPK_CLAMP_BITS) is 0.0 in float64: a row's log-probability
#: below it is held there, which bounds the fixed-point prefix sums
_TOPK_CLAMP_BITS = 10


def _topk_fix(caps: DensityCaps) -> tuple[int, int]:
    """``(S, bits)``: the tensor forms hold a log-probability in int64
    units of ``2**-S``, with every ``|A(x)| <= x ln 2 < 2**bits``, and a
    sum over ``caps.coord`` rows of values clamped at
    ``-2**_TOPK_CLAMP_BITS`` below ``2**62``: exact sums over strips."""
    bits = (caps.coord + 2).bit_length()
    return 62 - _TOPK_CLAMP_BITS - bits, bits


class _TopkRows(NamedTuple):
    """The candidate-independent rows of a causal_topk tensor."""

    i: torch.Tensor      # (coord,) row index, in the rows' integer type
    lo: torch.Tensor     # (coord,) first support column
    hi1: torch.Tensor    # (coord,) one past the last (lo on rows past the
                         # tensor, so they hold nothing)
    n: torch.Tensor      # (coord,) support size
    kc: torch.Tensor     # k held at coord + 1 (every row is wholly kept)
    w: torch.Tensor      # the window, held at coord + 1
    cols: torch.Tensor   # the columns, held at coord + 1


def _topk_rows_t(p, caps: DensityCaps) -> _TopkRows:
    """params: [k, rows, cols, window] (the kind's size is ``rows *
    cols``, so its first slot holds ``k``)."""
    lim = caps.coord + 1
    dt = torch.int32 if 4 * (lim + 1) < 2 ** 31 else torch.int64
    kc, rows, cols, w = (torch.round(p[j]).long().clamp(0, lim)
                         for j in range(4))
    i = torch.arange(caps.coord, dtype=dt, device=p.device)
    lo = torch.clamp(i - (w - 1), min=0)
    hi1 = torch.where(i < rows, torch.minimum(i, cols - 1) + 1, lo)
    return _TopkRows(i, lo, hi1, torch.clamp(hi1 - lo, min=0), kc, w, cols)


def _topk_miss_table_t(sup: _TopkRows, caps: DensityCaps) -> tuple:
    """``(nk, aq, aq_nk)``: a row that misses ``m`` of its support
    columns has the log-probability ``aq_nk - aq[nk - m]`` in units of
    ``2**-S``, ``nk = max(n, kc)``; ``aq`` is A in int64 at and past
    ``kc`` and ``2**61`` below it, where the row meets the columns for
    sure, so the difference clamps to the floor."""
    S, _ = _topk_fix(caps)
    y = torch.arange(caps.coord + 2, dtype=torch.float64,
                     device=sup.i.device)
    kf = sup.kc.double()
    a = torch.cumsum(torch.log1p(torch.where(y > kf, -kf / y, 0.0)), 0)
    aq = torch.where(y >= kf, torch.round(a * 2.0 ** S), 2.0 ** 61).long()
    nk = torch.maximum(sup.n, sup.kc)
    return nk, aq, aq[nk]


def _topk_grid_t(p, t, caps: DensityCaps):
    """The causal grid and, along a trailing axis of rows, each row's
    strip: ``(sup, ti, hh, kk, nr, nc, strip, ends)``, ``sup`` the rows'
    support.  ``strip`` holds, as seen from every row of a strip, the
    strip's nonempty run ``[b_lo, b_hi]``, its full tiles (``full``
    of them from ``bf_lo``) and its partial tiles as four candidate
    columns with a mask each (``slots``); ``ends`` marks each strip's
    last row, where a prefix sum over the rows less the one before the
    strip's first row (:func:`_topk_strip_sum`) is the strip's sum."""
    ti, tr, tc, nr, nc, rows, _, _, hh, kk = _causal_geometry_t(p, t, caps)
    sup = _topk_rows_t(p, caps)
    lim = caps.coord + 1

    def row(x):
        return x.clamp(max=lim).to(sup.i.dtype)[..., None]

    tr_, tc_, hh_, kk_, last = row(tr), row(tc), row(hh), row(kk), \
        row(nc - 1)
    r0 = sup.i // tr_ * tr_
    b_hi = torch.minimum((r0 + (hh_ - 1)) // tc_, last)
    b_lo = torch.clamp(-((sup.w + kk_ - 2 - r0) // tc_), min=0)
    # every row meets b's kk columns: b tc >= the last row's lo and
    # b tc + kk - 1 <= the first row's hi
    bf_lo = -(-torch.clamp(r0 + (hh_ - sup.w), min=0) // tc_)
    bf_hi = torch.minimum((torch.minimum(r0, sup.cols - 1) - (kk_ - 1))
                          // tc_, last)
    full = torch.clamp(bf_hi + 1 - bf_lo, min=0)
    has_full = full > 0
    # the partial tiles: left and right of the full ones, or the whole
    # run where there are none (four at most either way)
    left = torch.where(has_full, bf_lo, b_hi + 1)
    right = torch.where(has_full, bf_hi, b_lo + 1)
    slots = ((b_lo, b_lo < left), (b_lo + 1, b_lo + 2 <= left),
             (b_hi - 1, b_hi - 1 > right), (b_hi, b_hi > right))
    in_grid = sup.i < row(torch.minimum(nr * tr, rows))
    ends = (sup.i - r0 == hh_ - 1) & in_grid
    strip = dict(b_lo=b_lo, b_hi=b_hi, full=full, has_full=has_full,
                 slots=slots, tc=tc_, kk=kk_,
                 prev=torch.clamp(r0 - 1, min=0).long(), first=r0 == 0)
    return sup, ti, hh, kk, nr, nc, strip, ends


def _topk_strip_sum(v, strip):
    """Per row ``v``'s sum over the row's strip up to the row: at the
    strip's last row, the strip's sum (int64)."""
    c = torch.cumsum(v, -1)
    return c - torch.where(strip["first"], 0, c.gather(-1, strip["prev"]))


def _topk_overlap(sup: _TopkRows, b, strip):
    """Each row's support columns inside tile column ``b``."""
    c0 = b * strip["tc"]
    return torch.clamp(torch.minimum(sup.hi1, c0 + strip["kk"])
                       - torch.maximum(sup.lo, c0), min=0)


def causal_topk_prob_empty_t(p, h, t, caps: DensityCaps):
    """params: [k, rows, cols, window].  Per strip, the tiles outside
    its nonempty run are empty for sure, its full tiles share
    ``exp(sum_rows A(n_i) - A(n_i - kk))`` and each partial tile is
    its own sum; the sums are prefix sums over the rows in int64 fixed
    point, so exact and in one order.  O(caps.coord) per tile."""
    del h
    sup, _, _, _, nr, nc, strip, ends = _topk_grid_t(p, t, caps)
    nk, aq, aq_nk = _topk_miss_table_t(sup, caps)
    S, _ = _topk_fix(caps)
    floor = -(1 << (S + _TOPK_CLAMP_BITS))

    def p_miss(idx):
        """exp of the strip's summed log-probability that each row misses
        the columns that leave ``idx`` in the A table."""
        v = torch.clamp(aq_nk - aq[idx], min=floor)
        return torch.exp(_topk_strip_sum(v, strip).double() * 2.0 ** -S)

    empty = torch.where(strip["has_full"], strip["full"].double()
                        * p_miss(torch.clamp(nk - strip["kk"], min=0)), 0.0)
    for b, ok in strip["slots"]:
        empty = empty + torch.where(
            ok, p_miss(nk - _topk_overlap(sup, b, strip)), 0.0)
    run = torch.where(ends, torch.clamp(strip["b_hi"] - strip["b_lo"] + 1,
                                        min=0), 0).sum(-1)
    empty = torch.where(ends, empty, 0.0).sum(-1)
    return ((nr * nc - run).double() + empty) / (nr * nc).double()


def causal_topk_expected_density_t(p, h, t, caps: DensityCaps):
    """``sum_rows min(k, n_i) |S_i inside the grid's columns| / n_i`` in
    closed form: rows wholly inside the grid's columns give ``min(k,
    n_i)`` (a prefix sum), and the rest ``G_c (k_i / n_i) - k_i lo_i /
    n_i`` (two more); the three are candidate-independent tables."""
    del h
    ti, tr, tc, nr, nc, rows, cols, w, _, _ = _causal_geometry_t(p, t, caps)
    sup = _topk_rows_t(p, caps)
    kr = torch.minimum(sup.n, sup.kc)
    n = sup.n.double()
    some = sup.n > 0
    share = torch.where(some, kr.double() / n, 0.0)
    lo_share = torch.where(some, kr.double() * sup.lo.double() / n, 0.0)
    zero = torch.zeros(1, dtype=torch.float64, device=p.device)
    whole = torch.cat([zero.long(), torch.cumsum(kr, 0)])
    p1 = torch.cat([zero, torch.cumsum(share, 0)])
    p2 = torch.cat([zero, torch.cumsum(lo_share, 0)])
    g_r = torch.minimum(nr * tr, rows)
    g_c = torch.minimum(nc * tc, cols)
    e1 = torch.where(g_c >= cols, g_r, torch.minimum(g_r, g_c))
    e2 = torch.maximum(e1, torch.minimum(g_r, g_c + w - 1))
    e1, e2 = e1.clamp(0, caps.coord), e2.clamp(0, caps.coord)
    nnz = (whole[e1].double() + g_c.double() * (p1[e2] - p1[e1])
           - (p2[e2] - p2[e1]))
    return nnz / ((nr * nc).double() * ti.double())


def causal_topk_max_nnz_t(p, h, t, caps: DensityCaps):
    """The most nonzeros a draw can put in a tile, ``max_tiles sum_rows
    min(k, m_i)``: ``hh min(k, kk)`` wherever a strip has a full tile,
    else the most of its partial tiles'."""
    del h
    sup, ti, hh, kk, _, _, strip, ends = _topk_grid_t(p, t, caps)
    most = torch.where(strip["has_full"],
                       (hh * torch.minimum(kk, sup.kc))[..., None], 0)
    for b, ok in strip["slots"]:
        m = torch.minimum(_topk_overlap(sup, b, strip), sup.kc)
        most = torch.maximum(most, torch.where(
            ok, _topk_strip_sum(m, strip), 0))
    best = torch.where(ends, most, 0).amax(-1)
    return torch.minimum(ti, best).double()


# The causal_block_topk kind.  Row i's causal columns [0, hi_i], hi_i =
# min(i, cols - 1), fall in blocks of B columns, 0 .. nb_i - 1, nb_i =
# hi_i // B + 1.  The first ``init`` and the last ``local`` are forced
# (nonzero); of the other n_i, the candidates init .. lq_i - 1, lq_i =
# max(nb_i - local, init), min(k, n_i) are kept.  A row whose tile
# columns meet a forced block meets the tile for sure; one whose tile
# columns meet m candidate blocks misses it with causal_topk's
# probability C(n_i - m, k) / C(n_i, k), blocks in place of columns.  On
# the causal grid a strip's tiles past its last row's diagonal are empty
# for sure; a tile that starts in the init blocks, or reaches the first
# row's local blocks, is nonempty for sure; every other tile from the
# init blocks up to the first row's last candidate block and its last
# causal column (interior) meets the same candidate blocks in all its
# columns in every row of the strip, m_lo or m_lo + 1 of them as its
# columns fall on the blocks.  What is left are the tiles of the
# diagonal with local 0, two at most (hh, kk <= tc).
#
#: block, init and local share the params' last slot, ``block + init
#: 2**_BLOCK_BITS + local 2**(_BLOCK_BITS + _END_BITS)``, so the vector
#: keeps the four slots of the JAX package's kinds
_BLOCK_BITS, _END_BITS = 24, 12


class _BlockRows(NamedTuple):
    """The candidate-independent rows of a causal_block_topk tensor
    (``i``, ``n`` and ``kc`` as :class:`_TopkRows`' for the miss table)."""

    i: torch.Tensor         # (coord,) row index, in the rows' integer type
    hi: torch.Tensor        # (coord,) last causal column; -1 past the rows
    lq: torch.Tensor        # (coord,) first local block that is no init one
    lq_col: torch.Tensor    # (coord,) its first column (past hi if none)
    n: torch.Tensor         # (coord,) candidate blocks
    kc: torch.Tensor        # k held at coord + 1
    B: torch.Tensor         # the block, held in [1, 2 coord + 3]
    init: torch.Tensor      # init, held at coord + 1
    init_col: torch.Tensor  # init B, held at coord + 1
    local: torch.Tensor     # local, held at coord + 1
    cols: torch.Tensor      # the columns, held at coord + 1


def _block_rows_t(p, caps: DensityCaps) -> _BlockRows:
    """params: [k, rows, cols, block + init 2**24 + local 2**36].  The
    rows' integer type is int32 where every column a strip's tiles reach
    (below ``5 lim + 1``) fits."""
    lim = caps.coord + 1
    dt = torch.int32 if 8 * (lim + 1) < 2 ** 31 else torch.int64
    kc, rows, cols, g = (torch.round(p[j]).long() for j in range(4))
    # a block past 2 lim holds every row's columns, as it would at 2 lim
    B = torch.remainder(g, 1 << _BLOCK_BITS).clamp(1, 2 * lim + 1)
    init = torch.remainder(_floordiv(g, 1 << _BLOCK_BITS), 1 << _END_BITS)
    local = _floordiv(g, 1 << (_BLOCK_BITS + _END_BITS))
    kc, rows, cols, init, local, init_col = (
        x.clamp(0, lim).to(dt) for x in (kc, rows, cols, init, local,
                                          init.clamp(max=lim) * B))
    B = B.to(dt)
    i = torch.arange(caps.coord, dtype=dt, device=p.device)
    hi = torch.where(i < rows, torch.minimum(i, cols - 1), -1)
    nb = _floordiv(hi, B) + 1
    lq = torch.maximum(nb - local, init)
    return _BlockRows(i, hi, lq, torch.minimum(lq, nb) * B,
                      torch.clamp(nb - local - init, min=0), kc, B, init,
                      init_col, local, cols)


def _block_grid_t(p, t, caps: DensityCaps):
    """The causal grid and, along a trailing axis of rows, each row's
    strip, as :func:`_topk_grid_t`'s: ``strip`` holds the strip's run
    ``[0, b_hi]``, its interior tiles ``[bi_lo, bi_lo + nint)`` (of
    ``m_lo`` candidate blocks, ``cnt_hi`` of them of one more), the first
    of its two partial tiles ``s0`` and ``mu = min(B, kk)``, the most
    columns a block gives a tile."""
    ti, tr, tc, nr, nc, rows, cols = _band_grid_t(p, t, caps,
                                                  _scan_dtype(caps))
    hh, kk = torch.minimum(tr, rows), torch.minimum(tc, cols)
    sup = _block_rows_t(p, caps)
    lim = caps.coord + 1

    def row(x, most=lim):
        return x.clamp(max=most).to(sup.i.dtype)[..., None]

    # kk past 2 lim still passes every column and block end (<= 2 lim)
    tr_, tc_, hh_, kk_, last = row(tr), row(tc), row(hh), \
        row(kk, 2 * lim + 1), row(nc - 1)
    B = sup.B
    r0 = sup.i // tr_ * tr_
    hi0 = torch.minimum(r0, sup.cols - 1)
    b_hi = torch.minimum((r0 + (hh_ - 1)) // tc_, last)
    bi_lo = -(-sup.init_col // tc_)
    bi_hi = torch.minimum(torch.minimum(
        (torch.clamp(hi0 // B + 1 - sup.local, min=0) * B - kk_) // tc_,
        (hi0 - kk_ + 1) // tc_), last)
    nint = torch.clamp(bi_hi - bi_lo + 1, min=0)
    m_lo = (kk_ - 1) // B + 1
    # up to each tile column b, the columns that meet m_lo + 1 blocks
    c0 = torch.arange(caps.coord, dtype=torch.int64,
                      device=p.device) * tc_.long()
    up = torch.cumsum((c0 + (kk_ - 1)) // B - c0 // B + 1 - m_lo, -1)
    top = caps.coord - 1
    cnt_hi = torch.where(
        nint > 0, up.gather(-1, bi_hi.clamp(0, top).long())
        - torch.where(bi_lo > 0, up.gather(-1, (bi_lo - 1).clamp(
            0, top).long()), 0), 0)
    in_grid = sup.i < row(torch.minimum(nr * tr, rows))
    ends = (sup.i - r0 == hh_ - 1) & in_grid
    strip = dict(b_hi=b_hi, bi_lo=bi_lo, nint=nint, m_lo=m_lo,
                 cnt_hi=cnt_hi, s0=torch.maximum(bi_hi, bi_lo - 1) + 1,
                 tc=tc_, kk=kk_, mu=torch.minimum(B, kk_),
                 prev=torch.clamp(r0 - 1, min=0).long(), first=r0 == 0)
    return sup, ti, hh, kk, nr, nc, strip, ends


def _block_slot(sup: _BlockRows, b, strip):
    """Each row in tile column ``b``: ``(c, f, m, hit)``, its causal
    columns there, the forced ones among them, the candidate blocks they
    meet and whether they meet a forced block."""
    c0 = b * strip["tc"]
    e = torch.minimum(c0 + (strip["kk"] - 1), sup.hi)
    causal = c0 <= sup.hi
    c = torch.where(causal, e - c0 + 1, 0)
    f = torch.where(causal, torch.clamp(
        torch.minimum(e, sup.init_col - 1) - c0 + 1, min=0) + torch.clamp(
        e - torch.maximum(c0, sup.lq_col) + 1, min=0), 0)
    m = torch.where(causal, torch.clamp(
        torch.minimum(e // sup.B, sup.lq - 1)
        - torch.maximum(c0 // sup.B, sup.init) + 1, min=0), 0)
    return c, f, m, f > 0


def causal_block_topk_prob_empty_t(p, h, t, caps: DensityCaps):
    """params: [k, rows, cols, block + init 2**24 + local 2**36].  Per
    strip, the interior tiles share two values, ``exp(sum_rows A(n_i) -
    A(n_i - m))`` at ``m_lo`` and ``m_lo + 1``, the two partial tiles
    are each their own sum, and the tiles that meet a forced block are
    nonempty: int64 fixed-point prefix sums over the rows, as
    causal_topk's.  O(caps.coord) per tile."""
    del h
    sup, _, _, _, nr, nc, strip, ends = _block_grid_t(p, t, caps)
    nk, aq, aq_nk = _topk_miss_table_t(sup, caps)
    S, _ = _topk_fix(caps)
    floor = -(1 << (S + _TOPK_CLAMP_BITS))

    def p_miss(v):
        return torch.exp(_topk_strip_sum(v, strip).double() * 2.0 ** -S)

    def miss(m):
        return torch.clamp(aq_nk - aq[torch.clamp(nk - m, min=0)],
                           min=floor)

    hi = strip["cnt_hi"]
    empty = torch.where(strip["nint"] > 0, (strip["nint"] - hi).double()
                        * p_miss(miss(strip["m_lo"])) + hi.double()
                        * p_miss(miss(strip["m_lo"] + 1)), 0.0)
    for b in (strip["s0"], strip["s0"] + 1):
        _, _, m, hit = _block_slot(sup, b, strip)
        v = torch.where(hit, floor, miss(m))
        empty = empty + torch.where(b <= strip["b_hi"], p_miss(v), 0.0)
    run = torch.where(ends, strip["b_hi"] + 1, 0).sum(-1)
    empty = torch.where(ends, empty, 0.0).sum(-1)
    return ((nr * nc - run).double() + empty) / (nr * nc).double()


def causal_block_topk_expected_density_t(p, h, t, caps: DensityCaps):
    """``sum_rows (forced_i + min(k, n_i) cand_i / n_i)`` over ``nr nc
    t``, with ``forced_i`` and ``cand_i`` row i's forced and candidate
    columns inside the grid: one masked O(caps.coord) sum."""
    del h
    ti, tr, tc, nr, nc, rows, cols = _band_grid_t(p, t, caps,
                                                  _scan_dtype(caps))
    sup = _block_rows_t(p, caps)
    lim = caps.coord + 1
    g_r = torch.minimum(nr * tr, rows)[..., None]
    g_c = torch.minimum(nc * tc, cols).clamp(max=lim).to(sup.i.dtype)
    h1 = torch.minimum(sup.hi + 1, g_c[..., None])
    inside = sup.i < g_r
    forced = torch.minimum(sup.init_col, h1) + torch.clamp(
        h1 - sup.lq_col, min=0)
    cand = torch.clamp(torch.minimum(h1, sup.lq_col) - sup.init_col, min=0)
    some = sup.n > 0
    share = torch.where(some, torch.minimum(sup.n, sup.kc).double()
                        / sup.n.double(), 0.0)
    nnz = (torch.where(inside, forced, 0).sum(-1).double()
           + torch.where(inside, cand.double() * share, 0.0).sum(-1))
    return nnz / ((nr * nc).double() * ti.double())


def causal_block_topk_max_nnz_t(p, h, t, caps: DensityCaps):
    """A bound on the nonzeros a draw can put in a tile: ``max_tiles
    sum_rows min(c_i, f_i + min(k, m_i) mu)``, with ``c_i``, ``f_i`` and
    ``m_i`` row i's causal columns, forced columns and candidate blocks
    in the tile, taken exactly on the interior and partial tiles and
    bounded on the tiles that meet a forced block by each row's ``min(
    c_i(0), min(kk, F_i) + k mu)``, ``F_i`` its forced columns (column 0
    holds the most causal ones).  At block 1 it is causal_topk's."""
    del h
    sup, ti, hh, kk, _, _, strip, ends = _block_grid_t(p, t, caps)
    mu, kk_ = strip["mu"].long(), strip["kk"]
    m_top = strip["m_lo"] + (strip["cnt_hi"] > 0).to(sup.i.dtype)
    most = torch.where(strip["nint"] > 0, (hh[..., None] * torch.minimum(
        kk[..., None], torch.minimum(sup.kc, m_top).long() * mu)), 0)
    for b in (strip["s0"], strip["s0"] + 1):
        c, f, m, _ = _block_slot(sup, b, strip)
        u = torch.minimum(c.long(), f + torch.minimum(m, sup.kc).long() * mu)
        most = torch.maximum(most, torch.where(
            b <= strip["b_hi"], _topk_strip_sum(u, strip), 0))
    c0 = torch.clamp(torch.minimum(kk_, sup.hi + 1), min=0)
    forced = torch.minimum(sup.init_col, sup.hi + 1) + torch.clamp(
        sup.hi + 1 - sup.lq_col, min=0)
    bound = torch.minimum(c0.long(), torch.minimum(kk_, forced).long()
                          + sup.kc.long() * mu)
    has = (strip["bi_lo"] > 0) | (strip["b_hi"] > strip["s0"] + 1)
    most = torch.maximum(most, torch.where(
        has, _topk_strip_sum(bound, strip), 0))
    best = torch.where(ends, most, 0).amax(-1)
    return torch.minimum(ti, best).double()


def _by_distinct_tile(fn, p, t, caps: DensityCaps):
    """``fn(p, None, t, caps)`` (a table kind's form) evaluated once a
    distinct tile size of a stack the caller chose (the instance
    wrappers' route, :meth:`CausalTopkModel._by_tile`; the engine reads
    :func:`stat_table`): the stack sorted, each sorted tile's run counted,
    the first of each run gathered into a sorted static table of
    ``U = min(caps.tiles, t.numel())`` rows (padded with the largest
    size), ``fn`` on the table, and each tile's answer gathered from its
    row (``searchsorted``).  A tile whose row does not hold its own size
    answers NaN, never a neighbour's value: the stack held more than
    ``caps.tiles`` sizes.  Static shapes, no host synchronisation;
    ``caps.tiles`` 0 evaluates every tile."""
    tt = _tile(p, t)
    flat = tt.reshape(-1)
    U = min(caps.tiles, flat.numel())
    if not U:
        return fn(p, None, tt, caps)
    s = torch.sort(flat).values
    run = torch.cumsum(torch.cat([torch.ones_like(s[:1], dtype=torch.bool),
                                  s[1:] != s[:-1]]), 0) - 1
    row = torch.arange(U, dtype=run.dtype, device=s.device)
    table = s[torch.searchsorted(run, row).clamp(max=flat.numel() - 1)]
    vals = fn(p, None, table, caps)
    at = torch.searchsorted(table, flat).clamp(max=U - 1)
    return torch.where(table[at] == flat, vals[at], math.nan).view(tt.shape)


#: the table kinds' forms, (prob_empty, expected_density, max_nnz): the
#: kinds whose statistics the engine reads from a table of the tensor's
#: tile sizes (:func:`stat_table`)
TABLE_STATS = {
    CAUSAL_TOPK_ID: (causal_topk_prob_empty_t,
                     causal_topk_expected_density_t, causal_topk_max_nnz_t),
    CAUSAL_BLOCK_TOPK_ID: (causal_block_topk_prob_empty_t,
                           causal_block_topk_expected_density_t,
                           causal_block_topk_max_nnz_t)}


def stat_table(kind: int, params, caps: DensityCaps,
               device=None) -> torch.Tensor:
    """The ``(4, caps.tiles)`` statistics table of a table-kind tensor:
    its tile sizes (:func:`_tile_sizes` of its rows and cols, ``params[1]``
    and ``params[2]``, on the host), then ``prob_empty``,
    ``expected_density`` and ``max_nnz`` at them, each evaluated once by
    the kind's forms at ``caps``; padded with the largest size and its
    answers.  Each evaluation observes ``engine.topk_table_rows`` with the
    sizes it evaluated, so the histogram's count is three times the
    tables built: a count that grows with searches rather than with
    layers means a search rebuilds its table."""
    sizes = _tile_sizes(round(float(params[1])), round(float(params[2])))
    if len(sizes) > caps.tiles:
        raise ValueError(f"caps {caps} hold {caps.tiles} tile sizes, the "
                         f"tensor has {len(sizes)}")
    p = torch.as_tensor(np.asarray(params, np.float64), device=device)
    t = torch.tensor(sizes, dtype=torch.float64, device=device)
    rows = [t]
    for fn in TABLE_STATS[kind]:
        rows.append(fn(p, None, t, caps))
        obs.metrics.histogram("engine.topk_table_rows").observe(len(sizes))
    table = torch.stack(rows)
    return torch.cat([table, table[:, -1:].expand(
        -1, caps.tiles - len(sizes))], 1)


def stat_tables(kinds, params, caps: DensityCaps,
                device=None) -> torch.Tensor:
    """``(T, 4, caps.tiles)``: each table-kind tensor's :func:`stat_table`
    and zeros for every other kind (zero-width where ``caps.tiles`` is
    0, as the histograms are where no actual-data tensor exists)."""
    out = torch.zeros((len(kinds), 4, caps.tiles), dtype=torch.float64,
                      device=device)
    for i, (kind, p) in enumerate(zip(kinds, params)):
        if int(kind) in TABLE_STATS:
            out[i] = stat_table(int(kind), p, caps, device)
    return out


def _table_lookup(table, stat: int, t):
    """Row ``stat`` of a :func:`stat_table` at the tile sizes ``t``: each
    tile's column found among the sizes (``searchsorted``) and its answer
    gathered; a size the table does not hold, one that is no ``d e``
    product, answers NaN, never a neighbour's value.  Observes
    ``engine.topk_tiles`` with the tiles answered."""
    tt = _tile(table, t)
    flat = tt.reshape(-1)
    sizes = table[0]
    at = torch.searchsorted(sizes, flat).clamp(max=sizes.numel() - 1)
    obs.metrics.histogram("engine.topk_tiles").observe(flat.numel())
    return torch.where(sizes[at] == flat, table[stat][at],
                       math.nan).view(tt.shape)


def _actual_index(p, t):
    """Histogram column for a (clamped) tile size; params[0] is the
    valid table length (the concrete array's size)."""
    n = torch.round(p[0]).long()
    tt = torch.round(_tile(p, t)).long()
    return torch.clamp(torch.minimum(tt, n), min=1) - 1


def actual_prob_empty_t(p, h, t):
    return h[0][_actual_index(p, t)]


def actual_expected_density_t(p, h, t):
    return h[1][_actual_index(p, t)]


def actual_max_nnz_t(p, h, t):
    return h[2][_actual_index(p, t)]


class TracedDensityStats:
    """Per-kind tensor tile statistics behind one selection on the model
    id: ``prob_empty(kind, params, hist, tile_size)`` (and
    ``expected_density`` / ``max_nnz``) evaluate the kinds present and
    pick with ``torch.where`` on ``kind``, so one program evaluates
    tensors of mixed density kinds and the kind itself is workload data.
    ``kinds`` names the kind ids that may occur (all of them by default);
    the batched engine passes the one kind its host-side workload params
    hold, so a tensor pays for its own kind only.  Branches whose static
    capacity is zero (no banded or causal kind / no actual tensor can
    ever be selected) are pruned to the trivial dense form.  The
    ``causal_topk`` and ``causal_block_topk`` branches look their answers
    up in the tensor's ``table`` (:func:`stat_table`, the engine's
    workload leaf, built once a layer) and evaluate nothing; without a
    table they evaluate the forms at every tile."""

    def __init__(self, caps: DensityCaps):
        self.caps = caps
        band_ok = caps.coord > 0 and caps.div > 0
        actual_ok = caps.hist > 0

        def band(fn, dense):
            return (lambda p, h, t: fn(p, h, t, caps)) if band_ok else dense

        def topk(kind, stat, dense):
            """row ``stat`` of the table, or the form without one"""
            fn = TABLE_STATS[kind][stat - 1]

            def look(p, h, t, table=None):
                if not band_ok:
                    return dense(p, h, t)
                if table is None:
                    return fn(p, h, t, caps)
                return _table_lookup(table, stat, t)
            return look

        self._pe = (dense_prob_empty_t, uniform_prob_empty_t,
                    structured_prob_empty_t,
                    band(banded_prob_empty_t, dense_prob_empty_t),
                    actual_prob_empty_t if actual_ok
                    else dense_prob_empty_t,
                    band(causal_prob_empty_t, dense_prob_empty_t),
                    topk(CAUSAL_TOPK_ID, 1, dense_prob_empty_t),
                    topk(CAUSAL_BLOCK_TOPK_ID, 1, dense_prob_empty_t))
        self._ed = (dense_expected_density_t, uniform_expected_density_t,
                    structured_expected_density_t,
                    band(banded_expected_density_t,
                         dense_expected_density_t),
                    actual_expected_density_t if actual_ok
                    else dense_expected_density_t,
                    band(causal_expected_density_t,
                         dense_expected_density_t),
                    topk(CAUSAL_TOPK_ID, 2, dense_expected_density_t),
                    topk(CAUSAL_BLOCK_TOPK_ID, 2, dense_expected_density_t))
        self._mx = (dense_max_nnz_t, uniform_max_nnz_t,
                    structured_max_nnz_t,
                    band(banded_max_nnz_t, dense_max_nnz_t),
                    actual_max_nnz_t if actual_ok else dense_max_nnz_t,
                    band(causal_max_nnz_t, dense_max_nnz_t),
                    topk(CAUSAL_TOPK_ID, 3, dense_max_nnz_t),
                    topk(CAUSAL_BLOCK_TOPK_ID, 3, dense_max_nnz_t))

    @staticmethod
    def _select(branches, kind, params, hist, tile_size, kinds, table):
        def one(k):
            if k in TABLE_STATS:
                return branches[k](params, hist, tile_size, table)
            return branches[k](params, hist, tile_size)
        if not isinstance(kind, torch.Tensor):
            return one(int(kind))
        kinds = sorted(set(range(len(branches)) if kinds is None
                           else kinds))
        out = one(kinds[0])
        for k in kinds[1:]:
            # unselected branches may hold inf/NaN (lgamma, log terms);
            # where() keeps them out of the result
            out = torch.where(kind == k, one(k), out)
        return out

    def prob_empty(self, kind, params, hist, tile_size, kinds=None,
                   table=None):
        return self._select(self._pe, kind, params, hist, tile_size, kinds,
                            table)

    def expected_density(self, kind, params, hist, tile_size, kinds=None,
                         table=None):
        return self._select(self._ed, kind, params, hist, tile_size, kinds,
                            table)

    def max_nnz(self, kind, params, hist, tile_size, kinds=None,
                table=None):
        return self._select(self._mx, kind, params, hist, tile_size, kinds,
                            table)


class DensityModel:
    """Base interface; tile_size is the flattened number of elements."""

    #: True when the *_b methods below are traceable closed forms usable
    #: from the batched engine (core.batched).  Every Table-4 model now
    #: is (actual-data via its tile-occupancy histogram).
    batched: bool = False

    #: index into MODEL_KINDS / the TracedDensityStats switch
    kind_id: int = DENSE_ID

    def params(self) -> np.ndarray:
        """Fixed-shape traced parameter vector (NUM_DENSITY_PARAMS,).

        The traced ``<kind>_<stat>_t`` forms consume this, so a compiled
        program can evaluate a *different* instance of the same kind by
        swapping the vector — model parameters are workload data."""
        return np.zeros(NUM_DENSITY_PARAMS)

    def hist_table(self) -> np.ndarray:
        """(3, n) tile-occupancy histogram; only actual-data models have
        a non-empty one."""
        return np.zeros((3, 0))

    def _params_t(self) -> torch.Tensor:
        return torch.as_tensor(self.params(), dtype=torch.float64)

    def prob_empty_b(self, tile_size):
        """Tensor ``prob_empty``: tile_size is a tensor or a float."""
        raise BatchedDensityUnsupported(type(self).__name__)

    def prob_nonempty_b(self, tile_size):
        return 1.0 - self.prob_empty_b(tile_size)

    def expected_density_b(self, tile_size):
        raise BatchedDensityUnsupported(type(self).__name__)

    def max_nnz_b(self, tile_size):
        raise BatchedDensityUnsupported(type(self).__name__)

    #: fraction of nonzeros in the whole tensor
    density: float
    #: total elements in the tensor this model describes
    tensor_size: int

    def expected_density(self, tile_size: int) -> float:
        return self.density

    def prob_empty(self, tile_size: int) -> float:
        raise NotImplementedError

    def prob_nonempty(self, tile_size: int) -> float:
        return 1.0 - self.prob_empty(tile_size)

    def expected_nnz(self, tile_size: int) -> float:
        return self.expected_density(tile_size) * tile_size

    def max_nnz(self, tile_size: int) -> int:
        """Worst-case nonzeros in a tile (for capacity checks)."""
        return min(tile_size, math.ceil(self.density * self.tensor_size))

    def expected_density_nonempty(self, tile_size: int) -> float:
        """E[density | tile nonempty] — used for fibers of nonempty parents."""
        pne = self.prob_nonempty(tile_size)
        if pne <= 0.0:
            return 0.0
        return min(1.0, self.expected_density(tile_size) / pne)


@dataclasses.dataclass
class DenseModel(DensityModel):
    tensor_size: int = 1
    density: float = 1.0
    batched = True
    kind_id = DENSE_ID

    def prob_empty(self, tile_size: int) -> float:
        return 0.0

    def max_nnz(self, tile_size: int) -> int:
        return tile_size

    def prob_empty_b(self, tile_size):
        return dense_prob_empty_t(None, None, tile_size)

    def expected_density_b(self, tile_size):
        return dense_expected_density_t(None, None, tile_size)

    def max_nnz_b(self, tile_size):
        return dense_max_nnz_t(None, None, tile_size)


@dataclasses.dataclass
class UniformModel(DensityModel):
    """nnz locations uniformly random: tile nnz ~ Hypergeometric(S, N, T)."""

    tensor_size: int
    density: float
    batched = True

    @property
    def nnz(self) -> int:
        return round(self.density * self.tensor_size)

    def prob_empty(self, tile_size: int) -> float:
        S, N, T = self.tensor_size, self.nnz, min(tile_size, self.tensor_size)
        # P(empty) = C(S-N, T) / C(S, T)
        lp = _log_comb(S - N, T) - _log_comb(S, T)
        return math.exp(lp) if lp > -700 else 0.0

    def prob_nnz_eq(self, tile_size: int, k: int) -> float:
        S, N, T = self.tensor_size, self.nnz, min(tile_size, self.tensor_size)
        lp = (_log_comb(N, k) + _log_comb(S - N, T - k) - _log_comb(S, T))
        return math.exp(lp) if lp > -700 else 0.0

    def max_nnz(self, tile_size: int) -> int:
        return min(tile_size, self.nnz)

    kind_id = UNIFORM_ID

    def params(self) -> np.ndarray:
        return np.asarray([self.tensor_size, self.nnz, self.density, 0.0])

    def prob_empty_b(self, tile_size):
        return uniform_prob_empty_t(self._params_t(), None, tile_size)

    def expected_density_b(self, tile_size):
        return uniform_expected_density_t(self._params_t(), None, tile_size)

    def max_nnz_b(self, tile_size):
        return uniform_max_nnz_t(self._params_t(), None, tile_size)


@dataclasses.dataclass
class StructuredModel(DensityModel):
    """Fixed N:M structured sparsity along one axis (e.g. 2:4 of the STC).

    Every aligned block of ``m`` elements along the structured axis holds
    exactly ``n`` nonzeros.  For tiles that are multiples of the block the
    behaviour is fully deterministic (this is why Sparseloop reproduces the
    STC's 2x speedup with 100% accuracy — Sec. 6.3.5).
    """

    tensor_size: int
    n: int
    m: int

    @property
    def density(self) -> float:  # type: ignore[override]
        return self.n / self.m

    def expected_density(self, tile_size: int) -> float:
        return self.n / self.m

    def prob_empty(self, tile_size: int) -> float:
        if tile_size >= self.m - self.n + 1:
            # any window of that many elements must contain a nonzero when
            # aligned blocks carry exactly n nonzeros
            return 0.0
        # tile smaller than a block: positions of the n nonzeros within the
        # block are uniform -> hypergeometric within the block
        lp = _log_comb(self.m - self.n, tile_size) - _log_comb(self.m, tile_size)
        return math.exp(lp)

    def max_nnz(self, tile_size: int) -> int:
        full, rem = divmod(tile_size, self.m)
        return min(tile_size, full * self.n + min(rem, self.n))

    batched = True
    kind_id = STRUCTURED_ID

    def params(self) -> np.ndarray:
        return np.asarray([self.tensor_size, self.n, self.m, 0.0],
                          np.float64)

    def prob_empty_b(self, tile_size):
        return structured_prob_empty_t(self._params_t(), None, tile_size)

    def expected_density_b(self, tile_size):
        return structured_expected_density_t(self._params_t(), None,
                                             tile_size)

    def max_nnz_b(self, tile_size):
        return structured_max_nnz_t(self._params_t(), None, tile_size)


@dataclasses.dataclass
class BandedModel(DensityModel):
    """Diagonally banded 2-D tensor: A[i,j] != 0 iff |i - j| <= half_band.

    Coordinate-dependent: tiles on the diagonal are dense-ish, off-diagonal
    tiles are empty.  Tile statistics are derived analytically by counting
    band overlap over all aligned tile positions.

    The ``*_b`` methods are traceable closed forms of the same counts: a
    tile is nonempty iff the band's column footprint over the tile's rows,
    ``[r0 - w, r0 + h - 1 + w]``, intersects the tile's column interval —
    so the nonempty tiles of one row-strip form a contiguous ``tj`` range
    computable with two integer divisions; expected density reduces to
    the band population of the covered rectangle (one O(rows) masked
    reduction).  This keeps banded workloads on the batched engine;
    only ``actual``-data models remain scalar-only.
    """

    rows: int
    cols: int
    half_band: int
    batched = True

    @property
    def tensor_size(self) -> int:  # type: ignore[override]
        return self.rows * self.cols

    @property
    def density(self) -> float:  # type: ignore[override]
        nnz = sum(
            min(self.cols, i + self.half_band + 1) - max(0, i - self.half_band)
            for i in range(self.rows)
        )
        return nnz / self.tensor_size

    def _tile_shape(self, tile_size: int) -> tuple[int, int]:
        """Assume square-ish tiles unless told otherwise (see tile_stats)."""
        tr = int(math.sqrt(tile_size))
        while tile_size % tr:
            tr -= 1
        return tr, tile_size // tr

    def tile_stats(self, tile_rows: int, tile_cols: int) -> tuple[float, float]:
        """(P(tile empty), E[tile density]) over aligned tile positions."""
        nr = max(1, self.rows // max(1, tile_rows))
        nc = max(1, self.cols // max(1, tile_cols))
        empty = 0
        dens = 0.0
        for ti in range(nr):
            r0, r1 = ti * tile_rows, (ti + 1) * tile_rows
            for tj in range(nc):
                c0, c1 = tj * tile_cols, (tj + 1) * tile_cols
                nnz = 0
                for i in range(r0, min(r1, self.rows)):
                    lo = max(c0, i - self.half_band)
                    hi = min(c1, i + self.half_band + 1)
                    nnz += max(0, hi - lo)
                if nnz == 0:
                    empty += 1
                dens += nnz / (tile_rows * tile_cols)
        total = nr * nc
        return empty / total, dens / total

    def prob_empty(self, tile_size: int) -> float:
        return self.tile_stats(*self._tile_shape(tile_size))[0]

    def expected_density(self, tile_size: int) -> float:
        return self.tile_stats(*self._tile_shape(tile_size))[1]

    def max_nnz(self, tile_size: int) -> int:
        tr, tc = self._tile_shape(tile_size)
        # densest tile sits on the diagonal
        best = 0
        for ti in range(max(1, self.rows // max(1, tr))):
            r0 = ti * tr
            c0 = min(max(0, r0 - self.half_band), max(0, self.cols - tc))
            nnz = 0
            for i in range(r0, min(r0 + tr, self.rows)):
                lo = max(c0, i - self.half_band)
                hi = min(c0 + tc, i + self.half_band + 1)
                nnz += max(0, hi - lo)
            best = max(best, nnz)
        return min(tile_size, best if best else self.max_band_nnz(tile_size))

    def max_band_nnz(self, tile_size: int) -> int:
        return min(tile_size, (2 * self.half_band + 1) * int(math.sqrt(tile_size)) + 1)

    # ---------------- tensor closed forms (core.batched) ----------------
    kind_id = BANDED_ID

    def params(self) -> np.ndarray:
        return np.asarray([self.tensor_size, self.rows, self.cols,
                           self.half_band], np.float64)

    def _self_caps(self) -> DensityCaps:
        """Exact (unrounded) capacities for the instance wrappers."""
        return DensityCaps(
            coord=self.rows,
            div=max(1, math.isqrt(max(1, self.rows * self.cols))))

    def prob_empty_b(self, tile_size):
        return banded_prob_empty_t(self._params_t(), None, tile_size,
                                   self._self_caps())

    def expected_density_b(self, tile_size):
        return banded_expected_density_t(self._params_t(), None, tile_size,
                                         self._self_caps())

    def max_nnz_b(self, tile_size):
        return banded_max_nnz_t(self._params_t(), None, tile_size,
                                self._self_caps())


def _floor_sum(n: int, m: int, a: int, b: int) -> int:
    """sum_{i=0..n-1} floor((a*i + b) / m) for n >= 0, m >= 1 and
    a, b >= 0, in O(log m) steps (the Euclid-like reduction of AtCoder's
    ``floor_sum``)."""
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


@dataclasses.dataclass
class CausalModel(DensityModel):
    """Causal (one-sided) band of a 2-D tensor: element (i, j) is
    nonzero iff ``i - window < j <= i``, the attention map of a causal
    (``window`` >= rows: full) or sliding-window mask.

    Tiles follow ``BandedModel``'s aligned convention: a tile of ``t``
    elements is ``tr x tc``, ``tr`` the largest divisor of ``t`` at most
    ``sqrt(t)`` and ``tc = t // tr``, and the grid is ``nr x nc`` tiles
    from the origin, ``nr = max(1, rows // tr)``, ``nc = max(1, cols //
    tc)``.  Edge cases, once: rows and columns past the grid are left
    out; a tile taller (wider) than the tensor holds the tensor's rows
    (columns) and zeros past them, so every tile holds ``hh x kk =
    min(tr, rows) x min(tc, cols)`` of the tensor's elements, and its
    density is over all ``t``.  A window >= rows is the full causal
    mask (so ``window`` is held at most ``rows``).

    Every statistic is an exact count in closed form, with no loop over
    rows, tiles or elements.  A tile's nonzeros depend only on its
    offset ``d = a*tr - b*tc`` (row origin less column origin):
    ``_band_count(hh, kk, -d, w - 1 - d)``, symmetric and unimodal in
    ``d`` about ``c2 / 2``, ``c2 = kk + w - hh - 1``; it is nonzero
    iff ``1 - hh <= d <= w + kk - 2``.  The tiles whose offset lies in
    a range are a sum of floors over row-strips (:meth:`_tiles_between`,
    ``_floor_sum``), so ``prob_empty`` counts the nonempty ones, and
    ``max_nnz`` is the count at the offset nearest the centre, found by
    bisection on that distance.  ``expected_density`` is the band's
    nonzeros in the grid's rectangle.  The tensor forms
    (``causal_*_t``) compute the same counts, with one masked
    O(``caps.coord``) reduction over row-strips in ``prob_empty`` and
    ``max_nnz``.
    """

    rows: int
    cols: int
    window: int
    batched = True
    kind_id = CAUSAL_ID
    _WHOLE = ("rows", "cols", "window")

    def __post_init__(self) -> None:
        for name in self._WHOLE:
            v = getattr(self, name)
            if (isinstance(v, bool) or not isinstance(v, numbers.Real)
                    or int(v) != v or v < 1):
                raise ValueError(f"{MODEL_KINDS[self.kind_id]} {name} must "
                                 f"be a whole number >= 1, got {v!r}")
            setattr(self, name, int(v))

    @property
    def w(self) -> int:
        return min(self.window, self.rows)

    @property
    def tensor_size(self) -> int:  # type: ignore[override]
        return self.rows * self.cols

    @property
    def density(self) -> float:  # type: ignore[override]
        return (_band_count(self.rows, self.cols, 0, self.w - 1)
                / self.tensor_size)

    @staticmethod
    def _grid_of(rows: int, cols: int, tile_size) -> tuple[int, ...]:
        """``(t, tr, tc, nr, nc, hh, kk)`` of a tile size."""
        t = max(1, int(tile_size))
        tr = math.isqrt(t)
        while t % tr:
            tr -= 1
        tc = t // tr
        return (t, tr, tc, max(1, rows // tr), max(1, cols // tc),
                min(tr, rows), min(tc, cols))

    def _grid(self, tile_size) -> tuple[int, ...]:
        return self._grid_of(self.rows, self.cols, tile_size)

    @staticmethod
    def _tiles_between(tr: int, tc: int, nr: int, nc: int, lo: int,
                       hi: int) -> int:
        """#{(a, b) in [0, nr) x [0, nc) : lo <= a*tr - b*tc <= hi}.

        Strip ``a`` holds ``b`` in ``[ceil((a*tr - hi)/tc), floor((a*tr -
        lo)/tc)]`` clipped to ``[0, nc)``; both ends grow with ``a``, so
        the strips that hold any form a range, over which each clip is
        active on a prefix or a suffix, and the rest are floor sums."""
        if lo > hi:
            return 0
        a_s = max(0, -(-lo // tr))                  # floor((a tr - lo)/tc) >= 0
        a_e = min(nr, (hi + (nc - 1) * tc) // tr + 1)   # ceil(...) <= nc - 1
        if a_e <= a_s:
            return 0
        # sum of min(nc - 1, floor((a tr - lo)/tc)): unclipped below a_m
        a_m = min(max((lo + nc * tc - 1) // tr + 1, a_s), a_e)
        top = (_floor_sum(a_m - a_s, tc, tr, a_s * tr - lo)
               + (a_e - a_m) * (nc - 1))
        # sum of max(0, ceil((a tr - hi)/tc)): positive from a_z
        a_z = min(max(-(-(hi + 1) // tr), a_s), a_e)
        bottom = _floor_sum(a_e - a_z, tc, tr, a_z * tr - hi + tc - 1)
        return top - bottom + (a_e - a_s)

    def prob_empty(self, tile_size: int) -> float:
        t, tr, tc, nr, nc, hh, kk = self._grid(tile_size)
        full = self._tiles_between(tr, tc, nr, nc, 1 - hh,
                                   self.w + kk - 2)
        return (nr * nc - full) / (nr * nc)

    def expected_density(self, tile_size: int) -> float:
        t, tr, tc, nr, nc, _, _ = self._grid(tile_size)
        nnz = _band_count(min(nr * tr, self.rows), min(nc * tc, self.cols),
                          0, self.w - 1)
        return nnz / (nr * nc * t)

    def max_nnz(self, tile_size: int) -> int:
        t, tr, tc, nr, nc, hh, kk = self._grid(tile_size)
        c2 = kk + self.w - hh - 1

        def near(e: int) -> bool:
            """Some tile's offset d has |2d - c2| <= e."""
            return self._tiles_between(tr, tc, nr, nc, -((e - c2) // 2),
                                       (c2 + e) // 2) > 0

        lo, hi = 0, 2 * max((nr - 1) * tr, (nc - 1) * tc) + abs(c2)
        while lo < hi:
            mid = (lo + hi) // 2
            if near(mid):
                hi = mid
            else:
                lo = mid + 1
        off = (c2 + lo) // 2
        return min(t, _band_count(hh, kk, -off, self.w - 1 - off))

    # ---------------- tensor closed forms (core.batched) ----------------
    def params(self) -> np.ndarray:
        return np.asarray([self.tensor_size, self.rows, self.cols, self.w],
                          np.float64)

    def _self_caps(self) -> DensityCaps:
        """Exact (unrounded) capacities for the instance wrappers."""
        return DensityCaps(coord=self.rows,
                           div=max(1, math.isqrt(self.tensor_size)))

    def prob_empty_b(self, tile_size):
        return causal_prob_empty_t(self._params_t(), None, tile_size,
                                   self._self_caps())

    def expected_density_b(self, tile_size):
        return causal_expected_density_t(self._params_t(), None, tile_size,
                                         self._self_caps())

    def max_nnz_b(self, tile_size):
        return causal_max_nnz_t(self._params_t(), None, tile_size,
                                self._self_caps())


@functools.lru_cache(maxsize=16)
def _topk_rows(rows: int, cols: int, w: int, k: int) -> tuple:
    """Per row of a causal_topk tensor: ``(lo, hi, n, kept, a)``, the
    support ``[lo, hi]`` of ``n`` columns, ``kept = min(k, n)`` and the
    table ``a[x] = A(x) = -log C(x, k)`` (0 up to ``k``)."""
    i = np.arange(rows)
    lo = np.maximum(i - w + 1, 0)
    hi = np.minimum(i, cols - 1)
    n = np.maximum(hi - lo + 1, 0)
    y = np.arange(int(n.max(initial=0)) + 1, dtype=np.float64)
    a = np.cumsum(np.log1p(np.where(y > k, -k / np.maximum(y, 1.0), 0.0)))
    return lo, hi, n, np.minimum(n, k), a


@functools.lru_cache(maxsize=4096)
def _topk_tile(rows: int, cols: int, w: int, k: int, tile_size: int):
    """``(prob_empty, expected_density, max_nnz)`` of a causal_topk
    tensor at one tile size, over the strips and rows of its grid at
    once (:meth:`CausalTopkModel` has the definitions)."""
    lo, hi, n, kept, a = _topk_rows(rows, cols, w, k)
    t, tr, tc, nr, nc, hh, kk = CausalModel._grid_of(rows, cols, tile_size)
    g = nr * hh
    # expected density: each row's kept share of its columns in the grid
    cover = np.maximum(np.minimum(hi[:g], nc * tc - 1) - lo[:g] + 1, 0)
    nnz = np.sum(np.where(n[:g] > 0, kept[:g] * cover
                          / np.maximum(n[:g], 1), 0.0))
    lo, hi, n, kept = (x[:g].reshape(nr, hh) for x in (lo, hi, n, kept))
    r0 = np.arange(nr)[:, None] * tr
    # per strip: the nonempty run [b_lo, b_hi], the full tiles [bf_lo,
    # bf_hi] and the partial ones, two at most at either end of the run
    b_hi = np.minimum((r0 + hh - 1) // tc, nc - 1)
    b_lo = np.maximum(-((w + kk - 2 - r0) // tc), 0)
    bf_lo = -(-np.maximum(r0 + hh - w, 0) // tc)
    bf_hi = np.minimum((np.minimum(r0, cols - 1) - kk + 1) // tc, nc - 1)
    full = np.maximum(bf_hi - bf_lo + 1, 0)
    left = np.where(full > 0, bf_lo, b_hi + 1)
    right = np.where(full > 0, bf_hi, b_lo + 1)

    def log_miss(m):
        """The strip's log-probability that its rows miss m columns."""
        return np.where(m > n - kept, -np.inf,
                        a[n] - a[np.maximum(n - m, 0)]).sum(1, keepdims=True)

    empty = full * np.exp(log_miss(np.full_like(n, kk)))
    most = np.where(full > 0, hh * min(k, kk), 0)
    for b, ok in ((b_lo, b_lo < left), (b_lo + 1, b_lo + 1 < left),
                  (b_hi - 1, b_hi - 1 > right), (b_hi, b_hi > right)):
        c0 = b * tc
        m = np.maximum(np.minimum(hi + 1, c0 + kk) - np.maximum(lo, c0), 0)
        empty = empty + np.where(ok, np.exp(log_miss(m)), 0.0)
        most = np.maximum(most, np.where(
            ok, np.minimum(m, k).sum(1, keepdims=True), 0))
    run = int(np.maximum(b_hi - b_lo + 1, 0).sum())
    return ((nr * nc - run + float(empty.sum())) / (nr * nc),
            float(nnz) / (nr * nc * t), min(t, int(most.max())))


@dataclasses.dataclass
class CausalTopkModel(CausalModel):
    """A top-``k`` selection inside the causal band, the attention map of
    a learned sparse attention (DeepSeek-V3.2's DSA: a lightning indexer
    keeps 2,048 keys a query).  Row ``i``'s support is ``S_i = {j : i -
    window < j <= i}`` (within the columns), ``n_i = |S_i|``, and exactly
    ``k_i = min(k, n_i)`` of it is nonzero, drawn uniformly without
    replacement, the rows independent; ``k >= window`` is the causal map.

    On :class:`CausalModel`'s grid, with ``m_i`` row ``i``'s support
    columns inside a tile:

    * ``prob_empty``: the mean over tiles of ``prod_rows C(n_i - m_i,
      k_i) / C(n_i, k_i)``;
    * ``expected_density``: ``sum_rows k_i |S_i inside the grid's
      columns| / n_i`` over ``nr * nc * t``;
    * ``max_nnz``: the most nonzeros any draw can put in a tile, ``max
      over tiles of sum_rows min(k, m_i)``.

    A strip's tiles outside its nonempty run are empty for sure, the
    tiles every row meets in all its columns share one value, and the
    rest are at most two at either end of the run; so a tile size costs
    O(rows), over the strips and rows at once, memoised per tile size
    (``_topk_tile``).  The tensor forms (``causal_topk_*_t``) compute
    the same sums in int64 fixed point."""

    k: int
    kind_id = CAUSAL_TOPK_ID
    _WHOLE = ("rows", "cols", "window", "k")

    @property
    def density(self) -> float:  # type: ignore[override]
        return (float(_topk_rows(self.rows, self.cols, self.w, self.k)[3]
                      .sum()) / self.tensor_size)

    def _stats(self, tile_size) -> tuple:
        return _topk_tile(self.rows, self.cols, self.w, self.k,
                          max(1, int(tile_size)))

    def prob_empty(self, tile_size: int) -> float:
        return self._stats(tile_size)[0]

    def expected_density(self, tile_size: int) -> float:
        return self._stats(tile_size)[1]

    def max_nnz(self, tile_size: int) -> int:
        return self._stats(tile_size)[2]

    # ---------------- tensor closed forms (core.batched) ----------------
    def params(self) -> np.ndarray:
        return np.asarray([self.k, self.rows, self.cols, self.w],
                          np.float64)

    def _self_caps(self) -> DensityCaps:
        return dataclasses.replace(
            super()._self_caps(),
            tiles=_divisor_products(self.rows, self.cols))

    def _by_tile(self, fn, tile_size):
        """``fn`` once a distinct tile size, the table as large as the
        stack: a caller may ask any sizes, not only the engine's."""
        p = self._params_t()
        tt = _tile(p, tile_size)
        caps = self._self_caps()
        return _by_distinct_tile(fn, p, tt, dataclasses.replace(
            caps, tiles=max(caps.tiles, tt.numel())))

    def prob_empty_b(self, tile_size):
        return self._by_tile(causal_topk_prob_empty_t, tile_size)

    def expected_density_b(self, tile_size):
        return self._by_tile(causal_topk_expected_density_t, tile_size)

    def max_nnz_b(self, tile_size):
        return self._by_tile(causal_topk_max_nnz_t, tile_size)


@functools.lru_cache(maxsize=16)
def _block_rows(rows: int, cols: int, block: int, k: int, init: int,
                local: int) -> tuple:
    """Per row of a causal_block_topk tensor: ``(hi, lq, lq_col, n,
    kept, a)``, the last causal column, the first local block that is no
    init block and its first column (past ``hi`` where there is none),
    the candidate blocks, ``kept = min(k, n)`` and the table ``a[x] =
    -log C(x, k)`` (0 up to ``k``)."""
    hi = np.minimum(np.arange(rows), cols - 1)
    nb = hi // block + 1
    lq = np.maximum(nb - local, init)
    n = np.maximum(nb - local - init, 0)
    y = np.arange(int(n.max(initial=0)) + 1, dtype=np.float64)
    a = np.cumsum(np.log1p(np.where(y > k, -k / np.maximum(y, 1.0), 0.0)))
    return hi, lq, np.minimum(lq, nb) * block, n, np.minimum(n, k), a


def _block_columns(h1, lq_col, init_col) -> tuple:
    """Forced and candidate columns of the rows' first ``h1`` columns."""
    return (np.minimum(init_col, h1) + np.maximum(h1 - lq_col, 0),
            np.maximum(np.minimum(h1, lq_col) - init_col, 0))


@functools.lru_cache(maxsize=4096)
def _block_tile(rows: int, cols: int, block: int, k: int, init: int,
                local: int, tile_size: int):
    """``(prob_empty, expected_density, max_nnz)`` of a causal_block_topk
    tensor at one tile size, over the strips and rows of its grid at
    once (:class:`CausalBlockTopkModel` has the definitions)."""
    hi, lq, lq_col, n, kept, a = _block_rows(rows, cols, block, k, init,
                                             local)
    B, ic = block, init * block
    t, tr, tc, nr, nc, hh, kk = CausalModel._grid_of(rows, cols, tile_size)
    g = nr * hh
    forced, cand = _block_columns(np.minimum(hi[:g] + 1, min(nc * tc, cols)),
                                  lq_col[:g], ic)
    nnz = forced.sum() + np.sum(np.where(
        n[:g] > 0, kept[:g] * cand / np.maximum(n[:g], 1), 0.0))
    hi, lq, lq_col, n, kept = (x[:g].reshape(nr, hh)
                               for x in (hi, lq, lq_col, n, kept))
    r0 = np.arange(nr)[:, None] * tr
    hi0 = np.minimum(r0, cols - 1)
    # per strip: the run [0, b_hi]; the interior tiles [bi_lo, bi_hi],
    # every row's candidate blocks; its two partial tiles from s0
    b_hi = np.minimum((r0 + hh - 1) // tc, nc - 1)
    bi_lo = -(-ic // tc)
    bi_hi = np.minimum(np.minimum(
        (np.maximum(hi0 // B + 1 - local, 0) * B - kk) // tc,
        (hi0 - kk + 1) // tc), nc - 1)
    nint = np.maximum(bi_hi - bi_lo + 1, 0)
    m_lo, mu = (kk - 1) // B + 1, min(B, kk)
    c0 = np.arange(nc) * tc
    up = np.concatenate([[0], np.cumsum((c0 + kk - 1) // B - c0 // B + 1
                                        - m_lo)])
    cnt_hi = np.where(nint > 0, up[np.clip(bi_hi + 1, 0, nc)]
                      - up[np.clip(bi_lo, 0, nc)], 0)

    def log_miss(m, hit=False):
        """The strip's log-probability that its rows miss m blocks."""
        return np.where(hit | (m > n - kept), -np.inf,
                        a[n] - a[np.maximum(n - m, 0)]).sum(1, keepdims=True)

    empty = np.where(nint > 0, (nint - cnt_hi) * np.exp(log_miss(m_lo))
                     + cnt_hi * np.exp(log_miss(m_lo + 1)), 0.0)
    most = np.where(nint > 0, hh * np.minimum(
        kk, np.minimum(k, m_lo + (cnt_hi > 0)) * mu), 0)
    s0 = np.maximum(bi_hi, bi_lo - 1) + 1
    for b in (s0, s0 + 1):
        ok, c0 = b <= b_hi, b * tc
        e = np.minimum(c0 + kk - 1, hi)
        causal = c0 <= hi
        c = np.where(causal, e - c0 + 1, 0)
        f = np.where(causal, np.maximum(np.minimum(e, ic - 1) - c0 + 1, 0)
                     + np.maximum(e - np.maximum(c0, lq_col) + 1, 0), 0)
        m = np.where(causal, np.maximum(np.minimum(e // B, lq - 1)
                                        - np.maximum(c0 // B, init) + 1, 0),
                     0)
        empty = empty + np.where(ok, np.exp(log_miss(m, f > 0)), 0.0)
        most = np.maximum(most, np.where(ok, np.minimum(
            c, f + np.minimum(m, k) * mu).sum(1, keepdims=True), 0))
    held, _ = _block_columns(hi + 1, lq_col, ic)
    bound = np.minimum(np.minimum(kk, hi + 1),
                       np.minimum(kk, held) + k * mu).sum(1, keepdims=True)
    most = np.maximum(most, np.where((bi_lo > 0) | (b_hi > s0 + 1), bound,
                                     0))
    run = int((b_hi + 1).sum())
    return ((nr * nc - run + float(empty.sum())) / (nr * nc),
            float(nnz) / (nr * nc * t), min(t, int(most.max())))


@dataclasses.dataclass
class CausalBlockTopkModel(DensityModel):
    """A top-``k`` selection of whole key blocks inside the causal map,
    the attention map of a block-sparse attention (MiniMax-M3's MSA: an
    indexer scores max-pooled blocks of 128 keys and a query keeps its
    top 16, its first and its own).  Row ``i``'s causal columns ``[0,
    hi_i]``, ``hi_i = min(i, cols - 1)``, fall in blocks of ``block``
    columns, ``0 .. nb_i - 1``; its first ``init`` and last ``local``
    blocks are nonzero, and of the ``n_i`` others (candidates) exactly
    ``min(k, n_i)`` are, drawn uniformly without replacement, the rows
    independent.  ``block`` 1 with ``init`` and ``local`` 0 is
    ``causal_topk`` at ``window = rows``.

    On :class:`CausalModel`'s grid, with ``c_i``, ``f_i`` and ``m_i`` row
    ``i``'s causal columns, forced columns and candidate blocks met in a
    tile, and ``mu = min(block, kk)``:

    * ``prob_empty``: the mean over tiles of ``prod_rows [f_i = 0] C(n_i -
      m_i, k_i) / C(n_i, k_i)``, ``k_i = min(k, n_i)``;
    * ``expected_density``: ``sum_rows f_i + k_i g_i / n_i`` over ``nr nc
      t``, ``f_i`` and ``g_i`` the forced and candidate columns inside
      the grid's columns;
    * ``max_nnz``: a bound, ``max`` over the tiles of ``sum_rows min(c_i,
      f_i + min(k, m_i) mu)``, where the tiles that meet a forced block
      are bounded together by each row's ``min(c_i(0), min(kk, F_i) + k
      mu)``, ``F_i`` all its forced columns.

    A strip's tiles split into the empty ones past its diagonal, those
    that meet a forced block, the interior ones (two values) and two
    partial ones, so a tile size costs O(rows), over the strips and rows
    at once, memoised per tile size (``_block_tile``).  The tensor forms
    (``causal_block_topk_*_t``) compute the same sums in int64 fixed
    point."""

    rows: int
    cols: int
    block: int
    k: int
    init: int
    local: int
    batched = True
    kind_id = CAUSAL_BLOCK_TOPK_ID
    #: each field's least value, and the packed ones' bound
    _LEAST = {"rows": 1, "cols": 1, "block": 1, "k": 1, "init": 0,
              "local": 0}
    _BELOW = {"block": 1 << _BLOCK_BITS, "init": 1 << _END_BITS,
              "local": 1 << _END_BITS}

    def __post_init__(self) -> None:
        for name, least in self._LEAST.items():
            v = getattr(self, name)
            if (isinstance(v, bool) or not isinstance(v, numbers.Real)
                    or int(v) != v or not least <= v
                    < self._BELOW.get(name, math.inf)):
                raise ValueError(f"causal_block_topk {name} must be a whole "
                                 f"number in [{least}, "
                                 f"{self._BELOW.get(name, 'inf')}), got "
                                 f"{v!r}")
            setattr(self, name, int(v))

    @property
    def tensor_size(self) -> int:  # type: ignore[override]
        return self.rows * self.cols

    def _key(self) -> tuple:
        return (self.rows, self.cols, self.block, self.k, self.init,
                self.local)

    @property
    def density(self) -> float:  # type: ignore[override]
        hi, _, lq_col, n, kept, _ = _block_rows(*self._key())
        forced, cand = _block_columns(hi + 1, lq_col, self.init * self.block)
        return float(forced.sum() + np.sum(np.where(
            n > 0, kept * cand / np.maximum(n, 1), 0.0))) / self.tensor_size

    def _stats(self, tile_size) -> tuple:
        return _block_tile(*self._key(), max(1, int(tile_size)))

    def prob_empty(self, tile_size: int) -> float:
        return self._stats(tile_size)[0]

    def expected_density(self, tile_size: int) -> float:
        return self._stats(tile_size)[1]

    def max_nnz(self, tile_size: int) -> int:
        return self._stats(tile_size)[2]

    # ---------------- tensor closed forms (core.batched) ----------------
    def params(self) -> np.ndarray:
        return np.asarray([self.k, self.rows, self.cols, self.block
                           + (self.init << _BLOCK_BITS)
                           + (self.local << (_BLOCK_BITS + _END_BITS))],
                          np.float64)

    def _self_caps(self) -> DensityCaps:
        return DensityCaps(coord=self.rows,
                           div=max(1, math.isqrt(self.tensor_size)),
                           tiles=_divisor_products(self.rows, self.cols))

    _by_tile = CausalTopkModel._by_tile

    def prob_empty_b(self, tile_size):
        return self._by_tile(causal_block_topk_prob_empty_t, tile_size)

    def expected_density_b(self, tile_size):
        return self._by_tile(causal_block_topk_expected_density_t,
                             tile_size)

    def max_nnz_b(self, tile_size):
        return self._by_tile(causal_block_topk_max_nnz_t, tile_size)


#: tile-occupancy histograms keyed by the identity of the source array:
#: the table costs O(n log n) to build (and the workload's density spec
#: holds the same ndarray across model rebuilds), so it is computed once
#: per concrete array.  Entries keep the array alive so ids stay valid.
_HIST_CACHE: dict[int, tuple[object, np.ndarray]] = {}
_HIST_CACHE_CAP = 32


@dataclasses.dataclass
class ActualDataModel(DensityModel):
    """Exact empirical statistics from a concrete numpy array.

    This is the paper's "actual data" model: slower but exact, used e.g. for
    the Eyeriss-V2 validation where statistical approximation is the main
    error source (Sec. 6.3.2).

    The traced path lowers the array to a device-resident *tile-occupancy
    histogram* (:meth:`hist_table`): exact per-tile-size statistics
    precomputed once, gathered by traced tile size — so actual-data
    workloads ride the batched/bucketed engine like every other
    density kind.
    """

    data: np.ndarray

    def __post_init__(self) -> None:
        self._flat_nz = (np.asarray(self.data) != 0)
        self._hist: np.ndarray | None = None

    @property
    def tensor_size(self) -> int:  # type: ignore[override]
        return int(self._flat_nz.size)

    @property
    def density(self) -> float:  # type: ignore[override]
        return float(self._flat_nz.mean()) if self._flat_nz.size else 0.0

    def _tiled_nnz(self, tile_size: int) -> np.ndarray:
        """nnz per aligned 1-D tile of the flattened tensor.

        For multi-dim tile shapes callers should use :meth:`tile_nnz_grid`.
        """
        flat = self._flat_nz.reshape(-1)
        n = (flat.size // tile_size) * tile_size
        if n == 0:
            return np.array([flat.sum()])
        return flat[:n].reshape(-1, tile_size).sum(axis=1)

    def tile_nnz_grid(self, tile_dims: Sequence[int]) -> np.ndarray:
        """Exact nnz of every aligned tile of shape tile_dims."""
        a = self._flat_nz
        if a.ndim != len(tile_dims):
            return self._tiled_nnz(int(np.prod(tile_dims)))
        slices, new_shape = [], []
        for ext, t in zip(a.shape, tile_dims):
            t = min(t, ext)
            n = (ext // t) * t
            slices.append(slice(0, n))
            new_shape += [ext // t, t]
        a = a[tuple(slices)].reshape(new_shape)
        # sum over the intra-tile axes (odd positions)
        return a.sum(axis=tuple(range(1, 2 * len(tile_dims), 2)))

    def prob_empty(self, tile_size: int) -> float:
        nnz = self._tiled_nnz(min(tile_size, self.tensor_size))
        return float((nnz == 0).mean())

    def expected_density(self, tile_size: int) -> float:
        t = min(tile_size, self.tensor_size)
        return float(self._tiled_nnz(t).mean() / t)

    def max_nnz(self, tile_size: int) -> int:
        return int(self._tiled_nnz(min(tile_size, self.tensor_size)).max())

    # ------------- tile-occupancy histogram (traced lowering) -------------
    batched = True
    kind_id = ACTUAL_ID

    def params(self) -> np.ndarray:
        return np.asarray([self.tensor_size, self.density, 0.0, 0.0],
                          np.float64)

    def hist_table(self) -> np.ndarray:
        """(3, tensor_size) exact per-tile-size statistics: row 0 is
        ``prob_empty``, row 1 ``expected_density``, row 2 ``max_nnz``
        for every aligned 1-D tile size ``t = 1..tensor_size`` of the
        flattened array — the same semantics as the scalar methods above
        (non-divisible tails dropped, the remainder-free prefix tiled).
        Built from one cumulative sum, vectorized over divisor blocks
        (all tile sizes sharing a tile *count* ``m = n // t`` are one
        numpy gather): O(n log n) element work in O(sqrt n) Python
        iterations.  Cached per source array."""
        if self._hist is not None:
            return self._hist
        key = id(self.data)
        cached = _HIST_CACHE.get(key)
        if cached is not None and cached[0] is self.data:
            self._hist = cached[1]
            return self._hist
        flat = self._flat_nz.reshape(-1).astype(np.int64)
        n = flat.size
        out = np.zeros((3, n))
        cs = np.concatenate([[0], np.cumsum(flat)])
        t = 1
        while t <= n:
            m = n // t                     # aligned tiles at this size
            t_hi = n // m                  # all t in [t, t_hi] share m
            ts = np.arange(t, t_hi + 1)
            edges = ts[None, :] * np.arange(m + 1)[:, None]
            tiles = np.diff(cs[edges], axis=0)          # (m, len(ts))
            out[0, ts - 1] = (tiles == 0).mean(axis=0)
            out[1, ts - 1] = tiles.mean(axis=0) / ts
            out[2, ts - 1] = tiles.max(axis=0)
            t = t_hi + 1
        self._hist = out
        if len(_HIST_CACHE) >= _HIST_CACHE_CAP:
            _HIST_CACHE.pop(next(iter(_HIST_CACHE)))
        _HIST_CACHE[key] = (self.data, out)
        return out

    def _hist_b(self):
        return torch.as_tensor(self.hist_table(), dtype=torch.float64)

    def prob_empty_b(self, tile_size):
        return actual_prob_empty_t(self._params_t(), self._hist_b(),
                                   tile_size)

    def expected_density_b(self, tile_size):
        return actual_expected_density_t(self._params_t(), self._hist_b(),
                                         tile_size)

    def max_nnz_b(self, tile_size):
        return actual_max_nnz_t(self._params_t(), self._hist_b(), tile_size)


def make_density_model(spec: object, tensor_size: int) -> DensityModel:
    """Build a model from a workload density spec tuple."""
    if spec is None:
        return DenseModel(tensor_size)
    kind, arg = spec  # type: ignore[misc]
    if kind == "dense":
        return DenseModel(tensor_size)
    if kind == "uniform":
        return UniformModel(tensor_size=tensor_size, density=float(arg))
    if kind == "structured":
        return StructuredModel(tensor_size=tensor_size,
                               n=int(arg["n"]), m=int(arg["m"]))
    if kind == "banded":
        return BandedModel(rows=int(arg["rows"]), cols=int(arg["cols"]),
                           half_band=int(arg["half_band"]))
    if kind == "actual":
        return ActualDataModel(data=np.asarray(arg))
    if kind == "causal":
        return CausalModel(rows=arg["rows"], cols=arg["cols"],
                           window=arg["window"])
    if kind == "causal_topk":
        missing = {"rows", "cols", "window", "k"} - set(arg)
        if missing:
            raise ValueError(f"causal_topk needs {sorted(missing)}")
        return CausalTopkModel(rows=arg["rows"], cols=arg["cols"],
                               window=arg["window"], k=arg["k"])
    if kind == "causal_block_topk":
        keys = ("rows", "cols", "block", "k", "init", "local")
        missing = set(keys) - set(arg)
        if missing:
            raise ValueError(f"causal_block_topk needs {sorted(missing)}")
        return CausalBlockTopkModel(**{key: arg[key] for key in keys})
    raise ValueError(f"unknown density spec {spec!r}")
