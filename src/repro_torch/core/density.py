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

The scalar models (``DensityModel`` and its subclasses) are a copy of the
JAX package's; all prob/expectation math is done in log-space (lgamma).

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
at evaluation time.  Shape-dependent statistics (banded row scans,
histogram tables) are padded to static :class:`DensityCaps` so programs
stay shape-stable across layers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

#: density-model kind ids (the selection index of TracedDensityStats)
DENSE_ID, UNIFORM_ID, STRUCTURED_ID, BANDED_ID, ACTUAL_ID = range(5)
MODEL_KINDS = ("dense", "uniform", "structured", "banded", "actual")

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
    row count of any banded tensor (row-scan length), ``div`` >= the
    isqrt of any banded tensor's size (tile-shape divisor scan), and
    ``hist`` >= the size of any actual-data tensor (histogram table
    length).  Zero means "no tensor of that family" and prunes the
    corresponding branch of the kind selection entirely.  Caps are part of a
    compiled program's cache key; :func:`caps_for_models` rounds them up
    to powers of two so layers of similar size land on the same program.
    """

    coord: int = 0
    div: int = 0
    hist: int = 0

    def merge(self, other: "DensityCaps") -> "DensityCaps":
        return DensityCaps(coord=max(self.coord, other.coord),
                           div=max(self.div, other.div),
                           hist=max(self.hist, other.hist))

    def covers(self, need: "DensityCaps") -> bool:
        return (self.coord >= need.coord and self.div >= need.div
                and self.hist >= need.hist)


def _pow2_cap(n: int) -> int:
    return 1 << (int(n) - 1).bit_length() if n > 0 else 0


def caps_for_models(models: Sequence["DensityModel"],
                    round_pow2: bool = True) -> DensityCaps:
    """The smallest :class:`DensityCaps` covering ``models`` (rounded up
    to powers of two by default, so similarly-sized layers share)."""
    coord = div = hist = 0
    for m in models:
        if isinstance(m, BandedModel):
            coord = max(coord, m.rows)
            div = max(div, max(1, math.isqrt(max(1, m.rows * m.cols))))
        elif isinstance(m, ActualDataModel):
            hist = max(hist, m.tensor_size)
    if round_pow2:
        coord, div, hist = (_pow2_cap(coord), _pow2_cap(div),
                            _pow2_cap(hist))
    return DensityCaps(coord=coord, div=div, hist=hist)


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


def _banded_grid_t(p, t, caps: DensityCaps):
    """Tensor mirror of ``BandedModel._tile_shape`` + aligned-grid setup
    with the band geometry as params [size, rows, cols, w].

    ``tr`` is the largest divisor of the tile size <= floor(sqrt(t))
    (what the scalar decrement loop finds), found by scanning the static
    divisor range ``1..caps.div`` along a trailing axis."""
    rows = torch.round(p[1]).long()
    cols = torch.round(p[2]).long()
    ti = torch.clamp(torch.round(_tile(p, t)), min=1.0).long()
    d = torch.arange(1, caps.div + 1, dtype=torch.int64, device=ti.device)
    root = torch.floor(torch.sqrt(ti.double())).long()
    ok = (torch.remainder(ti[..., None], d) == 0) & (d <= root[..., None])
    tr = torch.where(ok, d, 1).amax(-1)
    tc = _floordiv(ti, tr)
    nr = torch.clamp(_floordiv(rows, tr), min=1)
    nc = torch.clamp(_floordiv(cols, tc), min=1)
    return ti, tr, tc, nr, nc, rows, cols


def banded_prob_empty_t(p, h, t, caps: DensityCaps):
    del h
    _, tr, tc, nr, nc, rows, _cols = _banded_grid_t(p, t, caps)
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
    ti, tr, tc, nr, nc, rows, _cols = _banded_grid_t(p, t, caps)
    w = torch.round(p[3]).long()
    i = torch.arange(caps.coord, dtype=torch.int64, device=tr.device)
    covered_rows = torch.minimum(nr * tr, rows)
    covered_cols = nc * tc          # c1 is never clamped to cols
    ln = torch.clamp(torch.minimum(covered_cols[..., None], i + w + 1)
                     - torch.clamp(i - w, min=0), min=0)
    nnz = torch.where(i < covered_rows[..., None], ln, 0).sum(-1)
    return nnz.double() / ((nr * nc).double() * ti.double())


def banded_max_nnz_t(p, h, t, caps: DensityCaps):
    del h
    ti, tr, tc, nr, _nc, rows, cols = _banded_grid_t(p, t, caps)
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
    ``kinds`` names the kind ids that may occur (all five by default);
    the batched engine passes the one kind its host-side workload params
    hold, so a tensor pays for its own kind only.  Branches whose static
    capacity is zero (no banded / no actual tensor can ever be selected)
    are pruned to the trivial dense form."""

    def __init__(self, caps: DensityCaps):
        self.caps = caps
        banded_ok = caps.coord > 0 and caps.div > 0
        actual_ok = caps.hist > 0

        def with_caps(fn):
            return lambda p, h, t: fn(p, h, t, caps)

        self._pe = (dense_prob_empty_t, uniform_prob_empty_t,
                    structured_prob_empty_t,
                    with_caps(banded_prob_empty_t) if banded_ok
                    else dense_prob_empty_t,
                    actual_prob_empty_t if actual_ok
                    else dense_prob_empty_t)
        self._ed = (dense_expected_density_t, uniform_expected_density_t,
                    structured_expected_density_t,
                    with_caps(banded_expected_density_t) if banded_ok
                    else dense_expected_density_t,
                    actual_expected_density_t if actual_ok
                    else dense_expected_density_t)
        self._mx = (dense_max_nnz_t, uniform_max_nnz_t,
                    structured_max_nnz_t,
                    with_caps(banded_max_nnz_t) if banded_ok
                    else dense_max_nnz_t,
                    actual_max_nnz_t if actual_ok else dense_max_nnz_t)

    @staticmethod
    def _select(branches, kind, params, hist, tile_size, kinds):
        if not isinstance(kind, torch.Tensor):
            return branches[int(kind)](params, hist, tile_size)
        kinds = sorted(set(range(len(branches)) if kinds is None
                           else kinds))
        out = branches[kinds[0]](params, hist, tile_size)
        for k in kinds[1:]:
            # unselected branches may hold inf/NaN (lgamma, log terms);
            # where() keeps them out of the result
            out = torch.where(kind == k,
                              branches[k](params, hist, tile_size), out)
        return out

    def prob_empty(self, kind, params, hist, tile_size, kinds=None):
        return self._select(self._pe, kind, params, hist, tile_size, kinds)

    def expected_density(self, kind, params, hist, tile_size, kinds=None):
        return self._select(self._ed, kind, params, hist, tile_size, kinds)

    def max_nnz(self, kind, params, hist, tile_size, kinds=None):
        return self._select(self._mx, kind, params, hist, tile_size, kinds)

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
    raise ValueError(f"unknown density spec {spec!r}")
