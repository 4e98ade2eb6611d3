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

The scalar models, frozen from the port's ``core/density.py`` with its
tensor forms taken out; all prob/expectation math is done in log-space
(lgamma).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import math
import re
from pathlib import Path
from typing import Sequence

import numpy as np

from .precision import real

def _log_comb(n: float, k: float) -> float:
    """log C(n, k); -inf when invalid."""
    if k < 0 or k > n or n < 0:
        return -math.inf
    return (real(math.lgamma(n + 1)) - real(math.lgamma(k + 1))
            - real(math.lgamma(n - k + 1)))


class DensityModel:
    """Base interface; tile_size is the flattened number of elements."""


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

    def prob_empty(self, tile_size: int) -> float:
        return 0.0

    def max_nnz(self, tile_size: int) -> int:
        return tile_size


@dataclasses.dataclass
class UniformModel(DensityModel):
    """nnz locations uniformly random: tile nnz ~ Hypergeometric(S, N, T)."""

    tensor_size: int
    density: float

    @property
    def nnz(self) -> int:
        return round(self.density * self.tensor_size)

    def prob_empty(self, tile_size: int) -> float:
        S, N, T = self.tensor_size, self.nnz, min(tile_size, self.tensor_size)
        # P(empty) = C(S-N, T) / C(S, T)
        lp = _log_comb(S - N, T) - _log_comb(S, T)
        return real(math.exp(lp)) if lp > -700 else real(0.0)

    def prob_nnz_eq(self, tile_size: int, k: int) -> float:
        S, N, T = self.tensor_size, self.nnz, min(tile_size, self.tensor_size)
        lp = (_log_comb(N, k) + _log_comb(S - N, T - k) - _log_comb(S, T))
        return real(math.exp(lp)) if lp > -700 else real(0.0)

    def max_nnz(self, tile_size: int) -> int:
        return min(tile_size, self.nnz)


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
        return real(math.exp(lp))

    def max_nnz(self, tile_size: int) -> int:
        full, rem = divmod(tile_size, self.m)
        return min(tile_size, full * self.n + min(rem, self.n))


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


@dataclasses.dataclass
class ActualDataModel(DensityModel):
    """Exact empirical statistics from a concrete numpy array.

    This is the paper's "actual data" model: slower but exact, used e.g. for
    the Eyeriss-V2 validation where statistical approximation is the main
    error source (Sec. 6.3.2).
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


#: where a kind that this module does not define is found:
#: ``kinds/<kind>.py`` (see ``kinds/__init__.py``)
KINDS = Path(__file__).resolve().parent / "kinds"
_KIND_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_\-]{0,63}$")
_KIND_MODULES: dict = {}


def named_kind(kind) -> bool:
    """Is ``kind`` a kind found by name, a file ``kinds/<kind>.py``?"""
    return (isinstance(kind, str) and bool(_KIND_NAME.match(kind))
            and kind != "__init__" and (KINDS / f"{kind}.py").is_file())


def _kind_module(path: Path):
    mod = _KIND_MODULES.get(path)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "portbench_kind_" + path.stem.replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _KIND_MODULES[path] = mod
    return mod


class NamedModel(DensityModel):
    """A kind found by name: the model its file returns, which answers
    ``density``, ``prob_empty``, ``expected_density`` and ``max_nnz``;
    the derived statistics are this base's, and every answer is in the
    number type the reference computes in."""

    def __init__(self, model, tensor_size: int):
        self.model = model
        self.tensor_size = tensor_size

    @property
    def density(self) -> float:  # type: ignore[override]
        return real(self.model.density)

    def expected_density(self, tile_size: int) -> float:
        return real(self.model.expected_density(tile_size))

    def prob_empty(self, tile_size: int) -> float:
        return real(self.model.prob_empty(tile_size))

    def max_nnz(self, tile_size: int) -> int:
        return int(self.model.max_nnz(tile_size))


def make_density_model(spec: object, tensor_size: int) -> DensityModel:
    """Build a model from a workload density spec tuple."""
    if spec is None:
        return DenseModel(tensor_size)
    kind, arg = spec  # type: ignore[misc]
    if kind == "dense":
        return DenseModel(tensor_size)
    if kind == "uniform":
        return UniformModel(tensor_size=tensor_size, density=real(arg))
    if kind == "structured":
        return StructuredModel(tensor_size=tensor_size,
                               n=int(arg["n"]), m=int(arg["m"]))
    if kind == "banded":
        return BandedModel(rows=int(arg["rows"]), cols=int(arg["cols"]),
                           half_band=int(arg["half_band"]))
    if kind == "actual":
        return ActualDataModel(data=np.asarray(arg))
    if named_kind(kind):
        return NamedModel(_kind_module(KINDS / f"{kind}.py").model(
            dict(arg or {}), tensor_size), tensor_size)
    raise ValueError(f"unknown density spec {spec!r}")
