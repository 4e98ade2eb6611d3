"""Per-rank format models (Sparseloop Sec. 5.3.3 'Format Analyzer').

Given a tile (a fiber sub-tree, Fig. 7b), its per-dim extents, and the
tensor's statistical density model, these models derive the expected and
worst-case metadata footprint of each format rank, e.g.

  Overhead_RLE = #nonempty-elements x run_length_bitwidth
  Overhead_B   = total #elements    x 1 bit

Occupancy math uses linearity of expectation: the expected number of
nonempty sub-blocks of size ``sz`` inside a tile equals
``count x P(nonempty block of size sz)`` under coordinate-independent
models; coordinate-dependent models (banded/actual) supply their own tile
statistics through the same DensityModel interface.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .density import DensityModel
from .precision import real
from .taxonomy import RankFormat, TensorFormat


@dataclasses.dataclass(frozen=True)
class RankOverhead:
    fmt: RankFormat
    metadata_bits_avg: float
    metadata_bits_max: float
    #: expected nonempty coordinates at this rank (payload count)
    occupancy_avg: float
    occupancy_max: float


@dataclasses.dataclass(frozen=True)
class TileFormatStats:
    """Full format stats of one tile at one storage level."""

    ranks: tuple[RankOverhead, ...]
    #: expected / worst-case stored data words (values only)
    data_words_avg: float
    data_words_max: float
    tile_size: int

    @property
    def metadata_bits_avg(self) -> float:
        return sum(r.metadata_bits_avg for r in self.ranks)

    @property
    def metadata_bits_max(self) -> float:
        return sum(r.metadata_bits_max for r in self.ranks)

    def footprint_words(self, word_bits: int, worst: bool = False) -> float:
        """Data + metadata footprint in data words."""
        if worst:
            return self.data_words_max + self.metadata_bits_max / word_bits
        return self.data_words_avg + self.metadata_bits_avg / word_bits

    def compression_rate(self, word_bits: int) -> float:
        """Uncompressed words / compressed words (Eyeriss Table 7 metric)."""
        comp = self.footprint_words(word_bits)
        return self.tile_size / comp if comp > 0 else float("inf")


def _align_dims_to_format(tile_dims: Sequence[int],
                          n_format_ranks: int) -> list[int]:
    """Flatten leading tile dims so the dim count matches the format rank
    count (hierarchical formats may flatten dims, Sec. 3.1.1)."""
    dims = [int(d) for d in tile_dims if d > 0] or [1]
    if len(dims) < n_format_ranks:
        dims = [1] * (n_format_ranks - len(dims)) + dims
    elif len(dims) > n_format_ranks:
        head = math.prod(dims[: len(dims) - n_format_ranks + 1])
        dims = [head] + dims[len(dims) - n_format_ranks + 1:]
    return dims


def analyze_tile_format(fmt: TensorFormat,
                        tile_dims: Sequence[int],
                        model: DensityModel) -> TileFormatStats:
    """Derive per-rank metadata overhead + stored data words for one tile."""
    dims = _align_dims_to_format(tile_dims, len(fmt.rank_formats))
    tile_size = math.prod(dims)

    # sub-block ("payload") size under one coordinate of rank i
    payload_sizes = [math.prod(dims[i + 1:]) for i in range(len(dims))]

    ranks: list[RankOverhead] = []
    fibers_avg, fibers_max = 1.0, 1.0
    for i, (rf, d, sz) in enumerate(zip(fmt.rank_formats, dims, payload_sizes)):
        coords_avg = fibers_avg * d          # coordinates scanned at rank i
        coords_max = fibers_max * d
        p_ne = model.prob_nonempty(max(1, sz)) if sz >= 1 else 0.0
        # expected nonempty coords at this rank across the whole tile
        n_blocks = math.prod(dims[: i + 1])
        occ_avg = min(coords_avg, n_blocks * p_ne)
        occ_max = min(coords_max,
                      math.ceil(model.max_nnz(tile_size) / max(1, sz))
                      if sz >= 1 else coords_max)
        occ_max = max(occ_max, 0)

        cb = fmt.coord_bits
        if rf == RankFormat.U:
            bits_avg = bits_max = 0.0
            occ_avg, occ_max = coords_avg, coords_max  # dense: all coords kept
        elif rf in (RankFormat.B, RankFormat.UB):
            bits_avg = fibers_avg * d * 1.0
            bits_max = fibers_max * d * 1.0
            if rf == RankFormat.UB:
                occ_avg, occ_max = coords_avg, coords_max  # data stays dense
        elif rf == RankFormat.CP:
            bits_avg = occ_avg * cb
            bits_max = occ_max * cb
        elif rf == RankFormat.RLE:
            bits_avg = occ_avg * cb
            bits_max = occ_max * cb
        elif rf == RankFormat.UOP:
            bits_avg = fibers_avg * 2.0 * cb
            bits_max = fibers_max * 2.0 * cb
        else:  # pragma: no cover
            raise ValueError(rf)

        ranks.append(RankOverhead(fmt=rf, metadata_bits_avg=bits_avg,
                                  metadata_bits_max=bits_max,
                                  occupancy_avg=occ_avg,
                                  occupancy_max=occ_max))
        fibers_avg, fibers_max = occ_avg, occ_max

    if fmt.is_uncompressed:
        data_avg = data_max = real(tile_size)
    else:
        data_avg = min(real(tile_size),
                       model.expected_nnz(tile_size))
        data_max = real(min(tile_size, model.max_nnz(tile_size)))
    return TileFormatStats(ranks=tuple(ranks), data_words_avg=data_avg,
                           data_words_max=data_max, tile_size=tile_size)
