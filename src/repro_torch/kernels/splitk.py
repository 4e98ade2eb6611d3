"""The split-K policy that the plans of K1/K2 (``block_mm.ops``) and K3
(``nm_spmm.ops``) share, and the fields of their plans.

A kernel's plan cuts the K range of each output tile into ``split``
slices, the blocks of one thread-block cluster, whose partial tiles the
cluster sums in rank order.  :func:`split_aim` is the first power of two
of slices that puts :data:`WAVES` waves of blocks on the card's SMs, at
most :data:`MAX_SPLIT`; each plan then cuts it to what its K range holds.
The sources (``csrc/*.cu``) each check ``split <= 16`` themselves: 16 is
the largest cluster the hardware runs (non-portable, opted into), not a
choice of this policy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

#: SMs of an H100 SXM, the plans' default
H100_SMS = 132
#: K-slices of one output tile at most: one cluster (16 blocks, past
#: the portable 8)
MAX_SPLIT = 16
#: blocks a plan wants in the grid, in waves of one block per SM
WAVES = 2


def sm_count(device) -> int:
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_aim(tiles: int, sms: int = H100_SMS) -> int:
    """The K-slices aimed at for ``tiles`` output tiles on ``sms`` SMs:
    the first power of two that gives :data:`WAVES` waves of blocks, at
    most :data:`MAX_SPLIT`."""
    return min(MAX_SPLIT, 1 << (math.ceil(WAVES * sms / tiles) - 1)
               .bit_length())


@dataclass(frozen=True)
class SplitPlan:
    """What a split-K kernel runs for one shape: the path (``narrow`` on
    the CUDA cores or ``wide`` on the tensor cores), the K-slices of one
    output tile (``split``, one cluster), the output tile of a block and
    the grid (split, row tiles, column tiles)."""
    path: str
    split: int
    tile: tuple
    grid: tuple

    @property
    def kernel(self) -> str:
        """The library's kernel: ``narrow``, or ``wide`` and its tile
        rows (``wide128``)."""
        return "narrow" if self.path == "narrow" else f"wide{self.tile[0]}"

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)

    def waves(self, sms: int = H100_SMS) -> float:
        return self.blocks / sms


__all__ = ["H100_SMS", "MAX_SPLIT", "WAVES", "SplitPlan", "sm_count",
           "split_aim"]
