"""The causal density kind by brute force, in plain PyTorch: the mask of
a ``rows x cols`` causal map, element (i, j) nonzero iff ``i - window < j
<= i``, and a tile size's statistics from the aligned grid of tiles,
reshaped and summed.  What the program's ``causal`` kind and
``kinds/causal.py`` compute in closed form is held to this in the tests.

The grid is the one the kinds share: a tile of ``t`` elements is ``tr x
tc``, ``tr`` the largest divisor of ``t`` at most ``sqrt(t)``, ``tc = t //
tr``; ``nr = max(1, rows // tr)`` by ``nc = max(1, cols // tc)`` tiles from
the origin, rows and columns past them left out, and a tile larger than
the tensor holding the tensor's part of it (zeros past its end).  Every
answer is a Python number, from exact integer counts.

Imports nothing of the program, of the JAX package or of JAX.
"""
from __future__ import annotations

import math

import torch


def mask(rows: int, cols: int, window: int, device=None) -> torch.Tensor:
    """The ``rows x cols`` boolean causal map."""
    i = torch.arange(rows, device=device)[:, None]
    j = torch.arange(cols, device=device)[None, :]
    return (j <= i) & (j > i - window)


def tile_shape(t: int) -> tuple[int, int]:
    tr = math.isqrt(t)
    while t % tr:
        tr -= 1
    return tr, t // tr


def tile_counts(m: torch.Tensor, t: int) -> torch.Tensor:
    """Nonzeros of every aligned tile of ``t`` elements, ``(nr, nc)``."""
    if m.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    rows, cols = m.shape
    tr, tc = tile_shape(t)
    nr, nc = max(1, rows // tr), max(1, cols // tc)
    hh, kk = min(tr, rows), min(tc, cols)
    return m[:nr * hh, :nc * kk].reshape(nr, hh, nc, kk).sum((1, 3))


def density(m: torch.Tensor) -> float:
    return int(m.sum()) / m.numel()


def stats(m: torch.Tensor, t: int) -> tuple[float, float, int]:
    """``(prob_empty, expected_density, max_nnz)`` at tile size ``t``."""
    counts = tile_counts(m, t)
    n = counts.numel()
    return (int((counts == 0).sum()) / n, int(counts.sum()) / (n * t),
            int(counts.max()))
