"""The causal_topk density kind by brute force, in plain PyTorch: seeded
selections of a ``rows x cols`` causal map and their tiles, and the
kind's statistics worked out tile by tile and row by row from
``math.comb`` ratios.  What the program's ``causal_topk`` kind and
``kinds/causal_topk.py`` compute over strips is held to this in the tests.

A selection keeps, in each row ``i``, the ``min(k, n_i)`` largest of
i.i.d. uniform scores over the row's causal support ``{j < cols : i -
window < j <= i}`` (``n_i`` columns): a uniform draw without replacement,
the rows independent.  The grid is the one the causal kinds share
(``causal_mask.py``'s); every answer is a Python number.

Imports nothing of the program, of the JAX package or of JAX.
"""
from __future__ import annotations

import math

import torch


def tile_shape(t: int) -> tuple[int, int]:
    tr = math.isqrt(t)
    while t % tr:
        tr -= 1
    return tr, t // tr


def support(rows: int, cols: int, window: int, device=None) -> torch.Tensor:
    """The ``rows x cols`` causal map, the rows' supports."""
    i = torch.arange(rows, device=device)[:, None]
    j = torch.arange(cols, device=device)[None, :]
    return (j <= i) & (j > i - window)


def masks(rows: int, cols: int, window: int, k: int, count: int,
          seed: int, device=None) -> torch.Tensor:
    """``count`` seeded selections, ``(count, rows, cols)`` booleans."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    held = support(rows, cols, window, device=device)
    scores = torch.rand((count, rows, cols), generator=gen, device=device)
    top = torch.where(held, scores, -1.0).topk(min(k, cols), dim=-1).indices
    keep = torch.zeros((count, rows, cols), dtype=torch.bool, device=device)
    keep.scatter_(-1, top, True)
    return keep & held


def tile_counts(m: torch.Tensor, t: int) -> torch.Tensor:
    """Nonzeros of every aligned tile of ``t`` elements of each mask of
    ``m`` (``(..., rows, cols)``), ``(..., nr, nc)``."""
    rows, cols = m.shape[-2:]
    tr, tc = tile_shape(t)
    nr, nc = max(1, rows // tr), max(1, cols // tc)
    hh, kk = min(tr, rows), min(tc, cols)
    part = m[..., :nr * hh, :nc * kk].to(torch.int64)
    return part.reshape(*m.shape[:-2], nr, hh, nc, kk).sum((-3, -1))


def tiles(rows: int, cols: int, window: int, k: int,
          t: int) -> list[tuple[float, float, int]]:
    """Per aligned tile of ``t`` elements, row-major: the probability
    that it is empty, its expected nonzeros and the most a selection can
    put in it, row by row: a row of ``n`` support columns, ``m`` of them
    in the tile, leaves the tile empty with probability ``C(n - m, k_i) /
    C(n, k_i)``, ``k_i = min(k, n)``, puts ``k_i m / n`` nonzeros in it on
    average and at most ``min(k, m)``."""
    tr, tc = tile_shape(t)
    nr, nc = max(1, rows // tr), max(1, cols // tc)
    hh, kk = min(tr, rows), min(tc, cols)
    out = []
    for a in range(nr):
        for b in range(nc):
            p, nnz, most = 1.0, 0.0, 0
            for i in range(a * tr, a * tr + hh):
                lo, hi = max(0, i - window + 1), min(i, cols - 1)
                n = max(0, hi - lo + 1)
                m = max(0, min(hi, b * tc + kk - 1) - max(lo, b * tc) + 1)
                ki = min(k, n)
                p *= math.comb(n - m, ki) / math.comb(n, ki)
                nnz += ki * m / n if n else 0.0
                most += min(k, m)
            out.append((p, nnz, most))
    return out


def exact(rows: int, cols: int, window: int, k: int,
          t: int) -> tuple[float, float, int]:
    """``(prob_empty, expected_density, max_nnz)`` at tile size ``t``,
    from :func:`tiles`."""
    each = tiles(rows, cols, window, k, t)
    return (sum(p for p, _, _ in each) / len(each),
            sum(n for _, n, _ in each) / (len(each) * t),
            max(m for _, _, m in each))


def indexer_masks(tokens: int, hidden: int, heads: int, head_dim: int,
                  k: int, count: int, seed: int) -> torch.Tensor:
    """``count`` selections of a lightning indexer (DeepSeek-V3.2's DSA)
    with seeded random weights over seeded random hidden states: query i
    scores key j <= i as ``sum_h w_ih ReLU(q_ih . k_j)`` and keeps its
    ``min(k, i + 1)`` best.  Unlike :func:`masks`, a key that scores high
    for one query tends to for the next: the rows are not independent.
    ``(count, tokens, tokens)`` booleans."""
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, dtype=torch.float64) * scale

    x = draw(count, tokens, hidden)
    q = (x @ draw(hidden, heads * head_dim, scale=hidden ** -0.5)).view(
        count, tokens, heads, head_dim)
    key = x @ draw(hidden, head_dim, scale=hidden ** -0.5)
    w = x @ draw(hidden, heads, scale=hidden ** -0.5)
    score = torch.einsum("cih,cihj->cij", w, torch.einsum(
        "cihd,cjd->cihj", q, key).relu())
    held = support(tokens, tokens, tokens)
    top = torch.where(held, score, -math.inf).topk(min(k, tokens),
                                                    dim=-1).indices
    keep = torch.zeros((count, tokens, tokens), dtype=torch.bool)
    keep.scatter_(-1, top, True)
    return keep & held
