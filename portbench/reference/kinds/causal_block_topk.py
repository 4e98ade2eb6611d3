"""A top-k selection of whole key blocks inside the causal attention map
as a density kind: the attention map of a block-sparse attention
(MiniMax-M3's MSA, whose indexer scores max-pooled blocks of 128 keys and
keeps a query's top 16, its first block and its own).  Row ``i`` of a
``rows x cols`` tensor has the causal columns ``[0, hi_i]``, ``hi_i =
min(i, cols - 1)``, in blocks of ``block`` columns, ``0 .. nb_i - 1``,
``nb_i = hi_i // block + 1``.  Its first ``init`` and last ``local``
blocks are nonzero (forced); of the ``n_i`` others (candidates) exactly
``k_i = min(k, n_i)`` are, drawn uniformly without replacement, the rows
independent.

Keys: ``block`` and ``k``, whole numbers >= 1, and ``init`` and
``local``, whole numbers >= 0 (``rows`` and ``cols`` come from the
tensor's shape in the layer).  Tiles are the causal kinds': a tile of
``t`` elements is ``tr x tc``, ``tr`` the largest divisor of ``t`` at
most ``sqrt(t)``, ``tc = t // tr``, on the aligned grid of ``nr = max(1,
rows // tr)`` by ``nc = max(1, cols // tc)`` tiles, each holding ``hh x
kk = min(tr, rows) x min(tc, cols)`` of the tensor.  With ``c_i``,
``f_i`` and ``m_i`` row ``i``'s causal columns, forced columns and
candidate blocks met in a tile, and ``mu = min(block, kk)``:

* ``prob_empty``: the mean over the tiles of ``prod_i [f_i = 0] C(n_i -
  m_i, k_i) / C(n_i, k_i)``;
* ``expected_density``: ``sum_i f_i + k_i g_i / n_i`` over ``nr nc t``,
  ``f_i`` and ``g_i`` the forced and candidate columns inside the grid's
  columns;
* ``max_nnz``: a bound, ``max`` over the tiles of ``sum_i min(c_i, f_i +
  min(k, m_i) mu)``, where the tiles that meet a forced block are bounded
  together by each row's ``min(min(kk, hi_i + 1), min(kk, F_i) + k mu)``,
  ``F_i`` all its forced columns.

The work is over the rows and the row-strips at once, in NumPy, with no
loop over tiles or elements.  A strip's tiles past its last row's
diagonal are empty for sure; those that start in the init blocks or reach
the first row's local blocks are nonempty for sure; those from the init
blocks to the first row's last candidate block and last causal column
(interior) meet the same candidate blocks in all their columns in every
row, ``m_lo`` or ``m_lo + 1`` of them; and the rest, with ``local`` 0,
are two at most.  ``log C(x, k)`` is the sum of ``-log1p(-k / y)`` over
``y = k + 1 .. x``.  Answers are memoised per tile size.  Imports
``math`` and NumPy only.
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
def blocks(rows, cols, block, k, init, local):
    """Per row ``(hi, lq, lq_col, n, kept, log_inv)``: the last causal
    column, the first local block past the init ones and its first
    column (past ``hi`` where there is none), the candidate blocks,
    ``kept = min(k, n)``, and ``log_inv[x] = -log C(x, k)`` (0 for ``x
    <= k``)."""
    hi = np.minimum(np.arange(rows), cols - 1)
    nb = hi // block + 1
    lq = np.maximum(nb - local, init)
    n = np.maximum(nb - local - init, 0)
    x = np.arange(int(n.max()) + 1, dtype=np.float64)
    step = np.where(x > k, -k / np.maximum(x, 1.0), 0.0)
    return (hi, lq, np.minimum(lq, nb) * block, n, np.minimum(n, k),
            np.cumsum(np.log1p(step)))


def columns(h1, lq_col, init_col):
    """The forced and the candidate columns among each row's first
    ``h1``."""
    return (np.minimum(init_col, h1) + np.maximum(h1 - lq_col, 0),
            np.maximum(np.minimum(h1, lq_col) - init_col, 0))


@functools.lru_cache(maxsize=4096)
def tile_stats(rows, cols, block, k, init, local, t):
    """``(prob_empty, expected_density, max_nnz)`` at tile size ``t``."""
    hi, lq, lq_col, n, kept, log_inv = blocks(rows, cols, block, k, init,
                                              local)
    init_col = init * block
    t, tr, tc, nr, nc, hh, kk = grid(rows, cols, t)
    g = nr * hh
    forced, cand = columns(np.minimum(hi[:g] + 1, min(nc * tc, cols)),
                           lq_col[:g], init_col)
    nnz = forced.sum() + np.sum(np.where(
        n[:g] > 0, kept[:g] * cand / np.maximum(n[:g], 1), 0.0))
    hi, lq, lq_col, n, kept = (v[:g].reshape(nr, hh)
                               for v in (hi, lq, lq_col, n, kept))
    top = np.arange(nr)[:, None] * tr
    top_hi = np.minimum(top, cols - 1)
    # the strip's nonempty tiles are the columns [0, last]; its interior
    # ones [inner_lo, inner_hi]; its partial ones two from first_part
    last = np.minimum((top + hh - 1) // tc, nc - 1)
    inner_lo = -(-init_col // tc)
    inner_hi = np.minimum(np.minimum(
        (np.maximum(top_hi // block + 1 - local, 0) * block - kk) // tc,
        (top_hi - kk + 1) // tc), nc - 1)
    inner = np.maximum(inner_hi - inner_lo + 1, 0)
    fewest, widest = (kk - 1) // block + 1, min(block, kk)
    starts = np.arange(nc) * tc
    more = np.concatenate([[0], np.cumsum(
        (starts + kk - 1) // block - starts // block + 1 - fewest)])
    inner_more = np.where(inner > 0, more[np.clip(inner_hi + 1, 0, nc)]
                          - more[np.clip(inner_lo, 0, nc)], 0)

    def log_p_miss(m, sure=False):
        """log P(every row of the strip misses its m blocks)."""
        sure = sure | (m > n - kept)
        return np.where(sure, -np.inf,
                        log_inv[n] - log_inv[np.maximum(n - m, 0)]).sum(
                            1, keepdims=True)

    p_empty = np.where(inner > 0, (inner - inner_more)
                       * np.exp(log_p_miss(fewest)) + inner_more
                       * np.exp(log_p_miss(fewest + 1)), 0.0)
    most = np.where(inner > 0, hh * np.minimum(
        kk, np.minimum(k, fewest + (inner_more > 0)) * widest), 0)
    first_part = np.maximum(inner_hi, inner_lo - 1) + 1
    for b in (first_part, first_part + 1):
        ok, c0 = b <= last, b * tc
        e = np.minimum(c0 + kk - 1, hi)
        causal = c0 <= hi
        c = np.where(causal, e - c0 + 1, 0)
        f = np.where(causal, np.maximum(np.minimum(e, init_col - 1) - c0 + 1,
                                        0)
                     + np.maximum(e - np.maximum(c0, lq_col) + 1, 0), 0)
        m = np.where(causal, np.maximum(np.minimum(e // block, lq - 1)
                                        - np.maximum(c0 // block, init) + 1,
                                        0), 0)
        p_empty = p_empty + np.where(ok, np.exp(log_p_miss(m, f > 0)), 0.0)
        most = np.maximum(most, np.where(ok, np.minimum(
            c, f + np.minimum(m, k) * widest).sum(1, keepdims=True), 0))
    held, _ = columns(hi + 1, lq_col, init_col)
    bound = np.minimum(np.minimum(kk, hi + 1),
                       np.minimum(kk, held) + k * widest).sum(1, keepdims=True)
    most = np.maximum(most, np.where(
        (inner_lo > 0) | (last > first_part + 1), bound, 0))
    nonempty = int((last + 1).sum())
    return ((nr * nc - nonempty + float(p_empty.sum())) / (nr * nc),
            float(nnz) / (nr * nc * t), min(t, int(most.max())))


class CausalBlockTopk:
    def __init__(self, rows, cols, block, k, init, local):
        self.key = (rows, cols, block, k, init, local)
        self.tensor_size = rows * cols
        hi, _, lq_col, n, kept, _ = blocks(*self.key)
        forced, cand = columns(hi + 1, lq_col, init * block)
        self.density = float(forced.sum() + np.sum(np.where(
            n > 0, kept * cand / np.maximum(n, 1), 0.0))) / self.tensor_size

    def prob_empty(self, tile_size):
        return tile_stats(*self.key, int(tile_size))[0]

    def expected_density(self, tile_size):
        return tile_stats(*self.key, int(tile_size))[1]

    def max_nnz(self, tile_size):
        return tile_stats(*self.key, int(tile_size))[2]


def _whole(x):
    return isinstance(x, int) and not isinstance(x, bool)


#: each key's least value
KEYS = {"block": 1, "k": 1, "init": 0, "local": 0}


def model(params, tensor_size):
    for key, least in KEYS.items():
        if key not in params:
            raise ValueError(f"causal_block_topk takes a {key}")
        if not (_whole(params[key]) and params[key] >= least):
            raise ValueError(f"causal_block_topk {key} {params[key]!r} is "
                             f"not a whole number >= {least}")
    rows, cols = params["rows"], params["cols"]
    if rows * cols != tensor_size:
        raise ValueError(f"causal_block_topk {rows} x {cols} is not "
                         f"{tensor_size} elements")
    extra = set(params) - set(KEYS) - {"rows", "cols"}
    if extra:
        raise ValueError(f"causal_block_topk takes {list(KEYS)}; unknown "
                         f"{sorted(extra)}")
    return CausalBlockTopk(rows, cols, *(params[key] for key in KEYS))
