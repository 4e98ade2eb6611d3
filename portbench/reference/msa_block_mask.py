"""MiniMax-M3's block-sparse attention (MSA) for one KV group, in plain
PyTorch with seeded random weights, in float32 with TF32 off: the map of
keys each query reads, and the attention core over them.

A query ``i`` of the group reads whole blocks of ``block`` keys.  Its
causal blocks are ``0 .. i // block``; the first ``init`` and the last
``local`` of them are always read, and of the others the ``k`` that the
group's indexer scores highest.  The indexer is ``idx_heads`` of the
group's query heads scoring each block's max-pooled keys: ``s[i, b] =
sum_h q_ih . max_{j in b} k_j / sqrt(d)``.  The core is softmax attention
of each of the group's query heads over the keys of its blocks that are
not past the query, computed by gathering those keys, and held in the
tests to dense softmax attention under the same mask.

What the ``causal_block_topk`` kind assumes and this does not: the kind
draws a row's blocks uniformly and the rows independently, while a real
indexer's scores favour the same blocks for neighbouring queries.

Imports nothing of the program, of the JAX package or of JAX.
"""
from __future__ import annotations

import math

import torch


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def group(tokens: int, hidden: int, heads: int, head_dim: int, seed: int,
          device=None) -> dict:
    """Seeded hidden states and one KV group's projections: ``q``
    ``(tokens, heads, head_dim)``, ``k`` and ``v`` ``(tokens,
    head_dim)``, float32."""
    _no_tf32()
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    x = draw(tokens, hidden)
    s = hidden ** -0.5
    return {"q": (x @ draw(hidden, heads * head_dim, scale=s)).view(
                tokens, heads, head_dim),
            "k": x @ draw(hidden, head_dim, scale=s),
            "v": x @ draw(hidden, head_dim, scale=s)}


def block_mask(g: dict, block: int, k: int, init: int, local: int,
               idx_heads: int) -> torch.Tensor:
    """The ``(tokens, tokens)`` boolean map of the keys each query reads."""
    q, key = g["q"], g["k"]
    tokens, _, d = q.shape
    nb = -(-tokens // block)
    pad = torch.full((nb * block - tokens, d), -math.inf, device=key.device)
    pooled = torch.cat([key, pad]).view(nb, block, d).amax(1)
    score = torch.einsum("ihd,bd->ib", q[:, :idx_heads], pooled) / d ** 0.5
    i = torch.arange(tokens, device=key.device)[:, None]
    b = torch.arange(nb, device=key.device)[None, :]
    last = i // block
    causal = b <= last
    forced = causal & ((b < init) | (b > last - local))
    cand = causal & ~forced
    top = torch.where(cand, score, -math.inf).topk(min(k, nb), -1).indices
    chosen = torch.zeros_like(cand)
    chosen.scatter_(-1, top, True)
    blocks = forced | (chosen & cand)
    j = torch.arange(tokens, device=key.device)[None, :]
    return blocks.gather(-1, (j // block).expand(tokens, tokens)) & (j <= i)


def core(g: dict, mask: torch.Tensor) -> torch.Tensor:
    """Each query head's softmax attention over the keys its query reads,
    by gathering them: ``(tokens, heads, head_dim)``."""
    q, key, v = g["q"], g["k"], g["v"]
    d = q.shape[-1]
    width = int(mask.sum(-1).max())
    idx = torch.where(mask, torch.arange(mask.shape[-1], device=mask.device),
                      mask.shape[-1]).sort(-1).values[:, :width]
    held = idx < mask.shape[-1]
    idx = idx.clamp(max=mask.shape[-1] - 1)
    s = torch.einsum("ihd,ijd->ihj", q, key[idx]) / d ** 0.5
    s = torch.where(held[:, None, :], s, -math.inf)
    return torch.einsum("ihj,ijd->ihd", s.softmax(-1), v[idx])


def dense_core(g: dict, mask: torch.Tensor) -> torch.Tensor:
    """The same attention as dense softmax over every key, the keys off
    the map masked out."""
    q, key, v = g["q"], g["k"], g["v"]
    s = torch.einsum("ihd,jd->hij", q, key) / q.shape[-1] ** 0.5
    s = torch.where(mask[None], s, -math.inf)
    return torch.einsum("hij,jd->ihd", s.softmax(-1), v)


def masks(tokens: int, hidden: int, heads: int, head_dim: int, block: int,
          k: int, init: int, local: int, idx_heads: int, count: int,
          seed: int) -> torch.Tensor:
    """``count`` maps from seeds ``seed .. seed + count - 1``,
    ``(count, tokens, tokens)`` booleans."""
    return torch.stack([block_mask(group(tokens, hidden, heads, head_dim,
                                         seed + c), block, k, init, local,
                                   idx_heads) for c in range(count)])
