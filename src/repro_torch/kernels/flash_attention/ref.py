"""Plain oracle for causal flash attention."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q/k/v: (BH, S, D) -> (BH, S, D) in f32."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(
        q.shape[-1])
    if causal:
        S = q.shape[1]
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float())
