"""Plain oracle for the block-sparse matmul (gate and skip semantics are
numerically identical — they differ only in cycles/energy)."""
from __future__ import annotations

import torch


def block_mm_ref(a: torch.Tensor, w: torch.Tensor,
                 block_mask: torch.Tensor, bk: int, bn: int
                 ) -> torch.Tensor:
    """a: (M, K); w: (K, N); block_mask: (K//bk, N//bn) 0/1.
    Zero blocks of W are treated as exact zeros; the product is f32."""
    mask = torch.as_tensor(block_mask, device=w.device).to(w.dtype)
    mask = mask.repeat_interleave(bk, 0).repeat_interleave(bn, 1)
    return a.float() @ (w * mask).float()
