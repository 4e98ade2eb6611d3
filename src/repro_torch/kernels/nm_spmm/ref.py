"""Plain oracle for the N:M structured-sparse matmul."""
from __future__ import annotations

import torch

from ...sparsity.nm import unpack_nm_with


def nm_spmm_ref(a: torch.Tensor, w_vals: torch.Tensor, w_idx: torch.Tensor,
                n: int, m: int) -> torch.Tensor:
    """a: (M, K); w_vals/w_idx: (K//m*n, N) packed N:M weights.
    Returns a @ W_dense in f32."""
    w = unpack_nm_with(w_vals, w_idx, n, m)
    return a.float() @ w.float()
