"""N:M structured-sparse matmul (K3, ``nm_spmm``), hand-written in CUDA
for Hopper: A @ unpack(values, CP offsets), read compressed."""
from .ops import NM_PAIRS, nm_spmm, nm_spmm_plain
from .ref import nm_spmm_ref

__all__ = ["NM_PAIRS", "nm_spmm", "nm_spmm_plain", "nm_spmm_ref"]
