"""N:M structured sparsity: magnitude pruning and the CP-packed layout
that the nm_spmm kernel (K3) reads."""
from .nm import (nm_prune_dense, offsets_bits, pack_nm, pack_offsets,
                 unpack_nm, unpack_nm_with, unpack_offsets)

__all__ = ["nm_prune_dense", "offsets_bits", "pack_nm", "pack_offsets",
           "unpack_nm", "unpack_nm_with", "unpack_offsets"]
