"""Block-sparse matmuls: SKIP (K1, ``skip_mm``) and GATE (K2,
``gated_mm``), hand-written in CUDA for Hopper."""
from .ops import (BlockList, block_indices, block_list, block_mm_ref,
                  column_pointers, gated_mm, gated_mm_plain, skip_mm,
                  skip_mm_plain)

__all__ = ["BlockList", "block_indices", "block_list", "block_mm_ref",
           "column_pointers", "gated_mm", "gated_mm_plain", "skip_mm",
           "skip_mm_plain"]
