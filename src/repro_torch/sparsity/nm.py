"""N:M structured sparsity utilities (magnitude pruning + CP packing).

The packed layout matches the paper's STC description (Fig. 14): each
nonzero weight carries an offset-based coordinate-payload (CP) metadata
entry locating it within its block of M values along the contraction
axis.  This is the format the nm_spmm kernel (K3) consumes and the
format model ``RankFormat.CP`` in the analytical engine describes.

Every function gives the JAX package's ``sparsity.nm`` output bit for
bit on the same input: ties are broken by stable sorts, as JAX's sorts
are, and the uint8 sums are cast back to uint8 as the reference does.
"""
from __future__ import annotations

import torch


def nm_prune_dense(w: torch.Tensor, n: int = 2, m: int = 4) -> torch.Tensor:
    """Magnitude-prune W (K, N) to N:M structure along K (axis 0): the n
    largest magnitudes of each block of m rows are kept, ties going to
    the lower row."""
    K, N = w.shape
    if K % m:
        raise ValueError(f"K={K} not divisible by m={m}")
    blocks = w.reshape(K // m, m, N)
    mag = blocks.abs()
    order = torch.argsort(-mag, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    keep = rank < n
    # signed zeros as the reference's compiled program gives them: it
    # turns the f32 product with the 0/1 mask into a select (a pruned
    # entry is +0.0) but multiplies in bf16 (a pruned negative is -0.0)
    if w.dtype == torch.float32:
        return torch.where(keep, blocks, 0.0).reshape(K, N)
    return (blocks * keep).reshape(K, N)


def pack_nm(w: torch.Tensor, n: int = 2, m: int = 4):
    """Pack an N:M-sparse W (K, N) -> (values (K//m*n, N), idx (K//m*n, N)).

    idx entries are the offsets within each M-block (CP metadata,
    ceil(log2(m)) bits of information — stored as int8)."""
    K, N = w.shape
    blocks = w.reshape(K // m, m, N)
    zero = (blocks == 0).to(torch.uint8)
    # order positions: nonzeros first (stable), take first n
    order = torch.argsort(zero, dim=1, stable=True)[:, :n, :]
    vals = torch.gather(blocks, 1, order)
    return (vals.reshape(K // m * n, N),
            order.to(torch.int8).reshape(K // m * n, N))


def unpack_nm(values: torch.Tensor, idx: torch.Tensor, m: int = 4
              ) -> torch.Tensor:
    """Inverse of pack_nm needs n, which the packed arrays do not carry:
    use :func:`unpack_nm_with`."""
    raise NotImplementedError("use unpack_nm_with(n=...)")


def offsets_bits(m: int) -> int:
    """CP metadata width for an offset in [0, m)."""
    return max(1, (m - 1).bit_length())


def _shifts(per: int, bits: int, device) -> torch.Tensor:
    return (torch.arange(per, dtype=torch.uint8, device=device)
            * bits)[None, :, None]


def pack_offsets(idx: torch.Tensor, m: int) -> torch.Tensor:
    """Bit-pack int8 offsets (R, N) into uint8 rows: ``per = 8 //
    offsets_bits(m)`` offsets per byte along the row axis -> (R//per, N);
    row r sits at bit ``(r % per) * bits`` of byte ``r // per``."""
    bits = offsets_bits(m)
    per = 8 // bits
    R, N = idx.shape
    if R % per:
        raise ValueError(f"rows {R} not divisible by {per} offsets/byte")
    g = idx.to(torch.uint8).reshape(R // per, per, N)
    return (g << _shifts(per, bits, idx.device)).sum(dim=1).to(torch.uint8)


def unpack_offsets(packed: torch.Tensor, m: int, rows: int) -> torch.Tensor:
    """Inverse of pack_offsets -> int32 (rows, N)."""
    bits = offsets_bits(m)
    per = 8 // bits
    mask = (1 << bits) - 1
    offs = (packed[:, None, :] >> _shifts(per, bits, packed.device)) & mask
    return offs.reshape(rows, packed.shape[1]).to(torch.int32)


def unpack_nm_with(values: torch.Tensor, idx: torch.Tensor, n: int, m: int
                   ) -> torch.Tensor:
    """Dense (K, N) from packed (K//m*n, N) values and int offsets: each
    m-block's n values scattered to their rows by a one-hot compare."""
    Kn, N = values.shape
    G = Kn // n
    vals = values.reshape(G, n, N)
    offs = idx.reshape(G, n, N).to(torch.int32)
    onehot = (offs[:, :, None, :] ==
              torch.arange(m, dtype=torch.int32,
                           device=idx.device)[None, None, :, None])
    dense = vals[:, :, None, :] * onehot.to(values.dtype)
    # a one-term sum is no sum in the reference (a product's -0.0 stays)
    dense = dense.sum(dim=1) if n > 1 else dense[:, 0]
    return dense.reshape(G * m, N)
