"""Wrapper of the N:M structured-sparse matmul kernel K3.

``nm_spmm`` launches the CUDA kernel of ``csrc/nm_spmm.cu`` for tensors
on a CUDA device and uses the plain PyTorch version beside it
(``nm_spmm_plain``) only for tensors on the CPU.  For a CUDA tensor it
launches the kernel or raises; it never falls back.  It counts its
launches in ``nm_spmm.launches``.  The kernel is built at first use with
``nvcc`` for ``sm_90a`` (``kernels.nvcc``), launches on PyTorch's current
stream and allocates nothing: the wrapper allocates the output.

Inputs, as the JAX package's ``nm_spmm`` takes them: A (M, K) f32 or
bf16; ``w_vals`` (K/m*n, N) of A's type; ``w_idx`` the CP offsets, int8
(K/m*n, N), or with ``packed=True`` bit-packed uint8 (K/m*n/per, N),
``per = 8 // offsets_bits(m)`` (``sparsity.pack_offsets``).  Returns
(M, N) f32.  Tiles are clamped as the reference clamps them (``bm =
min(bm, M)``, likewise ``bk``, ``bn``), and what the reference asserts
raises: ``K % bk``, ``bk % m``, ``M % bm``, ``N % bn`` and, packed,
``(bk/m*n) % per``.  The kernel takes ``bm`` in {8, 16, 32, 64, 128},
``bn`` in {32, 64, 128} and (n, m) in :data:`NM_PAIRS`; it walks K in
steps of its own, so ``bk`` only decides which shapes are legal.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...sparsity.nm import offsets_bits, unpack_offsets
from ..nvcc import CudaLibrary
from .ref import nm_spmm_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ``csrc/nm_spmm.cu``, built at first use (``kernels.nvcc``)
LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "nm_spmm.cu",
    {"nm_spmm": [_P, _P, _P, _P] + [_I] * 9 + [_P]})
#: the (n, m) patterns the kernel is built for: the JAX package's set
NM_PAIRS = ((2, 4), (1, 4), (2, 6), (2, 8), (4, 8))
_KERNEL_BM = (8, 16, 32, 64, 128)
_KERNEL_BN = (32, 64, 128)


def _tiles(a, w_vals, w_idx, n, m, bm, bk, bn, packed):
    """(M, K, N, bm, bk, bn) after the reference's clamping; raises
    where the reference asserts."""
    if a.dim() != 2 or w_vals.dim() != 2 or w_idx.dim() != 2:
        raise ValueError(f"need a (M, K), w_vals and w_idx 2-d, got "
                         f"{tuple(a.shape)}, {tuple(w_vals.shape)}, "
                         f"{tuple(w_idx.shape)}")
    M, K = a.shape
    Kc, N = w_vals.shape
    if Kc * m != K * n:
        raise ValueError(f"packed rows {Kc} inconsistent with K={K} at "
                         f"{n}:{m}")
    bm, bk, bn = min(bm, M), min(bk, K), min(bn, N)
    if K % bk or bk % m or M % bm or N % bn:
        raise ValueError(f"tiles ({bm}, {bk}, {bn}) do not fit (M, K, N) "
                         f"= ({M}, {K}, {N}) at m={m}: need K % bk, "
                         f"bk % m, M % bm and N % bn all 0")
    rows = Kc
    if packed:
        per = 8 // offsets_bits(m)
        if (bk // m * n) % per:
            raise ValueError(f"{bk // m * n} compressed rows per K tile "
                             f"do not fill bytes of {per} offsets")
        rows = Kc // per
    if tuple(w_idx.shape) != (rows, N):
        raise ValueError(f"w_idx {tuple(w_idx.shape)} != ({rows}, {N})"
                         f"{' (packed)' if packed else ''}")
    return M, K, N, bm, bk, bn


def nm_spmm_plain(a, w_vals, w_idx, *, n=2, m=4, bm=128, bk=128, bn=128,
                  packed=False):
    """Plain PyTorch K3, the reference kernel's arithmetic: per K tile,
    the compressed rows decompressed by a one-hot compare into a dense
    (bk, N) tile, then an f32 product accumulated over the tiles."""
    M, K, N, bm, bk, bn = _tiles(a, w_vals, w_idx, n, m, bm, bk, bn,
                                 packed)
    Kc = w_vals.shape[0]
    idx = (unpack_offsets(w_idx, m, Kc) if packed
           else w_idx.to(torch.int32))
    bkc, g = bk // m * n, bk // m
    pos = torch.arange(m, dtype=torch.int32, device=a.device)
    out = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    for t in range(K // bk):
        vals = w_vals[t * bkc:(t + 1) * bkc].reshape(g, n, N)
        offs = idx[t * bkc:(t + 1) * bkc].reshape(g, n, N)
        onehot = (offs[:, :, None, :] == pos[None, None, :, None])
        dense = (vals[:, :, None, :] * onehot.to(vals.dtype)).sum(dim=1)
        out += a[:, t * bk:(t + 1) * bk].float() @ dense.reshape(
            bk, N).float()
    return out


def _check_cuda(a, w_vals, w_idx, n, m, bm, bn, packed) -> None:
    if not (a.device == w_vals.device == w_idx.device
            and a.device.type == "cuda"):
        raise ValueError(f"a, w_vals and w_idx must lie on one CUDA "
                         f"device, got {a.device}, {w_vals.device} and "
                         f"{w_idx.device}")
    if a.dtype != w_vals.dtype or a.dtype not in (torch.float32,
                                                  torch.bfloat16):
        raise TypeError(f"a and w_vals must both be float32 or bfloat16, "
                        f"got {a.dtype} and {w_vals.dtype}")
    want = torch.uint8 if packed else torch.int8
    if w_idx.dtype != want:
        raise TypeError(f"w_idx must be {want}"
                        f"{' (packed)' if packed else ''}, got "
                        f"{w_idx.dtype}")
    if not (a.is_contiguous() and w_vals.is_contiguous()
            and w_idx.is_contiguous()):
        raise ValueError("a, w_vals and w_idx must be contiguous")
    if (n, m) not in NM_PAIRS or bm not in _KERNEL_BM \
            or bn not in _KERNEL_BN:
        raise ValueError(f"the kernel takes (n, m) in {NM_PAIRS}, bm in "
                         f"{_KERNEL_BM} and bn in {_KERNEL_BN}; got "
                         f"({n}, {m}), bm={bm}, bn={bn}")


def nm_spmm(a, w_vals, w_idx, *, n=2, m=4, bm=128, bk=128, bn=128,
            packed=False):
    """N:M structured-sparse matmul (K3): (M, N) f32 = A @ unpack(w_vals,
    w_idx), the weights read compressed and decompressed on chip."""
    M, K, N, bm, bk, bn = _tiles(a, w_vals, w_idx, n, m, bm, bk, bn,
                                 packed)
    if all(x.device.type == "cpu" for x in (a, w_vals, w_idx)):
        return nm_spmm_plain(a, w_vals, w_idx, n=n, m=m, bm=bm, bk=bk,
                             bn=bn, packed=packed)
    _check_cuda(a, w_vals, w_idx, n, m, bm, bn, packed)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    err = LIBRARY.lib().nm_spmm(
        a.data_ptr(), w_vals.data_ptr(), w_idx.data_ptr(), out.data_ptr(),
        M, K, N, n, m, bm, bn, int(packed), int(a.dtype == torch.bfloat16),
        torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"nm_spmm kernel launch failed: CUDA error "
                           f"{err}")
    nm_spmm.launches += 1
    return out


nm_spmm.launches = 0

__all__ = ["LIBRARY", "NM_PAIRS", "nm_spmm", "nm_spmm_plain",
           "nm_spmm_ref"]
