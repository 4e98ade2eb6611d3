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
``(bk/m*n) % per``.  Everything the reference takes, the kernels take
on the card, with 1 <= n < m <= :data:`MAX_M`: any M, N, bm, bk and bn;
``bm``, ``bk`` and ``bn`` only decide which shapes are legal: the kernel
picks its own tiles.

Which kernel runs, its K split and its tiles come from :func:`plan`, a
pure function of (M, K, N, n, m, dtype, SM count) that the wrapper
passes to the C interface.  For the (n, m) of :data:`NM_PAIRS`, compiled
into the kernels, and N a multiple of 4 (f32) or 8 (bf16), so that every
row starts 16-byte aligned: the narrow path (f32 at any M, bf16 at M <=
32) on the CUDA cores, 16 bytes of neighbouring columns per thread,
rows past M predicated; the wide path (bf16, M > 32, K % 8 == 0, N %
16 == 0) on the tensor cores.  Every other (n, m) and N: the general
path, a narrow kernel that takes n and m at run time and reads one
element at a time.  All split K into slices of whole ring stages,
reduced in a fixed order inside one thread-block cluster, so that
repeated calls give the same bits.  The three inputs must start 16-byte
aligned, else the wrapper raises.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from pathlib import Path

import torch

from ...sparsity.nm import offsets_bits, unpack_offsets
from ..nvcc import CudaLibrary
from ..splitk import H100_SMS, MAX_SPLIT, SplitPlan, sm_count, split_aim
from .ref import nm_spmm_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ``csrc/nm_spmm.cu``, built at first use (``kernels.nvcc``)
LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "nm_spmm.cu",
    {"nm_spmm": [_P, _P, _P, _P] + [_I] * 10 + [_P],
     "nm_spmm_info": [_I] * 5 + [_P]})
#: the (n, m) patterns compiled into the narrow and wide paths: the JAX
#: package's set; any other 1 <= n < m <= MAX_M runs the general path
NM_PAIRS = ((2, 4), (1, 4), (2, 6), (2, 8), (4, 8))
MAX_M = 16
#: the kernels of ``csrc/nm_spmm.cu``, by the number the C interface
#: takes: the narrow path, the wide one with 64- and 128-row tiles, and
#: the general path
KERNELS = {"narrow": 0, "wide64": 1, "wide128": 2, "general": 3}
#: the narrow path's block: groups of 16 bytes of neighbouring columns,
#: output rows, and compressed rows per ring stage
NARROW_GROUPS, NARROW_ROWS, NARROW_STAGE_ROWS = 64, 8, 8
#: the wide path's output tile columns; its rows are 64, or 128 above
#: M = 64; bf16 at M above NARROW_MAX_M goes wide
WIDE_COLS = 64
NARROW_MAX_M = 32
#: the wide path reads offsets 16 columns at a time: N % 16 == 0 there
COLUMN_GROUP = 16
#: the general path's block: one output column a thread
GENERAL_COLS = 128


@dataclass(frozen=True)
class Plan(SplitPlan):
    """What ``csrc/nm_spmm.cu`` runs for one shape (``splitk.SplitPlan``:
    path, split, tile, grid), with the m-groups of a K-slice
    (``slice_groups``; the last may hold fewer) and of a ring stage."""
    slice_groups: int
    stage_groups: int


def stage_groups(path: str, n: int, m: int) -> int:
    """m-groups per ring stage: narrow stages hold 8 compressed rows,
    wide ones 64 dense k rows (48 at m = 6: whole groups, 16-deep
    products); the general path's slices may end at any group."""
    if path == "narrow":
        return NARROW_STAGE_ROWS // n
    if path == "general":
        return 1
    return (48 if m == 6 else 64) // m


def plan(M: int, K: int, N: int, n: int, m: int, dtype,
         sms: int = H100_SMS) -> Plan:
    """The kernel's path, K split and tiles for (M, K, N) at n:m.

    An (n, m) outside :data:`NM_PAIRS`, or N not a multiple of 16 bytes
    of values (4 in f32, 8 in bf16), takes the general path (CUDA cores,
    8 rows by 128 columns, one element a thread).  Otherwise bf16 with M
    above 32, K % 8 == 0 and N % 16 == 0 takes the wide path (tensor
    cores, tiles of 64 columns by 64 rows, 128 above M = 64); everything
    else, f32 always, the narrow one (CUDA cores, 8 rows by 64 x 16
    bytes of columns).  Rows past M are predicated on every path.  All
    aim at two waves of blocks on ``sms`` SMs (``splitk.split_aim``):
    K/m is cut into a power of two of slices, at most 16, of whole
    stages, which hold whole groups and whole bytes of packed offsets;
    raises for shapes the kernels do not take (n, m outside 1 <= n < m
    <= 16)."""
    if (not 1 <= n < m <= MAX_M or K % m or M <= 0 or K <= 0
            or N <= 0):
        raise ValueError(f"no N:M kernel for ({M}, {K}, {N}) at {n}:{m}: "
                         f"the kernels take 1 <= n < m <= {MAX_M}")
    bf16 = dtype == torch.bfloat16
    vc = 8 if bf16 else 4
    if (n, m) not in NM_PAIRS or N % vc:
        path, tile = "general", (NARROW_ROWS, GENERAL_COLS)
    elif bf16 and M > NARROW_MAX_M and K % 8 == 0 and N % COLUMN_GROUP == 0:
        path, tile = "wide", (64 if M <= 64 else 128, WIDE_COLS)
    else:
        path, tile = "narrow", (NARROW_ROWS, NARROW_GROUPS * vc)
    tiles = math.ceil(M / tile[0]) * math.ceil(N / tile[1])
    groups, sg = K // m, stage_groups(path, n, m)
    split = min(split_aim(tiles, sms), math.ceil(groups / sg))
    gs = math.ceil(math.ceil(groups / split) / sg) * sg
    split = math.ceil(groups / gs)
    return Plan(path=path, split=split, tile=tile,
                grid=(split, math.ceil(M / tile[0]), math.ceil(N / tile[1])),
                slice_groups=gs, stage_groups=sg)


def kernel_info(kernel: str, dtype, n: int, m: int, packed: bool) -> dict:
    """What the library holds for one variant: m-groups per stage,
    registers and local memory (spills, stack) per thread, dynamic shared
    memory per block, resident blocks per SM and threads per block, from
    the CUDA runtime (builds the library); raises where it has none."""
    info = (ctypes.c_int * 6)()
    err = LIBRARY.lib().nm_spmm_info(n, m, int(packed), KERNELS[kernel],
                                     int(dtype == torch.bfloat16), info)
    if err:
        raise RuntimeError(f"nm_spmm_info failed: CUDA error {err}")
    return {"stage_groups": info[0], "registers": info[1],
            "local_bytes": info[2], "smem_bytes": info[3],
            "blocks_per_sm": info[4], "threads": info[5]}


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


def _check_cuda(a, w_vals, w_idx, packed) -> None:
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
    if any(x.data_ptr() % 16 for x in (a, w_vals, w_idx)):
        raise ValueError("a, w_vals and w_idx must start 16-byte aligned: "
                         "the kernel copies 16 bytes at a time")


def nm_spmm(a, w_vals, w_idx, *, n=2, m=4, bm=128, bk=128, bn=128,
            packed=False):
    """N:M structured-sparse matmul (K3): (M, N) f32 = A @ unpack(w_vals,
    w_idx), the weights read compressed and decompressed on chip."""
    M, K, N, bm, bk, bn = _tiles(a, w_vals, w_idx, n, m, bm, bk, bn,
                                 packed)
    if all(x.device.type == "cpu" for x in (a, w_vals, w_idx)):
        return nm_spmm_plain(a, w_vals, w_idx, n=n, m=m, bm=bm, bk=bk,
                             bn=bn, packed=packed)
    _check_cuda(a, w_vals, w_idx, packed)
    p = plan(M, K, N, n, m, a.dtype, sm_count(a.device))
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    err = LIBRARY.lib().nm_spmm(
        a.data_ptr(), w_vals.data_ptr(), w_idx.data_ptr(), out.data_ptr(),
        M, K, N, n, m, int(packed), int(a.dtype == torch.bfloat16),
        KERNELS[p.kernel], p.split, p.slice_groups,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"nm_spmm kernel launch failed: CUDA error "
                           f"{err}")
    nm_spmm.launches += 1
    return out


nm_spmm.launches = 0

__all__ = ["H100_SMS", "LIBRARY", "MAX_M", "MAX_SPLIT", "NM_PAIRS", "Plan",
           "kernel_info", "nm_spmm", "nm_spmm_plain", "nm_spmm_ref", "plan",
           "sm_count"]
