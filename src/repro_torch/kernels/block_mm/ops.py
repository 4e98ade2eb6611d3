"""Wrappers of the block-sparse matmul kernels K1 (SKIP) and K2 (GATE).

``skip_mm`` and ``gated_mm`` launch the CUDA kernels of
``csrc/block_mm.cu`` for tensors on a CUDA device and use the plain
PyTorch versions beside them (``skip_mm_plain`` / ``gated_mm_plain``)
only for tensors on the CPU.  For a CUDA tensor a wrapper launches its
kernel or raises; it never falls back.  Each wrapper counts its launches
in ``<wrapper>.launches``.

The kernels are built at first use with ``nvcc`` for ``sm_90a`` from the
source in this package, into ``build/repro_torch/`` at the root of the
checkout, and bound through a plain C interface with ``ctypes``
(``kernels.nvcc``).  They launch on PyTorch's current stream and
allocate nothing: the wrapper allocates the output with ``torch.empty``.

Both wrappers take A (M, K) and W (K, N) as f32 or bf16 (the same type,
contiguous, on one device) and return (M, N) f32.  Block sizes follow
the JAX package's wrappers (``bm = min(bm, M)``, likewise ``bk``,
``bn``), but a shape the tiles do not divide raises instead of silently
dropping the remainder.  The kernels take ``bm`` in {8, 16, 32, 64,
128}, ``bk`` a multiple of 32 and ``bn`` in {32, 64, 128}; ``bm`` only
decides which shapes are legal, and ``bk`` x ``bn`` is the granularity
of the block list and the mask.

Which kernel runs, its tiles and its K split come from :func:`plan`, a
pure function of the shape, the type, the SM count and, for K1, the
longest column run of the block list (``BlockList.max_run``, found once
by :func:`block_list`): the narrow path (f32 at any M, bf16 at M <= 32)
on the CUDA cores, 8 rows a block; the wide path (bf16 at M > 32) on the
tensor cores, 128 rows a block.  Both cut each column's k blocks into
slices reduced in a fixed order inside one thread-block cluster, so that
repeated calls give the same bits.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from pathlib import Path

import numpy as np
import torch

from ..nvcc import BUILD_DIR, CudaLibrary
from ..splitk import H100_SMS, MAX_SPLIT, SplitPlan, sm_count, split_aim
from .ref import block_mm_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ``csrc/block_mm.cu``, built at first use (``kernels.nvcc``)
LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "block_mm.cu",
    {"block_mm_skip": [_P, _P, _P, _P, _P] + [_I] * 10 + [_P],
     "block_mm_gated": [_P, _P, _P, _P] + [_I] * 10 + [_P],
     "block_mm_info": [_I] * 4 + [_P]})
_KERNEL_BM = (8, 16, 32, 64, 128)
_KERNEL_BN = (32, 64, 128)
#: the kernels of ``csrc/block_mm.cu``, by the number the C interface
#: takes: the narrow path, and the wide one with 128-row tiles
KERNELS = {"narrow": 0, "wide128": 1}
#: k rows per ring stage: every legal bk is a multiple
STAGE_ROWS = 32
#: output rows per block of the narrow and the wide path; bf16 above
#: NARROW_MAX_M rows goes wide
NARROW_ROWS, WIDE_ROWS = 8, 128
NARROW_MAX_M = 32


@dataclasses.dataclass(frozen=True)
class Plan(SplitPlan):
    """What ``csrc/block_mm.cu`` runs for one shape (``splitk.SplitPlan``:
    path, split, tile, grid), with the most k blocks any K-slice holds
    (``slice_blocks``, the kernel's ``cap``)."""
    slice_blocks: int


@functools.lru_cache(maxsize=256)
def plan(M: int, K: int, N: int, bm: int, bk: int, bn: int, dtype,
         sms: int = H100_SMS, run: int | None = None) -> Plan:
    """The kernels' path, tiles and K split for (M, K, N) in blocks of
    (bm, bk, bn); raises where the kernels cannot go (``bm``, ``bk``,
    ``bn`` as the wrappers clamp them).

    bf16 with M above 32 takes the wide path (tensor cores, tiles of 128
    rows; rows past M are read as zeros and not written); everything
    else, f32 always, the narrow one (CUDA cores, 8 rows).  Tiles are 64
    columns, 32 when bn is 32: a tile never spans two column blocks.
    ``run`` is the longest column run of K1's block list
    (``BlockList.max_run``; a list may repeat a block); K2 walks all K/bk
    blocks of every column.  K is cut into the power of two of slices
    that ``splitk.split_aim`` aims at (2 waves of blocks on ``sms`` SMs,
    at most 16), rounded down to a power of two no larger than the run.
    The policy is K3's, taken over unchanged: ``study.py`` times K1 and
    K2 under every split at the chip cells, and its pick is not always
    the fastest there (PERF.md).  Memoized: a launch repeats no host
    work."""
    if (bm not in _KERNEL_BM or bk <= 0 or bk % STAGE_ROWS
            or bn not in _KERNEL_BN or M <= 0 or K <= 0 or N <= 0
            or M % bm or K % bk or N % bn):
        raise ValueError(f"the kernel takes bm in {_KERNEL_BM}, bk a "
                         f"multiple of {STAGE_ROWS} and bn in {_KERNEL_BN} "
                         f"dividing (M, K, N); got ({bm}, {bk}, {bn}) for "
                         f"({M}, {K}, {N})")
    run = K // bk if run is None else run
    if run < 1:
        raise ValueError(f"a column run of {run} k blocks")
    wide = dtype == torch.bfloat16 and M > NARROW_MAX_M
    path, rows = ("wide", WIDE_ROWS) if wide else ("narrow", NARROW_ROWS)
    tile = (rows, 64 if bn % 64 == 0 else 32)
    split = min(split_aim(math.ceil(M / rows) * (N // tile[1]), sms), run)
    split = 1 << (split.bit_length() - 1)
    return Plan(path=path, split=split, tile=tile,
                grid=(split, math.ceil(M / rows), N // tile[1]),
                slice_blocks=math.ceil(run / split))


def kernel_info(kernel: str, tn: int, dtype, gate: bool) -> dict:
    """What the library holds for one variant: k rows per ring stage,
    registers and local memory (spills, stack) per thread, dynamic shared
    memory per block (the ring), resident blocks per SM and threads per
    block, from the CUDA runtime (builds the library); raises where it
    has none."""
    info = (ctypes.c_int * 6)()
    err = LIBRARY.lib().block_mm_info(KERNELS[kernel], tn,
                                      int(dtype == torch.bfloat16),
                                      int(gate), info)
    if err:
        raise RuntimeError(f"block_mm_info failed: CUDA error {err}")
    return {"stage_rows": info[0], "registers": info[1],
            "local_bytes": info[2], "smem_bytes": info[3],
            "blocks_per_sm": info[4], "threads": info[5]}


# ----------------------------------------------------------------------
# block lists
# ----------------------------------------------------------------------
def block_indices(block_mask) -> tuple[np.ndarray, np.ndarray]:
    """Nonzero (k, j) block coordinates sorted by j, with every column
    block guaranteed present (empty columns get a dummy (0, j) entry whose
    W block is zero by definition of the mask — caller must zero W there,
    as block_mm_ref does)."""
    mask = np.asarray(block_mask) != 0
    ks, js = np.nonzero(mask)
    missing = [j for j in range(mask.shape[1]) if not mask[:, j].any()]
    if missing:
        ks = np.concatenate([ks, np.zeros(len(missing), ks.dtype)])
        js = np.concatenate([js, np.asarray(missing, js.dtype)])
    order = np.argsort(js, kind="stable")
    return ks[order].astype(np.int32), js[order].astype(np.int32)


def _host_ints(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64).reshape(-1)


def column_pointers(kidx, jidx, nbk: int, nbn: int) -> np.ndarray:
    """int32 ``colptr`` (nbn + 1,): column block j's run of the block
    list is ``colptr[j] .. colptr[j + 1]``.  Raises unless ``jidx`` is
    sorted, every column is present and every index is in range — what
    :func:`block_indices` guarantees and K1 relies on."""
    ks, js = _host_ints(kidx), _host_ints(jidx)
    if ks.shape != js.shape:
        raise ValueError(f"kidx {ks.shape} and jidx {js.shape} differ")
    if len(js) and (js.min() < 0 or js.max() >= nbn or ks.min() < 0
                    or ks.max() >= nbk):
        raise ValueError(f"block indices out of range ({nbk} k blocks, "
                         f"{nbn} column blocks)")
    if np.any(np.diff(js) < 0):
        raise ValueError("jidx must be sorted by column block "
                         "(block_indices sorts it)")
    counts = np.bincount(js, minlength=nbn)
    if np.any(counts == 0):
        raise ValueError("every column block must appear in the block "
                         "list (block_indices adds a dummy (0, j) entry)")
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class BlockList:
    """A SKIP block list checked once and copied to its device once: the
    host ``kidx`` / ``jidx`` (int32) of a ``shape`` = (K/bk, N/bn) block
    grid, its longest column run ``max_run`` (the input of K1's
    :func:`plan`) and, for a CUDA device, ``index``: ``kidx`` followed by
    the column pointers, as K1 reads them.  Preparing it per call costs
    host time on the order of the kernel's own (validation, column
    pointers, the copy), so callers that launch K1 repeatedly on one
    list build it once with :func:`block_list`."""

    kidx: np.ndarray
    jidx: np.ndarray
    shape: tuple[int, int]
    max_run: int
    index: torch.Tensor | None = None


def block_list(kidx, jidx, shape, device) -> BlockList:
    """Check ``(kidx, jidx)`` against the (K/bk, N/bn) block grid
    ``shape`` (:func:`column_pointers`), find its longest column run and
    copy it to ``device``."""
    ks, js = _host_ints(kidx), _host_ints(jidx)
    colptr = column_pointers(ks, js, *shape)
    device = torch.device(device)
    index = (None if device.type == "cpu" else
             _to_device(np.concatenate([ks, colptr]), device))
    return BlockList(ks.astype(np.int32), js.astype(np.int32),
                     tuple(shape), int(np.diff(colptr).max()), index)


# ----------------------------------------------------------------------
# shapes and device
# ----------------------------------------------------------------------
def _tiles(a, w, bm, bk, bn) -> tuple[int, int, int, int, int, int]:
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"need a (M, K) and w (K, N), got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    M, K = a.shape
    N = w.shape[1]
    bm, bk, bn = min(bm, M), min(bk, K), min(bn, N)
    if M % bm or K % bk or N % bn:
        raise ValueError(f"tiles ({bm}, {bk}, {bn}) do not divide "
                         f"(M, K, N) = ({M}, {K}, {N})")
    return M, K, N, bm, bk, bn


def _check_cuda(a, w, bm, bk, bn) -> None:
    if a.device != w.device or a.device.type != "cuda":
        raise ValueError(f"a and w must lie on one CUDA device, got "
                         f"{a.device} and {w.device}")
    if a.dtype != w.dtype or a.dtype not in (torch.float32,
                                             torch.bfloat16):
        raise TypeError(f"a and w must both be float32 or bfloat16, got "
                        f"{a.dtype} and {w.dtype}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("a and w must be contiguous")
    if bm not in _KERNEL_BM or bk % 32 or bn not in _KERNEL_BN:
        raise ValueError(f"the kernel takes bm in {_KERNEL_BM}, bk a "
                         f"multiple of 32 and bn in {_KERNEL_BN}; got "
                         f"({bm}, {bk}, {bn})")


def _to_device(host: np.ndarray, device) -> torch.Tensor:
    """Copy small int32 index data to the card without a host-side wait
    (pinned staging, asynchronous on the current stream)."""
    t = torch.from_numpy(np.ascontiguousarray(host, np.int32))
    return t.pin_memory().to(device, non_blocking=True)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, copied to fresh storage if it does not start 16-byte
    aligned (a view at an odd offset): the kernels copy 16 bytes at a
    time."""
    return x.clone() if x.data_ptr() % 16 else x


def _on_cpu(a, w) -> bool:
    return a.device.type == "cpu" and w.device.type == "cpu"


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ----------------------------------------------------------------------
# K1 SKIP
# ----------------------------------------------------------------------
def skip_mm_plain(a, w_masked, kidx, jidx, *, bm=128, bk=128, bn=128):
    """Plain PyTorch K1: gather the listed (k, j) blocks, one batched
    product per block, ``index_add_`` into the output column blocks."""
    M, K, N, bm, bk, bn = _tiles(a, w_masked, bm, bk, bn)
    nbk, nbn = K // bk, N // bn
    ki = torch.as_tensor(_host_ints(kidx), device=a.device)
    ji = torch.as_tensor(_host_ints(jidx), device=a.device)
    a_blk = a.float().reshape(M, nbk, bk).index_select(1, ki)
    w_blk = w_masked.float().reshape(nbk, bk, nbn, bn).permute(
        0, 2, 1, 3)[ki, ji]
    prod = torch.einsum("mbk,bkn->bmn", a_blk, w_blk)
    out = torch.zeros(nbn, M, bn, dtype=torch.float32, device=a.device)
    out.index_add_(0, ji, prod)
    return out.permute(1, 0, 2).reshape(M, N)


def skip_mm(a, w_masked, kidx, jidx=None, *, bm=128, bk=128, bn=128):
    """SKIP block-sparse matmul (K1): (M, N) f32 = A @ W summed over the
    listed blocks only.  The block list is either host data ``kidx``,
    ``jidx`` (numpy or CPU tensors, sorted by j with every column
    present, as :func:`block_indices` gives it; checked and copied on
    every call) or a :class:`BlockList` passed as ``kidx`` (checked and
    copied once).  ``w_masked`` must already have its empty blocks
    zeroed, so dummy entries contribute nothing."""
    blocks = kidx if isinstance(kidx, BlockList) else None
    if blocks is not None and jidx is not None:
        raise TypeError("pass a BlockList alone, without jidx")
    if _on_cpu(a, w_masked):
        if blocks is not None:
            kidx, jidx = blocks.kidx, blocks.jidx
        return skip_mm_plain(a, w_masked, kidx, jidx, bm=bm, bk=bk, bn=bn)
    M, K, N, bm, bk, bn = _tiles(a, w_masked, bm, bk, bn)
    _check_cuda(a, w_masked, bm, bk, bn)
    if blocks is None:
        blocks = block_list(kidx, jidx, (K // bk, N // bn), a.device)
    elif (blocks.shape != (K // bk, N // bn) or blocks.index is None
          or blocks.index.device != a.device):
        raise ValueError(f"the block list of a {blocks.shape} grid does "
                         f"not fit ({K // bk}, {N // bn}) on {a.device}")
    idx = blocks.index
    p = plan(M, K, N, bm, bk, bn, a.dtype, sm_count(a.device),
             blocks.max_run)
    a, w_masked = _aligned(a), _aligned(w_masked)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    err = LIBRARY.lib().block_mm_skip(
        a.data_ptr(), w_masked.data_ptr(), idx.data_ptr(),
        idx.data_ptr() + 4 * len(blocks.kidx), out.data_ptr(), M, K, N, bk,
        bn, int(a.dtype == torch.bfloat16), KERNELS[p.kernel], p.tile[1],
        p.split, p.slice_blocks, _stream(a.device))
    if err:
        raise RuntimeError(f"skip_mm kernel launch failed: CUDA error {err}")
    skip_mm.launches += 1
    return out


skip_mm.launches = 0


# ----------------------------------------------------------------------
# K2 GATE
# ----------------------------------------------------------------------
def _mask_tensor(block_mask, device) -> torch.Tensor:
    if isinstance(block_mask, torch.Tensor):
        return block_mask.to(device)
    return torch.as_tensor(np.asarray(block_mask), device=device)


def gated_mm_plain(a, w, block_mask, *, bm=128, bk=128, bn=128):
    """Plain PyTorch K2: W's blocks scaled by the mask, one product."""
    M, K, N, bm, bk, bn = _tiles(a, w, bm, bk, bn)
    nbk, nbn = K // bk, N // bn
    mask = _mask_tensor(block_mask, a.device) != 0
    if tuple(mask.shape) != (nbk, nbn):
        raise ValueError(f"block_mask {tuple(mask.shape)} != ({nbk}, {nbn})")
    w_blk = w.float().reshape(nbk, bk, nbn, bn) * mask[:, None, :, None]
    return a.float() @ w_blk.reshape(K, N)


def gated_mm(a, w, block_mask, *, bm=128, bk=128, bn=128):
    """GATE block-sparse matmul (K2): (M, N) f32 = A @ W over the blocks
    ``block_mask`` (K/bk, N/bn) keeps; the kernel walks every block and
    predicates the arithmetic, so it saves energy, not time."""
    if _on_cpu(a, w):
        return gated_mm_plain(a, w, block_mask, bm=bm, bk=bk, bn=bn)
    M, K, N, bm, bk, bn = _tiles(a, w, bm, bk, bn)
    _check_cuda(a, w, bm, bk, bn)
    if isinstance(block_mask, torch.Tensor) and block_mask.is_cuda:
        # the kernel reads int32 and tests != 0 itself: a contiguous int32
        # mask goes in as it is, with no conversion launched per call
        mask = block_mask if (block_mask.dtype == torch.int32
                              and block_mask.is_contiguous()) else \
            (block_mask != 0).to(torch.int32).contiguous()
    else:
        mask = _to_device((np.asarray(block_mask) != 0).astype(np.int32),
                          a.device)
    if tuple(mask.shape) != (K // bk, N // bn) or mask.device != a.device:
        raise ValueError(f"block_mask {tuple(mask.shape)} on "
                         f"{mask.device} != ({K // bk}, {N // bn}) on "
                         f"{a.device}")
    p = plan(M, K, N, bm, bk, bn, a.dtype, sm_count(a.device))
    a, w = _aligned(a), _aligned(w)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    err = LIBRARY.lib().block_mm_gated(
        a.data_ptr(), w.data_ptr(), mask.data_ptr(), out.data_ptr(), M, K,
        N, bk, bn, int(a.dtype == torch.bfloat16), KERNELS[p.kernel],
        p.tile[1], p.split, p.slice_blocks, _stream(a.device))
    if err:
        raise RuntimeError(f"gated_mm kernel launch failed: CUDA error "
                           f"{err}")
    gated_mm.launches += 1
    return out


gated_mm.launches = 0

__all__ = ["BUILD_DIR", "BlockList", "H100_SMS", "KERNELS", "LIBRARY",
           "MAX_SPLIT", "Plan", "block_indices", "block_list",
           "block_mm_ref", "column_pointers", "gated_mm", "gated_mm_plain",
           "kernel_info", "plan", "skip_mm", "skip_mm_plain", "sm_count"]
