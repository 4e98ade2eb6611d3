"""Wrapper of the flash-attention kernel K4.

``flash_attention`` launches the CUDA kernel of ``csrc/flash_attention.cu``
for tensors on a CUDA device and uses the plain PyTorch version beside it
(``flash_attention_plain``) only for tensors on the CPU.  For a CUDA
tensor it launches the kernel or raises; it never falls back.  It counts
its launches in ``flash_attention.launches``.  The kernel is built at
first use with ``nvcc`` for ``sm_90a`` (``kernels.nvcc``), launches on
PyTorch's current stream and allocates nothing: the wrapper allocates the
output.  The launch is the operator ``torch.ops.repro_torch.flash_attention``
(``torch.library.custom_op``): a fake implementation for meta and fake
tensors and a FLOP formula for ``torch.utils.flop_counter`` and the
cost count.  On the card the
output carries a gradient: the operator's backward,
``flash_attention_backward``, is plain PyTorch in f32 on the saved q, k
and v.  There is no backward
kernel, since the JAX package has none (``jax.grad`` through its Pallas
K4 fails); the training step recomputes the forward under
checkpointing, so K4 launches twice a layer and step there.

As the JAX package's ``flash_attention``: q (B, S, H, D), k and v
(B, S, KV, D) with H a multiple of KV (GQA: query head h reads KV head
``h // (H // KV)``, the reference's ``jnp.repeat`` along the head axis);
returns (B, S, H, D) f32.  ``bq = min(bq, S)`` and ``bk = min(bk, S)``,
and ``S % bq`` or ``S % bk`` not 0 raises ``ValueError`` where the
reference asserts.  Under causal masking the kernel's key loop stops at
the diagonal: future key tiles are SKIPPED, where the TPU kernel GATED
them with ``pl.when``; the numerics are the same.  The kernel takes any
head dim D from 1 to :data:`MAX_HEAD_DIM` (the reference's K4 takes the
whole head as one block): it is compiled at the widths :data:`WIDTHS`,
and a head runs the first width at least as wide (:func:`width`) with
the missing columns read as zeros, its scale 1/sqrt(D) of its own D.  It
reads q, k and v through their strides (last dimension contiguous) and
never repeats K/V heads in memory or pads them; its key tile is its
own, so ``bq``/``bk`` only decide which shapes are legal.

The input type picks the variant (``kernel_info``).  At
the serve prefill cell (8, 512, 14, 2, 64, bf16, causal) the function's
bound on an H100 is its bytes, 7.2 us at 3.35 TB/s; the first version of
the kernel did its products on the f32 FMA pipes with synchronous loads
and took 0.166 ms there.  bf16 runs on the tensor cores: one warpgroup
issues ``wgmma`` for both products, with P kept in registers, while a
producer warp brings K/V tiles by TMA into a ring of shared-memory
stages.  The chain of product, softmax and product inside a block bounds
it, and several resident blocks per SM hide it (the source note says
how).  TMA reads 16-byte aligned rows: bf16 inputs need 16-byte aligned
pointers and strides that are multiples of 8 elements, and a view that
is not raises, as does a head dim above MAX_HEAD_DIM.  f32 stays on the
FMA kernel, bound by the f32 FMA pipes: the tensor cores' TF32 would
keep about three decimal digits, where the f32 checks need full f32,
and the FMA kernel is already faster than PyTorch's f32 attention at
the serve shape.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from ..nvcc import CudaLibrary
from .ref import flash_attention_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: ``csrc/flash_attention.cu``, built at first use (``kernels.nvcc``)
LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    {"flash_attention": [_P] * 4 + [_I] * 5 + [_L] * 9 + [_I, _I, _P],
     "flash_attention_info": [_I, _I, _I, _P]})
#: the head widths the kernel is built for; a head dim up to
#: MAX_HEAD_DIM runs the first at least as wide (``csrc``'s ``by_width``)
#: that its type has: f32 has no 80 (heads of 65 to 96 run 96)
WIDTHS = (16, 32, 48, 64, 80, 96, 112, 128, 160, 192, 256)
F32_WIDTHS = tuple(w for w in WIDTHS if w != 80)
MAX_HEAD_DIM = WIDTHS[-1]
NEG_INF = -1e30
#: the profiler range around each backward of K4's autograd Function
BACKWARD_RANGE = "flash_attention.backward"
#: the variants ``flash_attention_info`` of the library reports
VARIANTS = {1: "bf16 tensor cores (wgmma, TMA ring)", 0: "f32 FMA"}


def _shapes(q, k, v, bq, bk):
    """(B, S, H, KV, D, bq, bk) after the reference's clamping; raises
    where the reference asserts."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need q (B, S, H, D) and k, v (B, S, KV, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    KV = k.shape[2]
    if tuple(k.shape) != (B, S, KV, D) or tuple(v.shape) != (B, S, KV, D):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be ({B}, {S}, KV, {D})")
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV "
                         f"heads")
    bq, bk = min(bq, S), min(bk, S)
    if S % bq or S % bk:
        raise ValueError(f"tiles (bq, bk) = ({bq}, {bk}) do not divide "
                         f"S = {S}")
    return B, S, H, KV, D, bq, bk


def flash_attention_plain(q, k, v, *, bq=128, bk=128, causal=True):
    """Plain PyTorch K4: the recurrence of the reference's
    ``_flash_kernel``, one key tile at a time (all query tiles at once),
    with its roundings: scores in f32, ``p`` cast to v's type before the
    PV product, division by ``max(l, 1e-30)``; a key tile wholly in the
    future of a query tile leaves its statistics unchanged, as the
    reference's ``pl.when`` gate does.  Same arguments and result as
    :func:`flash_attention`."""
    B, S, H, KV, D, bq, bk = _shapes(q, k, v, bq, bk)
    rep = H // KV
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    nq, dev = S // bq, q.device
    qf = q.transpose(1, 2).reshape(B * H, nq, bq, D).float()
    kf = k.transpose(1, 2).reshape(B * H, S, D)
    vf = v.transpose(1, 2).reshape(B * H, S, D)
    scale = 1.0 / math.sqrt(D)
    m = torch.full((B * H, nq, bq), NEG_INF, device=dev)
    l = torch.zeros((B * H, nq, bq), device=dev)
    acc = torch.zeros((B * H, nq, bq, D), device=dev)
    q_pos = torch.arange(S, device=dev).reshape(nq, bq)
    for ki in range(S // bk):
        kt = kf[:, None, ki * bk:(ki + 1) * bk].float()
        vt = vf[:, None, ki * bk:(ki + 1) * bk]
        s = (qf @ kt.transpose(-1, -2)) * scale       # (BH, nq, bq, bk)
        if causal:
            k_pos = ki * bk + torch.arange(bk, device=dev)
            s = torch.where(k_pos[None, None, None, :]
                            <= q_pos[None, :, :, None], s,
                            torch.full_like(s, NEG_INF))
            needed = (ki * bk <= q_pos[:, -1])[None, :, None]
        else:
            needed = torch.ones((1, nq, 1), dtype=torch.bool, device=dev)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + p.to(v.dtype).float() @ vt.float()
        m = torch.where(needed, m_new, m)
        l = torch.where(needed, l_new, l)
        acc = torch.where(needed[..., None], acc_new, acc)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, S, D).transpose(1, 2).contiguous()


def width(D: int, dtype=torch.bfloat16) -> int:
    """The kernel width that runs heads of ``D`` columns in ``dtype``;
    raises for a head dim the kernel does not take."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims 1 to {MAX_HEAD_DIM}, "
                         f"got {D}")
    widths = F32_WIDTHS if dtype == torch.float32 else WIDTHS
    return next(w for w in widths if w >= D)


def _check_cuda(q, k, v, D) -> None:
    if not (q.device == k.device == v.device and q.device.type == "cuda"):
        raise ValueError(f"q, k and v must lie on one CUDA device, got "
                         f"{q.device}, {k.device} and {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"q, k and v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype} and {v.dtype}")
    width(D)
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v must be contiguous in their last "
                         "dimension")
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
                raise ValueError(
                    f"bf16 {name} is read 16 bytes at a time: it needs a "
                    f"16-byte aligned start and strides that are multiples "
                    f"of 8, got offset {x.data_ptr() % 16} and strides "
                    f"{tuple(x.stride())}")


def kernel_info(dtype, D: int, causal: bool = True) -> dict:
    """What the library runs for inputs of ``dtype`` and head dim ``D``:
    the variant, its width, registers and local memory (spills, stack)
    per thread, dynamic shared memory per block and resident blocks per
    SM, from the CUDA runtime (builds the library); raises where it has
    no kernel."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"no flash-attention kernel for {dtype} at D {D}")
    width(D)
    info = (ctypes.c_int * 6)()
    err = LIBRARY.lib().flash_attention_info(
        D, int(dtype == torch.bfloat16), int(causal), info)
    if err:
        raise RuntimeError(f"flash_attention_info failed: CUDA error {err}")
    return {"variant": VARIANTS[info[0]], "width": info[5],
            "registers": info[1], "local_bytes": info[2],
            "smem_bytes": info[3], "blocks_per_sm": info[4]}


def flash_attention_backward(q, k, v, dout, *, causal=True, chunk=1024):
    """(dq, dk, dv) of :func:`flash_attention` at ``q, k, v`` for the
    output gradient ``dout``, in plain PyTorch: the softmax gradient
    dS = P * (dP - rowsum(dO * O)), with dP = dO V^T and O = P V
    recomputed, all in f32 from the saved inputs, one chunk of ``chunk``
    queries at a time (under causal masking only the keys up to the
    chunk's end), then cast to the inputs' types.  GQA: the gradients of
    k and v are summed over the query heads that share them.  It equals
    autograd through :func:`flash_attention_plain` (and through the
    chunked ``sdpa``) on the same inputs, up to the order of f32 sums;
    in bf16 the plain version also rounds P and dP to bf16, this
    function does not.  The (chunk, keys) tensors are made four times
    (S, P, dP, its product with P in place) and read a few times each."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    rep = H // KV
    scale = 1.0 / math.sqrt(D)
    qf = q.float().transpose(1, 2) * scale              # (B, H, S, D)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    do = dout.float().transpose(1, 2)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    pos = torch.arange(S, device=q.device)
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        n = c1 if causal else S                         # keys it can see
        qc, doc, kc, vc = qf[:, :, c0:c1], do[:, :, c0:c1], kf[:, :, :n], \
            vf[:, :, :n]
        s = qc @ kc.transpose(-1, -2)                   # (B, H, C, n)
        if causal:
            s.masked_fill_(pos[None, :n] > pos[c0:c1, None], NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        rowsum = (doc * (p @ vc)).sum(dim=-1, keepdim=True)   # dO . O
        ds = (doc @ vc.transpose(-1, -2)).sub_(rowsum).mul_(p)
        dq[:, :, c0:c1] = (ds @ kc) * scale
        dk[:, :, :n] += ds.transpose(-1, -2) @ qc       # qc carries scale
        dv[:, :, :n] += p.transpose(-1, -2) @ doc
    if rep > 1:
        dk = dk.reshape(B, KV, rep, S, D).sum(dim=2)
        dv = dv.reshape(B, KV, rep, S, D).sum(dim=2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _launch(q, k, v, causal: bool):
    """One launch of the kernel on CUDA tensors; counts it."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    _check_cuda(q, k, v, D)
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
    err = LIBRARY.lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, H, KV, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> torch.Tensor:
    """K4 as an operator of PyTorch's dispatcher: one launch on CUDA
    tensors.  Its fake implementation gives the shape on meta and fake
    tensors, and its FLOP formula (:func:`flash_attention_flops`) is
    registered with ``torch.utils.flop_counter``."""
    return _launch(q, k, v, causal)


@_flash_attention_op.register_fake
def _(q, k, v, causal):
    return q.new_empty(q.shape, dtype=torch.float32)


def _setup_backward(ctx, inputs, output):
    q, k, v, causal = inputs
    ctx.causal = causal
    ctx.save_for_backward(q, k, v)


def _backward(ctx, dout):
    """The gradient of K4: :func:`flash_attention_backward`, plain
    PyTorch on the saved q, k and v.  There is no backward kernel: the
    JAX package has none to port (``jax.grad`` through its Pallas K4
    fails), and the function it differentiates off the TPU is this
    one."""
    q, k, v = ctx.saved_tensors
    with torch.profiler.record_function(BACKWARD_RANGE):
        dq, dk, dv = flash_attention_backward(q, k, v, dout,
                                              causal=ctx.causal)
    return dq, dk, dv, None


_flash_attention_op.register_autograd(_backward,
                                      setup_context=_setup_backward)


def flash_attention_flops(B: int, S: int, H: int, D: int,
                          causal: bool) -> int:
    """The multiply-adds of K4 counted as 2 FLOPs each: q k^T and P v
    over the (query, key) pairs it visits, S (S + 1) / 2 of them per
    head under causal masking, S^2 otherwise."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4 * B * H * D * pairs


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, *args, out_shape=None,
           **kwargs) -> int:
    B, S, H, D = q_shape
    return flash_attention_flops(B, S, H, D, causal)


def flash_attention(q, k, v, *, bq=128, bk=128, causal=True):
    """Multi-head flash attention (K4), GQA by head sharing: (B, S, H, D)
    f32 = softmax(q k^T / sqrt(D), causal or not) v.  Under causal
    masking the key loop stops at the diagonal (SKIP, where the TPU
    kernel GATES future tiles; same numerics).  On the card the result
    carries a gradient to q, k and v (the registered operator
    ``torch.ops.repro_torch.flash_attention``); CPU tensors go to
    :func:`flash_attention_plain`, which autograd differentiates.  (The
    models hand it each rank's shard of DTensors:
    ``launch.sharding.per_head_shard``.)"""
    B, S, H, KV, D, bq, bk = _shapes(q, k, v, bq, bk)
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return flash_attention_plain(q, k, v, bq=bq, bk=bk, causal=causal)
    return torch.ops.repro_torch.flash_attention(q, k, v, causal)


flash_attention.launches = 0

__all__ = ["BACKWARD_RANGE", "F32_WIDTHS", "LIBRARY", "MAX_HEAD_DIM",
           "WIDTHS",
           "flash_attention", "flash_attention_backward",
           "flash_attention_flops", "flash_attention_plain",
           "flash_attention_ref", "kernel_info", "width"]
