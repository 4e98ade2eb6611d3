"""Shared layer library of the dense decoder family: norms, rotary
embeddings, GQA attention (prefill and cached decode), gated MLP,
embedding and LM head (the dense part of the JAX package's
``models/layers.py``).

Parameters are :class:`Params` modules read like the reference's nested
dicts (``p["wq"]``, ``"bq" in p``); weights keep the reference's (d_in,
d_out) orientation and are used as ``x @ w``.  Attention over long
sequences is q-chunked; on a CUDA device self-attention under the
reference's conditions goes to the flash-attention kernel K4.  MLA,
cross-attention and MoE come with later slices.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.flash_attention.ops import flash_attention
from .config import ModelConfig

NEG_INF = -1e30


class Params(nn.Module):
    """A named set of weights and sub-sets, read like the reference's
    parameter dicts: ``p[name]`` and ``name in p`` see both the tensors
    (as non-trainable parameters) and the child modules."""

    def __init__(self, **entries):
        super().__init__()
        for name, value in entries.items():
            self[name] = value

    def __setitem__(self, name: str, value) -> None:
        if isinstance(value, nn.Module):
            self.add_module(name, value)
        else:
            self.register_parameter(
                name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _init(gen: torch.Generator | None, shape, scale_axis=0, device=None):
    """Normal weights scaled by 1/sqrt(shape[scale_axis]), in f32; with no
    generator, uninitialised (a skeleton to be filled)."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    scale = 1.0 / math.sqrt(max(1, shape[scale_axis]))
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * scale


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------
def init_norm(cfg: ModelConfig, d: int, device=None) -> Params:
    ones = torch.ones((d,), device=device)
    if cfg.norm == "layernorm":
        return Params(scale=ones, bias=torch.zeros((d,), device=device))
    return Params(scale=ones)


def apply_norm(p, x, eps: float = 1e-6):
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


def rms_head_norm(scale, x, eps: float = 1e-6):
    """qk-norm: per-head RMS norm (qwen3)."""
    xf = x.float()
    var = (xf ** 2).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ----------------------------------------------------------------------
# Rotary embeddings (interleaved pairs x[..., 0::2], x[..., 1::2])
# ----------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, pct: float = 1.0,
                     device=None):
    rot = int(head_dim * pct) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))
    return inv, rot


def apply_rope(x, positions, theta: float, pct: float = 1.0):
    """x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    inv, rot = rope_frequencies(d, theta, pct, device=x.device)
    ang = positions[..., :, None].float() * inv     # (..., S, rot/2)
    sin = torch.sin(ang)[..., :, None, :]
    cos = torch.cos(ang)[..., :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(*xr.shape)
    return torch.cat([out, xp.to(out.dtype)], dim=-1).to(x.dtype)


# ----------------------------------------------------------------------
# Attention core: chunked causal softmax attention
# ----------------------------------------------------------------------
def _mask_bias(q_pos, k_pos, window: int, causal: bool):
    if causal:
        ok = k_pos[None, :] <= q_pos[:, None]
    else:
        ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                        device=q_pos.device)
    if window:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    return torch.where(ok, 0.0, NEG_INF)


def sdpa(q, k, v, q_pos, k_pos, *, causal=True, window=0, chunk=1024):
    """q: (B,Sq,H,D) k/v: (B,Sk,KV,Dk/Dv).  GQA by head repetition.
    Walks the query chunks so Sq x Sk scores never fully materialize.
    On a CUDA device, self-attention (causal, no window, Sq == Sk,
    Sq % 128 == 0) goes to the flash-attention kernel K4; the chunked
    path is the fallback and the kernel's numerical reference."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    rep = H // KV
    scale = 1.0 / math.sqrt(D)

    if (q.is_cuda and causal and window == 0 and Sq == k.shape[1]
            and Sq % 128 == 0):
        return flash_attention(q, k, v, causal=True).to(q.dtype)

    kk = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vv = v.repeat_interleave(rep, dim=2) if rep > 1 else v

    def attend(qc, qp):
        # qc: (B,C,H,D); scores in f32 as preferred_element_type=f32
        s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kk.float()) * scale
        s = s + _mask_bias(qp, k_pos, window, causal)[None, None]
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, vv)

    if Sq <= chunk:
        return attend(q, q_pos)
    n = Sq // chunk
    return torch.cat([attend(q[:, i * chunk:(i + 1) * chunk],
                             q_pos[i * chunk:(i + 1) * chunk])
                      for i in range(n)], dim=1)


# ----------------------------------------------------------------------
# GQA attention block
# ----------------------------------------------------------------------
def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   device=None) -> Params:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = Params(wq=_init(gen, (d, qd), device=device),
               wk=_init(gen, (d, kvd), device=device),
               wv=_init(gen, (d, kvd), device=device),
               wo=_init(gen, (qd, d), device=device))
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((qd,), device=device)
        p["bk"] = torch.zeros((kvd,), device=device)
        p["bv"] = torch.zeros((kvd,), device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.head_dim,), device=device)
        p["k_norm"] = torch.ones((cfg.head_dim,), device=device)
    return p


def attention_qkv(p, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q, k, v = (q + p["bq"].to(x.dtype), k + p["bk"].to(x.dtype),
                   v + p["bv"].to(x.dtype))
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if "q_norm" in p:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    if cfg.rotary_pct > 0:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    return q, k, v


def attention_prefill(p, x, cfg: ModelConfig, positions, *,
                      project=True):
    """Returns (out, (k, v)); ``project=False`` returns the concatenated
    head outputs (for fused projections)."""
    B, S, _ = x.shape
    q, k, v = attention_qkv(p, x, cfg, positions)
    o = sdpa(q, k, v, positions[0], positions[0], causal=True,
             window=cfg.attn_window)
    o = o.reshape(B, S, cfg.q_dim)
    return (o @ p["wo"].to(x.dtype) if project else o), (k, v)


def attention_decode(p, x, cache, cfg: ModelConfig, pos, *,
                     project=True):
    """x: (B,1,d); cache k/v: (B,S,KV,D); pos: an int OR a (B,) vector of
    per-slot positions (continuous batching: slots advance
    independently).  Writes the new k/v at each slot's position IN PLACE
    (the returned cache is the one given) and attends over keys <= pos.
    GQA by grouping the query heads of one KV head (query head h reads KV
    head h // rep, as the reference's head repetition)."""
    B = x.shape[0]
    k_cache, v_cache = cache
    S = k_cache.shape[1]
    pos_vec = torch.as_tensor(pos, dtype=torch.long,
                              device=x.device).expand(B)
    q, k, v = attention_qkv(p, x, cfg, pos_vec[:, None])
    b_idx = torch.arange(B, device=x.device)
    k_cache[b_idx, pos_vec] = k[:, 0].to(k_cache.dtype)
    v_cache[b_idx, pos_vec] = v[:, 0].to(v_cache.dtype)
    k_pos = torch.arange(S, device=x.device)
    valid = k_pos[None, :] <= pos_vec[:, None]              # (B, S)
    if cfg.attn_window:
        valid = valid & (k_pos[None, :] > pos_vec[:, None] - cfg.attn_window)
    KV, rep = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(B, KV, rep, cfg.head_dim)
    s = torch.einsum("bgrd,bsgd->bgrs", qg.float(), k_cache.float())
    s = s / math.sqrt(cfg.head_dim) + torch.where(valid, 0.0, NEG_INF)[
        :, None, None, :]
    prob = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bgrs,bsgd->bgrd", prob, v_cache.to(x.dtype))
    o = o.reshape(B, 1, cfg.q_dim)
    out = o @ p["wo"].to(x.dtype) if project else o
    return out, (k_cache, v_cache)


# ----------------------------------------------------------------------
# Gated MLP
# ----------------------------------------------------------------------
def init_mlp(d: int, d_ff: int, gen: torch.Generator, device=None) -> Params:
    return Params(wi=_init(gen, (d, d_ff), device=device),
                  wg=_init(gen, (d, d_ff), device=device),
                  wo=_init(gen, (d_ff, d), device=device))


def mlp_fwd(p, x):
    return mlp_hidden(p, x) @ p["wo"].to(x.dtype)


def mlp_hidden(p, x):
    """Gated hidden activations without the output projection."""
    return torch.nn.functional.silu(x @ p["wg"].to(x.dtype)) * (
        x @ p["wi"].to(x.dtype))


# ----------------------------------------------------------------------
# Embeddings / LM head
# ----------------------------------------------------------------------
def init_embedding(cfg: ModelConfig, gen: torch.Generator,
                   device=None) -> Params:
    p = Params(tok=_init(gen, (cfg.vocab_size, cfg.d_model), 1,
                         device=device) * 0.02 * (cfg.d_model ** 0.5))
    if not cfg.tie_embeddings:
        p["head"] = _init(gen, (cfg.d_model, cfg.vocab_size), device=device)
    return p


def embed(p, tokens, cfg: ModelConfig):
    return p["tok"].to(getattr(torch, cfg.dtype))[tokens.long()]


def lm_logits(p, x, cfg: ModelConfig):
    w = p["head"] if "head" in p else p["tok"].T
    return x @ w.to(x.dtype)
