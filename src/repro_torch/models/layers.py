"""Shared layer library (the JAX package's ``models/layers.py``): norms,
rotary embeddings, GQA attention (full-sequence, prefill and cached
decode), MLA with its compressed cache, cross-attention, gated MLP,
capacity-based MoE, embedding and LM head.

Parameters are :class:`Params` modules read like the reference's nested
dicts (``p["wq"]``, ``"bq" in p``); weights keep the reference's (d_in,
d_out) orientation and are used as ``x @ w``.  They are registered
without gradients; training switches them on (``requires_grad_``).
Every function here is differentiable: nothing writes in place into a
tensor that autograd saved (the MoE's combine adds into a fresh zero
tensor; only decode writes its caches in place, under ``no_grad``).
Attention over long sequences is q-chunked; on a CUDA device
self-attention under the reference's conditions goes to the
flash-attention kernel K4.  MLA, the
MoE's expert products and cross-attention are plain PyTorch, as the
reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.flash_attention.ops import flash_attention
from ..launch.sharding import PartitionSpec as P
from .config import ModelConfig

NEG_INF = -1e30
MODEL = "model"
DATA = "data"


class Params(nn.Module):
    """A named set of weights and sub-sets, read like the reference's
    parameter dicts: ``p[name]`` and ``name in p`` see both the tensors
    (parameters registered without gradients; training switches them on
    with ``requires_grad_``) and the child modules.  ``specs`` holds the
    partition spec of each of its own tensors (the reference's spec
    tree, set by :meth:`with_specs`; :func:`param_specs` collects them
    by state-dict name)."""

    def __init__(self, **entries):
        super().__init__()
        self.specs: dict[str, P] = {}
        for name, value in entries.items():
            self[name] = value

    def with_specs(self, **specs) -> "Params":
        """Record the partition spec of each named tensor; returns self."""
        self.specs.update(specs)
        return self

    def __delitem__(self, name: str) -> None:
        delattr(self, name)
        self.specs.pop(name, None)

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


def param_specs(model: nn.Module) -> dict[str, P]:
    """The partition spec of every parameter of ``model``, keyed by its
    state-dict name: the reference's spec of the same leaf, with the
    leading layer axis of its stacked groups dropped (the port holds one
    module per layer).  Raises ``KeyError`` for a parameter without
    one."""
    out = {}
    for prefix, mod in model.named_modules():
        for name in mod._parameters:
            key = f"{prefix}.{name}" if prefix else name
            specs = getattr(mod, "specs", {})
            if name not in specs:
                raise KeyError(f"{key}: no partition spec")
            out[key] = specs[name]
    return out


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
        return Params(scale=ones, bias=torch.zeros((d,), device=device)
                      ).with_specs(scale=P(None), bias=P(None))
    return Params(scale=ones).with_specs(scale=P(None))


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
    Walks the query chunks so Sq x Sk scores never fully materialize;
    ``Sq > chunk`` needs ``Sq % chunk == 0`` (raises ``ValueError`` where
    the reference's reshape fails).  On a CUDA device, self-attention
    (causal, no window, Sq == Sk, Sq % 128 == 0) goes to the
    flash-attention kernel K4, whose output carries a gradient; the
    chunked path is the fallback and the kernel's numerical reference.
    DTensors run it on each rank's (batch, heads) shard
    (``launch.sharding.per_head_shard``)."""
    if hasattr(q, "device_mesh"):       # DTensors: each rank its shard
        from ..launch.sharding import per_head_shard
        return per_head_shard(sdpa, q, k, v, q_pos, k_pos, causal=causal,
                              window=window, chunk=chunk)
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
    if Sq % chunk:
        raise ValueError(f"{Sq} queries are not a whole number of chunks "
                         f"of {chunk}")
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
               wo=_init(gen, (qd, d), device=device)).with_specs(
        wq=P(None, MODEL), wk=P(None, MODEL), wv=P(None, MODEL),
        wo=P(MODEL, None))
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((qd,), device=device)
        p["bk"] = torch.zeros((kvd,), device=device)
        p["bv"] = torch.zeros((kvd,), device=device)
        p.with_specs(bq=P(MODEL), bk=P(MODEL), bv=P(MODEL))
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.head_dim,), device=device)
        p["k_norm"] = torch.ones((cfg.head_dim,), device=device)
        p.with_specs(q_norm=P(None), k_norm=P(None))
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


def attention_fwd(p, x, cfg: ModelConfig, positions, *, causal=True,
                  project=True):
    """Full-sequence attention without a cache (training, whisper's
    encoder); ``project=False`` returns the concatenated head outputs
    (for fused projections)."""
    B, S, _ = x.shape
    q, k, v = attention_qkv(p, x, cfg, positions)
    o = sdpa(q, k, v, positions[0], positions[0], causal=causal,
             window=cfg.attn_window)
    o = o.reshape(B, S, cfg.q_dim)
    return o @ p["wo"].to(x.dtype) if project else o


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
    pos_vec = _pos_vec(pos, B, x.device)
    q, k, v = attention_qkv(p, x, cfg, pos_vec[:, None])
    write_rows(k_cache, pos_vec, k[:, 0])
    write_rows(v_cache, pos_vec, v[:, 0])
    k_pos = torch.arange(S, device=x.device)
    valid = k_pos[None, :] <= pos_vec[:, None]              # (B, S)
    if cfg.attn_window:
        valid = valid & (k_pos[None, :] > pos_vec[:, None] - cfg.attn_window)
    if hasattr(q, "device_mesh"):       # DTensors: each rank its shard
        from ..launch.sharding import per_head_shard
        o = per_head_shard(_decode_attend, q, k_cache, v_cache,
                           batch_args=(valid,))
    else:
        o = _decode_attend(q, k_cache, v_cache, valid)
    o = o.reshape(B, 1, cfg.q_dim)
    out = o @ p["wo"].to(x.dtype) if project else o
    return out, (k_cache, v_cache)


def _decode_attend(q, k_cache, v_cache, valid):
    """q (B, 1, H, D) over the cache (B, S, KV, D) where ``valid`` (B, S):
    scores in f32, GQA by grouping the query heads of one KV head;
    returns (B, 1, H, D) in q's type."""
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, D)
    s = torch.einsum("bgrd,bsgd->bgrs", qg.float(), k_cache.float())
    s = s / math.sqrt(D) + torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    prob = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bgrs,bsgd->bgrd", prob, v_cache.to(q.dtype))
    return o.reshape(B, 1, H, D)


def write_rows(cache, pos_vec, new) -> None:
    """``cache[b, pos_vec[b]] = new[b]`` for every row b, IN PLACE: cache
    (B, S, ...), pos_vec (B,), new (B, ...).  A DTensor cache is written
    shard by shard (``launch.sharding.write_rows_sharded``): each rank
    writes its own rows, and where the cache is split along S, only the
    rank that holds the position."""
    if hasattr(cache, "device_mesh"):
        from ..launch.sharding import write_rows_sharded
        write_rows_sharded(cache, pos_vec, new)
        return
    b_idx = torch.arange(cache.shape[0], device=cache.device)
    cache[b_idx, pos_vec] = new.to(cache.dtype)


def _pos_vec(pos, B: int, device):
    """``pos`` (an int or a (B,) vector) as a (B,) long vector."""
    return torch.as_tensor(pos, dtype=torch.long, device=device).expand(B)


# ----------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV; the cache holds (c_kv, k_rope)
# ----------------------------------------------------------------------
def init_mla(cfg: ModelConfig, gen: torch.Generator, device=None) -> Params:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    return Params(
        w_dkv=_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                    device=device),
        w_uk=_init(gen, (m.kv_lora_rank, H, m.qk_nope_head_dim),
                   device=device),
        w_uv=_init(gen, (m.kv_lora_rank, H, m.v_head_dim), device=device),
        w_q=_init(gen, (d, H, m.qk_nope_head_dim + m.qk_rope_head_dim),
                  device=device),
        wo=_init(gen, (H * m.v_head_dim, d), device=device),
        kv_norm=torch.ones((m.kv_lora_rank,), device=device)).with_specs(
        w_dkv=P(None, None), w_uk=P(None, MODEL, None),
        w_uv=P(None, MODEL, None), w_q=P(None, MODEL, None),
        wo=P(MODEL, None), kv_norm=P(None))


def _mla_q(w_q, x, cfg: ModelConfig, positions):
    m = cfg.mla
    q = torch.einsum("bsd,dhe->bshe", x, w_q.to(x.dtype))
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q[..., :m.qk_nope_head_dim], q_rope


def _mla_ckv(p, x, cfg: ModelConfig, positions):
    r = cfg.mla.kv_lora_rank
    ckv = x @ p["w_dkv"].to(x.dtype)
    c_kv = apply_norm({"scale": p["kv_norm"]}, ckv[..., :r])
    k_rope = apply_rope(ckv[..., None, r:], positions,
                        cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def mla_fwd(p, x, cfg: ModelConfig, positions, cache=None, pos=None):
    """Absorbed-matmul MLA: W_uk is folded into the query, so scores are
    taken in the compressed rank r against the cached ``c_kv``.  Prefill
    (``cache`` None) returns the prompt's (c_kv, k_rope); decode
    (``cache`` (B, S, r) and (B, S, rope) with ``pos`` an int or a (B,)
    vector) writes the new entries at each slot's position IN PLACE and
    returns the cache given.  On DTensors a prefill's per-head products
    run on each rank's (batch, heads) shard
    (``launch.sharding.per_head_block``)."""
    B, S, _ = x.shape
    if pos is None:
        q_pos = positions
    else:
        pos_vec = _pos_vec(pos, B, x.device)
        q_pos = pos_vec[:, None]
    c_new, kr_new = _mla_ckv(p, x, cfg, q_pos)
    if pos is None:
        c_kv, k_rope = c_new, kr_new
        k_pos = positions[0]
        ok = (k_pos[None, :] <= k_pos[:, None])[None]          # (1, Sq, Sk)
    else:
        c_kv, k_rope = cache
        write_rows(c_kv, pos_vec, c_new[:, 0])
        write_rows(k_rope, pos_vec, kr_new[:, 0])
        k_pos = torch.arange(c_kv.shape[1], device=x.device)
        ok = k_pos[None, None, :] <= pos_vec[:, None, None]    # (B, 1, Sk)
    heads = (p["w_q"], p["w_uk"], p["w_uv"])
    if pos is None and hasattr(x, "device_mesh"):
        from ..launch.sharding import per_head_block
        o = per_head_block(_mla_attend, x, (q_pos, c_kv, k_rope, ok),
                           heads, cfg)
    else:
        o = _mla_attend(x, q_pos, c_kv, k_rope, ok, *heads, cfg)
    return o.reshape(B, S, -1) @ p["wo"].to(x.dtype), (c_kv, k_rope)


def _mla_attend(x, q_pos, c_kv, k_rope, ok, w_q, w_uk, w_uv,
                cfg: ModelConfig):
    """The MLA's per-head products: the queries, W_uk absorbed into
    them, scores against the compressed cache, the context and W_uv.
    (B, S, H, v_head_dim)."""
    m = cfg.mla
    q_nope, q_rope = _mla_q(w_q, x, cfg, q_pos)
    q_c = torch.einsum("bshe,rhe->bshr", q_nope, w_uk.to(x.dtype))
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    s = (torch.einsum("bshr,bkr->bhsk", q_c.float(), c_kv.float())
         + torch.einsum("bshe,bke->bhsk", q_rope.float(),
                        k_rope.float())) * scale
    s = s + torch.where(ok, 0.0, NEG_INF)[:, None]
    prob = torch.softmax(s, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhsk,bkr->bshr", prob, c_kv.to(x.dtype))
    return torch.einsum("bshr,rhe->bshe", ctx, w_uv.to(x.dtype))


# ----------------------------------------------------------------------
# Cross attention (whisper decoder)
# ----------------------------------------------------------------------
def cross_attention_fwd(p, x, enc_kv, cfg: ModelConfig):
    B, S, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, cfg.num_heads,
                                          cfg.head_dim)
    k, v = enc_kv
    o = sdpa(q, k, v, torch.arange(S, device=x.device),
             torch.arange(k.shape[1], device=x.device), causal=False)
    return o.reshape(B, S, cfg.q_dim) @ p["wo"].to(x.dtype)


def encode_kv(p, enc_out, cfg: ModelConfig):
    B, S, _ = enc_out.shape
    k = (enc_out @ p["wk"].to(enc_out.dtype)).reshape(
        B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (enc_out @ p["wv"].to(enc_out.dtype)).reshape(
        B, S, cfg.num_kv_heads, cfg.head_dim)
    return k, v


# ----------------------------------------------------------------------
# Gated MLP
# ----------------------------------------------------------------------
def init_mlp(d: int, d_ff: int, gen: torch.Generator, device=None) -> Params:
    return Params(wi=_init(gen, (d, d_ff), device=device),
                  wg=_init(gen, (d, d_ff), device=device),
                  wo=_init(gen, (d_ff, d), device=device)).with_specs(
        wi=P(None, MODEL), wg=P(None, MODEL), wo=P(MODEL, None))


def mlp_fwd(p, x):
    return mlp_hidden(p, x) @ p["wo"].to(x.dtype)


def mlp_hidden(p, x):
    """Gated hidden activations without the output projection."""
    return torch.nn.functional.silu(x @ p["wg"].to(x.dtype)) * (
        x @ p["wi"].to(x.dtype))


# ----------------------------------------------------------------------
# MoE: top-k routing with static-capacity gather/scatter dispatch
# ----------------------------------------------------------------------
def init_moe(cfg: ModelConfig, gen: torch.Generator, device=None) -> Params:
    m = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.expert_d_ff
    p = Params(router=_init(gen, (d, E), device=device),
               wi=_init(gen, (E, d, f), 1, device=device),
               wg=_init(gen, (E, d, f), 1, device=device),
               wo=_init(gen, (E, f, d), 1, device=device)).with_specs(
        router=P(None, None), wi=P(MODEL, None, None),
        wg=P(MODEL, None, None), wo=P(MODEL, None, None))
    if m.num_shared_experts:
        p["shared"] = init_mlp(d, m.shared_d_ff * m.num_shared_experts, gen,
                               device)
    return p


def moe_fwd(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (out, aux).  The reference's static-shape dispatch:
    the (token, choice) pairs sorted stably by expert, each expert's
    contiguous segment cut or padded to the capacity C = ceil(T k / E
    cf), so which tokens are dropped depends on T = B S.  Ties in the
    router keep the lower expert index first (``lax.top_k``).  The
    combine is ``index_add_``, atomic on the card (the order of the sums
    is not fixed there).  ``aux`` is the Switch-style load-balancing
    loss."""
    m = cfg.moe
    B, S, d = x.shape
    T, E = B * S, m.num_experts
    xt = x.reshape(T, d)
    probs = torch.softmax((xt @ p["router"].to(x.dtype)).float(), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :m.top_k], top_e[:, :m.top_k]
    top_w = (top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
             ).to(x.dtype)

    TK = T * m.top_k
    C = max(1, int(math.ceil(TK / E * m.capacity_factor)))
    flat_e = top_e.reshape(TK)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(E, device=x.device)
    seg_start = torch.searchsorted(sorted_e, experts, side="left")
    seg_end = torch.searchsorted(sorted_e, experts, side="right")
    slot = seg_start[:, None] + torch.arange(C, device=x.device)[None, :]
    valid = slot < seg_end[:, None]                         # (E, C)
    src = order[slot.clamp(0, TK - 1)]                      # flat indices
    tok = src // m.top_k
    x_e = xt[tok] * valid[..., None].to(x.dtype)            # (E, C, d)

    h = torch.nn.functional.silu(
        torch.einsum("ecd,edf->ecf", x_e, p["wg"].to(x.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", x_e, p["wi"].to(x.dtype))
    y_e = torch.einsum("ecf,efd->ecd", h, p["wo"].to(x.dtype))

    w = top_w.reshape(TK)[src] * valid.to(x.dtype)          # (E, C)
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device).index_add_(
        0, tok.reshape(-1), (y_e * w[..., None]).reshape(-1, d))
    if "shared" in p:
        out = out + mlp_fwd(p["shared"], xt)
    ce = torch.bincount(flat_e, minlength=E).float() / TK
    aux = E * torch.sum(probs.mean(0) * ce)
    return out.reshape(B, S, d), aux


# ----------------------------------------------------------------------
# Embeddings / LM head
# ----------------------------------------------------------------------
def init_embedding(cfg: ModelConfig, gen: torch.Generator,
                   device=None) -> Params:
    p = Params(tok=_init(gen, (cfg.vocab_size, cfg.d_model), 1,
                         device=device) * 0.02 * (cfg.d_model ** 0.5)
               ).with_specs(tok=P(MODEL, None))
    if not cfg.tie_embeddings:
        p["head"] = _init(gen, (cfg.d_model, cfg.vocab_size), device=device)
        p.with_specs(head=P(None, MODEL))
    return p


def embed(p, tokens, cfg: ModelConfig):
    return p["tok"].to(getattr(torch, cfg.dtype))[tokens.long()]


def lm_logits(p, x, cfg: ModelConfig):
    w = p["head"] if "head" in p else p["tok"].T
    return x @ w.to(x.dtype)
