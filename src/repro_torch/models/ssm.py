"""State-space and recurrent blocks (the JAX package's ``models/ssm.py``):
Mamba2 (SSD), mLSTM and sLSTM.

Mamba2 and mLSTM share one core, a gated linear recurrence over
outer-product states:

    H_t = a_t * H_{t-1} + v_t k_t^T          (state: (heads, d_v, d_k))
    y_t = H_t q_t

Prefill takes the exact chunkwise-parallel form (matmuls inside a chunk,
a loop over chunks carrying the state); decode is the O(1) recurrent
step.  mLSTM's normalizer is folded in as an extra constant channel of
v.  sLSTM mixes its state recurrently, so it is a strictly sequential
Python loop over the sequence, as the reference's ``lax.scan``; there is
no kernel for it (the reference has no Pallas kernel for any of these).

Dtypes follow the reference: the matrix state ``h`` and the conv cache
are in the activations' type, gates and decays in f32, and sLSTM's
``c, n, m`` in f32.
"""
from __future__ import annotations

import math

import torch
from torch.nn.functional import silu

from .config import ModelConfig
from ..launch.sharding import PartitionSpec as P
from .layers import MODEL, Params, _init, apply_norm


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ----------------------------------------------------------------------
# Chunked gated linear recurrence (exact)
# ----------------------------------------------------------------------
def chunked_recurrence(a, q, k, v, h0, chunk: int = 128):
    """a: (B,S,H) per-step decay in (0,1]; q,k: (B,S,H,Dk); v: (B,S,H,Dv);
    h0: (B,H,Dv,Dk).  Returns y: (B,S,H,Dv), h_final.  ``S`` must be a
    whole number of chunks of ``min(chunk, S)`` (``ValueError`` where the
    reference's reshape fails)."""
    S = k.shape[1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"a sequence of {S} is not a whole number of "
                         f"chunks of {Q}")
    la = torch.log(a.clamp(1e-20, 1.0))                     # (B,S,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    h, ys = h0, []
    for c0 in range(0, S, Q):
        lac, qc, kc, vc = (t[:, c0:c0 + Q] for t in (la, q, k, v))
        s = torch.cumsum(lac, dim=1)                         # (B,Q,H)
        total = s[:, -1:, :]                                 # (B,1,H)
        # inter-chunk: y_t += (q_t * exp(s_t)) . h
        q_dec = qc * torch.exp(s)[..., None].to(qc.dtype)
        y_inter = torch.einsum("bqhk,bhvk->bqhv", q_dec, h)
        # intra-chunk: masked decay-weighted attention
        gap = s[:, :, None, :] - s[:, None, :, :]            # (B,Q,Q,H)
        w = torch.where(mask[None, :, :, None], torch.exp(gap), 0.0)
        scores = torch.einsum("bqhk,bjhk->bqjh", qc.float(), kc.float())
        y_intra = torch.einsum("bqjh,bjhv->bqhv",
                               (scores * w).to(vc.dtype), vc)
        # state update: h' = exp(total) h + sum_j exp(total - s_j) v_j k_j^T
        k_dec = kc * torch.exp(total - s)[..., None].to(kc.dtype)
        h = (h * torch.exp(total[:, 0, :])[:, :, None, None].to(h.dtype)
             + torch.einsum("bjhv,bjhk->bhvk", vc, k_dec))
        ys.append(y_inter + y_intra)
    return torch.cat(ys, dim=1), h


def recurrence_step(a, q, k, v, h):
    """One decode step.  a: (B,H); q,k: (B,H,Dk); v: (B,H,Dv);
    h: (B,H,Dv,Dk)."""
    h = h * a[..., None, None].to(h.dtype) \
        + torch.einsum("bhv,bhk->bhvk", v, k)
    return torch.einsum("bhvk,bhk->bhv", h, q), h


# ----------------------------------------------------------------------
# Causal depthwise conv1d with cache
# ----------------------------------------------------------------------
def causal_conv(x, w, cache=None):
    """x: (B,S,D); w: (K,D) depthwise.  cache: (B,K-1,D) previous inputs.
    Returns (silu(conv), new cache)."""
    K = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(K))
    new_cache = xp[:, -(K - 1):, :] if K > 1 else pad
    return silu(out), new_cache


# ----------------------------------------------------------------------
# Mamba2 block
# ----------------------------------------------------------------------
def _mamba_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    head_dim = 64
    heads = max(1, d_in // head_dim)
    return d_in, heads, head_dim


def init_mamba2(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> Params:
    d = cfg.d_model
    d_in, H, _ = _mamba_dims(cfg)
    n = cfg.ssm_state
    return Params(
        # packed in-projection: [z, x, B, C, dt]
        w_in=_init(gen, (d, 2 * d_in + 2 * n + H), device=device),
        conv_w=torch.ones((cfg.ssm_conv, d_in + 2 * n),
                          device=device) / cfg.ssm_conv,
        A_log=torch.zeros((H,), device=device) + math.log(0.5),
        dt_bias=torch.zeros((H,), device=device),
        D=torch.ones((H,), device=device),
        out_norm=torch.ones((d_in,), device=device),
        w_out=_init(gen, (d_in, d), device=device)).with_specs(
        w_in=P(None, MODEL), conv_w=P(None, MODEL), A_log=P(None),
        dt_bias=P(None), D=P(None), out_norm=P(MODEL), w_out=P(MODEL, None))


def _mamba_gates(p, u, cfg: ModelConfig):
    d_in, _, _ = _mamba_dims(cfg)
    n = cfg.ssm_state
    z = u[..., :d_in]
    xbc = u[..., d_in:2 * d_in + 2 * n]
    dt = _softplus(u[..., 2 * d_in + 2 * n:].float() + p["dt_bias"])
    a = torch.exp(-torch.exp(p["A_log"])[None, None, :] * dt)  # (B,S,H)
    return z, xbc, dt, a


def mamba2_fwd(p, x, cfg: ModelConfig, state=None):
    """state: (conv_cache, h) or None.  Returns (y, new_state)."""
    B, S, _ = x.shape
    d_in, H, hd = _mamba_dims(cfg)
    n = cfg.ssm_state
    u = x @ p["w_in"].to(x.dtype)
    z, xbc, dt, a = _mamba_gates(p, u, cfg)
    xbc, new_conv = causal_conv(xbc, p["conv_w"].to(x.dtype),
                                None if state is None else state[0])
    xs = xbc[..., :d_in].reshape(B, S, H, hd)
    k = xbc[..., d_in:d_in + n][:, :, None, :].expand(B, S, H, n)
    q = xbc[..., d_in + n:][:, :, None, :].expand(B, S, H, n)
    v = xs * dt[..., None].to(x.dtype)
    if state is None:
        h0 = torch.zeros((B, H, hd, n), dtype=x.dtype, device=x.device)
    else:
        h0 = state[1]
    if S == 1 and state is not None:
        y, h = recurrence_step(a[:, 0], q[:, 0], k[:, 0], v[:, 0], h0)
        y = y[:, None]
    else:
        y, h = chunked_recurrence(a, q, k, v, h0)
    y = y + xs * p["D"][None, None, :, None].to(x.dtype)
    y = apply_norm({"scale": p["out_norm"]}, y.reshape(B, S, d_in)) \
        * silu(z)
    return y @ p["w_out"].to(x.dtype), (new_conv, h)


# ----------------------------------------------------------------------
# mLSTM block (xLSTM): matrix memory, exponential gating; the normalizer
# rides as an extra channel of v
# ----------------------------------------------------------------------
def init_mlstm(cfg: ModelConfig, gen: torch.Generator,
               device=None) -> Params:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = cfg.num_heads
    return Params(
        w_up=_init(gen, (d, 2 * d_in), device=device),        # (xi, z)
        conv_w=torch.ones((cfg.ssm_conv, d_in),
                          device=device) / cfg.ssm_conv,
        w_qkv=_init(gen, (d_in, 3 * d_in), device=device),
        w_if=_init(gen, (d_in, 2 * H), device=device),
        out_norm=torch.ones((d_in,), device=device),
        w_down=_init(gen, (d_in, d), device=device)).with_specs(
        w_up=P(None, MODEL), conv_w=P(None, MODEL), w_qkv=P(MODEL, None),
        w_if=P(MODEL, None), out_norm=P(MODEL), w_down=P(MODEL, None))


def mlstm_fwd(p, x, cfg: ModelConfig, state=None):
    """state: (conv_cache, h) or None.  Returns (y, new_state)."""
    B, S, d = x.shape
    d_in = cfg.ssm_expand * d
    H = cfg.num_heads
    hd = d_in // H
    up = x @ p["w_up"].to(x.dtype)
    xi, z = up[..., :d_in], up[..., d_in:]
    xc, new_conv = causal_conv(xi, p["conv_w"].to(x.dtype),
                               None if state is None else state[0])
    qkv = xc @ p["w_qkv"].to(x.dtype)
    q = qkv[..., :d_in].reshape(B, S, H, hd) / math.sqrt(hd)
    k = qkv[..., d_in:2 * d_in].reshape(B, S, H, hd) / math.sqrt(hd)
    v = qkv[..., 2 * d_in:].reshape(B, S, H, hd)
    gates = (xc @ p["w_if"].to(x.dtype)).float()
    i_g = torch.exp(-_softplus(-gates[..., :H]))             # in (0,1)
    f_g = torch.sigmoid(gates[..., H:] + 4.0)                # forget ~1
    # v with a channel of ones: the state's last row is the normalizer
    # n_t = f n + i k
    i_x = i_g[..., None].to(x.dtype)
    v_aug = torch.cat([v * i_x, torch.ones((B, S, H, 1), dtype=x.dtype,
                                           device=x.device) * i_x], dim=-1)
    if state is None:
        h0 = torch.zeros((B, H, hd + 1, hd), dtype=x.dtype, device=x.device)
    else:
        h0 = state[1]
    if S == 1 and state is not None:
        y_aug, h = recurrence_step(f_g[:, 0], q[:, 0], k[:, 0],
                                   v_aug[:, 0], h0)
        y_aug = y_aug[:, None]
    else:
        y_aug, h = chunked_recurrence(f_g, q, k, v_aug, h0)
    num, den = y_aug[..., :hd], y_aug[..., hd:]
    y = (num / torch.clamp_min(den.abs(), 1.0)).reshape(B, S, d_in)
    y = apply_norm({"scale": p["out_norm"]}, y) * silu(z)
    return y @ p["w_down"].to(x.dtype), (new_conv, h)


# ----------------------------------------------------------------------
# sLSTM block: scalar memory, strictly sequential (recurrent mixing)
# ----------------------------------------------------------------------
def init_slstm(cfg: ModelConfig, gen: torch.Generator,
               device=None) -> Params:
    d = cfg.d_model
    return Params(
        w_gates=_init(gen, (d, 4 * d), device=device),          # i, f, z, o
        r_gates=_init(gen, (d, 4 * d), device=device) * 0.1,   # recurrent
        w_down=_init(gen, (d, d), device=device),
        out_norm=torch.ones((d,), device=device)).with_specs(
        w_gates=P(None, MODEL), r_gates=P(None, MODEL), w_down=P(MODEL, None),
        out_norm=P(None))


def slstm_fwd(p, x, cfg: ModelConfig, state=None):
    """state: (h, c, n, m), each (B, d); ``h`` in x's type, the rest f32.
    One step per position, in order (xLSTM eq. 15-17, stabilised).  On
    DTensors each rank runs it on its batch shard with the weights
    whole (``launch.sharding.per_batch_shard``): the loop's steps are
    too small to split."""
    if hasattr(x, "device_mesh"):
        from ..launch.sharding import per_batch_shard
        return per_batch_shard(slstm_fwd, p, x, cfg, state=state)
    B, S, d = x.shape
    pre = x @ p["w_gates"].to(x.dtype)                     # (B,S,4d)
    if state is None:
        h = torch.zeros((B, d), dtype=x.dtype, device=x.device)
        c = torch.zeros((B, d), device=x.device)
        n = torch.ones((B, d), device=x.device)
        m = torch.zeros((B, d), device=x.device)
    else:
        h, c, n, m = state
    r_w = p["r_gates"].to(x.dtype)
    ys = []
    for t in range(S):
        g = (pre[:, t] + h @ r_w).float()
        gi, gf, gz, go = g.chunk(4, dim=-1)
        log_f = -_softplus(-gf)                             # log sigmoid
        m_new = torch.maximum(log_f + m, gi)
        i_s = torch.exp(gi - m_new)
        f_s = torch.exp(log_f + m - m_new)
        c = f_s * c + i_s * torch.tanh(gz)
        n = f_s * n + i_s
        h = (torch.sigmoid(go) * (c / torch.clamp_min(n, 1.0))).to(x.dtype)
        m = m_new
        ys.append(h)
    y = apply_norm({"scale": p["out_norm"]}, torch.stack(ys, dim=1))
    return y @ p["w_down"].to(x.dtype), (h, c, n, m)
