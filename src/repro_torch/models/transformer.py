"""Model assembly of every family (the JAX package's
``models/transformer.py``): training and serving.

* dense / moe / vlm: a :class:`DecoderLM` of decoder blocks (GQA or MLA
  attention, gated MLP or MoE);
* ssm (xLSTM): an :class:`XLSTM` of (mLSTM, sLSTM) pairs;
* hybrid (zamba2): a :class:`HybridLM` of Mamba2 layers in super-blocks
  of ``period``, each followed by ONE shared attention block (its
  parameters shared, its KV cache kept per application);
* audio (whisper): an :class:`EncDec`, a non-causal encoder over
  precomputed frame embeddings (the frontend is a stub) and a decoder
  with self- and cross-attention.

Each model holds ``nn.ModuleList``s in place of the reference's
``lax.scan`` over stacked parameters.  Parameter names equal the
reference's dict keys, so its path ``("blocks", "attn", "wq")[l]`` is the
state-dict key ``blocks.{l}.attn.wq`` (``interop.params_from_reference``
carries weights across).  Every family provides init, forward_train,
prefill and decode_step; decode writes caches and recurrent states IN
PLACE and returns the ones given.

Training: ``forward_train`` returns (final hidden states, auxiliary
loss) with autograd's graph; the reference's ``jax.checkpoint`` around
each scanned block is ``torch.utils.checkpoint`` (non-reentrant) around
each block (``_remat``), and :func:`lm_loss_from_hidden` is the
sequence-chunked cross entropy.  The weights are registered without
gradients: the training step switches them on.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.device import resolve_device
from ..launch.sharding import PartitionSpec as P
from . import layers as L
from . import ssm as S
from .config import ModelConfig
from .layers import Params

def _f32_to(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every f32 weight in ``dtype`` (as the reference's ``_f32_to``)."""
    for prm in module.parameters():
        if prm.dtype == torch.float32:
            prm.data = prm.data.to(dtype)
    return module


def _stacked(cfg: ModelConfig, n: int, init_one) -> nn.ModuleList:
    """``n`` layers from ``init_one()``, each cast to ``cfg.dtype`` as it
    is built, so the f32 draws of only one layer live at a time."""
    dtype = getattr(torch, cfg.dtype)
    return nn.ModuleList([_f32_to(init_one(), dtype) for _ in range(n)])


def _embed_init(cfg: ModelConfig, gen, device) -> Params:
    return _f32_to(L.init_embedding(cfg, gen, device),
                   getattr(torch, cfg.dtype))


def _zeros(shape, dtype, device, like=None, spec=None):
    """Zeros of ``shape``: a DTensor placed by the partition ``spec`` on
    ``like``'s mesh when ``like`` (the activations the cache follows) is
    a DTensor, so each rank makes only its shard; a plain tensor on
    ``device`` otherwise."""
    if like is not None and hasattr(like, "device_mesh"):
        from ..launch.sharding import sharded_zeros
        return sharded_zeros(shape, dtype, spec, like)
    return torch.zeros(shape, dtype=dtype, device=device)


def cache_specs(cfg: ModelConfig):
    """The partition specs of the caches and states of ``cfg`` (the
    reference's ``cache_specs`` and ``launch.steps.abstract_cache``'s),
    shaped like the trees of ``lm_init_cache``, ``xlstm_init_state``,
    ``hybrid_init_state`` and whisper's prefill cache."""
    if cfg.enc_dec:
        self_spec = P(None, "data", None, "model", None)
        cross_spec = P(None, "data", "model", None, None)
        return ((self_spec, self_spec), (cross_spec, cross_spec))
    if cfg.family == "ssm":
        return ((P(None, "data", None, "model"),
                 P(None, "data", None, None, None)),
                (P(None, "data", "model"),) * 4)
    if cfg.family == "hybrid":
        return ((P(None, None, "data", None, "model"),
                 P(None, None, "data", "model", None, None)),
                (P(None, "data", None, "model", None),) * 2)
    if cfg.mla:
        return (P(None, "data", None, None),) * 2
    return (P(None, "data", None, "model", None),) * 2


def _positions(B: int, S_: int, device):
    return torch.arange(S_, device=device).expand(B, S_)


def _logits_last(params, x, cfg: ModelConfig):
    x = L.apply_norm(params["ln_f"], x)
    return L.lm_logits(params["embed"], x[:, -1:, :], cfg)


def _copy_into(dst, src) -> None:
    """Copy the tree of tensors ``src`` into ``dst`` leaf by leaf."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return
    for d, s in zip(dst, src):
        _copy_into(d, s)


def _select(tree, *index):
    """The tree of views ``leaf[index]``."""
    if isinstance(tree, torch.Tensor):
        return tree[index]
    return tuple(_select(t, *index) for t in tree)


# ======================================================================
# Decoder block (attn/MLA + MLP/MoE) of dense/moe/vlm and whisper's decoder
# ======================================================================
class Block(Params):
    """One decoder block: ``ln1``, ``attn`` (GQA or MLA), ``ln_x`` and
    ``xattn`` (cross-attention), ``ln2`` (not in a parallel block),
    ``mlp`` or ``moe`` and, for a fused parallel block, ``w_fused`` in
    place of the two output projections."""


def init_block(cfg: ModelConfig, gen: torch.Generator, device=None, *,
               cross: bool = False, moe_layer: bool | None = None) -> Block:
    moe_layer = cfg.moe is not None if moe_layer is None else moe_layer
    p = Block()
    p["ln1"] = L.init_norm(cfg, cfg.d_model, device)
    p["attn"] = (L.init_mla if cfg.mla else L.init_attention)(cfg, gen,
                                                             device)
    if cross:
        p["ln_x"] = L.init_norm(cfg, cfg.d_model, device)
        p["xattn"] = L.init_attention(cfg, gen, device)
    if not cfg.parallel_block:
        p["ln2"] = L.init_norm(cfg, cfg.d_model, device)
    if moe_layer:
        p["moe"] = L.init_moe(cfg, gen, device)
    else:
        p["mlp"] = L.init_mlp(cfg.d_model, cfg.d_ff, gen, device)
    if cfg.parallel_block and cfg.fused_proj and not moe_layer:
        # PaLM-style fusion: [attn_heads ; ffn_hidden] @ W_fused; the
        # separate output projections are dropped
        del p["attn"]["wo"], p["mlp"]["wo"]
        p["w_fused"] = L._init(gen, (cfg.q_dim + cfg.d_ff, cfg.d_model),
                               device=device)
        p.with_specs(w_fused=P(L.MODEL, None))
    return p


def _ffn(p, h, cfg: ModelConfig):
    if "moe" in p:
        return L.moe_fwd(p["moe"], h, cfg)
    return L.mlp_fwd(p["mlp"], h), 0.0


def block_fwd(p, x, cfg: ModelConfig, positions, *, mode="train",
              cache=None, pos=None, enc_kv=None):
    """mode: train | prefill | decode.  Returns (x, new_cache, aux):
    ``new_cache`` is None in training, ``aux`` the MoE's load-balancing
    loss (0.0 without an MoE).  ``enc_kv``, the encoder's (k, v), adds
    cross-attention after self-attention."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"block mode {mode!r}: train, prefill or decode")
    h = L.apply_norm(p["ln1"], x)
    if "w_fused" in p:
        # fused parallel block: one contraction for both outputs
        if mode == "train":
            o = L.attention_fwd(p["attn"], h, cfg, positions, project=False)
            new_cache = None
        elif mode == "prefill":
            o, new_cache = L.attention_prefill(p["attn"], h, cfg, positions,
                                               project=False)
        else:
            o, new_cache = L.attention_decode(p["attn"], h, cache, cfg, pos,
                                              project=False)
        fused = torch.cat([o, L.mlp_hidden(p["mlp"], h)], dim=-1) \
            @ p["w_fused"].to(x.dtype)
        return x + fused, new_cache, 0.0
    if cfg.mla:
        a, new_cache = L.mla_fwd(p["attn"], h, cfg, positions, cache=cache,
                                 pos=pos)
        if mode == "train":
            new_cache = None
    elif mode == "train":
        a, new_cache = L.attention_fwd(p["attn"], h, cfg, positions), None
    elif mode == "prefill":
        a, new_cache = L.attention_prefill(p["attn"], h, cfg, positions)
    else:
        a, new_cache = L.attention_decode(p["attn"], h, cache, cfg, pos)
    if cfg.parallel_block:
        # command-r: attention and FFN read the same norm, summed
        f, aux = _ffn(p, h, cfg)
        return x + a + f, new_cache, aux
    x = x + a
    if enc_kv is not None:
        x = x + L.cross_attention_fwd(p["xattn"], L.apply_norm(p["ln_x"], x),
                                      enc_kv, cfg)
    f, aux = _ffn(p, L.apply_norm(p["ln2"], x), cfg)
    return x + f, new_cache, aux


# ======================================================================
# Family: dense / moe / vlm decoder-only LM
# ======================================================================
class DecoderLM(Params):
    """``embed`` (``tok``, and ``head`` when untied), ``blocks`` (an
    ``nn.ModuleList`` of :class:`Block`) and ``ln_f``."""


def init_lm(cfg: ModelConfig, generator: torch.Generator | None,
            device=None) -> DecoderLM:
    """Random weights drawn from ``generator`` (a generator on
    ``device``) in the reference's shapes and scales, in f32 and cast to
    ``cfg.dtype`` part by part as they are built.  ``device`` follows the
    device rule: None is the CUDA card, the CPU only when asked for.
    With no generator the weights are left uninitialised: a skeleton to
    be filled (``interop.params_from_reference`` builds one on the meta
    device)."""
    device = resolve_device(device)
    gen = generator
    p = DecoderLM()
    p["embed"] = _embed_init(cfg, gen, device)
    p["blocks"] = _stacked(cfg, cfg.num_layers,
                           lambda: init_block(cfg, gen, device))
    p["ln_f"] = L.init_norm(cfg, cfg.d_model, device)
    return _f32_to(p, getattr(torch, cfg.dtype))


#: the products the ``"dots"`` policy saves: the weight contractions
#: (``x @ w``) and the batched ones of attention and the MoE's experts
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default)


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


REMAT_POLICIES = {
    "full": None,   # recompute everything in the backward pass
    # save the products: the backward pass does not replay the matmuls
    "dots": _save_products,
}


def _remat(body, policy: str | None):
    """``body`` under activation checkpointing: ``None`` keeps every
    activation, ``"full"`` recomputes the whole body in the backward
    pass (the reference's ``jax.checkpoint``), ``"dots"`` keeps the
    products and recomputes the rest (its
    ``dots_with_no_batch_dims_saveable``).  Any other name raises."""
    if policy is None:
        return body
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {policy!r}: one of "
                         f"{sorted(REMAT_POLICIES)} or None")
    save = REMAT_POLICIES[policy]
    kw = {} if save is None else {"context_fn": partial(
        create_selective_checkpoint_contexts, save)}
    return lambda *args: checkpoint(body, *args, use_reentrant=False, **kw)


def lm_hidden(params, x, cfg: ModelConfig, positions, *, remat=True,
              remat_policy: str | None = "full"):
    """The decoder blocks over the embeddings ``x`` (B, S, d), each
    block under ``_remat`` when ``remat``; returns (final-normed hidden
    states, the summed MoE aux loss as an f32 scalar)."""
    def body(h, bp):
        h, _, a = block_fwd(bp, h, cfg, positions, mode="train")
        return h, a

    if remat:
        body = _remat(body, remat_policy)
    aux = torch.zeros((), device=x.device)
    for bp in params["blocks"]:
        x, a = body(x, bp)
        aux = aux + a
    return L.apply_norm(params["ln_f"], x), aux


def lm_forward_train(params, tokens, cfg: ModelConfig, *, remat=True,
                     prefix_embeds=None, remat_policy: str | None = "full"):
    """tokens: (B, S) -> (hidden (B, P + S, d), aux); a vlm's
    ``prefix_embeds`` (B, P, d) go before the tokens."""
    B = tokens.shape[0]
    x = L.embed(params["embed"], tokens, cfg)
    if prefix_embeds is not None:   # vlm: precomputed patch embeddings
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = _positions(B, x.shape[1], x.device)
    return lm_hidden(params, x, cfg, positions, remat=remat,
                     remat_policy=remat_policy)


def lm_init_cache(cfg: ModelConfig, B: int, S_: int, dtype, device=None,
                  like=None):
    """(k, v), each (L, B, S, KV, D); with MLA (c_kv, k_rope), (L, B, S,
    r) and (L, B, S, rope).  With ``like`` a DTensor, DTensors placed by
    :func:`cache_specs` on its mesh."""
    if cfg.mla:
        m = cfg.mla
        shapes = ((cfg.num_layers, B, S_, m.kv_lora_rank),
                  (cfg.num_layers, B, S_, m.qk_rope_head_dim))
    else:
        shapes = ((cfg.num_layers, B, S_, cfg.num_kv_heads,
                   cfg.head_dim),) * 2
    return tuple(_zeros(s, dtype, device, like, sp)
                 for s, sp in zip(shapes, cache_specs(cfg)))


@torch.no_grad()
def lm_prefill(params, tokens, cfg: ModelConfig, S_max: int,
               prefix_embeds=None):
    """tokens: (B, S) -> (logits of the last position (B, 1, V), cache):
    the cache is ``lm_init_cache``'s, zero past the prompt.  A vlm's
    ``prefix_embeds`` (B, P, d), precomputed patch embeddings, go before
    the tokens."""
    B = tokens.shape[0]
    x = L.embed(params["embed"], tokens, cfg)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    Sx = x.shape[1]
    positions = _positions(B, Sx, x.device)
    cache = lm_init_cache(cfg, B, S_max, x.dtype, x.device, like=x)
    for layer, bp in enumerate(params["blocks"]):
        x, kv, _ = block_fwd(bp, x, cfg, positions, mode="prefill")
        for c, t in zip(cache, kv):
            c[layer, :, :Sx] = t
    return _logits_last(params, x, cfg), cache


@torch.no_grad()
def lm_decode_step(params, token, cache, pos, cfg: ModelConfig):
    """token: (B, 1); cache: stacked over layers, written IN PLACE at
    each slot's position and returned; pos: an int or a (B,) vector."""
    x = L.embed(params["embed"], token, cfg)
    for layer, bp in enumerate(params["blocks"]):
        x, _, _ = block_fwd(bp, x, cfg, None, mode="decode",
                            cache=_select(cache, layer), pos=pos)
    x = L.apply_norm(params["ln_f"], x)
    return L.lm_logits(params["embed"], x, cfg), cache


# ======================================================================
# Family: ssm (xLSTM), alternating mLSTM/sLSTM pairs
# ======================================================================
class XLSTM(Params):
    """``embed``, ``pairs`` (each ``ln_m``, ``mlstm``, ``ln_s``,
    ``slstm``) and ``ln_f``."""


def init_xlstm(cfg: ModelConfig, generator: torch.Generator | None,
               device=None) -> XLSTM:
    """As :func:`init_lm`, for ``num_layers // 2`` (mLSTM, sLSTM)
    pairs."""
    device = resolve_device(device)
    gen = generator
    p = XLSTM()
    p["embed"] = _embed_init(cfg, gen, device)
    p["pairs"] = _stacked(cfg, cfg.num_layers // 2, lambda: Params(
        ln_m=L.init_norm(cfg, cfg.d_model, device),
        mlstm=S.init_mlstm(cfg, gen, device),
        ln_s=L.init_norm(cfg, cfg.d_model, device),
        slstm=S.init_slstm(cfg, gen, device)))
    p["ln_f"] = L.init_norm(cfg, cfg.d_model, device)
    return _f32_to(p, getattr(torch, cfg.dtype))


def _xlstm_pair_fwd(bp, x, cfg: ModelConfig, state=None):
    y, new_m = S.mlstm_fwd(bp["mlstm"], L.apply_norm(bp["ln_m"], x), cfg,
                           None if state is None else state[0])
    x = x + y
    y, new_s = S.slstm_fwd(bp["slstm"], L.apply_norm(bp["ln_s"], x), cfg,
                           None if state is None else state[1])
    return x + y, (new_m, new_s)


def xlstm_hidden(params, x, cfg: ModelConfig, *, remat=True):
    """The (mLSTM, sLSTM) pairs over ``x``, each pair recomputed in the
    backward pass when ``remat``; returns (hidden, 0.0 aux)."""
    body = _remat(lambda h, bp: _xlstm_pair_fwd(bp, h, cfg)[0],
                  "full" if remat else None)
    for bp in params["pairs"]:
        x = body(x, bp)
    return L.apply_norm(params["ln_f"], x), torch.zeros((), device=x.device)


def xlstm_forward_train(params, tokens, cfg: ModelConfig, *, remat=True,
                        prefix_embeds=None):
    x = L.embed(params["embed"], tokens, cfg)
    return xlstm_hidden(params, x, cfg, remat=remat)


def xlstm_init_state(cfg: ModelConfig, B: int, dtype, device=None,
                     like=None):
    """((conv (P, B, K-1, d_in), h (P, B, H, hd+1, hd)), (h, c, n, m) each
    (P, B, d)) over the P pairs; ``c, n, m`` in f32.  With ``like`` a
    DTensor, DTensors placed by :func:`cache_specs`."""
    n_pairs, d = cfg.num_layers // 2, cfg.d_model
    d_in = cfg.ssm_expand * d
    H = cfg.num_heads
    hd = d_in // H
    (conv_sp, h_sp), (s_sp, _, _, _) = cache_specs(cfg)

    def zeros(*shape, dt=dtype, sp=s_sp):
        return _zeros((n_pairs, B) + shape, dt, device, like, sp)

    return ((zeros(cfg.ssm_conv - 1, d_in, sp=conv_sp),
             zeros(H, hd + 1, hd, sp=h_sp)),
            (zeros(d), zeros(d, dt=torch.float32),
             zeros(d, dt=torch.float32) + 1, zeros(d, dt=torch.float32)))


@torch.no_grad()
def xlstm_prefill(params, tokens, cfg: ModelConfig, S_max: int):
    """tokens: (B, S) -> (logits of the last position, the recurrent
    states of ``xlstm_init_state``); ``S_max`` is unused (the states do
    not grow)."""
    x = L.embed(params["embed"], tokens, cfg)
    state = xlstm_init_state(cfg, x.shape[0], x.dtype, x.device, like=x)
    for i, bp in enumerate(params["pairs"]):
        x, st = _xlstm_pair_fwd(bp, x, cfg)
        _copy_into(_select(state, i), st)
    return _logits_last(params, x, cfg), state


@torch.no_grad()
def xlstm_decode_step(params, token, state, pos, cfg: ModelConfig):
    """One token through every pair; the states are updated IN PLACE and
    returned (``pos`` is unused)."""
    x = L.embed(params["embed"], token, cfg)
    for i, bp in enumerate(params["pairs"]):
        st = _select(state, i)
        x, new = _xlstm_pair_fwd(bp, x, cfg, st)
        _copy_into(st, new)
    x = L.apply_norm(params["ln_f"], x)
    return L.lm_logits(params["embed"], x, cfg), state


# ======================================================================
# Family: hybrid (zamba2), Mamba2 super-blocks + one shared attention block
# ======================================================================
class HybridLM(Params):
    """``embed``, ``mamba`` (``num_layers`` Mamba2 layers, each ``ln``
    and ``mamba``), ``shared`` (ONE :class:`Block`) and ``ln_f``."""


def _hybrid_shared_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg, d_ff=cfg.hybrid.shared_attn_d_ff or cfg.d_ff, moe=None,
        mla=None)


def init_hybrid(cfg: ModelConfig, generator: torch.Generator | None,
                device=None) -> HybridLM:
    """As :func:`init_lm`: ``n_super * period`` Mamba2 layers and the
    one shared attention block."""
    device = resolve_device(device)
    gen = generator
    period = cfg.hybrid.period
    p = HybridLM()
    p["embed"] = _embed_init(cfg, gen, device)
    p["mamba"] = _stacked(cfg, cfg.num_layers // period * period,
                          lambda: Params(
                              ln=L.init_norm(cfg, cfg.d_model, device),
                              mamba=S.init_mamba2(cfg, gen, device)))
    p["shared"] = init_block(_hybrid_shared_cfg(cfg), gen, device,
                             moe_layer=False)
    p["ln_f"] = L.init_norm(cfg, cfg.d_model, device)
    return _f32_to(p, getattr(torch, cfg.dtype))


def hybrid_init_state(cfg: ModelConfig, B: int, S_cache: int, dtype,
                      device=None, like=None):
    """((conv (n, P, B, K-1, d_in + 2N), h (n, P, B, H, hd, N)), (k, v)
    each (n, B, S, KV, D)) for n super-blocks of P Mamba2 layers: the
    Mamba leaves carry the batch on axis 2, the shared block's KV (one
    per application) on axis 1."""
    period = cfg.hybrid.period
    n_super = cfg.num_layers // period
    d_in, H, hd = S._mamba_dims(cfg)
    n = cfg.ssm_state
    lead = (n_super, period, B)
    kv = (n_super, B, S_cache, cfg.num_kv_heads, cfg.head_dim)
    shapes = ((lead + (cfg.ssm_conv - 1, d_in + 2 * n), lead + (H, hd, n)),
              (kv, kv))
    return tuple(tuple(_zeros(s, dtype, device, like, sp)
                       for s, sp in zip(pair, specs))
                 for pair, specs in zip(shapes, cache_specs(cfg)))


def _hybrid_layers(params, cfg: ModelConfig):
    """(super-block, index in it, Mamba2 layer) in order."""
    period = cfg.hybrid.period
    for i, ip in enumerate(params["mamba"]):
        yield i // period, i % period, ip


def hybrid_hidden(params, x, cfg: ModelConfig, positions, *, remat=True):
    """Super-blocks of ``period`` Mamba2 layers, each followed by the
    shared attention block, one super-block recomputed in the backward
    pass when ``remat``; returns (hidden, 0.0 aux)."""
    period, scfg = cfg.hybrid.period, _hybrid_shared_cfg(cfg)
    layers = list(params["mamba"])

    def super_body(h, *block):
        for ip in block:
            y, _ = S.mamba2_fwd(ip["mamba"], L.apply_norm(ip["ln"], h), cfg)
            h = h + y
        h, _, _ = block_fwd(params["shared"], h, scfg, positions,
                            mode="train")
        return h

    super_body = _remat(super_body, "full" if remat else None)
    for s in range(0, len(layers), period):
        x = super_body(x, *layers[s:s + period])
    return L.apply_norm(params["ln_f"], x), torch.zeros((), device=x.device)


def hybrid_forward_train(params, tokens, cfg: ModelConfig, *, remat=True,
                         prefix_embeds=None):
    B, S_ = tokens.shape
    x = L.embed(params["embed"], tokens, cfg)
    return hybrid_hidden(params, x, cfg, _positions(B, S_, x.device),
                         remat=remat)


@torch.no_grad()
def hybrid_prefill(params, tokens, cfg: ModelConfig, S_max: int):
    """tokens: (B, S) -> (logits of the last position, the state of
    ``hybrid_init_state`` with the prompt's KV, zero past it)."""
    B, S_ = tokens.shape
    period, scfg = cfg.hybrid.period, _hybrid_shared_cfg(cfg)
    x = L.embed(params["embed"], tokens, cfg)
    positions = _positions(B, S_, x.device)
    (conv, h), kv = state = hybrid_init_state(cfg, B, S_max, x.dtype,
                                              x.device, like=x)
    for s, j, ip in _hybrid_layers(params, cfg):
        y, (c1, h1) = S.mamba2_fwd(ip["mamba"], L.apply_norm(ip["ln"], x),
                                   cfg)
        x = x + y
        conv[s, j], h[s, j] = c1, h1
        if j == period - 1:
            x, new_kv, _ = block_fwd(params["shared"], x, scfg, positions,
                                     mode="prefill")
            for c, t in zip(kv, new_kv):
                c[s, :, :S_] = t
    return _logits_last(params, x, cfg), state


@torch.no_grad()
def hybrid_decode_step(params, token, state, pos, cfg: ModelConfig):
    """One token: each Mamba2 layer's recurrent step and each
    application of the shared block against its own KV, all updated IN
    PLACE; returns the state given."""
    period, scfg = cfg.hybrid.period, _hybrid_shared_cfg(cfg)
    mamba_state, kv = state
    x = L.embed(params["embed"], token, cfg)
    for s, j, ip in _hybrid_layers(params, cfg):
        st = _select(mamba_state, s, j)
        y, new = S.mamba2_fwd(ip["mamba"], L.apply_norm(ip["ln"], x), cfg,
                              state=st)
        x = x + y
        _copy_into(st, new)
        if j == period - 1:
            x, _, _ = block_fwd(params["shared"], x, scfg, None,
                                mode="decode", cache=_select(kv, s),
                                pos=pos)
    x = L.apply_norm(params["ln_f"], x)
    return L.lm_logits(params["embed"], x, cfg), state


# ======================================================================
# Family: audio (whisper), encoder-decoder with a stub frontend
# ======================================================================
class EncDec(Params):
    """``embed``, ``enc`` (each ``ln1``, ``attn``, ``ln2``, ``mlp``),
    ``dec`` (cross-attention :class:`Block`s), ``ln_enc`` and
    ``ln_f``."""


def init_encdec(cfg: ModelConfig, generator: torch.Generator | None,
                device=None) -> EncDec:
    """As :func:`init_lm`: ``enc_layers`` encoder blocks and
    ``num_layers`` decoder blocks with cross-attention."""
    device = resolve_device(device)
    gen = generator
    p = EncDec()
    p["embed"] = _embed_init(cfg, gen, device)
    p["enc"] = _stacked(cfg, cfg.enc_layers, lambda: Params(
        ln1=L.init_norm(cfg, cfg.d_model, device),
        attn=L.init_attention(cfg, gen, device),
        ln2=L.init_norm(cfg, cfg.d_model, device),
        mlp=L.init_mlp(cfg.d_model, cfg.d_ff, gen, device)))
    p["dec"] = _stacked(cfg, cfg.num_layers,
                        lambda: init_block(cfg, gen, device, cross=True))
    p["ln_enc"] = L.init_norm(cfg, cfg.d_model, device)
    p["ln_f"] = L.init_norm(cfg, cfg.d_model, device)
    return _f32_to(p, getattr(torch, cfg.dtype))


def encode(params, frames, cfg: ModelConfig):
    """frames: precomputed frame embeddings (B, S_enc, d), the stub
    frontend; non-causal self-attention.  Differentiable: training's
    gradient reaches the encoder through it."""
    B, Se, _ = frames.shape
    positions = _positions(B, Se, frames.device)
    x = frames.to(getattr(torch, cfg.dtype))
    for bp in params["enc"]:
        x = x + L.attention_fwd(bp["attn"], L.apply_norm(bp["ln1"], x), cfg,
                                positions, causal=False)
        x = x + L.mlp_fwd(bp["mlp"], L.apply_norm(bp["ln2"], x))
    return L.apply_norm(params["ln_enc"], x)


def encdec_forward_train(params, batch, cfg: ModelConfig, *, remat=True):
    """batch: (frames (B, S_enc, d), decoder tokens (B, S)) -> (decoder
    hidden, 0.0 aux); each decoder block recomputed in the backward pass
    when ``remat`` (the encoder is not, as in the reference)."""
    frames, dec_tokens = batch
    enc_out = encode(params, frames, cfg)
    B, Sd = dec_tokens.shape
    positions = _positions(B, Sd, enc_out.device)
    x = L.embed(params["embed"], dec_tokens, cfg)

    def body(h, bp):
        kv = L.encode_kv(bp["xattn"], enc_out, cfg)
        return block_fwd(bp, h, cfg, positions, mode="train", enc_kv=kv)[0]

    body = _remat(body, "full" if remat else None)
    for bp in params["dec"]:
        x = body(x, bp)
    return L.apply_norm(params["ln_f"], x), torch.zeros((), device=x.device)


@torch.no_grad()
def encdec_prefill(params, batch, cfg: ModelConfig, S_max: int):
    """batch: (frames (B, S_enc, d), decoder prompt (B, S)) -> (logits of
    the last position, cache): the cache is ((k, v) of self-attention,
    each (L, B, min(S_max, dec_max_len), KV, D) and zero past the
    prompt, (k, v) of the encoder output, each (L, B, S_enc, KV, D))."""
    frames, dec_tokens = batch
    enc_out = encode(params, frames, cfg)
    B, Sd = dec_tokens.shape
    positions = _positions(B, Sd, enc_out.device)
    x = L.embed(params["embed"], dec_tokens, cfg)
    S_dec = min(S_max, cfg.dec_max_len)
    shape = (cfg.num_layers, B, S_dec, cfg.num_kv_heads, cfg.head_dim)
    self_kv = tuple(_zeros(shape, x.dtype, x.device, x, sp)
                    for sp in cache_specs(cfg)[0])
    cross = []
    for layer, bp in enumerate(params["dec"]):
        xkv = L.encode_kv(bp["xattn"], enc_out, cfg)
        x, kv, _ = block_fwd(bp, x, cfg, positions, mode="prefill",
                             enc_kv=xkv)
        for c, t in zip(self_kv, kv):
            c[layer, :, :Sd] = t
        cross.append(xkv)
    cross_kv = tuple(torch.stack([c[i] for c in cross]) for i in range(2))
    return _logits_last(params, x, cfg), (self_kv, cross_kv)


@torch.no_grad()
def encdec_decode_step(params, token, cache, pos, cfg: ModelConfig):
    """token: (B, 1); cache: ``encdec_prefill``'s, its self-attention KV
    written IN PLACE and returned; pos: an int or a (B,) vector."""
    self_kv, cross_kv = cache
    x = L.embed(params["embed"], token, cfg)
    for layer, bp in enumerate(params["dec"]):
        x, _, _ = block_fwd(bp, x, cfg, None, mode="decode",
                            cache=_select(self_kv, layer), pos=pos,
                            enc_kv=_select(cross_kv, layer))
    x = L.apply_norm(params["ln_f"], x)
    return L.lm_logits(params["embed"], x, cfg), cache


# ======================================================================
# Loss: sequence-chunked cross entropy
# ======================================================================
def lm_loss_from_hidden(params, hidden, targets, cfg: ModelConfig,
                        chunk: int = 512):
    """hidden: (B, S, d); targets: (B, S) -> the mean cross entropy, f32.
    Walks chunks of the sequence (the largest divisor of S not above
    ``chunk``), so the f32 logits of one chunk are live at a time in
    the forward pass."""
    B, Sq, _ = hidden.shape
    chunk = min(chunk, Sq)
    while Sq % chunk:       # largest divisor of Sq not above the target
        chunk -= 1
    total = torch.zeros((), device=hidden.device)
    for c0 in range(0, Sq, chunk):
        logits = L.lm_logits(params["embed"], hidden[:, c0:c0 + chunk],
                             cfg).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, targets[:, c0:c0 + chunk, None].long())[..., 0]
        total = total + (lse - ll).sum()
    return total / (B * Sq)


# ======================================================================
# Family dispatch
# ======================================================================
@dataclasses.dataclass(frozen=True)
class ModelApi:
    init: Any               # (cfg, generator, device) -> module
    forward_train: Any      # (params, inputs, cfg) -> (hidden, aux)
    prefill: Any            # (params, inputs, cfg, S_max) -> (logits, cache)
    decode_step: Any        # (params, token, cache, pos, cfg)
    #: the batch axis of each leaf of the cache, as a tree of ints
    #: shaped like the cache (the serving loop splices along it)
    batch_axes: Any = (1, 1)


def get_api(cfg: ModelConfig) -> ModelApi:
    if cfg.enc_dec:
        return ModelApi(init_encdec, encdec_forward_train, encdec_prefill,
                        encdec_decode_step, ((1, 1), (1, 1)))
    if cfg.family == "ssm":
        return ModelApi(init_xlstm, xlstm_forward_train, xlstm_prefill,
                        xlstm_decode_step, ((1, 1), (1, 1, 1, 1)))
    if cfg.family == "hybrid":
        return ModelApi(init_hybrid, hybrid_forward_train, hybrid_prefill,
                        hybrid_decode_step, ((2, 2), (1, 1)))
    return ModelApi(init_lm, lm_forward_train, lm_prefill, lm_decode_step)
