"""Model assembly of the dense decoder-only family (the dense / vlm LM of
the JAX package's ``models/transformer.py``), for serving.

A :class:`DecoderLM` holds the embedding, an ``nn.ModuleList`` of
:class:`Block`s (in place of the reference's ``lax.scan`` over stacked
blocks) and the final norm.  Parameter names equal the reference's dict
keys, so its path ``("blocks", "attn", "wq")[l]`` is the state-dict key
``blocks.{l}.attn.wq`` (``interop.params_from_reference`` carries
weights across).  The family provides init, prefill, decode_step and
init_cache; the other families (moe/MLA, ssm, hybrid, enc-dec) and
training come with later slices (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..core.device import resolve_device
from . import layers as L
from .config import ModelConfig
from .layers import Params

#: where the families and the training step not ported yet stand
_LATER = "ROADMAP Queue 1 item 14"


def _f32_to(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every f32 weight in ``dtype`` (as the reference's ``_f32_to``)."""
    for prm in module.parameters():
        if prm.dtype == torch.float32:
            prm.data = prm.data.to(dtype)
    return module


# ======================================================================
# Decoder block (attn + mlp)
# ======================================================================
class Block(Params):
    """One decoder block: ``ln1``, ``attn``, ``ln2`` (not in a parallel
    block), ``mlp`` and, for a fused parallel block, ``w_fused`` in place
    of the two output projections."""


def init_block(cfg: ModelConfig, gen: torch.Generator, device=None) -> Block:
    if cfg.mla is not None or cfg.moe is not None:
        raise NotImplementedError(f"MLA and MoE blocks are not ported yet "
                                  f"({_LATER})")
    p = Block()
    p["ln1"] = L.init_norm(cfg, cfg.d_model, device)
    p["attn"] = L.init_attention(cfg, gen, device)
    if not cfg.parallel_block:
        p["ln2"] = L.init_norm(cfg, cfg.d_model, device)
    p["mlp"] = L.init_mlp(cfg.d_model, cfg.d_ff, gen, device)
    if cfg.parallel_block and cfg.fused_proj:
        # PaLM-style fusion: [attn_heads ; ffn_hidden] @ W_fused; the
        # separate output projections are dropped
        del p["attn"].wo, p["mlp"].wo
        p["w_fused"] = L._init(gen, (cfg.q_dim + cfg.d_ff, cfg.d_model),
                               device=device)
    return p


def block_fwd(p, x, cfg: ModelConfig, positions, *, mode="prefill",
              cache=None, pos=None):
    """mode: prefill | decode.  Returns (x, new_cache); the reference's
    third value, the MoE auxiliary loss, comes with the MoE family."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"block mode {mode!r} (training) is not "
                                  f"ported yet ({_LATER})")
    h = L.apply_norm(p["ln1"], x)
    project = "w_fused" not in p
    if mode == "prefill":
        a, new_cache = L.attention_prefill(p["attn"], h, cfg, positions,
                                           project=project)
    else:
        a, new_cache = L.attention_decode(p["attn"], h, cache, cfg, pos,
                                          project=project)
    if not project:
        # fused parallel block: one contraction for both outputs
        fused = torch.cat([a, L.mlp_hidden(p["mlp"], h)], dim=-1) \
            @ p["w_fused"].to(x.dtype)
        return x + fused, new_cache
    if cfg.parallel_block:
        # command-r: attention and FFN read the same norm, summed
        return x + a + L.mlp_fwd(p["mlp"], h), new_cache
    x = x + a
    x = x + L.mlp_fwd(p["mlp"], L.apply_norm(p["ln2"], x))
    return x, new_cache


# ======================================================================
# Family: dense / vlm decoder-only LM
# ======================================================================
class DecoderLM(Params):
    """``embed`` (``tok``, and ``head`` when untied), ``blocks`` (an
    ``nn.ModuleList`` of :class:`Block`) and ``ln_f``."""


def init_lm(cfg: ModelConfig, generator: torch.Generator | None,
            device=None) -> DecoderLM:
    """Random weights drawn from ``generator`` (a generator on
    ``device``) in the reference's shapes and scales, f32 weights then
    cast to ``cfg.dtype``.  ``device`` follows the device rule: None is
    the CUDA card, the CPU only when asked for.  With no generator the
    weights are left uninitialised: a skeleton to be filled
    (``interop.params_from_reference`` builds one on the meta device)."""
    if cfg.family not in ("dense", "vlm") or cfg.enc_dec:
        raise NotImplementedError(f"the {cfg.family} family is not ported "
                                  f"yet ({_LATER})")
    device = resolve_device(device)
    gen = generator
    p = DecoderLM()
    p["embed"] = L.init_embedding(cfg, gen, device)
    p["blocks"] = nn.ModuleList([init_block(cfg, gen, device)
                                 for _ in range(cfg.num_layers)])
    p["ln_f"] = L.init_norm(cfg, cfg.d_model, device)
    return _f32_to(p, getattr(torch, cfg.dtype))


def lm_forward_train(params, tokens, cfg: ModelConfig, **_kw):
    raise NotImplementedError(f"training is not ported yet ({_LATER})")


def lm_init_cache(cfg: ModelConfig, B: int, S: int, dtype, device=None):
    shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


@torch.no_grad()
def lm_prefill(params, tokens, cfg: ModelConfig, S_max: int,
               prefix_embeds=None):
    """tokens: (B, S) -> (logits of the last position (B, 1, V), cache):
    the cache is (k, v), each (L, B, S_max, KV, D) and zero past the
    prompt."""
    B = tokens.shape[0]
    x = L.embed(params["embed"], tokens, cfg)
    if prefix_embeds is not None:   # vlm: precomputed patch embeddings
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    Sx = x.shape[1]
    positions = torch.arange(Sx, device=x.device).expand(B, Sx)
    k0, v0 = lm_init_cache(cfg, B, S_max, x.dtype, x.device)
    for layer, bp in enumerate(params["blocks"]):
        x, (k, v) = block_fwd(bp, x, cfg, positions, mode="prefill")
        k0[layer, :, :Sx] = k
        v0[layer, :, :Sx] = v
    x = L.apply_norm(params["ln_f"], x)
    return L.lm_logits(params["embed"], x[:, -1:, :], cfg), (k0, v0)


@torch.no_grad()
def lm_decode_step(params, token, cache, pos, cfg: ModelConfig):
    """token: (B, 1); cache: (k, v) stacked over layers, written IN PLACE
    at each slot's position and returned; pos: an int or a (B,)
    vector."""
    x = L.embed(params["embed"], token, cfg)
    k_cache, v_cache = cache
    for layer, bp in enumerate(params["blocks"]):
        x, _ = block_fwd(bp, x, cfg, None, mode="decode",
                         cache=(k_cache[layer], v_cache[layer]), pos=pos)
    x = L.apply_norm(params["ln_f"], x)
    return L.lm_logits(params["embed"], x, cfg), cache


# ======================================================================
# Family dispatch
# ======================================================================
@dataclasses.dataclass(frozen=True)
class ModelApi:
    init: Any               # (cfg, generator, device) -> module
    forward_train: Any      # not ported yet: raises
    prefill: Any            # (params, tokens, cfg, S_max) -> (logits, cache)
    decode_step: Any        # (params, token, cache, pos, cfg)


def get_api(cfg: ModelConfig) -> ModelApi:
    if cfg.enc_dec:
        raise NotImplementedError(f"the enc-dec family is not ported yet "
                                  f"({_LATER})")
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(f"the {cfg.family} family is not ported "
                                  f"yet ({_LATER})")
    if cfg.moe is not None or cfg.mla is not None:
        raise NotImplementedError(f"MoE and MLA models are not ported yet "
                                  f"({_LATER})")
    return ModelApi(init_lm, lm_forward_train, lm_prefill, lm_decode_step)
