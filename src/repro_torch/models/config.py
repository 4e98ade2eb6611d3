"""Unified model configuration covering all 10 assigned architectures.

One dataclass, many families: dense decoder LMs (GQA, optional QKV-bias,
qk_norm, parallel blocks), MoE (top-k routed + shared experts), MLA
(DeepSeek low-rank KV), encoder-decoder (whisper), xLSTM (mLSTM/sLSTM),
and Mamba2 hybrids (zamba2 shared-attention pattern).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["attn", "mamba2", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    #: apply MoE every k-th layer (1 = all layers)
    every: int = 1


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """zamba2-style: `period` SSM blocks followed by one SHARED attention
    block (parameters shared across all its applications)."""
    period: int = 6
    shared_attn_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "audio", "ssm", "vlm", "hybrid"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    # --- attention details ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0
    attn_window: int = 0               # 0 = full causal attention
    parallel_block: bool = False       # command-r style parallel attn+ffn
    #: fuse the parallel block's two output projections into one matmul
    #: (PaLM-style): one TP all-reduce per layer instead of two
    fused_proj: bool = False
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    tie_embeddings: bool = False
    # --- families ---
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    hybrid: HybridConfig | None = None
    block_pattern: tuple[BlockKind, ...] = ()   # xlstm: ("mlstm","slstm")
    # --- ssm ---
    ssm_state: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    # --- encoder-decoder (whisper) ---
    enc_dec: bool = False
    enc_layers: int = 0
    dec_max_len: int = 448
    # --- modality frontend stub ---
    frontend: Literal["none", "audio_stub", "vision_stub"] = "none"
    #: dtype for parameters/activations in the compiled step
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        assert self.num_heads % self.num_kv_heads == 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid families)."""
        return self.family in ("ssm", "hybrid")

    def block_kind(self, layer: int) -> BlockKind:
        if self.block_pattern:
            return self.block_pattern[layer % len(self.block_pattern)]
        if self.family in ("ssm",):
            return "mlstm"
        if self.family == "hybrid":
            return "mamba2"
        return "attn"

    def is_moe_layer(self, layer: int) -> bool:
        return self.moe is not None and (layer % self.moe.every == 0)

    # rough parameter count (embeddings + blocks), for reporting
    def param_count(self) -> int:
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        for layer in range(self.num_layers):
            kind = self.block_kind(layer)
            if kind == "attn":
                if self.mla:
                    m = self.mla
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    total += m.kv_lora_rank * self.num_heads * (
                        m.qk_nope_head_dim + m.v_head_dim)
                    total += d * self.num_heads * (
                        m.qk_nope_head_dim + m.qk_rope_head_dim)
                    total += self.num_heads * m.v_head_dim * d
                else:
                    total += d * (self.q_dim + 2 * self.kv_dim) \
                        + self.q_dim * d
            elif kind == "mamba2":
                di = self.ssm_expand * d
                total += d * 2 * di + di * d + di * (2 * self.ssm_state + 3)
            else:  # xlstm blocks
                di = self.ssm_expand * d
                total += 2 * d * di + di * d
            if kind == "attn" or self.family not in ("ssm",):
                if self.is_moe_layer(layer):
                    m = self.moe
                    total += m.num_experts * 3 * d * m.expert_d_ff
                    total += m.num_shared_experts * 3 * d * m.shared_d_ff
                    total += d * m.num_experts
                elif self.d_ff:
                    total += 3 * d * self.d_ff
        if self.hybrid and self.hybrid.shared_attn_d_ff:
            total += (self.d_model * (self.q_dim + 2 * self.kv_dim)
                      + self.q_dim * self.d_model
                      + 3 * self.d_model * self.hybrid.shared_attn_d_ff)
        if self.enc_dec:
            # encoder blocks + cross-attention in decoder
            total += self.enc_layers * (4 * d * d + 3 * d * self.d_ff)
            total += self.num_layers * 4 * d * d
        return total
