"""Causal / non-causal flash attention (K4, ``flash_attention``),
hand-written in CUDA for Hopper: online softmax over key tiles, the
score matrix never stored."""
from .ops import flash_attention, flash_attention_plain
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_ref"]
