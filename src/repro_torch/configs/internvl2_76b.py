"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — LM backbone only (llama-3-70b-style); the InternViT
frontend is a STUB: input_specs provides precomputed patch embeddings
prepended to the token sequence.  [arXiv:2404.16821; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=28672, vocab_size=128256,
    rope_theta=500_000.0, frontend="vision_stub",
)

REDUCED = ModelConfig(
    name="internvl2-76b-reduced", family="vlm",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    head_dim=16, d_ff=448, vocab_size=512,
    frontend="vision_stub", dtype="float32",
)
