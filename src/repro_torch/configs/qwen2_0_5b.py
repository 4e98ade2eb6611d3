"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA, QKV bias, tied embeddings. [arXiv:2407.10671; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="qwen2-0.5b-reduced", family="dense",
    num_layers=2, d_model=112, num_heads=7, num_kv_heads=1,
    d_ff=304, vocab_size=512,
    qkv_bias=True, tie_embeddings=True, dtype="float32",
)
