"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — GQA, no-bias, parallel attention/FFN blocks, layernorm.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000,
    qkv_bias=False, parallel_block=True, norm="layernorm",
    rope_theta=8_000_000.0,
)

REDUCED = ModelConfig(
    name="command-r-35b-reduced", family="dense",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=352, vocab_size=512,
    qkv_bias=False, parallel_block=True, norm="layernorm",
    dtype="float32",
)
