"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 16 experts top-1 + 1 shared expert — early
fusion (vision frontend stubbed to text-only here).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=202048,
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=1, expert_d_ff=8192,
                  num_shared_experts=1, shared_d_ff=8192),
)

REDUCED = ModelConfig(
    name="llama4-scout-reduced", family="moe",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    head_dim=16, d_ff=256, vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=1, expert_d_ff=256,
                  num_shared_experts=1, shared_d_ff=256),
    dtype="float32",
)
