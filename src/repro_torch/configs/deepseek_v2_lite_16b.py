"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400 — MLA kv_lora=512, MoE 2 shared + 64 routed top-6.
(The assignment note says "160 routed"; the published DeepSeek-V2-Lite
config has 64 routed experts — we follow the 64e figure also given in the
assignment header.)  [arXiv:2405.04434; hf]"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=128, d_ff=10944, vocab_size=102400,
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408,
                  num_shared_experts=2, shared_d_ff=1408),
)

REDUCED = ModelConfig(
    name="deepseek-v2-lite-reduced", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=256, vocab_size=512,
    mla=MLAConfig(kv_lora_rank=64, qk_nope_head_dim=32,
                  qk_rope_head_dim=16, v_head_dim=32),
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=64,
                  num_shared_experts=2, shared_d_ff=64),
    dtype="float32",
)
