"""zamba2-7b [hybrid]: 81L d_model=3584 32H d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 backbone with ONE shared attention block applied
every 6 layers (13 applications + 3 trailing mamba layers folded into the
last super-block period; we use 78 = 13 x 6 mamba layers + 13 shared-attn
applications, noted in DESIGN.md).  Sub-quadratic: runs long_500k with a
4096-token window on the shared attention (adaptation noted).
[arXiv:2411.15242; unverified]"""
from repro_torch.models.config import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=78, d_model=3584, num_heads=32, num_kv_heads=32,
    head_dim=112, d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2,
    hybrid=HybridConfig(period=6, shared_attn_d_ff=14336),
    attn_window=4096,
)

REDUCED = ModelConfig(
    name="zamba2-7b-reduced", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    hybrid=HybridConfig(period=2, shared_attn_d_ff=128),
    attn_window=0, dtype="float32",
)
