"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 —
alternating mLSTM (matrix memory) + sLSTM (scalar memory) blocks;
O(1)-state decode -> eligible for long_500k.  [arXiv:2405.04517]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "slstm"), ssm_expand=2, ssm_conv=4,
)

REDUCED = ModelConfig(
    name="xlstm-350m-reduced", family="ssm",
    num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
    d_ff=0, vocab_size=512,
    block_pattern=("mlstm", "slstm"), ssm_expand=2, ssm_conv=4,
    dtype="float32",
)
