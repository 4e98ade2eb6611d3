"""whisper-base [audio]: 6L d_model=512 8H d_ff=2048 vocab=51865 —
encoder-decoder; conv frontend is a STUB (input_specs provides
precomputed frame embeddings).  Decoder max target length 448.
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    enc_dec=True, enc_layers=6, dec_max_len=448,
    norm="layernorm", rotary_pct=0.0,   # whisper uses learned/sinusoidal
    frontend="audio_stub",
)

REDUCED = ModelConfig(
    name="whisper-base-reduced", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512,
    enc_dec=True, enc_layers=2, dec_max_len=32,
    norm="layernorm", rotary_pct=0.0, frontend="audio_stub",
    dtype="float32",
)
