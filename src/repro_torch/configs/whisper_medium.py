"""whisper-medium — enc-dec audio transformer, MHA, conv frontend stubbed.

[arXiv:2212.04356; unverified]  24L d_model=1024 16H (kv=16) d_ff=4096
vocab=51865.  Whisper uses LayerNorm + GELU non-GLU FFNs and learned
positions (no RoPE).  The audio conv frontend is a stub: a request carries
precomputed frame embeddings (S_enc, d_model), which feed the encoder
directly.
"""
from repro_torch.config.arch import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    use_rope=False,
    ffn_activation="gelu",
    ffn_glu=False,
    norm="layernorm",
    norm_eps=1e-5,
    is_encoder_decoder=True,
    encoder_layers=24,
    # expanded beyond whisper's 1500 for the assigned shapes
    max_source_positions=32768,
    frontend="audio_conv",
    frontend_dim=128,             # mel bins (stubbed)
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
