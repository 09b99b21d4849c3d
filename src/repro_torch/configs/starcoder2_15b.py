"""starcoder2-15b — dense GQA code model, RoPE, LayerNorm + non-GLU GELU FFN.

[arXiv:2402.19173; hf]  40L d_model=6144 48H (kv=4) d_ff=24576 vocab=49152.
"""
from repro_torch.config.arch import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    qkv_bias=True,
    rope_theta=1e5,
    ffn_activation="gelu",
    ffn_glu=False,
    norm="layernorm",
    norm_eps=1e-5,
    source="arXiv:2402.19173",
)
