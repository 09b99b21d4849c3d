"""granite-moe-1b-a400m — fine-grained MoE, 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]  24L d_model=1024 16H (kv=8)
d_ff=512 (per expert) vocab=49155.
"""
from repro_torch.config.arch import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=32,
    experts_per_token=8,
    tie_embeddings=True,
    rope_theta=10000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
