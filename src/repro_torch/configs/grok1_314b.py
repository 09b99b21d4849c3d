"""grok-1-314b — large MoE, 8 experts top-2, attention logit capping.

[hf:xai-org/grok-1; unverified]  64L d_model=6144 48H (kv=8) d_ff=32768
vocab=131072, head_dim=128.
"""
from repro_torch.config.arch import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    n_experts=8,
    experts_per_token=2,
    attn_softcap=30.0,
    rope_theta=10000.0,
    source="hf:xai-org/grok-1",
)
