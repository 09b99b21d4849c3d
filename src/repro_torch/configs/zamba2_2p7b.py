"""zamba2-2.7b — hybrid Mamba2 + attention blocks.

[arXiv:2411.15242; hf]  54L d_model=2560 32H (kv=32, MHA) d_ff=10240
vocab=32000, ssm_state=64.  The hybrid stack is modelled as Mamba2 blocks
with a full attention block every 6 blocks (zamba2 interleaves shared
attention at a similar rate; here each attention block has weights of its
own), as the JAX package models it.
"""
from repro_torch.config.arch import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_headdim=64,
    hybrid_attn_every=6,
    rope_theta=10000.0,
    source="arXiv:2411.15242",
)
