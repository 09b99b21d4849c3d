"""gemma2-9b — dense GQA, alternating local/global attention, logit softcap.

[arXiv:2408.00118; hf]  42L d_model=3584 16H (kv=8) d_ff=14336 vocab=256000,
head_dim=256, sliding window 4096 on local layers, attn softcap 50, final
logit softcap 30, GeGLU FFN, tied + scaled embeddings, post-attn/ffn norms.
"""
from repro_torch.config.arch import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    rope_theta=10000.0,
    local_window=4096,
    layer_pattern="LG",
    logit_softcap=30.0,
    attn_softcap=50.0,
    ffn_activation="gelu",
    ffn_glu=True,
    tie_embeddings=True,
    embedding_scale=True,
    post_attn_norm=True,
    source="arXiv:2408.00118",
)
