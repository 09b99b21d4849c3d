"""internvl2-26b — VLM: InternViT frontend (stubbed) + InternLM2-20B backbone.

[arXiv:2404.16821; hf]  48L d_model=6144 48H (kv=8) d_ff=16384 vocab=92553.
The ViT frontend is a stub: ``input_specs()`` provides precomputed patch
embeddings that occupy the first ``n_vis`` positions of the sequence.
"""
from repro_torch.config.arch import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1e6,
    frontend="vit_patch",
    frontend_dim=256,           # number of visual patch positions per request
    source="arXiv:2404.16821",
)
