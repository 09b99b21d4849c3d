"""falcon-mamba-7b — pure Mamba1 SSM LM (attention-free).

[arXiv:2410.05355; unverified]  64L d_model=4096 d_ff=0 vocab=65024,
ssm_state=16, expand=2 (inner 8192), dt_rank = d_model/16 = 256.

HCache applicability: no KV cache exists. The planner assigns every
Mamba1 layer the ``kv`` method, whose per-layer restore is a no-op here;
the session's whole recurrent state (conv and ssm) is saved and restored
as one state blob (``core/hcache.py``, ``core/restoration.py``).
"""
from repro_torch.config.arch import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    use_rope=False,
    source="arXiv:2410.05355",
)
