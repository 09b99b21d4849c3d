"""The paper's own evaluation models (§6): Llama2-7B/13B, OPT-30B.

These drive the analytical replications of the paper's figures
(benchmarks/). All three are MHA — the paper's primary regime.
"""
from repro_torch.config.arch import ArchConfig

LLAMA2_7B = ArchConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    source="arXiv:2307.09288",
)

LLAMA2_13B = ArchConfig(
    name="llama2-13b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=13824,
    vocab_size=32000,
    source="arXiv:2307.09288",
)

OPT_30B = ArchConfig(
    name="opt-30b",
    family="dense",
    n_layers=48,
    d_model=7168,
    n_heads=56,
    n_kv_heads=56,
    d_ff=28672,
    vocab_size=50272,
    use_rope=False,
    ffn_activation="relu",
    ffn_glu=False,
    norm="layernorm",
    norm_eps=1e-5,
    source="arXiv:2205.01068",
)
