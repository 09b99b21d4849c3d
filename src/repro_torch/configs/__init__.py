"""Architecture registry: the paper's own evaluation models (§6), the
dense assigned models (qwen2-7b, qwen2.5-14b, starcoder2-15b, gemma2-9b),
the MoE models (granite-moe-1b-a400m, grok-1-314b), the VLM backbone
(internvl2-26b), falcon-mamba-7b (the ``ssm`` family), zamba2-2.7b
(the ``hybrid`` family) and whisper-medium (the encoder-decoder
family)."""
from __future__ import annotations

from typing import Dict

from repro_torch.config.arch import ArchConfig
from repro_torch.configs.falcon_mamba_7b import CONFIG as FALCON_MAMBA_7B
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.granite_moe_1b import CONFIG as GRANITE_MOE_1B
from repro_torch.configs.grok1_314b import CONFIG as GROK1_314B
from repro_torch.configs.internvl2_26b import CONFIG as INTERNVL2_26B
from repro_torch.configs.paper_models import LLAMA2_13B, LLAMA2_7B, OPT_30B
from repro_torch.configs.qwen2_7b import CONFIG as QWEN2_7B
from repro_torch.configs.qwen2p5_14b import CONFIG as QWEN2P5_14B
from repro_torch.configs.starcoder2_15b import CONFIG as STARCODER2_15B
from repro_torch.configs.whisper_medium import CONFIG as WHISPER_MEDIUM
from repro_torch.configs.zamba2_2p7b import CONFIG as ZAMBA2_2P7B

# the dry-run's assigned grid (``launch/dryrun.py``), in the JAX
# package's order
ASSIGNED: Dict[str, ArchConfig] = {
    c.name: c for c in (
        WHISPER_MEDIUM, ZAMBA2_2P7B, QWEN2_7B, STARCODER2_15B, GEMMA2_9B,
        QWEN2P5_14B, GRANITE_MOE_1B, GROK1_314B, INTERNVL2_26B,
        FALCON_MAMBA_7B,
    )
}

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in (LLAMA2_7B, LLAMA2_13B, OPT_30B, FALCON_MAMBA_7B,
                        QWEN2_7B, QWEN2P5_14B, STARCODER2_15B, GEMMA2_9B,
                        GRANITE_MOE_1B, GROK1_314B, INTERNVL2_26B, ZAMBA2_2P7B,
                        WHISPER_MEDIUM)
}


def get_arch(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]
