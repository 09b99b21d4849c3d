"""Architecture registry: the paper's own evaluation models (§6) and
falcon-mamba-7b (the ``ssm`` family)."""
from __future__ import annotations

from typing import Dict

from repro_torch.config.arch import ArchConfig
from repro_torch.configs.falcon_mamba_7b import CONFIG as FALCON_MAMBA_7B
from repro_torch.configs.paper_models import LLAMA2_13B, LLAMA2_7B, OPT_30B

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in (LLAMA2_7B, LLAMA2_13B, OPT_30B, FALCON_MAMBA_7B)
}


def get_arch(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]
