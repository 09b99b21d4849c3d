from repro_torch.config.arch import (ArchConfig, AttnKind, BlockKind,
                                     reduced_for_smoke)
from repro_torch.config.hardware import PAPER_H800, PROFILES, HardwareProfile

__all__ = ["ArchConfig", "AttnKind", "BlockKind", "reduced_for_smoke",
           "PAPER_H800", "PROFILES", "HardwareProfile"]
