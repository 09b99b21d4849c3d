"""Assigned input shapes.

Each architecture is exercised against all four LM shapes; ``decode_*`` and
``long_*`` lower ``serve_step`` (one new token against a KV cache of
``seq_len``), not ``train_step``.  ``long_500k`` runs only for sub-quadratic
archs (ssm / hybrid) — the skip list lives here so the dry-run, roofline and
docs all agree on it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.config.arch import ArchConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")
# extra (not part of the assigned 40-cell grid): the paper's restoration op
# at production scale — 32 sessions × 32k-token histories
RESTORE_32K = InputShape("restore_32k", 32768, 32, "restore")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES + (RESTORE_32K,)}

# Families with a sub-quadratic (state-space / linear-time) sequence path.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ArchConfig, shape: InputShape) -> Optional[str]:
    """Return None if the (arch, shape) cell runs, else a skip reason."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return ("pure full-attention arch: 500k decode has no sub-quadratic "
                "path (skip per assignment; see DESIGN.md)")
    return None


def cells_for(cfg: ArchConfig):
    """All applicable (shape, skip_reason) rows for an arch — 40-cell table."""
    return [(s, shape_applicable(cfg, s)) for s in ALL_SHAPES]
