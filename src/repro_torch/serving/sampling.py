"""Token sampling (greedy / temperature)."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, *, temperature: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits (B, 1, V) -> (B,) int32: argmax, or a draw from
    softmax(logits / temperature) with ``generator``."""
    lg = logits[:, -1, :]
    if temperature <= 0.0:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    probs = torch.softmax(lg.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
