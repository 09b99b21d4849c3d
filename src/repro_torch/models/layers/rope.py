"""Rotary position embeddings (llama-style rotate-half) and sinusoidal
absolute positions (the whisper encoder)."""
from __future__ import annotations

import math

import torch


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) -> cos, sin of shape (..., S, head_dim//2), fp32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (B, S, H, hd); cos/sin (B, S, hd/2) fp32 -> x rotated, x's dtype."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_table(n_pos: int, head_dim: int, theta: float, device):
    """cos/sin (cap, head_dim//2) for positions [0, cap), cap the power of
    two >= max(n_pos, 128). Prefill, decode and restoration all gather
    their angles from such a table: an elementwise cos computed over
    different shapes may round differently at the same position, and equal
    angles are what makes restored K equal to prefill K bitwise."""
    cap = 128
    while cap < n_pos:
        cap <<= 1
    return rope_angles(torch.arange(cap, device=device), head_dim, theta)


def sinusoidal_positions(n_pos: int, d: int, dtype=torch.float32,
                         device=None):
    """Whisper-style sinusoidal table (n_pos, d): [sin, cos] of position
    times log-spaced frequencies, computed in fp32, then cast."""
    half = d // 2
    step = torch.tensor(math.log(10000.0), dtype=torch.float32,
                        device=device) / max(half - 1, 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=device) * step)
    ang = (torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
           * freqs[None, :])
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
