"""Parameter containers and initialisers.

Parameters are plain nested dicts of tensors with the JAX package's tree
layout (``repro/models/module.py``), so a converted JAX tree and a tree
initialised here are interchangeable. Per-layer parameters are stacked
along a leading layer axis. Initialisation draws from an explicit
``torch.Generator`` with the JAX package's scales; the two frameworks give
different numbers from the same seed.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def normal_init(gen: torch.Generator, shape: Sequence[int], dtype,
                scale: float, device) -> torch.Tensor:
    """N(0, scale²) drawn in fp32 on ``device``, then cast."""
    x = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def dense_param(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
                scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return normal_init(gen, (d_in, d_out), dtype, scale, device)


def bias_param(d: int, dtype, device) -> torch.Tensor:
    return torch.zeros(d, dtype=dtype, device=device)


def scale_param(d: int, dtype, device, value: float = 1.0) -> torch.Tensor:
    return torch.full((d,), value, dtype=dtype, device=device)


def stacked_init(per_layer_init: Callable[[], dict], n: int) -> dict:
    """Run a per-layer init ``n`` times and stack each leaf along a new
    leading layer axis. The stack is filled layer by layer, so at most one
    layer's temporaries exist beside it."""
    first = per_layer_init()

    def alloc(x):
        if isinstance(x, dict):
            return {k: alloc(v) for k, v in x.items()}
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        out[0] = x
        return out

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i] = v

    stacked = alloc(first)
    del first
    for i in range(1, n):
        fill(stacked, per_layer_init(), i)
    return stacked


def count_params(tree: dict) -> int:
    return sum(count_params(v) if isinstance(v, dict) else v.numel()
               for v in tree.values())
