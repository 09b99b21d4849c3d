"""RMSNorm / LayerNorm (pre-norm transformer style), fp32 internals."""
from __future__ import annotations

import torch

from repro_torch.models.module import bias_param, scale_param


def init_norm(kind: str, d: int, dtype, device) -> dict:
    p = {"scale": scale_param(d, dtype, device)}
    if kind == "layernorm":
        p["bias"] = bias_param(d, dtype, device)
    return p


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by a fixed pairwise tree of elementwise
    adds. A library reduction picks its summation order from the whole
    tensor's shape (how many rows share a launch), so the same row could
    round differently in prefill, decode and restoration, or alone and in
    a batch; this order depends on the row alone."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis (keeping it, of size 1) in ``row_sum``'s
    order."""
    return row_sum(x)[..., None] / x.shape[-1]


def apply_norm(p: dict, x: torch.Tensor, kind: str, eps: float):
    """Normalise over the last axis in fp32; ``p``'s tensors broadcast
    against ``x``. Returns x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = row_mean(torch.square(xf))
        out = xf * torch.reciprocal(torch.sqrt(var + eps))
        out = out * p["scale"].float()
    elif kind == "layernorm":
        mu = row_mean(xf)
        var = row_mean(torch.square(xf - mu))
        out = (xf - mu) * torch.reciprocal(torch.sqrt(var + eps))
        out = out * p["scale"].float() + p["bias"].float()
    else:
        raise ValueError(kind)
    return out.to(x.dtype)
