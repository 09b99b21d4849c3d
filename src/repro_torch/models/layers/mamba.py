"""Mamba1 block (falcon-mamba), the ``ssm`` family's mixer.

The JAX package evaluates the selective scan as a chunked ``lax.scan``
over materialised ``dA`` and ``dBx`` of shape (B, S, I, N). Here ``dt``,
``x``, ``B`` and ``C`` come from batched products over the whole sequence
and the recurrence runs through ``kernels.ops.ssm_scan``: on the card one
launch of the hand-written scan kernel per layer call walks all S tokens
with the (B, I, N) state held on chip and writes it back into its buffer
in place, so nothing of size S·I·N exists (on the CPU the plain version
steps token by token). Decode is the same call at S = 1 on the cache's
state.

The Mamba2 half of the JAX module (zamba2) belongs to the hybrid family
and is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.module import bias_param, dense_param, normal_init


def causal_conv1d(x, weight, bias, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x (B,S,C), weight (C,W), bias (C,). With
    ``state`` (B, W-1, C) the conv sees the previous inputs (decode).
    Returns (y (B,S,C), new_state (B, W-1, C))."""
    B, S, C = x.shape
    W = weight.shape[1]
    if state is None:
        state = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)        # (B, S+W-1, C)
    y = xp[:, 0:S] * weight[:, 0]
    for w in range(1, W):
        y = y + xp[:, w:w + S] * weight[:, w]
    y = y + bias
    new_state = xp[:, S:] if W > 1 else state
    return y, new_state


@dataclasses.dataclass(frozen=True)
class Mamba1Hyper:
    d_model: int
    d_state: int
    d_conv: int = 4
    expand: int = 2

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(self.d_model // 16, 1)


def init_mamba1(gen: torch.Generator, h: Mamba1Hyper, dtype, device) -> dict:
    """The JAX package's init: a_log = log(1..N) per channel, kept fp32
    whatever the model dtype; dt_bias the inverse softplus of 0.01."""
    I, N, R = h.d_inner, h.d_state, h.dt_rank
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=device)).expand(I, N).contiguous()
    dt_bias = torch.log(torch.expm1(torch.full((I,), 0.01,
                                               dtype=torch.float32,
                                               device=device)))
    return {
        "in_proj": dense_param(gen, h.d_model, 2 * I, dtype, device),
        "conv_w": normal_init(gen, (I, h.d_conv), dtype, h.d_conv ** -0.5,
                              device),
        "conv_b": bias_param(I, dtype, device),
        "x_proj": dense_param(gen, I, R + 2 * N, dtype, device),
        "dt_proj": dense_param(gen, R, I, dtype, device, R ** -0.5),
        "dt_bias": dt_bias.to(dtype),
        "a_log": a_log,
        "d_skip": torch.ones((I,), dtype=dtype, device=device),
        "out_proj": dense_param(gen, I, h.d_model, dtype, device),
    }


def apply_mamba1(p: dict, x, h: Mamba1Hyper, *,
                 init_state: Optional[torch.Tensor] = None,
                 conv_state: Optional[torch.Tensor] = None):
    """x (B,S,D) -> (out (B,S,D), (conv_state (B,W-1,I), ssm_state
    (B,I,N) fp32)). ``init_state``, when given, must be a contiguous fp32
    (B,I,N) tensor: the recurrence updates it in place and returns it as
    the new ssm state (the JAX package returns a new array)."""
    I, N, R = h.d_inner, h.d_state, h.dt_rank
    xz = torch.matmul(x, p["in_proj"])
    xi, z = xz[..., :I], xz[..., I:]
    xc, new_conv = causal_conv1d(xi, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    proj = torch.matmul(xc, p["x_proj"])
    dt_low, Bm, Cm = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
    dt = F.softplus(torch.matmul(dt_low, p["dt_proj"])
                    + p["dt_bias"]).float()                  # (B,S,I)
    A = -torch.exp(p["a_log"].float())                        # (I,N)
    if init_state is None:
        init_state = torch.zeros((x.shape[0], I, N), dtype=torch.float32,
                                 device=x.device)
    y = ops.ssm_scan(init_state, dt, xc, A, Bm, Cm, p["d_skip"])
    y = (y.float() * F.silu(z.float())).to(x.dtype)
    return torch.matmul(y, p["out_proj"]), (new_conv, init_state)


def decode_mamba1_step(p: dict, x, h: Mamba1Hyper, *, conv_state,
                       ssm_state):
    """Single-token decode. x (B,1,D); states as ``apply_mamba1`` returns
    them (``ssm_state`` is updated in place)."""
    return apply_mamba1(p, x, h, init_state=ssm_state, conv_state=conv_state)
