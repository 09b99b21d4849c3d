"""Mamba1 (falcon-mamba, the ``ssm`` family's mixer) and Mamba2/SSD
(zamba2, the ``hybrid`` family's) blocks.

Mamba1:

The JAX package evaluates the selective scan as a chunked ``lax.scan``
over materialised ``dA`` and ``dBx`` of shape (B, S, I, N). Here ``dt``,
``x``, ``B`` and ``C`` come from batched products over the whole sequence
and the recurrence runs through ``kernels.ops.ssm_scan``: on the card one
launch of the hand-written scan kernel per layer call walks all S tokens
with the (B, I, N) state held on chip and writes it back into its buffer
in place, so nothing of size S·I·N exists (on the CPU the plain version
steps token by token). Decode is the same call at S = 1 on the cache's
state.

Mamba2 is the SSD chunked form, as the JAX package computes it in jnp
(no Pallas kernel there, so none here): within a chunk of ``chunk``
tokens an attention-like product of C, B and the decay matrix L, then the
chunks' states, a recurrence of length S/chunk over them, and their
contribution to the outputs; a gated RMSNorm (eps 1e-6) closes the block.
``dt``, ``A``, ``B``, ``C``, the states and the gate stay in fp32 whatever
the model dtype. Decode is the same function at S = 1 on the cache's
states, where the SSD's two sums over the state axis run as a fixed tree
of elementwise adds (``norm.row_sum``) and its other products have a
single term: a batched product picks its algorithm by the batch count,
so a row decoded in a batch of four would not get the bits of the same
row alone.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers.norm import row_mean, row_sum
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


# ==================================================================== Mamba 2
@dataclasses.dataclass(frozen=True)
class Mamba2Hyper:
    d_model: int
    d_state: int
    head_dim: int = 64
    d_conv: int = 4
    expand: int = 2
    n_groups: int = 1
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def init_mamba2(gen: torch.Generator, h: Mamba2Hyper, dtype, device) -> dict:
    """The JAX package's init: dt_bias the inverse softplus of 0.01,
    a_log = log(1..H) and d_skip ones, all three fp32 whatever the model
    dtype; the gate norm's scale ones."""
    I, N, H, G = h.d_inner, h.d_state, h.n_heads, h.n_groups
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_param(gen, h.d_model, 2 * I + 2 * G * N + H, dtype,
                               device),
        "conv_w": normal_init(gen, (h.conv_channels, h.d_conv), dtype,
                              h.d_conv ** -0.5, device),
        "conv_b": bias_param(h.conv_channels, dtype, device),
        "dt_bias": torch.log(torch.expm1(torch.full((H,), 0.01, **f32))),
        "a_log": torch.log(torch.arange(1, H + 1, **f32)),
        "d_skip": torch.ones((H,), **f32),
        "gate_norm": torch.ones((I,), dtype=dtype, device=device),
        "out_proj": dense_param(gen, I, h.d_model, dtype, device),
    }


def _ssd_chunk_tensors(xh, dt, Bm, Cm, Q: int):
    """(B, S, ...) tensors -> per-chunk (B, S/Q, Q, ...) views for SSD."""
    B, S = dt.shape[:2]
    nc = S // Q
    return (xh.reshape(B, nc, Q, *xh.shape[2:]), dt.reshape(B, nc, Q, -1),
            Bm.reshape(B, nc, Q, *Bm.shape[2:]),
            Cm.reshape(B, nc, Q, *Cm.shape[2:]), nc)


def apply_mamba2(p: dict, x, h: Mamba2Hyper, *,
                 init_state: Optional[torch.Tensor] = None,
                 conv_state: Optional[torch.Tensor] = None):
    """SSD chunked forward. x (B,S,D) -> (out (B,S,D), (conv_state
    (B, W-1, I+2GN) in x's dtype, ssm_state (B, H, P, N) fp32)), from
    ``init_state``/``conv_state`` when given, else from zero."""
    B, S, _ = x.shape
    I, N, H, P, G = h.d_inner, h.d_state, h.n_heads, h.head_dim, h.n_groups
    proj = torch.matmul(x, p["in_proj"])
    z, xBC, dt_raw = (proj[..., :I], proj[..., I:2 * I + 2 * G * N],
                      proj[..., 2 * I + 2 * G * N:])
    xBC, new_conv = causal_conv1d(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC)
    xi, Bm, Cm = xBC[..., :I], xBC[..., I:I + G * N], xBC[..., I + G * N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])              # (B,S,H)
    A = -torch.exp(p["a_log"])                                  # (H,)

    Q = min(h.chunk, S)
    padS = (Q - S % Q) % Q
    if padS:
        xi, Bm, Cm, dt = (F.pad(t, (0, 0, 0, padS)) for t in (xi, Bm, Cm, dt))
    Sp = S + padS
    xh = xi.reshape(B, Sp, H, P)
    Bg = Bm.reshape(B, Sp, G, N).float()
    Cg = Cm.reshape(B, Sp, G, N).float()
    xh_c, dt_c, B_c, C_c, nc = _ssd_chunk_tensors(xh, dt, Bg, Cg, Q)

    a = dt_c * A                                          # (B,nc,Q,H) <= 0
    a_cs = torch.cumsum(a, dim=2)
    a_total = a_cs[:, :, -1, :]                           # (B,nc,H)

    # intra-chunk: L[i, j] = exp(a_cs[i] - a_cs[j]) for i >= j
    seg = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]  # (B,nc,Q,Q,H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                    torch.zeros((), device=x.device))
    if Q == 1:          # decode: the sum over n in a fixed order
        scores = row_sum(C_c * B_c)[:, :, :, None, :]
    else:
        scores = torch.einsum("bcqgn,bckgn->bcqkg", C_c, B_c)  # (B,nc,Q,Q,G)
    dx = dt_c[..., None] * xh_c.float()                    # (B,nc,Q,H,P)
    M = torch.repeat_interleave(scores, H // G, dim=-1) * L
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, dx)

    # chunk states and the inter-chunk recurrence
    decay_to_end = torch.exp(a_total[:, :, None, :] - a_cs)  # (B,nc,Q,H)
    state_c = torch.einsum("bcqgn,bcqhp->bchpn", B_c,
                           dx * decay_to_end[..., None])    # (B,nc,H,P,N)
    hs = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    decay = torch.exp(a_total)
    prev = []
    for c in range(nc):
        prev.append(hs)
        hs = decay[:, c, :, None, None] * hs + state_c[:, c]
    h_prev = torch.stack(prev, dim=1)                      # (B,nc,H,P,N)

    if Q == 1:          # the sum over (g, n) in a fixed order
        Cf = C_c.reshape(B, nc, 1, 1, 1, G * N)
        hf = h_prev[:, :, None, :, :, None, :].expand(
            B, nc, 1, H, P, G, N).reshape(B, nc, 1, H, P, G * N)
        y_inter = row_sum(Cf * hf)
    else:
        y_inter = torch.einsum("bcqgn,bchpn->bcqhp", C_c, h_prev)
    y_inter = y_inter * torch.exp(a_cs)[..., None]
    y = (y_intra + y_inter).reshape(B, Sp, H, P)[:, :S]
    y = y + xh[:, :S].float() * p["d_skip"][None, None, :, None]
    y = y.reshape(B, S, I)
    # gated RMSNorm (mamba2's norm before the gate)
    y = y * F.silu(z.float())
    var = row_mean(torch.square(y))
    y = (y * torch.reciprocal(torch.sqrt(var + 1e-6))
         * p["gate_norm"].float())
    out = torch.matmul(y.to(x.dtype), p["out_proj"])
    return out, (new_conv, hs)


def decode_mamba2_step(p: dict, x, h: Mamba2Hyper, *, conv_state,
                       ssm_state):
    """Single-token decode. x (B,1,D); states as ``apply_mamba2`` returns
    them. Returns (out, (conv_state, ssm_state)), new tensors."""
    return apply_mamba2(p, x, h, init_state=ssm_state, conv_state=conv_state)
