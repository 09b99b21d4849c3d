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
state. The training forward takes the scan under autograd
(``kernels/ssm_update.py::SSMScanFn``: one launch per 128-token chunk, a
plain backward).

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

Over M model shards (``apply_mamba2_shards``, the mesh serving programs)
Mamba2 splits ``ssm_heads``: shard m computes its H/M heads' SSD. The
reference splits the whole in_proj output [z | x | B | C | dt] and the
conv state's I + 2GN channels evenly over ``ssm_inner``, which is not on
head boundaries, and with ``n_groups`` = 1 every head reads all of B and
C. So beyond the reference's even split each shard holds a copy of the
B/C columns of in_proj and of their conv weights and channels (2GN = 128
at zamba2-2.7b: at M = 16 a shard's conv state has 320 + 128 = 448
channels against the even 328), and computes B and C itself; the gated
norm's mean of squares and out_proj's product are summed over the
shards. The conv state is stored in the reference's even split and
converted around each block (``mamba2_conv_from_layout``/
``mamba2_conv_to_layout``, an all-gather each).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import (gather_from_shards,
                                                 reduce_from_shards)
from repro_torch.distributed.tp import on_device
from repro_torch.kernels import ops
from repro_torch.models.layers.norm import row_sum
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
    (B,I,N) fp32)): ``apply_mamba1_shards`` on one shard. ``init_state``,
    when given, must be a contiguous fp32 (B,I,N) tensor: the recurrence
    updates it in place and returns it as the new ssm state (the JAX
    package returns a new array). Under autograd (grad enabled and a scan
    input that requires grad) the scan goes through
    ``ops.ssm_scan_autograd`` instead, which leaves ``init_state`` as it
    is and returns a new state."""
    outs, states = apply_mamba1_shards([p], [x], h, init_states=[init_state],
                                       conv_states=[conv_state])
    return outs[0], states[0]


def decode_mamba1_step(p: dict, x, h: Mamba1Hyper, *, conv_state,
                       ssm_state):
    """Single-token decode. x (B,1,D); states as ``apply_mamba1`` returns
    them (``ssm_state`` is updated in place)."""
    return apply_mamba1(p, x, h, init_state=ssm_state, conv_state=conv_state)


def mamba1_channel_order(in_proj: torch.Tensor, M: int) -> torch.Tensor:
    """in_proj (..., D, 2I) with its columns reordered so that a
    contiguous split into M parts gives model shard m its channels' x
    columns and then their gate columns, [x_m | z_m] (the whole is
    [x | z], so a plain split would give shard 0 only x columns)."""
    if M == 1:
        return in_proj
    lead, I = in_proj.shape[:-1], in_proj.shape[-1] // 2
    return (in_proj.reshape(*lead, 2, M, I // M).transpose(-3, -2)
            .reshape(*lead, 2 * I))


def apply_mamba1_shards(ps: list, xs: list, h: Mamba1Hyper, *,
                        init_states=None, conv_states=None):
    """The Mamba1 layer over M model shards, ``ssm_inner`` split (the JAX
    package's ``constrain(..., "ssm_inner")``; one shard: the whole
    layer): ``ps[m]`` shard m's parameters (its I/M channels: in_proj in
    ``mamba1_channel_order``, conv, dt_proj columns, a_log, d_skip,
    x_proj and out_proj rows), ``xs[m]`` the replicated input (B,S,D) on
    its device; states per shard or None, (B,W-1,I/M) and (B,I/M,N) fp32
    (as ``apply_mamba1`` takes them). Each shard scans its channels
    through kernel #6; the two products that sum over I, x_proj's and
    out_proj's, are summed over the shards in shard order. Returns (the
    output (B,S,D) on every shard, each shard's (conv_state,
    ssm_state))."""
    M = len(ps)
    init_states = init_states or [None] * M
    conv_states = conv_states or [None] * M
    N, R = h.d_state, h.dt_rank
    xcs, zs, convs, parts = [], [], [], []
    for m, (p, x, cs) in enumerate(zip(ps, xs, conv_states)):
        I = p["in_proj"].shape[-1] // 2
        with on_device(x.device, m):
            xz = torch.matmul(x, p["in_proj"])
            xc, new_conv = causal_conv1d(xz[..., :I], p["conv_w"],
                                         p["conv_b"], cs)
            xc = F.silu(xc)
            parts.append(torch.matmul(xc, p["x_proj"]))
        xcs.append(xc)
        zs.append(xz[..., I:])
        convs.append(new_conv)
    outs, states = [], []
    for m, (p, x, xc, z, proj, h0, conv) in enumerate(zip(
            ps, xs, xcs, zs, reduce_from_shards(parts), init_states,
            convs)):
        dt_low, Bm, Cm = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
        with on_device(x.device, m):
            dt = F.softplus(torch.matmul(dt_low, p["dt_proj"])
                            + p["dt_bias"]).float()          # (B,S,I)
            A = -torch.exp(p["a_log"].float())                # (I,N)
            if h0 is None:
                h0 = torch.zeros((x.shape[0], xc.shape[-1], N),
                                 dtype=torch.float32, device=x.device)
            scan_in = (dt, xc, A, Bm, Cm, p["d_skip"])
            if (torch.is_grad_enabled()
                    and any(t.requires_grad for t in scan_in)):
                y, state = ops.ssm_scan_autograd(h0, *scan_in)
            else:
                y, state = ops.ssm_scan(h0, *scan_in), h0
            y = (y.float() * F.silu(z.float())).to(x.dtype)
            outs.append(torch.matmul(y, p["out_proj"]))
        states.append((conv, state))
    return reduce_from_shards(outs), states


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
    """SSD chunked forward, ``apply_mamba2_shards`` on one shard. x
    (B,S,D) -> (out (B,S,D), (conv_state (B, W-1, I+2GN) in x's dtype,
    ssm_state (B, H, P, N) fp32)), from ``init_state``/``conv_state``
    when given, else from zero."""
    outs, states = apply_mamba2_shards([p], [x], h, init_states=[init_state],
                                       conv_states=[conv_state])
    return outs[0], states[0]


def mamba2_shard_columns(h: Mamba2Hyper, M: int, m: int) -> torch.Tensor:
    """The in_proj columns of model shard m of M over ``ssm_heads``: its
    heads' z and x columns, every B and C column (``n_groups`` = 1: each
    head reads all of them) and its heads' dt columns, [z_m | x_m | B | C
    | dt_m]. The whole is [z | x | B | C | dt]; one shard takes it as it
    is."""
    I, GN, H = h.d_inner, h.n_groups * h.d_state, h.n_heads
    Im, Hm = I // M, H // M
    dt = 2 * I + 2 * GN
    return torch.cat([torch.arange(m * Im, (m + 1) * Im),
                      torch.arange(I + m * Im, I + (m + 1) * Im),
                      torch.arange(2 * I, dt),
                      torch.arange(dt + m * Hm, dt + (m + 1) * Hm)])


def mamba2_shard_channels(h: Mamba2Hyper, M: int, m: int) -> torch.Tensor:
    """The conv channels of model shard m (rows of conv_w, conv_b and the
    conv state's last axis): its heads' x channels and every B and C
    channel, [x_m | B | C] of the whole [x | B | C]."""
    I, GN = h.d_inner, h.n_groups * h.d_state
    Im = I // M
    return torch.cat([torch.arange(m * Im, (m + 1) * Im),
                      torch.arange(I, I + 2 * GN)])


def mamba2_shard_params(p: dict, h: Mamba2Hyper, M: int, m: int) -> dict:
    """Model shard m's Mamba2 parameters (any leading stack axes) from the
    whole ``p``: in_proj by ``mamba2_shard_columns``, conv_w/conv_b by
    ``mamba2_shard_channels``, its heads' dt_bias, a_log and d_skip, its
    channels' gate_norm and out_proj rows."""
    if M == 1:
        return p
    Im, Hm = h.d_inner // M, h.n_heads // M
    dev = p["in_proj"].device
    cols = mamba2_shard_columns(h, M, m).to(dev)
    chans = mamba2_shard_channels(h, M, m).to(dev)
    heads = slice(m * Hm, (m + 1) * Hm)
    inner = slice(m * Im, (m + 1) * Im)
    return {"in_proj": p["in_proj"].index_select(-1, cols),
            "conv_w": p["conv_w"].index_select(-2, chans),
            "conv_b": p["conv_b"].index_select(-1, chans),
            "dt_bias": p["dt_bias"][..., heads].contiguous(),
            "a_log": p["a_log"][..., heads].contiguous(),
            "d_skip": p["d_skip"][..., heads].contiguous(),
            "gate_norm": p["gate_norm"][..., inner].contiguous(),
            "out_proj": p["out_proj"][..., inner, :].contiguous()}


def mamba2_conv_to_layout(convs: list, h: Mamba2Hyper) -> list:
    """Each model shard's conv state (..., [x_m | B | C]) -> its even block
    of the whole (..., I + 2GN) along the last axis, the reference's
    ``ssm_inner`` split: the x channels gathered over the shards (an
    all-gather), each shard's own B/C after them. One shard: as it is."""
    M = len(convs)
    if M == 1:
        return convs
    Im = h.d_inner // M
    xs = gather_from_shards([c[..., :Im] for c in convs], convs[0].dim() - 1)
    n = h.conv_channels // M
    return [torch.cat([x, c[..., Im:]], dim=-1)[..., m * n:(m + 1) * n]
            .contiguous() for m, (x, c) in enumerate(zip(xs, convs))]


def mamba2_conv_from_layout(parts: list, h: Mamba2Hyper) -> list:
    """The reverse of ``mamba2_conv_to_layout``: each shard's even block
    gathered over the shards (an all-gather), then its own channels
    [x_m | B | C] taken out."""
    M = len(parts)
    if M == 1:
        return parts
    Im, I = h.d_inner // M, h.d_inner
    whole = gather_from_shards(parts, parts[0].dim() - 1)
    return [torch.cat([w[..., m * Im:(m + 1) * Im], w[..., I:]], dim=-1)
            for m, w in enumerate(whole)]


def apply_mamba2_shards(ps: list, xs: list, h: Mamba2Hyper, *,
                        init_states=None, conv_states=None):
    """The Mamba2 layer over M model shards, ``ssm_heads`` split (one
    shard: the whole layer): ``ps[m]`` shard m's parameters
    (``mamba2_shard_params``: its H/M heads, their I/M channels, every
    B/C column and conv channel), ``xs[m]`` the replicated input (B,S,D)
    on its device; states per shard or None, conv (B, W-1, I/M + 2GN) in
    ``mamba2_shard_channels`` order and ssm (B, H/M, P, N) fp32. Each
    shard computes its heads' SSD (and the shared B and C, a copy on
    every shard); the gated norm's mean of squares over all I channels
    and out_proj's product are summed over the shards in shard order.
    Returns (the output (B,S,D) on every shard, each shard's (conv_state,
    ssm_state))."""
    M = len(ps)
    init_states = init_states or [None] * M
    conv_states = conv_states or [None] * M
    ys, zs, states = [], [], []
    for m, (p, x, h0, cs) in enumerate(zip(ps, xs, init_states,
                                           conv_states)):
        with on_device(x.device, m):
            y, z, st = _ssd_shard(p, x, h, h0, cs)
        ys.append(y)
        zs.append(z)
        states.append(st)
    # gated RMSNorm (mamba2's norm before the gate) over all I channels
    gated, sums = [], []
    for m, (y, z) in enumerate(zip(ys, zs)):
        with on_device(y.device, m):
            g = y * F.silu(z.float())
            sums.append(row_sum(torch.square(g))[..., None])
        gated.append(g)
    outs = []
    for m, (p, x, g, total) in enumerate(zip(ps, xs, gated,
                                             reduce_from_shards(sums))):
        with on_device(x.device, m):
            var = total / h.d_inner
            g = (g * torch.reciprocal(torch.sqrt(var + 1e-6))
                 * p["gate_norm"].float())
            outs.append(torch.matmul(g.to(x.dtype), p["out_proj"]))
    return reduce_from_shards(outs), states


def _ssd_shard(p: dict, x, h: Mamba2Hyper, init_state, conv_state):
    """One shard's in_proj, conv and SSD over its heads: (y (B,S,I_m) fp32
    before the gate, z (B,S,I_m), (conv_state, ssm_state))."""
    B, S, _ = x.shape
    N, P, G = h.d_state, h.head_dim, h.n_groups
    I = p["out_proj"].shape[-2]               # this shard's channels
    H = I // P
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

    # intra-chunk: L[i, j] = exp(a_cs[i] - a_cs[j]) for i >= j, else 0.
    # The segment sums above the diagonal are masked to -inf BEFORE the
    # exp (the reference masks after it): there they are >= 0 and overflow
    # fp32 at full width (zamba2-2.7b: |A| up to 80), and the exp's
    # backward then multiplies the masked zero gradient by inf (NaN). The
    # forward values are the same either way.
    seg = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]  # (B,nc,Q,Q,H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                  float("-inf")))
    if Q == 1:          # decode: the sum over n in a fixed order
        scores = row_sum(C_c * B_c)[:, :, :, None, :]
    else:
        scores = torch.einsum("bcqgn,bckgn->bcqkg", C_c, B_c)  # (B,nc,Q,Q,G)
    dx = dt_c[..., None] * xh_c.float()                    # (B,nc,Q,H,P)
    Mx = torch.repeat_interleave(scores, H // G, dim=-1) * L
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", Mx, dx)

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
    return y.reshape(B, S, I), z, (new_conv, hs)


def decode_mamba2_step(p: dict, x, h: Mamba2Hyper, *, conv_state,
                       ssm_state):
    """Single-token decode. x (B,1,D); states as ``apply_mamba2`` returns
    them. Returns (out, (conv_state, ssm_state)), new tensors."""
    return apply_mamba2(p, x, h, init_state=ssm_state, conv_state=conv_state)
