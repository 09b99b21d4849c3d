"""Top-k routed mixture-of-experts FFN, capacity-dropping, per batch row.

The JAX package's ``_apply_moe_gspmd`` (``repro/models/layers/moe.py``)
with the same semantics:

  * router logits in fp32; softmax, top-k, the top-k probabilities
    renormalised to sum to one;
  * capacity C = ceil(S·K/E · capacity_factor) when S·K >= E, else S·K,
    clamped to [1, S];
  * each row's S·K assignments stably sorted by expert id; an expert
    keeps its first C (in token order) and the rest are dropped: they
    contribute 0, and the residual passes the token through;
  * the expert outputs weighted by their probability and summed back at
    their tokens.

Routing and capacity are per batch row, as the reference's ``vmap``
makes them, so a row's output never depends on the other rows of its
batch (a decode batch, or the zero rows of the recompute replay).

The combine sums a token's K weighted outputs in a fixed order (rank 0
first), one elementwise add per rank, where the reference scatter-adds
them: a scatter-add on CUDA runs on atomics, whose order varies from run
to run, and bf16 sums in another order round differently. The expert
products are batched matmuls over the expert axis (the reference's
``einsum``s, outside any Pallas kernel); sort, gather and the slot
buffers are plain torch ops.

The shard_map path (``late_combine``) is tensor parallelism and the
load-balancing aux a training term: neither is ported.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.layers.mlp import ACTS
from repro_torch.models.module import normal_init


@dataclasses.dataclass(frozen=True)
class MoEHyper:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    activation: str = "silu"
    glu: bool = True
    capacity_factor: float = 1.25


def capacity(S: int, h: MoEHyper) -> int:
    """Slots per expert for a row of S tokens."""
    E, K = h.n_experts, h.top_k
    C = math.ceil(S * K / E * h.capacity_factor) if S * K >= E else S * K
    return max(min(C, S), 1)


def init_moe(gen: torch.Generator, h: MoEHyper, dtype, device) -> dict:
    E, D, F = h.n_experts, h.d_model, h.d_ff
    p = {
        "router": normal_init(gen, (D, E), dtype, D ** -0.5, device),
        "w_up": normal_init(gen, (E, D, F), dtype, D ** -0.5, device),
        "w_down": normal_init(gen, (E, F, D), dtype, F ** -0.5, device),
    }
    if h.glu:
        p["w_gate"] = normal_init(gen, (E, D, F), dtype, D ** -0.5, device)
    return p


def route(p: dict, x: torch.Tensor, h: MoEHyper):
    """Per-row routing of x (B, S, D): the top-k probabilities (B, S·K) in
    token-major order (token s's ranks at s·K .. s·K+K-1), and each
    assignment's slot (B, S·K) in [0, E·C), or E·C where the capacity
    dropped it."""
    B, S, _ = x.shape
    E, K = h.n_experts, h.top_k
    C = capacity(S, h)
    T = S * K
    logits = torch.matmul(x.float(), p["router"].float())       # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)                  # (B, S, K)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = top_e.reshape(B, T)
    order = torch.argsort(flat_e, dim=-1, stable=True)           # (B, T)
    sorted_e = flat_e.gather(1, order)
    counts = torch.nn.functional.one_hot(flat_e, E).sum(1)       # (B, E)
    starts = counts.cumsum(-1) - counts
    pos = (torch.arange(T, device=x.device)[None]
           - starts.gather(1, sorted_e))                         # (B, T)
    sorted_slot = torch.where(pos < C, sorted_e * C + pos,
                              torch.full_like(pos, E * C))
    slot = torch.empty_like(sorted_slot).scatter_(1, order, sorted_slot)
    return top_p.reshape(B, T), slot


def apply_moe(p: dict, x: torch.Tensor, h: MoEHyper) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D), each row routed on its own."""
    B, S, D = x.shape
    E, K = h.n_experts, h.top_k
    C = capacity(S, h)
    T, EC = S * K, E * C
    weight, slot = route(p, x, h)
    # the token of each slot (B, E·C): kept slots are unique, so the
    # scatter is a permutation; the sentinel column takes the dropped
    tok = torch.full((B, EC + 1), -1, dtype=torch.long, device=x.device)
    tok.scatter_(1, slot, torch.arange(S, device=x.device).repeat_interleave(
        K)[None].expand(B, T).contiguous())
    tok = tok[:, :EC]
    base = torch.arange(B, device=x.device)[:, None] * S
    ge = x.reshape(B * S, D).index_select(
        0, (tok.clamp_min(0) + base).reshape(-1)).view(B, EC, D)
    ge = torch.where((tok >= 0)[..., None], ge, torch.zeros_like(ge))
    # expert-major (E, B·C, D) for one batched product per weight
    ge = ge.view(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)
    act = ACTS[h.activation]
    up = torch.bmm(ge, p["w_up"])
    if "w_gate" in p:
        up = act(torch.bmm(ge, p["w_gate"])) * up
    else:
        up = act(up)
    out_e = torch.bmm(up, p["w_down"])                           # (E, B·C, D)
    out_e = out_e.view(E, B, C, D).transpose(0, 1).reshape(B, EC, D)
    out_e = torch.cat([out_e, out_e.new_zeros(B, 1, D)], dim=1)
    rows = (slot + torch.arange(B, device=x.device)[:, None] * (EC + 1))
    contrib = out_e.reshape(B * (EC + 1), D).index_select(
        0, rows.reshape(-1)).view(B, S, K, D)
    w = weight.to(x.dtype).view(B, S, K, 1)
    out = contrib[:, :, 0] * w[:, :, 0]
    for k in range(1, K):
        out = out + contrib[:, :, k] * w[:, :, k]
    return out
