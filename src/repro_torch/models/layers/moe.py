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

``route`` also returns the full softmax ``probs`` (B, S, E), which
``apply_moe`` hands out beside its output for the training forward's
GShard load-balance aux (``routing_stats``, ``load_balance_aux``: the
reference's ``transformer._ffn``, with f and P taken over the whole
batch when it is split over data shards).

``apply_moe_sharded`` is the layer over M model shards, with the expert
FFNs' ``d_ff`` split over them (the training forward of
``models/transformer.py``): every model shard routes its (replicated)
tokens alike, runs the experts on its ``d_ff`` slice, weights and
combines its partial outputs at their tokens and then sums once over
the shards, (B, S, D) (the reference's ``late_combine``,
``_apply_moe_shard_map``). The reference's default sums the partial
expert outputs (B, E·C, D) over the shards before the combine instead:
the same function with its sums in another order. On one shard it is
``apply_moe``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.collectives import (copy_to_shards,
                                                 reduce_from_shards)
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


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``one_hot(idx, n)`` (int64) as the card computes it, a scatter into
    zeros: ``one_hot`` also reads the indices' range back to the host on
    the CPU (not on the card, and it cannot on ``meta``), so its ops would
    differ by device."""
    out = torch.zeros(idx.shape + (n,), dtype=torch.long, device=idx.device)
    return out.scatter_(-1, idx.unsqueeze(-1), 1)


def route(p: dict, x: torch.Tensor, h: MoEHyper):
    """Per-row routing of x (B, S, D): the top-k probabilities (B, S·K) in
    token-major order (token s's ranks at s·K .. s·K+K-1), each
    assignment's slot (B, S·K) in [0, E·C), or E·C where the capacity
    dropped it, and the router's full softmax (B, S, E) fp32."""
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
    counts = _one_hot(flat_e, E).sum(1)                          # (B, E)
    starts = counts.cumsum(-1) - counts
    pos = (torch.arange(T, device=x.device)[None]
           - starts.gather(1, sorted_e))                         # (B, T)
    sorted_slot = torch.where(pos < C, sorted_e * C + pos,
                              torch.full_like(pos, E * C))
    slot = torch.empty_like(sorted_slot).scatter_(1, order, sorted_slot)
    return top_p.reshape(B, T), slot, probs


def routing_stats(probs: torch.Tensor):
    """What the load-balance aux needs of one layer's router softmax
    (B, S, E): (its sum over tokens (E,), the top-1 counts (E,)); the
    gradient flows through the first alone."""
    E = probs.shape[-1]
    top1 = _one_hot(probs.detach().argmax(-1), E)
    return probs.sum(dim=(0, 1)), top1.float().sum(dim=(0, 1))


def load_balance_aux(stats, n_tokens: int):
    """The GShard load-balance aux summed over layers: ``stats[li]`` layer
    li's ``routing_stats`` of every data shard in shard order, over
    ``n_tokens`` tokens in all. Per layer E · sum_e f_e · P_e, f the share
    of tokens whose top-1 expert is e and P the mean probability of e,
    both over the whole batch (f·P is not linear: a mean of per-shard
    auxes is another value)."""
    aux = 0.0
    for layer in stats:
        P, f = layer[0]
        for psum, top1 in layer[1:]:
            P, f = P + psum.to(P.device), f + top1.to(P.device)
        aux = aux + P.shape[0] * torch.sum((f / n_tokens) * (P / n_tokens))
    return aux


def _dispatch(x: torch.Tensor, slot: torch.Tensor, h: MoEHyper):
    """x (B, S, D) gathered into expert-major slots (E, B·C, D); an
    empty slot holds zeros."""
    B, S, D = x.shape
    E, K = h.n_experts, h.top_k
    C = capacity(S, h)
    T, EC = S * K, E * C
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
    return ge.view(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)


def _experts(p: dict, ge: torch.Tensor, h: MoEHyper) -> torch.Tensor:
    """The expert FFNs over their slots (E, B·C, D) -> (E, B·C, D); with
    a ``d_ff`` slice of the weights, a partial sum."""
    act = ACTS[h.activation]
    up = torch.bmm(ge, p["w_up"])
    if "w_gate" in p:
        up = act(torch.bmm(ge, p["w_gate"])) * up
    else:
        up = act(up)
    return torch.bmm(up, p["w_down"])


def _combine(out_e: torch.Tensor, slot: torch.Tensor, weight: torch.Tensor,
             B: int, S: int, h: MoEHyper) -> torch.Tensor:
    """Expert outputs (E, B·C, D) weighted and summed back at their
    tokens, rank 0 first -> (B, S, D)."""
    E, K = h.n_experts, h.top_k
    C = capacity(S, h)
    EC, D = E * C, out_e.shape[-1]
    out_e = out_e.view(E, B, C, D).transpose(0, 1).reshape(B, EC, D)
    out_e = torch.cat([out_e, out_e.new_zeros(B, 1, D)], dim=1)
    rows = (slot + torch.arange(B, device=slot.device)[:, None] * (EC + 1))
    contrib = out_e.reshape(B * (EC + 1), D).index_select(
        0, rows.reshape(-1)).view(B, S, K, D)
    w = weight.to(out_e.dtype).view(B, S, K, 1)
    out = contrib[:, :, 0] * w[:, :, 0]
    for k in range(1, K):
        out = out + contrib[:, :, k] * w[:, :, k]
    return out


def apply_moe(p: dict, x: torch.Tensor, h: MoEHyper):
    """x (B, S, D) -> (out (B, S, D), the router softmax (B, S, E)),
    each row routed on its own."""
    B, S, _ = x.shape
    weight, slot, probs = route(p, x, h)
    out_e = _experts(p, _dispatch(x, slot, h), h)
    return _combine(out_e, slot, weight, B, S, h), probs


def apply_moe_sharded(ps: list, xs: list, h: MoEHyper):
    """The layer over M model shards: ``ps[m]`` shard m's parameters (the
    router whole, the expert weights' ``d_ff`` slice), ``xs[m]`` the
    (replicated) input (B, S, D) on its device. Returns (the output on
    every shard, each shard's router softmax (B, S, E)). Routing runs on
    the replicated inputs, outside the parallel region, so the router's
    gradient is whole on every shard."""
    if len(ps) == 1:
        out, probs = apply_moe(ps[0], xs[0], h)
        return [out], [probs]
    B, S, _ = xs[0].shape
    routes = [route(p, x, h) for p, x in zip(ps, xs)]
    xin = copy_to_shards(xs)
    weights = copy_to_shards([r[0] for r in routes])
    outs = [_combine(_experts(p, _dispatch(x, r[1], h), h), r[1], w, B, S, h)
            for p, x, r, w in zip(ps, xin, routes, weights)]
    return reduce_from_shards(outs), [r[2] for r in routes]
