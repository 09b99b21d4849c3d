"""Decoder-only LM stack (dense / GQA / MoE / VLM) over layer-stacked
parameters.

Entry points (functions over the parameter dict):

  init_lm         -> parameters, stacked along a leading layer axis
  lm_forward      -> full-sequence forward (prefill), optionally capturing
                     per-layer hidden states (the HCache save path) and
                     emitting stacked K/V; it is ``lm_forward_shards`` on
                     one shard, which runs the same blocks over the model
                     shards of a mesh (``distributed/mesh_serving.py``)
  lm_decode_step  -> one decode token per sequence; also returns the
                     per-layer hidden states; it is
                     ``lm_decode_step_shards`` on one shard, which runs
                     over model shards and a cache split along the context
  lm_decode_step_paged -> the same over a paged KV pool (block tables)
  lm_restore_kv   -> the paper's op: stacked K/V from stacked saved
                     hidden states (norm + projection + RoPE only)
  lm_train_forward -> the training forward (the reference's ``lm_forward(
                     ..., skip_logits=True)``): final hidden states for the
                     chunked loss and the MoE load-balance aux, each
                     block under activation checkpointing,
                     differentiable through kernel #5; it is
                     ``lm_train_forward_shards`` on one shard, which runs
                     the same blocks over the model shards of a mesh
                     (``training/sharded.py``), joined by the collectives
                     of ``distributed/collectives.py`` (each the identity
                     on one shard)

The saved hidden state of layer i is the residual-stream INPUT to layer i.
Prefill, decode and restoration all compute K/V with ``norm_rows`` and
``project_kv_rows``: the model's own norm and the grouped restoration
kernel (``kernels.ops.restore_kv_grouped``) over the whole weight stack,
with the batch folded into the kernel's token axis. Restored K/V therefore
equals prefill K/V by construction.

A MoE stack (``cfg.n_experts``) replaces each block's FFN by the routed
experts of ``layers/moe.py``; a VLM (internvl2) takes precomputed patch
embeddings (``patch_embeds``, (B, n_vis, D)) in place of the token
embeddings at positions [0, n_vis) of a prefill that starts at 0. A
stack without RoPE (opt-30b) adds learned absolute positions
(``embed/positions``, ``max_positions`` rows) to the token embeddings at
each token's absolute position: in a prefill, a chunk over history, a
decode step and the recompute replay.

The JAX package scans over the layer stack; here the stack is walked by a
Python loop, since PyTorch runs eagerly.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.config.arch import ArchConfig, AttnKind
from repro_torch.distributed.collectives import (copy_to_shards,
                                                 gather_from_shards,
                                                 reduce_from_shards)
from repro_torch.distributed.sharding import pad_heads
from repro_torch.distributed.tp import Sharded, on_device
from repro_torch.kernels import ops
from repro_torch.launch import exec_cost
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers.attention import AttnHyper
from repro_torch.models.layers.embedding import (MAX_POSITIONS, embed_tokens,
                                                 init_embedding,
                                                 logits as embed_logits,
                                                 positional)
from repro_torch.models.layers.mlp import apply_mlp, init_mlp
from repro_torch.models.layers.moe import (MoEHyper, apply_moe_sharded,
                                           init_moe, load_balance_aux,
                                           routing_stats)
from repro_torch.models.layers.norm import apply_norm, init_norm
from repro_torch.models.layers.rope import rope_table
from repro_torch.models.module import stacked_init


@dataclasses.dataclass(frozen=True)
class LMHyper:
    """``model_axis``: the width of the mesh's model axis the parameters
    are laid out for (query heads padded to a multiple of it,
    ``distributed.sharding.pad_heads``)."""

    cfg: ArchConfig
    dtype: torch.dtype = torch.float32
    max_positions: int = MAX_POSITIONS   # learned-position stacks only
    model_axis: int = 1

    @functools.cached_property
    def attn(self) -> AttnHyper:
        c = self.cfg
        padded, _ = pad_heads(c.n_heads, c.n_kv_heads, self.model_axis)
        return AttnHyper(
            n_heads=c.n_heads, n_kv_heads=c.n_kv_heads, head_dim=c.head_dim_,
            qkv_bias=c.qkv_bias, use_rope=c.use_rope,
            rope_theta=c.rope_theta, attn_softcap=c.attn_softcap,
            padded_heads=padded if padded != c.n_heads else 0)

    @functools.cached_property
    def moe(self) -> Optional[MoEHyper]:
        c = self.cfg
        if not c.n_experts:
            return None
        return MoEHyper(n_experts=c.n_experts, top_k=c.experts_per_token,
                        d_model=c.d_model, d_ff=c.d_ff,
                        activation=c.ffn_activation, glu=c.ffn_glu)


# ------------------------------------------------------------------- params
def init_block(gen: torch.Generator, h: LMHyper, device) -> dict:
    c = h.cfg
    p = {
        "ln1": init_norm(c.norm, c.d_model, h.dtype, device),
        "attn": attn_lib.init_attention(gen, c.d_model, h.attn, h.dtype,
                                        device),
        "ln2": init_norm(c.norm, c.d_model, h.dtype, device),
    }
    if h.moe is not None:
        p["moe"] = init_moe(gen, h.moe, h.dtype, device)
    else:
        p["mlp"] = init_mlp(gen, c.d_model, c.d_ff, c.ffn_glu, h.dtype,
                            device)
    if c.post_attn_norm:
        p["post_ln1"] = init_norm(c.norm, c.d_model, h.dtype, device)
        p["post_ln2"] = init_norm(c.norm, c.d_model, h.dtype, device)
    return p


def init_lm(gen: torch.Generator, h: LMHyper, device) -> dict:
    c = h.cfg
    return {
        "embed": init_embedding(gen, c.vocab_size, c.d_model, h.dtype,
                                device, c.tie_embeddings,
                                0 if c.use_rope else h.max_positions),
        "blocks": stacked_init(lambda: init_block(gen, h, device),
                               c.n_layers),
        "final_norm": init_norm(c.norm, c.d_model, h.dtype, device),
    }


def layer_windows(h: LMHyper) -> List[Optional[int]]:
    """Per-layer attention window (gemma2 local/global); None = global."""
    c = h.cfg
    if not c.local_window:
        return [None] * c.n_layers
    return [c.local_window if k == AttnKind.LOCAL else None
            for k in c.attn_kinds()]


def layer_params(blocks: dict, li: int) -> dict:
    """One layer's slice of the stacked block parameters (views)."""
    return {k: layer_params(v, li) if isinstance(v, dict) else v[li]
            for k, v in blocks.items()}


# ------------------------------------------------- shared K/V projection
def norm_rows(blocks: dict, rows: torch.Tensor, hidden: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    """The input norm of layers ``rows`` on hidden (G, S, D)."""
    idx = rows.long()
    ln = {k: v[idx][:, None, :] for k, v in blocks["ln1"].items()}
    return apply_norm(ln, hidden, cfg.norm, cfg.norm_eps)


def project_kv_rows(blocks: dict, rows: torch.Tensor, normed: torch.Tensor,
                    cos: torch.Tensor, sin: torch.Tensor, h: AttnHyper):
    """K/V of layers ``rows`` from normed (G, S, D) through the grouped
    restoration kernel; cos/sin (S, hd/2). Returns (G, S, Kv, hd) each."""
    a = blocks["attn"]
    G, S, _ = normed.shape
    k, v = ops.restore_kv_grouped(
        normed, a["wk"], a["wv"], a.get("bk"), a.get("bv"), rows, cos, sin,
        head_dim=h.head_dim, use_rope=h.use_rope)
    return (k.view(G, S, h.n_kv_heads, h.head_dim),
            v.view(G, S, h.n_kv_heads, h.head_dim))


def rope_at(h: AttnHyper, positions: torch.Tensor,
            end: Optional[int] = None):
    """cos/sin (..., hd/2) at ``positions``, gathered from the shared
    table (see ``layers.rope.rope_table``). ``end``, when the caller knows
    it, is ``positions.max() + 1``: reading that from the device would
    wait for it."""
    if end is None:
        end = int(positions.max()) + 1
    cos, sin = rope_table(end, h.head_dim, h.rope_theta, positions.device)
    idx = positions.long()
    return cos[idx], sin[idx]


def _shard_rope(h: AttnHyper, positions, end: int):
    """``rope_at`` over each shard's positions, under its shard: (cos
    list, sin list)."""
    cos, sin = [], []
    for m, pos in enumerate(positions):
        with on_device(pos.device, m):
            c, s = rope_at(h, pos, end)
        cos.append(c)
        sin.append(s)
    return cos, sin


def _shard_positions(tokens, base: int):
    """Each shard's positions base + [0, S) as (B, S), under its shard."""
    out = []
    for m, t in enumerate(tokens):
        B, S = t.shape
        with on_device(t.device, m):
            out.append((base + torch.arange(S, device=t.device)[None, :])
                       .expand(B, S))
    return out


@functools.lru_cache(maxsize=None)
def _row(li: int, device: torch.device) -> torch.Tensor:
    """Layer ``li``'s row index on ``device``, uploaded once: a fresh
    upload per layer would make the host wait for the device every time."""
    return torch.tensor([li], dtype=torch.int32, device=device)


def _attn_qkv(blocks, li, x, h: LMHyper, cos, sin,
              q_attn: Optional[AttnHyper] = None):
    """q (B,S,H,hd), k/v (B,S,Kv,hd) of layer ``li``; ``q_attn`` (a model
    shard's query heads, ``blocks``' wq its columns) in place of
    ``h.attn`` for q."""
    B, S, D = x.shape
    rows = _row(li, x.device)
    normed = norm_rows(blocks, rows, x.reshape(1, B * S, D), h.cfg)
    k, v = project_kv_rows(blocks, rows, normed, cos.reshape(B * S, -1),
                           sin.reshape(B * S, -1), h.attn)
    normed = normed.reshape(B, S, D)
    q = attn_lib.project_q(layer_params(blocks["attn"], li), normed,
                           q_attn or h.attn, cos, sin)
    kv_shape = (B, S, h.attn.n_kv_heads, h.attn.head_dim)
    return q, k.reshape(kv_shape), v.reshape(kv_shape)


def _ffn(ps: List[dict], xs, h: LMHyper):
    """The block's FFN over M model shards, ``ps`` each shard's layer
    parameters and ``xs`` its (replicated) input (one shard: the whole
    layer): ``d_ff`` column- then row-parallel, summed over the shards.
    Returns (outs, each shard's router softmax (B,S,E), or None for a
    dense FFN)."""
    if h.moe is not None:
        return apply_moe_sharded([p["moe"] for p in ps], xs, h.moe)
    parts = [apply_mlp(p["mlp"], x, h.cfg.ffn_activation)
             for p, x in zip(ps, copy_to_shards(xs))]
    return reduce_from_shards(parts), None


def _residual_ffn(ps: List[dict], xs, attn, h: LMHyper):
    """What follows a block's output projection, over M model shards
    (``attn`` its result per shard): post-attention norm, residual, FFN,
    post-FFN norm, residual. Returns (outs, the router softmaxes or
    None)."""
    c = h.cfg
    if c.post_attn_norm:
        attn = [apply_norm(p["post_ln1"], a, c.norm, c.norm_eps)
                for p, a in zip(ps, attn)]
    xs = [x + a for x, a in zip(xs, attn)]
    normed = [apply_norm(p["ln2"], x, c.norm, c.norm_eps)
              for p, x in zip(ps, xs)]
    ff, probs = _ffn(ps, normed, h)
    if c.post_attn_norm:
        ff = [apply_norm(p["post_ln2"], f, c.norm, c.norm_eps)
              for p, f in zip(ps, ff)]
    return [x + f for x, f in zip(xs, ff)], probs


def _block_tail(p: dict, x, attn_out, h: LMHyper):
    """Output projection, residual and FFN of a block: (x_out, the FFN's
    router softmax or None)."""
    outs, probs = _residual_ffn(
        [p], [x], [attn_lib.attn_output(p["attn"], attn_out)], h)
    return outs[0], None if probs is None else probs[0]


# ---------------------------------------------------------------- blocks
def block_forward_shards(blocks: List[dict], li: int, xs, h: LMHyper, *,
                         cos, sin, window: Optional[int], hist_kv=None,
                         hist_len: Optional[int] = None,
                         causal: bool = True):
    """Full-sequence block ``li`` over M model shards (one shard: the
    whole layer): ``blocks`` each shard's stacked block parameters (its
    query heads ``qkv_out``, ``o_in`` and ``d_ff`` where M > 1, the whole
    K/V projection), ``xs`` its replicated input (B,S,D) at positions
    hist_len + [0, S) and cos/sin (B,S,hd/2) per shard; optional restored
    history K/V per shard, a (B,Sh,Kv,hd) pair prepended to the attention
    context. Each shard projects K/V of every head through kernel #1 and
    attends its query heads through kernel #5; ``wo`` is row-parallel and
    the FFN column- then row-parallel, summed over the shards in shard
    order; ``causal`` False: every query sees every key (an encoder).
    Returns (outs, each shard's (k, v) of the new tokens, all heads)."""
    a = h.attn
    M = len(blocks)
    heads = _Heads(a.q_heads, a.n_kv_heads, M)
    local = (None if M == 1 else dataclasses.replace(
        a, n_heads=heads.per_shard, padded_heads=0))
    kv_len = (None if hist_kv is None or hist_len is None
              else hist_len + xs[0].shape[1])
    outs, new = [], []
    for m, (b, x) in enumerate(zip(blocks, xs)):
        with on_device(x.device, m):
            q, k, v = _attn_qkv(b, li, x, h, cos[m], sin[m], q_attn=local)
            new.append((k, v))
            k_all, v_all = k, v
            if hist_kv is not None:
                hk, hv = hist_kv[m]
                k_all = torch.cat([hk.to(k.dtype), k], dim=1)
                v_all = torch.cat([hv.to(v.dtype), v], dim=1)
            if M > 1:
                k_all, v_all = heads.select(m, k_all, v_all)
            o = attn_lib.flash_attention(
                q, k_all, v_all, a, q_offset=hist_len or 0, causal=causal,
                window=window, kv_len=kv_len)
            outs.append(attn_lib.attn_output(layer_params(b["attn"], li), o))
    xs, _ = _residual_ffn([layer_params(b, li) for b in blocks], xs,
                          reduce_from_shards(outs), h)
    return xs, new


def block_forward(blocks: dict, li: int, x, h: LMHyper, *, cos, sin,
                  window: Optional[int], hist_kv=None,
                  hist_len: Optional[int] = None):
    """``block_forward_shards`` on one shard: x (B,S,D), cos/sin
    (B,S,hd/2), hist_kv a (B,Sh,Kv,hd) pair or None. Returns (x_out, (k,
    v) of the new tokens)."""
    xs, new = block_forward_shards(
        [blocks], li, [x], h, cos=[cos], sin=[sin], window=window,
        hist_kv=None if hist_kv is None else [hist_kv], hist_len=hist_len)
    return xs[0], new[0]


def write_step_kv(k_cache, v_cache, k, v, lengths, start=None) -> None:
    """A decode step's new K/V (B,1,Kv,hd) into caches (B,Smax,Kv,hd) at
    ``lengths``, IN PLACE (the JAX package's ``.at[].set`` returns a new
    array); a slot that is already full drops the write, as
    ``mode="drop"`` does. ``start`` (B,): the caches are a context slice
    holding positions [start, start + Smax), and a row whose position
    lies outside it drops the write."""
    B, smax = k.shape[0], k_cache.shape[1]
    bidx = torch.arange(B, device=k.device)
    local = lengths.long() if start is None else lengths.long() - start
    slot = local.clamp(min=0, max=smax - 1)
    fits = ((local < smax) & (local >= 0))[:, None, None]
    k_cache[bidx, slot] = torch.where(fits, k[:, 0], k_cache[bidx, slot])
    v_cache[bidx, slot] = torch.where(fits, v[:, 0], v_cache[bidx, slot])


def write_pool_kv(k_pool, v_pool, k, v, write) -> None:
    """A decode step's new K/V (B,1,Kv,hd) into pools (NB,bs,Kv,hd) IN
    PLACE at ``write`` = (rows, flat pool positions); the other rows' K/V
    is dropped."""
    rows, slots = write
    NB, bs = k_pool.shape[0], k_pool.shape[1]
    k_pool.view(NB * bs, *k_pool.shape[2:])[slots] = k[rows, 0]
    v_pool.view(NB * bs, *v_pool.shape[2:])[slots] = v[rows, 0]


def attend_slices(qs, k_caches, v_caches, a: AttnHyper, *, lengths,
                  grow: int, starts=None, window: Optional[int] = None,
                  host_kv_len=None, host_starts=None, new=None, device,
                  dtype):
    """One query token of every head against a cache over C context
    shards: ``qs`` (B,1,H,hd) per model shard (the query of every head,
    gathered), ``k_caches``/``v_caches`` (B,Sc,Kv,hd) and ``lengths``
    (B,) per context shard on its device, ``starts`` (B,) the absolute
    position of each slice's first key (None: one shard). Context shard c
    takes the query of model shard c % M (sent to another data shard for
    c >= M); with ``new`` (each model shard's (k, v) (B,1,Kv,hd)) it
    first writes the new token's K/V where it holds position ``lengths``
    (``write_step_kv``). Each shard attends its slice through kernel #3
    at the absolute live length ``lengths + grow`` (clamped to the whole
    cache's capacity, as the unsplit kernel clamps it) with its
    ``kv_start`` and log-sum-exp, and the partials merge in fp32 in shard
    order on ``device`` (``attention.merge_partials``). One context
    shard: one launch without either, the plain call. ``host_kv_len``
    (B,) the live lengths and ``host_starts`` (one int per context
    shard) on the host, for the count. Returns (B,1,H,hd) in
    ``dtype``."""
    M, C = len(qs), len(k_caches)
    capacity = sum(kc.shape[1] for kc in k_caches)
    outs, lses = [], []
    for c, (kc, vc, n) in enumerate(zip(k_caches, v_caches, lengths)):
        dev = kc.device
        q = qs[c % M].to(dev)
        sent = (q,)
        if new is not None:
            k, v = (t.to(dev) for t in new[c % M])
            sent = (q, k, v)
        if c >= M:      # the query (and new K/V) sent to another data shard
            exec_cost.report_collective("collective-permute", [sent],
                                        [exec_cost.index(c)])
        with on_device(dev, c):
            live = n + grow if grow else n
            if C == 1:
                if new is not None:
                    write_step_kv(kc, vc, k, v, n)
                outs.append(attn_lib.decode_attention(
                    q, kc, vc, a, kv_len=live, window=window,
                    host_kv_len=host_kv_len))
                lses.append(None)
                continue
            if new is not None:
                write_step_kv(kc, vc, k, v, n, starts[c])
            o, lse = attn_lib.decode_attention(
                q, kc, vc, a, kv_len=live.clamp(max=capacity),
                window=window, kv_start=starts[c], return_lse=True,
                host_kv_len=(None if host_kv_len is None else
                             [min(x, capacity) for x in host_kv_len]),
                host_kv_start=(None if host_starts is None
                               else host_starts[c]))
        outs.append(o)
        lses.append(lse)
    if C > 1:           # the partials merged across the context shards
        exec_cost.report_collective("all-reduce", zip(outs, lses))
    return attn_lib.merge_partials(
        [o.to(device) for o in outs],
        [None if x is None else x.to(device) for x in lses], dtype)


def block_decode_shards(blocks: List[dict], li: int, xs, h: LMHyper, *,
                        k_caches, v_caches, lengths, starts=None, cos, sin,
                        window: Optional[int], host_lengths=None,
                        host_starts=None):
    """Single-token block ``li`` over M model shards (``blocks``, ``xs``
    (B,1,D) and cos/sin per shard, as ``block_forward_shards``) and C
    context shards of the layer's cache: ``k_caches``/``v_caches``
    (B,Sc,Kv,hd), ``lengths`` (B,) tokens ALREADY cached and ``starts``
    (B,) int32 the absolute position of the slice's first key (None: one
    shard, the whole cache), each on its cache's device. Model shard m
    projects its query heads; the query of every head, gathered over the
    model shards, goes to each context shard c (from model shard c % M),
    which writes the new token's K/V where it holds position ``lengths``
    (``write_step_kv``) and attends its slice through kernel #3 with its
    ``kv_start`` and log-sum-exp. The partials merge in shard order in
    fp32 on model shard 0's device (``attention.merge_partials``), the
    step's one cross-shard reduction of attention, before the
    row-parallel ``wo``. ``host_lengths`` (B,) and ``host_starts`` (one
    int per context shard): ``lengths`` and ``starts`` on the host, where
    the caller knows them (kernel #3's count, ``launch/exec_cost.py``)."""
    a = h.attn
    M = len(blocks)
    heads = _Heads(a.q_heads, a.n_kv_heads, M)
    local = (None if M == 1 else dataclasses.replace(
        a, n_heads=heads.per_shard, padded_heads=0))
    qs, new = [], []
    for m, (b, x) in enumerate(zip(blocks, xs)):
        with on_device(x.device, m):
            q, k, v = _attn_qkv(b, li, x, h, cos[m], sin[m], q_attn=local)
        qs.append(q)
        new.append((k, v))
    whole = attend_slices(
        gather_from_shards(qs, 2), k_caches, v_caches, a, lengths=lengths,
        grow=1, starts=starts, window=window,
        host_kv_len=(None if host_lengths is None else
                     [x + 1 for x in host_lengths]),
        host_starts=host_starts, new=new, device=xs[0].device,
        dtype=xs[0].dtype)
    hs = heads.per_shard
    parts = []
    for m, (b, x) in enumerate(zip(blocks, xs)):
        o = whole.to(x.device)
        if M > 1:
            o = o[:, :, m * hs:(m + 1) * hs]
        with on_device(x.device, m):
            parts.append(attn_lib.attn_output(layer_params(b["attn"], li),
                                              o))
    return _residual_ffn([layer_params(b, li) for b in blocks], xs,
                         reduce_from_shards(parts), h)[0]


def block_decode(blocks: dict, li: int, x, h: LMHyper, *, k_cache, v_cache,
                 lengths, cos, sin, window: Optional[int]):
    """``block_decode_shards`` on one shard and one context shard: x
    (B,1,D); caches (B,Smax,Kv,hd) of this layer; lengths (B,) tokens
    ALREADY cached (the new token lands at ``lengths``,
    ``write_step_kv``)."""
    return block_decode_shards([blocks], li, [x], h, k_caches=[k_cache],
                               v_caches=[v_cache], lengths=[lengths],
                               cos=[cos], sin=[sin], window=window)[0]


def block_decode_paged(blocks: dict, li: int, x, h: LMHyper, *, k_pool,
                       v_pool, block_table, write, lengths, cos, sin,
                       window: Optional[int], host_lengths=None):
    """Single-token block ``li`` over a paged KV cache. x (B,1,D); pools
    (NB,bs,Kv,hd) of this layer; block_table (B,MB) int32 (entries >= NB
    are unallocated sentinels); lengths (B,) tokens already cached;
    ``write`` = (rows, slots): the batch rows whose new K/V lands in the
    pool and their flat pool positions ``page·bs + offset`` (the paged
    backend computes them from its host copies of table and lengths). The K/V of the other rows is dropped, as the
    JAX package's ``mode="drop"`` scatter drops it: an unallocated or
    full row owns no page to write to. The write is in place; attention
    then reads the pool in place through the block table."""
    q, k, v = _attn_qkv(blocks, li, x, h, cos, sin)
    if isinstance(k_pool, Sharded):
        attn_out = sharded_decode_attention(q, k, v, k_pool, v_pool,
                                            block_table, write, lengths,
                                            h, window)
    else:
        write_pool_kv(k_pool, v_pool, k, v, write)
        attn_out = attn_lib.decode_attention_paged(
            q, k_pool, v_pool, block_table, h.attn, kv_len=lengths + 1,
            window=window, host_kv_len=(None if host_lengths is None else
                                        [n + 1 for n in host_lengths]))
    return _block_tail(layer_params(blocks, li), x, attn_out, h)[0]


def sharded_decode_attention(q, k, v, k_pool: Sharded, v_pool: Sharded,
                             block_tables, writes, lengths, h: LMHyper,
                             window: Optional[int]):
    """Decode attention over a pool split on the KV-head axis
    (``serving.kv_cache.ShardedPagedBackend``): q (B,1,H,hd) and the new
    k/v (B,1,Kv,hd), projected whole; pools ``Sharded`` on axis 2, part s
    (NB,bs,Kv/tp,hd) on its shard's device; ``block_tables``/``writes``
    the step's table and write addresses on each shard's device. Shard s
    writes its KV heads' slice of the new token, then launches kernel #4
    on the query heads [s·H/tp, (s+1)·H/tp), which are exactly the
    queries of its KV heads (GQA groups are contiguous). The shards'
    outputs are gathered over heads onto the first shard's device: the
    one gather of the step, before ``wo``."""
    tp = len(k_pool.parts)
    kvs, qs = h.attn.n_kv_heads // tp, h.attn.q_heads // tp
    attn = dataclasses.replace(h.attn, n_heads=qs, n_kv_heads=kvs,
                               padded_heads=0)
    kv_len = lengths + 1
    outs = []
    for s, (kp, vp, table, write) in enumerate(zip(
            k_pool.parts, v_pool.parts, block_tables, writes)):
        dev = kp.device
        with on_device(dev):
            heads = slice(s * kvs, (s + 1) * kvs)
            write_pool_kv(kp, vp, k[:, :, heads].to(dev),
                          v[:, :, heads].to(dev), write)
            outs.append(attn_lib.decode_attention_paged(
                q[:, :, s * qs:(s + 1) * qs].to(dev), kp, vp, table, attn,
                kv_len=kv_len.to(dev), window=window))
    return Sharded(outs, 2).gather(q.device)


@dataclasses.dataclass(frozen=True)
class _Heads:
    """The query heads of each of M model shards and the K/V heads they
    read (GQA groups are contiguous: query head j reads K/V head
    j // group)."""

    q_heads: int
    kv_heads: int
    M: int

    @property
    def per_shard(self) -> int:
        return self.q_heads // self.M

    @property
    def aligned(self) -> bool:
        """Each shard's own K/V columns hold exactly the K/V heads its
        query heads read: no gather."""
        return self.kv_heads % self.M == 0

    def select(self, m: int, k, v):
        """Of the gathered k/v (B,S,Kv,hd), the heads shard m's queries
        read, one per query head's group."""
        g, hs = self.q_heads // self.kv_heads, self.per_shard
        lo, hi = m * hs // g, ((m + 1) * hs - 1) // g + 1
        if hi - lo == 1 or (hs % g == 0 and m * hs % g == 0):
            return k[:, :, lo:hi], v[:, :, lo:hi]
        idx = torch.arange(m * hs, (m + 1) * hs, device=k.device) // g
        return k.index_select(2, idx), v.index_select(2, idx)


def _train_attention(ps: List[dict], normed, h: LMHyper, cos, sin,
                     window: Optional[int], causal: bool):
    """A block's attention over M model shards, Megatron style by the
    rules (one shard: the whole layer): ``normed`` the replicated input
    (B,S,D) and cos/sin (B,S,hd/2) (None without RoPE) per shard. Shard m
    projects its query heads (``qkv_out``) and its slice of the K/V
    columns (``kv_out``); where a slice cuts the K/V heads its queries
    read (Kv not a multiple of M), the slices are gathered first, since
    RoPE pairs columns within a head. Attention runs through kernel #5
    under autograd on the shard's heads, under its device; the output
    projection is row-parallel (``o_in``), summed over the shards."""
    a_h = h.attn
    heads = _Heads(a_h.q_heads, a_h.n_kv_heads, len(ps))
    # the shard's query heads (``project_q`` reads q_heads alone)
    local = dataclasses.replace(a_h, n_heads=heads.per_shard,
                                padded_heads=0)
    xin = copy_to_shards(normed)
    kvs = [attn_lib.project_kv(p["attn"], x, a_h) for p, x in zip(ps, xin)]
    ks, vs = [k for k, _ in kvs], [v for _, v in kvs]
    if not heads.aligned:
        ks, vs = gather_from_shards(ks, 2), gather_from_shards(vs, 2)
    outs = []
    for m, (p, x, k, v) in enumerate(zip(ps, xin, ks, vs)):
        q = attn_lib.project_q(p["attn"], x, local, cos[m], sin[m])
        k, v = attn_lib.kv_heads(k, v, a_h, cos[m], sin[m])
        if not heads.aligned:
            k, v = heads.select(m, k, v)
        with on_device(q.device, m):
            o = attn_lib.flash_attention(q, k, v, a_h, q_offset=0,
                                         causal=causal, window=window)
        outs.append(attn_lib.attn_output(p["attn"], o))
    return reduce_from_shards(outs)


def block_train_shards(ps: List[dict], xs, h: LMHyper, *, cos, sin,
                       window: Optional[int], causal: bool = True):
    """Full-sequence block for training over M model shards: ``ps`` one
    layer's parameters per shard (one shard: the whole layer), ``xs`` its
    replicated input (B,S,D) at positions [0, S) and cos/sin (B,S,hd/2)
    (Nones without RoPE) per shard. Q, K and V come from plain products
    and attention from kernel #5 under autograd (``_train_attention``),
    causal unless ``causal`` is False (an encoder). Returns (outs, each
    shard's ``routing_stats`` for a MoE block, else None)."""
    c = h.cfg
    normed = [apply_norm(p["ln1"], x, c.norm, c.norm_eps)
              for p, x in zip(ps, xs)]
    attn = _train_attention(ps, normed, h, cos, sin, window, causal)
    outs, probs = _residual_ffn(ps, xs, attn, h)
    return outs, None if probs is None else [routing_stats(pr)
                                             for pr in probs]


def block_train(p: dict, x, h: LMHyper, *, cos, sin,
                window: Optional[int], causal: bool = True):
    """``block_train_shards`` on one shard, x (B,S,D): (x_out, the FFN's
    load-balance aux: a tensor for a MoE block, else 0.0)."""
    outs, stats = block_train_shards([p], [x], h, cos=[cos], sin=[sin],
                                     window=window, causal=causal)
    if stats is None:
        return outs[0], 0.0
    return outs[0], load_balance_aux([stats], x.shape[0] * x.shape[1])


def unstack_layers(blocks: dict) -> List[dict]:
    """The stacked block parameters as per-layer trees, one
    ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where ``layer_params``' per-layer selects would each add a zeroed
    stack."""
    def split(t):
        return (list(t.unbind(0)) if isinstance(t, torch.Tensor)
                else [dict(zip(t, vals)) for vals in
                      zip(*(split(v) for v in t.values()))])
    return split(blocks)


def remat(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when grad is on
    (the reference's ``remat="full"``, the only setting its launcher and
    tests use): backward recomputes ``fn`` from its inputs, so only they
    stay alive."""
    if not torch.is_grad_enabled():
        return fn(*args)
    base = exec_cost.index(0)

    def run(*a):        # the recompute counts to the same shards
        with exec_cost.shards(base):
            return fn(*a)

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False)


def lm_train_forward_shards(ps: List[dict], tokens, h: LMHyper, *,
                            patches=None):
    """Training forward of an ``lm`` stack over M model shards (the JAX
    package's ``lm_forward`` with ``skip_logits``; one shard: the whole
    model): ``ps`` each shard's parameters (the table a slice of the
    vocabulary where M > 1), ``tokens`` (B,S) at positions [0, S) and
    ``patches`` (B, n_vis, D) or None per shard, on its device. Returns
    (final_x (B,S,D) after the final norm on every shard, per layer each
    shard's ``routing_stats`` for a MoE stack, else Nones). Each block
    runs under ``remat``."""
    c = h.cfg
    B, S = tokens[0].shape
    positions = _shard_positions(tokens, 0)
    cos, sin = _shard_rope(h.attn, positions, S)
    xs = embed_shards(ps, tokens, h, positions=positions, end=S,
                      patches=patches)
    windows = layer_windows(h)
    per_layer = [unstack_layers(p["blocks"]) for p in ps]
    stats = []
    for li in range(c.n_layers):
        run = functools.partial(
            block_train_shards, [layers[li] for layers in per_layer], h=h,
            cos=cos, sin=sin, window=windows[li])
        xs, st = remat(lambda *a, run=run: run(list(a)), *xs)
        stats.append(st)
    return [apply_norm(p["final_norm"], x, c.norm, c.norm_eps)
            for p, x in zip(ps, xs)], stats


def lm_train_forward(params: dict, tokens: torch.Tensor, h: LMHyper, *,
                     patch_embeds=None) -> dict:
    """``lm_train_forward_shards`` on one shard: tokens (B,S), optional
    patch embeddings (B, n_vis, D) in place of the first n_vis tokens' (a
    VLM) -> dict(final_x (B,S,D) after the final norm, aux: the MoE
    layers' load-balance aux summed over layers, as the reference's scan
    carry sums it; 0.0 for a dense stack)."""
    xs, stats = lm_train_forward_shards([params], [tokens], h,
                                        patches=[patch_embeds])
    aux = (0.0 if h.moe is None else load_balance_aux(
        [[st[0]] for st in stats], tokens.shape[0] * tokens.shape[1]))
    return {"final_x": xs[0], "aux": aux}


# ------------------------------------------------------------ full forward
def embed_shards(ps: List[dict], tokens, h, *, positions=None, end=None,
                 patches=None, scale: Optional[bool] = None):
    """Token embeddings (B, S, D) on each of M model shards (one shard:
    the whole table; M > 1: each table a slice of the vocabulary, the
    lookups summed over the shards in shard order), plus the learned
    positions at ``positions`` (B, S) per shard when the stack has them
    (``end`` = ``positions.max() + 1``) and the patch embeddings
    (B, n_vis, D) per shard or None in place of those of the first n_vis
    positions. ``scale`` defaults to the config's ``embedding_scale``."""
    c = h.cfg
    M = len(ps)
    scale = c.embedding_scale if scale is None else scale
    parts = []
    for m, (p, t) in enumerate(zip(ps, tokens)):
        with on_device(t.device, m):
            parts.append(embed_tokens(
                p["embed"], t, scale=scale, d_model=c.d_model,
                first_row=(m * p["embed"]["table"].shape[0] if M > 1
                           else None)))
    return [embed_extras(p, h, x, pos, end, pt) for p, x, pos, pt in zip(
        ps, reduce_from_shards(parts), positions or [None] * M,
        patches or [None] * M)]


def _embed_input(params: dict, h: LMHyper, tokens, positions, end: int,
                 patch_embeds=None):
    """``embed_shards`` on one shard."""
    return embed_shards([params], [tokens], h, positions=[positions],
                        end=end, patches=[patch_embeds])[0]


def embed_extras(params: dict, h: LMHyper, x, positions, end: int,
                 patch_embeds=None):
    """What ``embed_shards`` adds to the token embeddings x (B, S, D):
    the learned positions, the patches, the cast to the model dtype."""
    c = h.cfg
    if not c.use_rope and "positions" in params["embed"]:
        x = x + positional(params["embed"], positions, end).to(x.dtype)
    if patch_embeds is not None:
        n_vis = patch_embeds.shape[1]
        if n_vis > x.shape[1]:
            raise ValueError(f"{n_vis} patch positions in a segment of "
                             f"{x.shape[1]} tokens")
        x = torch.cat([patch_embeds.to(x.dtype), x[:, n_vis:]], dim=1)
    return x.to(h.dtype)


def final_logits_shards(ps: List[dict], xs, cfg: ArchConfig,
                        softcap: Optional[float] = None):
    """The final norm and each model shard's slice of the vocabulary's
    logits (one shard: all of them), under its device."""
    outs = []
    for m, (p, x) in enumerate(zip(ps, xs)):
        with on_device(x.device, m):
            xn = apply_norm(p["final_norm"], x, cfg.norm, cfg.norm_eps)
            n = (p["embed"]["unembed"].shape[1] if "unembed" in p["embed"]
                 else p["embed"]["table"].shape[0])
            outs.append(embed_logits(p["embed"], xn, softcap=softcap,
                                     true_vocab=cfg.vocab_size,
                                     first_col=m * n))
    return outs


def _final_logits(params: dict, x, h: LMHyper):
    c = h.cfg
    return final_logits_shards([params], [x], c, c.logit_softcap)[0]


def _kept(x, sl: slice):
    """Positions ``sl`` of x (B, S, ...): x itself when that is all of
    it, else a copy, so that x can be freed."""
    return x if sl == slice(None) else x[:, sl].clone()


def lm_forward_shards(ps: List[dict], tokens, h: LMHyper, *, patches=None,
                      hist_kv=None, hist_len: Optional[int] = None,
                      capture_hidden: bool = False, emit_kv: bool = False,
                      final_logits_only: bool = False,
                      keep: Optional[List[slice]] = None) -> dict:
    """Prefill forward over M model shards (one shard: ``lm_forward``):
    ``ps`` each shard's parameters (the table a slice of the vocabulary
    where M > 1), ``tokens`` (B,S) and ``patches`` (B,n_vis,D) or None per
    shard on its device, ``hist_kv`` per shard a stacked (L,B,Sh,Kv,hd)
    pair with ``hist_len`` live positions; the blocks are
    ``block_forward_shards``. ``keep``: the positions whose K/V and
    hidden states are emitted, one slice per context shard, slice c taken
    on model shard c % M (default: all of them, once per model shard).
    Returns dict(logits: per model shard; kv: per slice a (k, v) pair of
    (L,B,s,Kv,hd) when ``emit_kv``; hidden: per slice (L,B,s,D) when
    ``capture_hidden``; else None)."""
    M = len(ps)
    keep = keep or [slice(None)] * M
    B, S = tokens[0].shape
    base = 0 if hist_len is None else int(hist_len)
    positions = _shard_positions(tokens, base)
    cos, sin = _shard_rope(h.attn, positions, base + S)
    xs = embed_shards(ps, tokens, h, positions=positions, end=base + S,
                      patches=patches)
    windows = layer_windows(h)
    ks, vs, hidden = ([[] for _ in keep] for _ in range(3))
    for li in range(h.cfg.n_layers):
        if capture_hidden:
            for c, sl in enumerate(keep):
                hidden[c].append(_kept(xs[c % M], sl))
        hkv = (None if hist_kv is None else
               [(hk[li], hv[li]) for hk, hv in hist_kv])
        xs, new = block_forward_shards(
            [p["blocks"] for p in ps], li, xs, h, cos=cos, sin=sin,
            window=windows[li], hist_kv=hkv, hist_len=hist_len)
        if emit_kv:
            for c, sl in enumerate(keep):
                k, v = new[c % M]
                ks[c].append(_kept(k, sl))
                vs[c].append(_kept(v, sl))
    if final_logits_only:
        xs = [x[:, -1:] for x in xs]
    return {"logits": final_logits_shards(ps, xs, h.cfg,
                                          h.cfg.logit_softcap),
            "kv": ([(torch.stack(k), torch.stack(v)) for k, v in zip(ks, vs)]
                   if emit_kv else None),
            "hidden": ([torch.stack(x) for x in hidden] if capture_hidden
                       else None)}


def lm_forward(params: dict, tokens: torch.Tensor, h: LMHyper, *,
               patch_embeds=None, hist_kv=None,
               hist_len: Optional[int] = None, capture_hidden: bool = False,
               emit_kv: bool = False,
               final_logits_only: bool = False) -> dict:
    """Prefill forward, ``lm_forward_shards`` on one shard. tokens (B,S)
    int; patch_embeds optional (B,n_vis,D) in place of the first n_vis
    tokens' embeddings; hist_kv optional restored history, a stacked
    (L,B,Sh,Kv,hd) pair, with ``hist_len`` live positions. Returns
    dict(logits, kv, hidden): kv a (k, v) pair of (L,B,S,Kv,hd) when
    ``emit_kv``, hidden (L,B,S,D) when ``capture_hidden``, else None. The
    training forward is ``lm_train_forward``."""
    out = lm_forward_shards(
        [params], [tokens], h, patches=[patch_embeds],
        hist_kv=None if hist_kv is None else [hist_kv], hist_len=hist_len,
        capture_hidden=capture_hidden, emit_kv=emit_kv,
        final_logits_only=final_logits_only)
    return {"logits": out["logits"][0],
            "kv": out["kv"][0] if emit_kv else None,
            "hidden": out["hidden"][0] if capture_hidden else None}


def lm_decode_step_shards(ps: List[dict], tokens, h: LMHyper, *, k, v,
                          lengths, starts=None, host_lengths=None,
                          host_starts=None):
    """One decode step over M model shards (one shard: ``lm_decode_step``):
    ``ps`` and ``tokens`` (B,1) per model shard, as
    ``lm_forward_shards``; the cache over C context shards, ``k``/``v``
    (L,B,Sc,Kv,hd) written in place, ``lengths`` (B,) and ``starts`` (B,)
    per context shard on its cache's device (``block_decode_shards``);
    ``host_lengths`` (B,) and ``host_starts`` (one int per context
    shard) the same on the host, where the caller knows them: then no
    value is read back from the device. Returns (logits (B,1,V/M) per
    model shard, hidden (L,B,1,D) per model shard)."""
    lens = [lengths[m].to(t.device) for m, t in enumerate(tokens)]
    end = (int(lens[0].max()) if host_lengths is None
           else max(int(n) for n in host_lengths)) + 1
    cos, sin = _shard_rope(h.attn, [n[:, None] for n in lens], end)
    xs = embed_shards(ps, tokens, h, positions=[n[:, None] for n in lens],
                      end=end)
    windows = layer_windows(h)
    hidden = [[] for _ in ps]
    for li in range(h.cfg.n_layers):
        for hs, x in zip(hidden, xs):
            hs.append(x)
        xs = block_decode_shards(
            [p["blocks"] for p in ps], li, xs, h,
            k_caches=[x[li] for x in k], v_caches=[x[li] for x in v],
            lengths=lengths, starts=starts, cos=cos, sin=sin,
            window=windows[li], host_lengths=host_lengths,
            host_starts=host_starts)
    return (final_logits_shards(ps, xs, h.cfg, h.cfg.logit_softcap),
            [torch.stack(x) for x in hidden])


def lm_decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                   h: LMHyper):
    """One decode step, ``lm_decode_step_shards`` on one shard. cache:
    dict(k, v (L,B,Smax,Kv,hd), lengths (B,)). tokens (B,1). Returns
    (logits (B,1,V), new cache, hidden (L,B,1,D)). The new cache shares
    ``k``/``v`` with the old one, which this step wrote into in place."""
    lengths = cache["lengths"]
    logits, hidden = lm_decode_step_shards(
        [params], [tokens], h, k=[cache["k"]], v=[cache["v"]],
        lengths=[lengths])
    new_cache = {"k": cache["k"], "v": cache["v"], "lengths": lengths + 1}
    return logits[0], new_cache, hidden[0]


def lm_decode_step_paged(params: dict, cache: dict, tokens: torch.Tensor,
                         h: LMHyper):
    """One decode step over a paged KV cache. cache: dict(k_pool, v_pool
    (L,NB,bs,Kv,hd), block_table (B,MB) int32, lengths (B,) int32, write:
    the (rows, flat pool positions) of the rows whose new K/V is kept, as
    device tensors, which the caller computes from its host copies of
    table and lengths; optionally ``host_lengths``, its host copy of the
    lengths, so the step reads none back from the device).
    tokens (B,1). Returns (logits (B,1,V), new cache, hidden (L,B,1,D));
    the new cache shares the pools, which this step wrote into in place.
    With every live position mapped by the table this gives the bits of
    ``lm_decode_step`` at logical width MB·bs. Pools split on the KV-head
    axis (``Sharded``, a tensor-parallel backend) come with a table and
    write addresses per shard (``sharded_decode_attention``), and give the
    same bits."""
    lengths, table = cache["lengths"], cache["block_table"]
    k_pool, v_pool, write = cache["k_pool"], cache["v_pool"], cache["write"]
    host = cache.get("host_lengths")
    end = (int(lengths.max()) if host is None else int(max(host))) + 1
    cos, sin = rope_at(h.attn, lengths[:, None], end)
    x = _embed_input(params, h, tokens, lengths[:, None], end)
    windows = layer_windows(h)
    hidden = []
    for li in range(h.cfg.n_layers):
        hidden.append(x)
        x = block_decode_paged(params["blocks"], li, x, h,
                               k_pool=k_pool[li], v_pool=v_pool[li],
                               block_table=table, write=write,
                               lengths=lengths, cos=cos, sin=sin,
                               window=windows[li], host_lengths=host)
    new_cache = {"k_pool": k_pool, "v_pool": v_pool, "block_table": table,
                 "lengths": lengths + 1}
    return _final_logits(params, x, h), new_cache, torch.stack(hidden)


# -------------------------------------------------------------- HCache op
def lm_restore_kv(params: dict, hidden: torch.Tensor, h: LMHyper, *,
                  positions: torch.Tensor, end: Optional[int] = None):
    """Stacked K/V from stacked saved hidden states, in one kernel launch.

    hidden (L,B,S,D) residual-stream inputs per layer; positions (B,S);
    ``end`` = ``positions.max() + 1`` where the caller knows it. Returns
    (k, v): (L,B,S,Kv,hd) each, what prefill with ``emit_kv`` produced
    for these layers."""
    L, B, S, D = hidden.shape
    rows = torch.arange(L, dtype=torch.int32, device=hidden.device)
    cos, sin = rope_at(h.attn, positions, end)
    normed = norm_rows(params["blocks"], rows,
                       hidden.to(h.dtype).reshape(L, B * S, D), h.cfg)
    k, v = project_kv_rows(params["blocks"], rows, normed,
                           cos.reshape(B * S, -1), sin.reshape(B * S, -1),
                           h.attn)
    shape = (L, B, S, h.attn.n_kv_heads, h.attn.head_dim)
    return k.reshape(shape), v.reshape(shape)


def lm_replay_kv(params: dict, tokens: torch.Tensor, segments, h: LMHyper,
                 n_layers: int, patches: Optional[torch.Tensor] = None):
    """K/V of layers [0, n_layers) rebuilt from tokens by replaying the
    session's history segment by segment, the way it was first computed.

    tokens (N,) int; segments: [start, n, "prefill"] or [start, n,
    "decode"(, width, row)] covering [0, N) in order. A prefill segment
    runs as one prefill over the history before it, a decode segment one
    token at a time, in a batch of ``width`` rows (default 1) with the
    session at row ``row`` and zero tokens elsewhere, as a serving
    engine's batched decode ran it. Each layer's output therefore comes
    from the same operations on the same shapes as the original prefills
    and decode steps, so the rebuilt K/V equals theirs bitwise wherever
    those operations are deterministic per shape (the kernels and cuBLAS
    on one card: a library product picks its algorithm from the batch
    width, so a B=4 step need not give a B=1 step's bits). Rebuilding the
    whole stream in one prefill would instead sum attention in another
    order and drift from the decoded history. ``patches`` (n_vis, D), a
    VLM session's patch embeddings, enter the prefill segment that starts
    at 0, as they entered its first prefill. Returns (k, v):
    (n_layers, 1, N, Kv, hd)."""
    N = tokens.shape[0]
    a = h.attn
    dev = tokens.device
    W = max([int(seg[3]) for seg in segments
             if seg[2] == "decode" and len(seg) > 3] + [1])
    # 2W - 1 cache rows with the session's at row W - 1: the W-row window
    # that starts at W - 1 - row puts it at batch row ``row``
    shape = (n_layers, 2 * W - 1, N, a.n_kv_heads, a.head_dim)
    kbuf = torch.zeros(shape, dtype=h.dtype, device=dev)
    vbuf = torch.zeros_like(kbuf)
    k, v = kbuf[:, W - 1:W], vbuf[:, W - 1:W]
    blocks, windows = params["blocks"], layer_windows(h)
    for seg in segments:
        start, n, kind = seg[0], seg[1], seg[2]
        if kind == "prefill":
            positions = start + torch.arange(n, device=dev)[None]
            cos, sin = rope_at(a, positions, start + n)
            x = _embed_input(params, h, tokens[None, start:start + n],
                             positions, start + n,
                             patches[None] if patches is not None
                             and start == 0 else None)
            for li in range(n_layers):
                hist = ((k[li][:, :start], v[li][:, :start])
                        if start else None)
                x, (kl, vl) = block_forward(
                    blocks, li, x, h, cos=cos, sin=sin, window=windows[li],
                    hist_kv=hist, hist_len=start if start else None)
                k[li][:, start:start + n] = kl
                v[li][:, start:start + n] = vl
            continue
        width, row = (int(seg[3]), int(seg[4])) if len(seg) > 3 else (1, 0)
        lo = W - 1 - row
        kc, vc = kbuf[:, lo:lo + width], vbuf[:, lo:lo + width]
        toks = torch.zeros((width, 1), dtype=tokens.dtype, device=dev)
        for p in range(start, start + n):
            toks[row, 0] = tokens[p]
            lengths = torch.full((width,), p, dtype=torch.int32, device=dev)
            cos, sin = rope_at(a, lengths[:, None], p + 1)
            x = _embed_input(params, h, toks, lengths[:, None], p + 1)
            for li in range(n_layers):
                x = block_decode(blocks, li, x, h, k_cache=kc[li],
                                 v_cache=vc[li], lengths=lengths, cos=cos,
                                 sin=sin, window=windows[li])
    return k, v
