"""Decoder-only LM stack (dense / GQA / MoE / VLM) over layer-stacked
parameters.

Entry points (functions over the parameter dict):

  init_lm         -> parameters, stacked along a leading layer axis
  lm_forward      -> full-sequence forward (prefill), optionally capturing
                     per-layer hidden states (the HCache save path) and
                     emitting stacked K/V
  lm_decode_step  -> one decode token per sequence; also returns the
                     per-layer hidden states
  lm_decode_step_paged -> the same over a paged KV pool (block tables)
  lm_restore_kv   -> the paper's op: stacked K/V from stacked saved
                     hidden states (norm + projection + RoPE only)
  lm_train_forward -> the training forward (the reference's ``lm_forward(
                     ..., skip_logits=True)``): final hidden states for the
                     chunked loss and the MoE load-balance aux, each
                     block under activation checkpointing,
                     differentiable through kernel #5

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
from repro_torch.distributed.tp import Sharded, on_device
from repro_torch.kernels import ops
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers.attention import AttnHyper
from repro_torch.models.layers.embedding import (MAX_POSITIONS, embed_tokens,
                                                 init_embedding,
                                                 logits as embed_logits,
                                                 positional)
from repro_torch.models.layers.mlp import apply_mlp, init_mlp
from repro_torch.models.layers.moe import (MoEHyper, apply_moe, init_moe,
                                           load_balance_aux)
from repro_torch.models.layers.norm import apply_norm, init_norm
from repro_torch.models.layers.rope import rope_table
from repro_torch.models.module import stacked_init


@dataclasses.dataclass(frozen=True)
class LMHyper:
    cfg: ArchConfig
    dtype: torch.dtype = torch.float32
    max_positions: int = MAX_POSITIONS   # learned-position stacks only

    @functools.cached_property
    def attn(self) -> AttnHyper:
        c = self.cfg
        return AttnHyper(
            n_heads=c.n_heads, n_kv_heads=c.n_kv_heads, head_dim=c.head_dim_,
            qkv_bias=c.qkv_bias, use_rope=c.use_rope,
            rope_theta=c.rope_theta, attn_softcap=c.attn_softcap)

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


@functools.lru_cache(maxsize=None)
def _row(li: int, device: torch.device) -> torch.Tensor:
    """Layer ``li``'s row index on ``device``, uploaded once: a fresh
    upload per layer would make the host wait for the device every time."""
    return torch.tensor([li], dtype=torch.int32, device=device)


def _attn_qkv(blocks, li, x, h: LMHyper, cos, sin):
    """normed input, q (B,S,H,hd), k/v (B,S,Kv,hd) of layer ``li``."""
    B, S, D = x.shape
    rows = _row(li, x.device)
    normed = norm_rows(blocks, rows, x.reshape(1, B * S, D), h.cfg)
    k, v = project_kv_rows(blocks, rows, normed, cos.reshape(B * S, -1),
                           sin.reshape(B * S, -1), h.attn)
    normed = normed.reshape(B, S, D)
    q = attn_lib.project_q(layer_params(blocks["attn"], li), normed, h.attn,
                           cos, sin)
    kv_shape = (B, S, h.attn.n_kv_heads, h.attn.head_dim)
    return q, k.reshape(kv_shape), v.reshape(kv_shape)


def _ffn(p: dict, x, h: LMHyper):
    """The block's FFN: (out, the MoE router's softmax (B,S,E), or None
    for a dense FFN)."""
    if h.moe is None:
        return apply_mlp(p["mlp"], x, h.cfg.ffn_activation), None
    return apply_moe(p["moe"], x, h.moe)


def _block_tail(p: dict, x, attn_out, h: LMHyper):
    """Output projection, residual and FFN of a block: (x_out, the FFN's
    router softmax or None)."""
    c = h.cfg
    attn_out = attn_lib.attn_output(p["attn"], attn_out)
    if c.post_attn_norm:
        attn_out = apply_norm(p["post_ln1"], attn_out, c.norm, c.norm_eps)
    x = x + attn_out
    normed2 = apply_norm(p["ln2"], x, c.norm, c.norm_eps)
    ff, probs = _ffn(p, normed2, h)
    if c.post_attn_norm:
        ff = apply_norm(p["post_ln2"], ff, c.norm, c.norm_eps)
    return x + ff, probs


# ---------------------------------------------------------------- blocks
def block_forward(blocks: dict, li: int, x, h: LMHyper, *, cos, sin,
                  window: Optional[int], hist_kv=None,
                  hist_len: Optional[int] = None):
    """Full-sequence block ``li``. x (B,S,D) at positions hist_len + [0, S);
    cos/sin (B,S,hd/2); optional restored history K/V (B,Sh,Kv,hd) pair
    prepended to the attention context. Returns (x_out, (k, v) of the new
    tokens)."""
    q, k, v = _attn_qkv(blocks, li, x, h, cos, sin)
    if hist_kv is not None:
        hk, hv = hist_kv
        k_all = torch.cat([hk.to(k.dtype), k], dim=1)
        v_all = torch.cat([hv.to(v.dtype), v], dim=1)
        kv_len = None if hist_len is None else hist_len + x.shape[1]
    else:
        k_all, v_all, kv_len = k, v, None
    attn_out = attn_lib.flash_attention(
        q, k_all, v_all, h.attn, q_offset=hist_len or 0, causal=True,
        window=window, kv_len=kv_len)
    return _block_tail(layer_params(blocks, li), x, attn_out, h)[0], (k, v)


def write_step_kv(k_cache, v_cache, k, v, lengths) -> None:
    """A decode step's new K/V (B,1,Kv,hd) into caches (B,Smax,Kv,hd) at
    ``lengths``, IN PLACE (the JAX package's ``.at[].set`` returns a new
    array); a slot that is already full drops the write, as
    ``mode="drop"`` does."""
    B, smax = k.shape[0], k_cache.shape[1]
    bidx = torch.arange(B, device=k.device)
    slot = lengths.long().clamp(max=smax - 1)
    fits = (lengths.long() < smax)[:, None, None]
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


def block_decode(blocks: dict, li: int, x, h: LMHyper, *, k_cache, v_cache,
                 lengths, cos, sin, window: Optional[int]):
    """Single-token block ``li``. x (B,1,D); caches (B,Smax,Kv,hd) of this
    layer; lengths (B,) tokens ALREADY cached (the new token lands at
    ``lengths``, ``write_step_kv``)."""
    q, k, v = _attn_qkv(blocks, li, x, h, cos, sin)
    write_step_kv(k_cache, v_cache, k, v, lengths)
    attn_out = attn_lib.decode_attention(q, k_cache, v_cache, h.attn,
                                         kv_len=lengths + 1, window=window)
    return _block_tail(layer_params(blocks, li), x, attn_out, h)[0]


def block_decode_paged(blocks: dict, li: int, x, h: LMHyper, *, k_pool,
                       v_pool, block_table, write, lengths, cos, sin,
                       window: Optional[int]):
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
            window=window)
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
    kvs, qs = h.attn.n_kv_heads // tp, h.attn.n_heads // tp
    attn = dataclasses.replace(h.attn, n_heads=qs, n_kv_heads=kvs)
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


def block_train(p: dict, x, h: LMHyper, *, cos, sin,
                window: Optional[int], causal: bool = True):
    """Full-sequence block for training: ``p`` one layer's parameters, x
    (B,S,D) at positions [0, S), cos/sin (B,S,hd/2) (None without RoPE).
    Q, K and V come from plain products (``layers.attention.project_qkv``)
    and attention from kernel #5 under autograd, causal unless ``causal``
    is False (an encoder). Returns (x_out, the FFN's load-balance aux:
    a tensor for a MoE block, else 0.0)."""
    c = h.cfg
    normed = apply_norm(p["ln1"], x, c.norm, c.norm_eps)
    q, k, v = attn_lib.project_qkv(p["attn"], normed, h.attn, cos, sin)
    attn_out = attn_lib.flash_attention(q, k, v, h.attn, q_offset=0,
                                        causal=causal, window=window)
    x, probs = _block_tail(p, x, attn_out, h)
    return x, (0.0 if probs is None else load_balance_aux(probs))


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
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def lm_train_forward(params: dict, tokens: torch.Tensor, h: LMHyper, *,
                     patch_embeds=None) -> dict:
    """Training forward of an ``lm`` stack (the JAX package's
    ``lm_forward`` with ``skip_logits``): tokens (B,S) at positions [0, S),
    optional patch embeddings (B, n_vis, D) in place of the first n_vis
    tokens' (a VLM) -> dict(final_x (B,S,D) after the final norm, aux: the
    MoE layers' load-balance aux summed over layers, as the reference's
    scan carry sums it; 0.0 for a dense stack). Each block runs under
    ``remat``."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    cos, sin = rope_at(h.attn, positions, S)
    x = _embed_input(params, h, tokens, positions, S, patch_embeds)
    windows = layer_windows(h)
    aux = 0.0
    for li, p in enumerate(unstack_layers(params["blocks"])):
        x, a = remat(functools.partial(block_train, p, h=h, cos=cos, sin=sin,
                                       window=windows[li]), x)
        aux = aux + a
    c = h.cfg
    return {"final_x": apply_norm(params["final_norm"], x, c.norm,
                                  c.norm_eps),
            "aux": aux}


# ------------------------------------------------------------ full forward
def _embed_input(params: dict, h: LMHyper, tokens, positions, end: int,
                 patch_embeds=None):
    """Token embeddings (B, S, D), plus the learned positions at
    ``positions`` (B, S) when the stack has them (``end`` =
    ``positions.max() + 1``); ``patch_embeds`` (B, n_vis, D) replace
    those of the first n_vis positions."""
    c = h.cfg
    x = embed_tokens(params["embed"], tokens, scale=c.embedding_scale,
                     d_model=c.d_model)
    if not c.use_rope and "positions" in params["embed"]:
        x = x + positional(params["embed"], positions, end).to(x.dtype)
    if patch_embeds is not None:
        n_vis = patch_embeds.shape[1]
        if n_vis > x.shape[1]:
            raise ValueError(f"{n_vis} patch positions in a segment of "
                             f"{x.shape[1]} tokens")
        x = torch.cat([patch_embeds.to(x.dtype), x[:, n_vis:]], dim=1)
    return x.to(h.dtype)


def _final_logits(params: dict, x, h: LMHyper):
    c = h.cfg
    x = apply_norm(params["final_norm"], x, c.norm, c.norm_eps)
    return embed_logits(params["embed"], x, softcap=c.logit_softcap,
                        true_vocab=c.vocab_size)


def lm_forward(params: dict, tokens: torch.Tensor, h: LMHyper, *,
               patch_embeds=None, hist_kv=None,
               hist_len: Optional[int] = None, capture_hidden: bool = False,
               emit_kv: bool = False,
               final_logits_only: bool = False) -> dict:
    """Prefill forward. tokens (B,S) int; patch_embeds optional (B,n_vis,D)
    in place of the first n_vis tokens' embeddings; hist_kv optional
    restored history, a stacked (L,B,Sh,Kv,hd) pair, with ``hist_len``
    live positions. Returns dict(logits, kv, hidden): kv a (k, v) pair of
    (L,B,S,Kv,hd) when ``emit_kv``, hidden (L,B,S,D) when
    ``capture_hidden``, else None. The training forward is
    ``lm_train_forward``."""
    B, S = tokens.shape
    base = 0 if hist_len is None else int(hist_len)
    positions = base + torch.arange(S, device=tokens.device)[None, :]
    positions = positions.expand(B, S)
    cos, sin = rope_at(h.attn, positions, base + S)
    x = _embed_input(params, h, tokens, positions, base + S, patch_embeds)
    windows = layer_windows(h)
    blocks = params["blocks"]
    ks, vs, hidden = [], [], []
    for li in range(h.cfg.n_layers):
        if capture_hidden:
            hidden.append(x)
        hkv = (None if hist_kv is None
               else (hist_kv[0][li], hist_kv[1][li]))
        x, (k, v) = block_forward(blocks, li, x, h, cos=cos, sin=sin,
                                  window=windows[li], hist_kv=hkv,
                                  hist_len=hist_len)
        if emit_kv:
            ks.append(k)
            vs.append(v)
    if final_logits_only:
        x = x[:, -1:]
    return {"logits": _final_logits(params, x, h),
            "kv": (torch.stack(ks), torch.stack(vs)) if emit_kv else None,
            "hidden": torch.stack(hidden) if capture_hidden else None}


def lm_decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                   h: LMHyper):
    """One decode step. cache: dict(k, v (L,B,Smax,Kv,hd), lengths (B,)).
    tokens (B,1). Returns (logits (B,1,V), new cache, hidden (L,B,1,D)).
    The new cache shares ``k``/``v`` with the old one, which this step
    wrote into in place."""
    lengths = cache["lengths"]
    end = int(lengths.max()) + 1
    cos, sin = rope_at(h.attn, lengths[:, None], end)
    x = _embed_input(params, h, tokens, lengths[:, None], end)
    windows = layer_windows(h)
    hidden = []
    for li in range(h.cfg.n_layers):
        hidden.append(x)
        x = block_decode(params["blocks"], li, x, h, k_cache=cache["k"][li],
                         v_cache=cache["v"][li], lengths=lengths, cos=cos,
                         sin=sin, window=windows[li])
    new_cache = {"k": cache["k"], "v": cache["v"], "lengths": lengths + 1}
    return _final_logits(params, x, h), new_cache, torch.stack(hidden)


def lm_decode_step_paged(params: dict, cache: dict, tokens: torch.Tensor,
                         h: LMHyper):
    """One decode step over a paged KV cache. cache: dict(k_pool, v_pool
    (L,NB,bs,Kv,hd), block_table (B,MB) int32, lengths (B,) int32, write:
    the (rows, flat pool positions) of the rows whose new K/V is kept, as
    device tensors, which the caller computes from its host copies of
    table and lengths).
    tokens (B,1). Returns (logits (B,1,V), new cache, hidden (L,B,1,D));
    the new cache shares the pools, which this step wrote into in place.
    With every live position mapped by the table this gives the bits of
    ``lm_decode_step`` at logical width MB·bs. Pools split on the KV-head
    axis (``Sharded``, a tensor-parallel backend) come with a table and
    write addresses per shard (``sharded_decode_attention``), and give the
    same bits."""
    lengths, table = cache["lengths"], cache["block_table"]
    k_pool, v_pool, write = cache["k_pool"], cache["v_pool"], cache["write"]
    end = int(lengths.max()) + 1
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
                               window=windows[li])
    new_cache = {"k_pool": k_pool, "v_pool": v_pool, "block_table": table,
                 "lengths": lengths + 1}
    return _final_logits(params, x, h), new_cache, torch.stack(hidden)


# -------------------------------------------------------------- HCache op
def lm_restore_kv(params: dict, hidden: torch.Tensor, h: LMHyper, *,
                  positions: torch.Tensor):
    """Stacked K/V from stacked saved hidden states, in one kernel launch.

    hidden (L,B,S,D) residual-stream inputs per layer; positions (B,S).
    Returns (k, v): (L,B,S,Kv,hd) each, what prefill with ``emit_kv``
    produced for these layers."""
    L, B, S, D = hidden.shape
    rows = torch.arange(L, dtype=torch.int32, device=hidden.device)
    cos, sin = rope_at(h.attn, positions)
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
