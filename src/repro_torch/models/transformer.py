"""Decoder-only LM stack (dense / GQA) over layer-stacked parameters.

Entry points (functions over the parameter dict):

  init_lm         -> parameters, stacked along a leading layer axis
  lm_forward      -> full-sequence forward (prefill), optionally capturing
                     per-layer hidden states (the HCache save path) and
                     emitting stacked K/V
  lm_decode_step  -> one decode token per sequence; also returns the
                     per-layer hidden states
  lm_restore_kv   -> the paper's op: stacked K/V from stacked saved
                     hidden states (norm + projection + RoPE only)

The saved hidden state of layer i is the residual-stream INPUT to layer i.
Prefill, decode and restoration all compute K/V with ``norm_rows`` and
``project_kv_rows``: the model's own norm and the grouped restoration
kernel (``kernels.ops.restore_kv_grouped``) over the whole weight stack,
with the batch folded into the kernel's token axis. Restored K/V therefore
equals prefill K/V by construction.

The JAX package scans over the layer stack; here the stack is walked by a
Python loop, since PyTorch runs eagerly.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import torch

from repro_torch.config.arch import ArchConfig, AttnKind
from repro_torch.kernels import ops
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers.attention import AttnHyper
from repro_torch.models.layers.embedding import (embed_tokens, init_embedding,
                                                 logits as embed_logits)
from repro_torch.models.layers.mlp import apply_mlp, init_mlp
from repro_torch.models.layers.norm import apply_norm, init_norm
from repro_torch.models.layers.rope import rope_table
from repro_torch.models.module import stacked_init


@dataclasses.dataclass(frozen=True)
class LMHyper:
    cfg: ArchConfig
    dtype: torch.dtype = torch.float32

    @functools.cached_property
    def attn(self) -> AttnHyper:
        c = self.cfg
        return AttnHyper(
            n_heads=c.n_heads, n_kv_heads=c.n_kv_heads, head_dim=c.head_dim_,
            qkv_bias=c.qkv_bias, use_rope=c.use_rope,
            rope_theta=c.rope_theta, attn_softcap=c.attn_softcap)


# ------------------------------------------------------------------- params
def init_block(gen: torch.Generator, h: LMHyper, device) -> dict:
    c = h.cfg
    p = {
        "ln1": init_norm(c.norm, c.d_model, h.dtype, device),
        "attn": attn_lib.init_attention(gen, c.d_model, h.attn, h.dtype,
                                        device),
        "ln2": init_norm(c.norm, c.d_model, h.dtype, device),
        "mlp": init_mlp(gen, c.d_model, c.d_ff, c.ffn_glu, h.dtype, device),
    }
    if c.post_attn_norm:
        p["post_ln1"] = init_norm(c.norm, c.d_model, h.dtype, device)
        p["post_ln2"] = init_norm(c.norm, c.d_model, h.dtype, device)
    return p


def init_lm(gen: torch.Generator, h: LMHyper, device) -> dict:
    c = h.cfg
    return {
        "embed": init_embedding(gen, c.vocab_size, c.d_model, h.dtype,
                                device, c.tie_embeddings),
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


def rope_at(h: AttnHyper, positions: torch.Tensor):
    """cos/sin (..., hd/2) at ``positions``, gathered from the shared
    table (see ``layers.rope.rope_table``)."""
    cos, sin = rope_table(int(positions.max()) + 1, h.head_dim,
                          h.rope_theta, positions.device)
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


def _block_tail(p: dict, x, attn_out, h: LMHyper):
    c = h.cfg
    attn_out = attn_lib.attn_output(p["attn"], attn_out)
    if c.post_attn_norm:
        attn_out = apply_norm(p["post_ln1"], attn_out, c.norm, c.norm_eps)
    x = x + attn_out
    normed2 = apply_norm(p["ln2"], x, c.norm, c.norm_eps)
    ff = apply_mlp(p["mlp"], normed2, c.ffn_activation)
    if c.post_attn_norm:
        ff = apply_norm(p["post_ln2"], ff, c.norm, c.norm_eps)
    return x + ff


# ---------------------------------------------------------------- blocks
def block_forward(blocks: dict, li: int, x, h: LMHyper, *, cos, sin,
                  positions, window: Optional[int], hist_kv=None,
                  hist_len: Optional[int] = None):
    """Full-sequence block ``li``. x (B,S,D); cos/sin (B,S,hd/2); optional
    restored history K/V (B,Sh,Kv,hd) pair prepended to the attention
    context. Returns (x_out, (k, v) of the new tokens)."""
    q, k, v = _attn_qkv(blocks, li, x, h, cos, sin)
    if hist_kv is not None:
        hk, hv = hist_kv
        k_all = torch.cat([hk.to(k.dtype), k], dim=1)
        v_all = torch.cat([hv.to(v.dtype), v], dim=1)
        kv_len = None if hist_len is None else hist_len + x.shape[1]
    else:
        k_all, v_all, kv_len = k, v, None
    attn_out = attn_lib.flash_attention(
        q, k_all, v_all, h.attn, q_positions=positions, causal=True,
        window=window, kv_len=kv_len)
    return _block_tail(layer_params(blocks, li), x, attn_out, h), (k, v)


def block_decode(blocks: dict, li: int, x, h: LMHyper, *, k_cache, v_cache,
                 lengths, cos, sin, window: Optional[int]):
    """Single-token block ``li``. x (B,1,D); caches (B,Smax,Kv,hd) of this
    layer; lengths (B,) tokens ALREADY cached (the new token lands at
    ``lengths``). The new K/V is written into the caches IN PLACE (the
    JAX package's ``.at[].set`` returns a new array); a slot that is
    already full drops the write, as ``mode="drop"`` does."""
    B = x.shape[0]
    q, k, v = _attn_qkv(blocks, li, x, h, cos, sin)
    smax = k_cache.shape[1]
    bidx = torch.arange(B, device=x.device)
    slot = lengths.long().clamp(max=smax - 1)
    fits = (lengths.long() < smax)[:, None, None]
    k_cache[bidx, slot] = torch.where(fits, k[:, 0], k_cache[bidx, slot])
    v_cache[bidx, slot] = torch.where(fits, v[:, 0], v_cache[bidx, slot])
    attn_out = attn_lib.decode_attention(q, k_cache, v_cache, h.attn,
                                         kv_len=lengths + 1, window=window)
    return _block_tail(layer_params(blocks, li), x, attn_out, h)


# ------------------------------------------------------------ full forward
def _embed_input(params: dict, h: LMHyper, tokens):
    c = h.cfg
    x = embed_tokens(params["embed"], tokens, scale=c.embedding_scale,
                     d_model=c.d_model)
    return x.to(h.dtype)


def _final_logits(params: dict, x, h: LMHyper):
    c = h.cfg
    x = apply_norm(params["final_norm"], x, c.norm, c.norm_eps)
    return embed_logits(params["embed"], x, softcap=c.logit_softcap,
                        true_vocab=c.vocab_size)


def lm_forward(params: dict, tokens: torch.Tensor, h: LMHyper, *,
               hist_kv=None, hist_len: Optional[int] = None,
               capture_hidden: bool = False, emit_kv: bool = False,
               final_logits_only: bool = False) -> dict:
    """Prefill forward. tokens (B,S) int; hist_kv optional restored
    history, a stacked (L,B,Sh,Kv,hd) pair, with ``hist_len`` live
    positions. Returns dict(logits, kv, hidden): kv a (k, v) pair of
    (L,B,S,Kv,hd) when ``emit_kv``, hidden (L,B,S,D) when
    ``capture_hidden``, else None."""
    B, S = tokens.shape
    base = 0 if hist_len is None else int(hist_len)
    positions = base + torch.arange(S, device=tokens.device)[None, :]
    positions = positions.expand(B, S)
    cos, sin = rope_at(h.attn, positions)
    x = _embed_input(params, h, tokens)
    windows = layer_windows(h)
    blocks = params["blocks"]
    ks, vs, hidden = [], [], []
    for li in range(h.cfg.n_layers):
        if capture_hidden:
            hidden.append(x)
        hkv = (None if hist_kv is None
               else (hist_kv[0][li], hist_kv[1][li]))
        x, (k, v) = block_forward(blocks, li, x, h, cos=cos, sin=sin,
                                  positions=positions, window=windows[li],
                                  hist_kv=hkv, hist_len=hist_len)
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
    cos, sin = rope_at(h.attn, lengths[:, None])
    x = _embed_input(params, h, tokens)
    windows = layer_windows(h)
    hidden = []
    for li in range(h.cfg.n_layers):
        hidden.append(x)
        x = block_decode(params["blocks"], li, x, h, k_cache=cache["k"][li],
                         v_cache=cache["v"][li], lengths=lengths, cos=cos,
                         sin=sin, window=windows[li])
    new_cache = {"k": cache["k"], "v": cache["v"], "lengths": lengths + 1}
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
                 n_layers: int):
    """K/V of layers [0, n_layers) rebuilt from tokens by replaying the
    session's history segment by segment, the way it was first computed.

    tokens (N,) int; segments: [start, n, "prefill" | "decode"] covering
    [0, N) in order — a prefill segment runs as one prefill over the
    history before it, a decode segment one token at a time. Each layer's
    output therefore comes from the same operations on the same shapes as
    the original prefills and decode steps, so the rebuilt K/V equals
    theirs bitwise wherever those operations are deterministic per shape
    (the kernels and cuBLAS on one card). Rebuilding the whole stream in
    one prefill would instead sum attention in another order and drift
    from the decoded history. Returns (k, v): (n_layers, 1, N, Kv, hd)."""
    N = tokens.shape[0]
    a = h.attn
    k = torch.zeros((n_layers, 1, N, a.n_kv_heads, a.head_dim), dtype=h.dtype,
                    device=tokens.device)
    v = torch.zeros_like(k)
    blocks, windows = params["blocks"], layer_windows(h)
    for start, n, kind in segments:
        if kind == "prefill":
            positions = start + torch.arange(n, device=tokens.device)[None]
            cos, sin = rope_at(a, positions)
            x = _embed_input(params, h, tokens[None, start:start + n])
            for li in range(n_layers):
                hist = ((k[li][:, :start], v[li][:, :start])
                        if start else None)
                x, (kl, vl) = block_forward(
                    blocks, li, x, h, cos=cos, sin=sin, positions=positions,
                    window=windows[li], hist_kv=hist,
                    hist_len=start if start else None)
                k[li][:, start:start + n] = kl
                v[li][:, start:start + n] = vl
        else:
            for p in range(start, start + n):
                lengths = torch.tensor([p], dtype=torch.int32,
                                       device=tokens.device)
                cos, sin = rope_at(a, lengths[:, None])
                x = _embed_input(params, h, tokens[None, p:p + 1])
                for li in range(n_layers):
                    x = block_decode(blocks, li, x, h, k_cache=k[li],
                                     v_cache=v[li], lengths=lengths, cos=cos,
                                     sin=sin, window=windows[li])
    return k, v
