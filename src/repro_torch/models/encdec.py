"""Encoder-decoder stack (whisper-medium).

The audio conv frontend is a stub, as in the JAX package: a request
carries precomputed frame embeddings (B, S_enc, D); the encoder adds
sinusoidal positions and runs bidirectional blocks. The decoder adds
learned positions to its token embeddings and runs causal self-attention
and cross-attention over the encoder output.

Entry points (functions over the parameter dict):

  init_encdec       -> parameters: ``embed`` (with ``positions``),
                       ``enc_blocks`` and ``enc_norm``, ``dec_blocks``
                       (``ln1``/``self_attn``, ``ln_x``/``cross_attn``,
                       ``ln2``/``mlp``), ``final_norm``
  encode            -> encoder output (and per-layer hidden states)
  cross_kv          -> the cross K/V of every decoder layer from the
                       encoder output (prefill, and the HCache restore of
                       the cross context: one stored tensor rebuilds 2·L)
  decode_prefill    -> decoder prefill, over restored history and a cross
                       state from the cache when given
  decode_step       -> one decode token per sequence (contiguous cache)
  decode_step_paged -> the same over a paged self-K/V pool
  restore_self_kv   -> the paper's op for the decoder self-attention

Every K/V goes through the grouped restoration kernel
(``kernels.ops.restore_kv_grouped``): the encoder's and the decoder's
self K/V as the transformer stack computes them (``transformer.
_attn_qkv``, through a view of the decoder blocks with ``self_attn`` as
``attn``), the cross K/V of all L decoder layers in one launch over the
stacked ``cross_attn`` weights (no norm, no bias, no RoPE), with the
encoder output copied to each of the L group rows (the kernel takes a
contiguous (G, S, D) input). Prefill and restore call ``cross_kv`` on the
same encoder output, so the restored cross K/V equals the prefill's bit
for bit. Attention runs through the kernels: the encoder non-causal
(#5), decoder self-attention causal (#5) in prefill and through the
decode kernels (#3 contiguous, #4 paged) at decode, cross-attention
non-causal (#5) in prefill and through #3 at decode, with each row's
``enc_len`` as its live length.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.config.arch import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers.embedding import (MAX_POSITIONS, embed_tokens,
                                                 init_embedding,
                                                 logits as embed_logits,
                                                 positional)
from repro_torch.models.layers.mlp import apply_mlp, init_mlp
from repro_torch.models.layers.norm import apply_norm, init_norm
from repro_torch.models.layers.rope import rope_table, sinusoidal_positions
from repro_torch.models.module import stacked_init


@dataclasses.dataclass(frozen=True)
class EncDecHyper:
    cfg: ArchConfig
    dtype: torch.dtype = torch.float32
    max_positions: int = MAX_POSITIONS     # decoder learned positions

    @functools.cached_property
    def lm(self) -> tfm.LMHyper:
        """The view the transformer's block helpers take: MHA without
        RoPE, LayerNorm, a plain GELU FFN."""
        return tfm.LMHyper(cfg=self.cfg, dtype=self.dtype,
                           max_positions=self.max_positions)

    @property
    def attn(self):
        return self.lm.attn


# ------------------------------------------------------------------- params
def _init_dec_block(gen: torch.Generator, h: EncDecHyper, device) -> dict:
    c = h.cfg
    return {
        "ln1": init_norm(c.norm, c.d_model, h.dtype, device),
        "self_attn": attn_lib.init_attention(gen, c.d_model, h.attn,
                                             h.dtype, device),
        "ln_x": init_norm(c.norm, c.d_model, h.dtype, device),
        "cross_attn": attn_lib.init_attention(gen, c.d_model, h.attn,
                                              h.dtype, device),
        "ln2": init_norm(c.norm, c.d_model, h.dtype, device),
        "mlp": init_mlp(gen, c.d_model, c.d_ff, c.ffn_glu, h.dtype, device),
    }


def init_encdec(gen: torch.Generator, h: EncDecHyper, device) -> dict:
    c = h.cfg
    return {
        "embed": init_embedding(gen, c.vocab_size, c.d_model, h.dtype,
                                device, c.tie_embeddings, h.max_positions),
        "enc_blocks": stacked_init(lambda: tfm.init_block(gen, h.lm, device),
                                   c.encoder_layers),
        "enc_norm": init_norm(c.norm, c.d_model, h.dtype, device),
        "dec_blocks": stacked_init(lambda: _init_dec_block(gen, h, device),
                                   c.n_layers),
        "final_norm": init_norm(c.norm, c.d_model, h.dtype, device),
    }


def self_view(dec_blocks: dict) -> dict:
    """The decoder blocks' self-attention as the transformer stack's
    block layout (``ln1`` and ``attn``): what ``transformer._attn_qkv``,
    ``norm_rows`` and ``project_kv_rows`` read."""
    return {"ln1": dec_blocks["ln1"], "attn": dec_blocks["self_attn"]}


def _rope_rows(h: EncDecHyper, n: int, device):
    """cos/sin (n, hd/2) for the kernel's operands; RoPE is off, so the
    kernel never applies them."""
    cos, sin = rope_table(n, h.attn.head_dim, h.attn.rope_theta, device)
    return cos[:n], sin[:n]


# ------------------------------------------------------------------ encoder
def encode(params: dict, frames: torch.Tensor, h: EncDecHyper, *,
           capture_hidden: bool = False):
    """frames (B, S_enc, D) -> (enc_out (B, S_enc, D), per-layer hidden
    states (L_enc, B, S_enc, D) when ``capture_hidden``, else None)."""
    c = h.cfg
    B, S, D = frames.shape
    pos = sinusoidal_positions(S, D, h.dtype, frames.device)
    x = frames.to(h.dtype) + pos[None]
    positions = torch.arange(S, device=frames.device)[None].expand(B, S)
    cos, sin = tfm.rope_at(h.attn, positions, S)
    blocks = params["enc_blocks"]
    hidden = []
    for li in range(c.encoder_layers):
        if capture_hidden:
            hidden.append(x)
        q, k, v = tfm._attn_qkv(blocks, li, x, h.lm, cos, sin)
        a = attn_lib.flash_attention(q, k, v, h.attn, q_offset=0,
                                     causal=False)
        x = tfm._block_tail(tfm.layer_params(blocks, li), x, a, h.lm)
    x = apply_norm(params["enc_norm"], x, c.norm, c.norm_eps)
    return x, (torch.stack(hidden) if capture_hidden else None)


@functools.lru_cache(maxsize=None)
def _all_rows(n: int, device: torch.device) -> torch.Tensor:
    """Rows [0, n) as int32 on ``device``, uploaded once."""
    return torch.arange(n, dtype=torch.int32, device=device)


def cross_kv(params: dict, enc_out: torch.Tensor, h: EncDecHyper):
    """The stacked cross K/V of every decoder layer, (L, B, S_enc, Kv, hd)
    each, in one launch of the restoration kernel over the stacked
    ``cross_attn`` weights."""
    c, a = h.cfg, h.attn
    L = c.n_layers
    B, S, D = enc_out.shape
    hidden = enc_out.to(h.dtype).reshape(1, B * S, D).expand(
        L, B * S, D).contiguous()
    cross = params["dec_blocks"]["cross_attn"]
    cos, sin = _rope_rows(h, B * S, enc_out.device)
    k, v = ops.restore_kv_grouped(
        hidden, cross["wk"], cross["wv"], None, None,
        _all_rows(L, enc_out.device), cos, sin, head_dim=a.head_dim,
        use_rope=False)
    shape = (L, B, S, a.n_kv_heads, a.head_dim)
    return k.view(shape), v.view(shape)


# ------------------------------------------------------------------ decoder
def _embed(params: dict, h: EncDecHyper, tokens, positions, end: int):
    c = h.cfg
    x = embed_tokens(params["embed"], tokens, scale=False, d_model=c.d_model)
    x = x + positional(params["embed"], positions, end).to(x.dtype)
    return x.to(h.dtype)


def _cross_and_ffn(p: dict, x, h: EncDecHyper, ck, cv, enc_len):
    """Cross-attention over (ck, cv) (B, S_enc, Kv, hd), then the FFN, of
    one decoder layer ``p``. ``enc_len`` None: a prefill chunk over all
    S_enc keys (kernel #5, non-causal); else (B,) live lengths of a decode
    step (kernel #3)."""
    c = h.cfg
    normed = apply_norm(p["ln_x"], x, c.norm, c.norm_eps)
    q = attn_lib.project_q(p["cross_attn"], normed, h.attn, None, None)
    if enc_len is None:
        a = attn_lib.flash_attention(q, ck, cv, h.attn, q_offset=0,
                                     causal=False)
    else:
        a = attn_lib.decode_attention(q, ck, cv, h.attn, kv_len=enc_len)
    x = x + attn_lib.attn_output(p["cross_attn"], a)
    normed2 = apply_norm(p["ln2"], x, c.norm, c.norm_eps)
    return x + apply_mlp(p["mlp"], normed2, c.ffn_activation)


def _final_logits(params: dict, x, h: EncDecHyper):
    c = h.cfg
    x = apply_norm(params["final_norm"], x, c.norm, c.norm_eps)
    return embed_logits(params["embed"], x, true_vocab=c.vocab_size)


def decode_prefill(params: dict, tokens: torch.Tensor,
                   enc_out: Optional[torch.Tensor], h: EncDecHyper, *,
                   capture_hidden: bool = False, emit_kv: bool = False,
                   final_logits_only: bool = False, hist_kv=None,
                   hist_len: Optional[int] = None, cross=None,
                   pos_offset: int = 0) -> dict:
    """Decoder prefill over tokens (B, S). ``hist_kv``: restored self-K/V
    history, a stacked (L, B, hist_len, Kv, hd) pair the chunk attends
    over; ``cross``: the stacked cross K/V (L, B, S_enc, Kv, hd) pair of
    the slot, in place of projecting ``enc_out`` (which may then be
    None); ``pos_offset``: the chunk's absolute start, so the learned
    positions and the causal mask line up with the history. Returns
    dict(logits, kv, hidden, cross_kv)."""
    c = h.cfg
    B, S = tokens.shape
    dev = tokens.device
    positions = (pos_offset + torch.arange(S, device=dev))[None].expand(B, S)
    x = _embed(params, h, tokens, positions, pos_offset + S)
    ckv = cross if cross is not None else cross_kv(params, enc_out, h)
    cos, sin = tfm.rope_at(h.attn, positions, pos_offset + S)
    blocks = params["dec_blocks"]
    view = self_view(blocks)
    ks, vs, hidden = [], [], []
    for li in range(c.n_layers):
        if capture_hidden:
            hidden.append(x)
        q, k, v = tfm._attn_qkv(view, li, x, h.lm, cos, sin)
        if hist_kv is not None:
            k_all = torch.cat([hist_kv[0][li].to(k.dtype), k], dim=1)
            v_all = torch.cat([hist_kv[1][li].to(v.dtype), v], dim=1)
            kv_len = int(hist_len) + S
        else:
            k_all, v_all, kv_len = k, v, None
        a = attn_lib.flash_attention(q, k_all, v_all, h.attn,
                                     q_offset=pos_offset, causal=True,
                                     kv_len=kv_len)
        p = tfm.layer_params(blocks, li)
        x = x + attn_lib.attn_output(p["self_attn"], a)
        x = _cross_and_ffn(p, x, h, ckv[0][li], ckv[1][li], None)
        if emit_kv:
            ks.append(k)
            vs.append(v)
    if final_logits_only:
        x = x[:, -1:]
    return {"logits": _final_logits(params, x, h),
            "kv": (torch.stack(ks), torch.stack(vs)) if emit_kv else None,
            "hidden": torch.stack(hidden) if capture_hidden else None,
            "cross_kv": ckv}


def _step_inputs(params: dict, cache: dict, tokens, h: EncDecHyper):
    """Embedded tokens (B, 1, D), cos/sin and (B,) int32 encoder lengths
    of a decode step; ``cache["enc_len"]`` may be a scalar."""
    lengths = cache["lengths"]
    B = tokens.shape[0]
    end = int(lengths.max()) + 1
    x = _embed(params, h, tokens, lengths[:, None], end)
    cos, sin = tfm.rope_at(h.attn, lengths[:, None], end)
    enc_len = torch.as_tensor(cache["enc_len"], device=tokens.device).to(
        torch.int32).reshape(-1).expand(B)
    return x, cos, sin, enc_len


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                h: EncDecHyper):
    """One decode step. cache: dict(self_k/self_v (L, B, Smax, Kv, hd),
    cross_k/cross_v (L, B, S_enc, Kv, hd), enc_len scalar or (B,),
    lengths (B,)); tokens (B, 1). Returns (logits (B, 1, V), new cache,
    hidden (L, B, 1, D)); the new cache shares the buffers, whose self
    K/V this step wrote in place."""
    lengths = cache["lengths"]
    x, cos, sin, enc_len = _step_inputs(params, cache, tokens, h)
    blocks = params["dec_blocks"]
    view = self_view(blocks)
    hidden = []
    for li in range(h.cfg.n_layers):
        hidden.append(x)
        kc, vc = cache["self_k"][li], cache["self_v"][li]
        q, k, v = tfm._attn_qkv(view, li, x, h.lm, cos, sin)
        tfm.write_step_kv(kc, vc, k, v, lengths)
        a = attn_lib.decode_attention(q, kc, vc, h.attn, kv_len=lengths + 1)
        p = tfm.layer_params(blocks, li)
        x = x + attn_lib.attn_output(p["self_attn"], a)
        x = _cross_and_ffn(p, x, h, cache["cross_k"][li],
                           cache["cross_v"][li], enc_len)
    new_cache = dict(cache, lengths=lengths + 1)
    return _final_logits(params, x, h), new_cache, torch.stack(hidden)


def decode_step_paged(params: dict, cache: dict, tokens: torch.Tensor,
                      h: EncDecHyper):
    """One decode step with the self K/V in a page pool. cache:
    dict(k_pool/v_pool (L, NB, bs, Kv, hd), block_table (B, MB) int32,
    write (rows, flat pool positions), cross_k/cross_v (L, B, S_enc, Kv,
    hd), enc_len (B,), lengths (B,)). Same contract as ``decode_step``;
    with every live position mapped by the table it gives that step's
    bits (the cross side is the same per-slot layout in both)."""
    lengths, table = cache["lengths"], cache["block_table"]
    x, cos, sin, enc_len = _step_inputs(params, cache, tokens, h)
    blocks = params["dec_blocks"]
    view = self_view(blocks)
    hidden = []
    for li in range(h.cfg.n_layers):
        hidden.append(x)
        kp, vp = cache["k_pool"][li], cache["v_pool"][li]
        q, k, v = tfm._attn_qkv(view, li, x, h.lm, cos, sin)
        tfm.write_pool_kv(kp, vp, k, v, cache["write"])
        a = attn_lib.decode_attention_paged(q, kp, vp, table, h.attn,
                                            kv_len=lengths + 1)
        p = tfm.layer_params(blocks, li)
        x = x + attn_lib.attn_output(p["self_attn"], a)
        x = _cross_and_ffn(p, x, h, cache["cross_k"][li],
                           cache["cross_v"][li], enc_len)
    new_cache = {k: cache[k] for k in ("k_pool", "v_pool", "block_table",
                                       "cross_k", "cross_v", "enc_len")}
    new_cache["lengths"] = lengths + 1
    return _final_logits(params, x, h), new_cache, torch.stack(hidden)


# -------------------------------------------------------------- HCache op
def restore_self_kv(params: dict, hidden: torch.Tensor, h: EncDecHyper, *,
                    positions: torch.Tensor):
    """The decoder's self K/V (L, B, S, Kv, hd) from its stacked saved
    hidden states (L, B, S, D): ``ln1`` and the restoration kernel, in one
    launch, as ``transformer.lm_restore_kv``."""
    return tfm.lm_restore_kv({"blocks": self_view(params["dec_blocks"])},
                             hidden, h.lm, positions=positions)
