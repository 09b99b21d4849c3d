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
  encdec_train_forward -> the training forward (encoder, then the
                       decoder over the targets' inputs)

``encode``, ``decode_prefill`` and ``decode_step`` are the one-shard calls
of ``encode_shards``, ``decode_prefill_shards`` and
``decode_step_shards``, which run the same blocks over the model shards
of a mesh (``distributed/mesh_serving.py``: query heads, ``o_in``,
``d_ff`` and the vocabulary split; the cross K/V split along the
context at decode).

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
``enc_len`` as its live length. The training forward projects every
K/V by plain products instead (kernel #1 has no backward) and takes
kernel #5 under autograd.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.config.arch import ArchConfig
from repro_torch.distributed.collectives import (gather_from_shards,
                                                 reduce_from_shards)
from repro_torch.distributed.tp import on_device
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
def encode_shards(ps, frames, h: EncDecHyper, *,
                  capture_hidden: bool = False):
    """The encoder over M model shards (one shard: ``encode``): ``ps``
    each shard's parameters, ``frames`` (B, S_enc, D) per shard on its
    device (the ``seq`` axis is whole under the default rules, so every
    model shard of a data shard holds all frames). Each block is
    ``transformer.block_forward_shards`` without a causal mask: per layer
    and shard kernel #1 once (the K/V of every head) and kernel #5 once,
    non-causal, on the shard's query heads. Returns (enc_out (B, S_enc,
    D) per shard, per shard the per-layer hidden states (L_enc, B, S_enc,
    D) when ``capture_hidden``, else None)."""
    c = h.cfg
    xs, cos, sin = [], [], []
    for m, f in enumerate(frames):
        B, S, D = f.shape
        with on_device(f.device, m):
            pos = sinusoidal_positions(S, D, h.dtype, f.device)
            xs.append(f.to(h.dtype) + pos[None])
            positions = torch.arange(S, device=f.device)[None].expand(B, S)
            cs, sn = tfm.rope_at(h.attn, positions, S)
        cos.append(cs)
        sin.append(sn)
    hidden = [[] for _ in xs]
    for li in range(c.encoder_layers):
        if capture_hidden:
            for hs, x in zip(hidden, xs):
                hs.append(x)
        xs, _ = tfm.block_forward_shards(
            [p["enc_blocks"] for p in ps], li, xs, h.lm, cos=cos, sin=sin,
            window=None, causal=False)
    outs = []
    for m, (p, x) in enumerate(zip(ps, xs)):
        with on_device(x.device, m):
            outs.append(apply_norm(p["enc_norm"], x, c.norm, c.norm_eps))
    return outs, ([torch.stack(x) for x in hidden] if capture_hidden
                  else None)


def encode(params: dict, frames: torch.Tensor, h: EncDecHyper, *,
           capture_hidden: bool = False):
    """frames (B, S_enc, D) -> (enc_out (B, S_enc, D), per-layer hidden
    states (L_enc, B, S_enc, D) when ``capture_hidden``, else None):
    ``encode_shards`` on one shard."""
    outs, hidden = encode_shards([params], [frames], h,
                                 capture_hidden=capture_hidden)
    return outs[0], (hidden[0] if capture_hidden else None)


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


def _local_attn(h: EncDecHyper, M: int):
    """(head split, the query heads' hyper of one of M model shards:
    None for one shard)."""
    a = h.attn
    heads = tfm._Heads(a.q_heads, a.n_kv_heads, M)
    return heads, (None if M == 1 else dataclasses.replace(
        a, n_heads=heads.per_shard, padded_heads=0))


def decode_prefill_shards(ps, tokens, h: EncDecHyper, *, cross,
                          capture_hidden: bool = False, emit_kv: bool = False,
                          final_logits_only: bool = False, hist_kv=None,
                          hist_len: Optional[int] = None,
                          pos_offset: int = 0, keep=None) -> dict:
    """Decoder prefill over M model shards (one shard:
    ``decode_prefill``): ``ps`` each shard's parameters (query heads,
    ``o_in``, ``d_ff`` and the vocabulary split where M > 1, the whole
    K/V projection of the self- and cross-attention), ``tokens`` (B, S)
    per shard, ``cross`` per shard the stacked cross K/V (L, B, S_enc, Kv,
    hd) pair of every head (``cross_kv`` on its copy of the encoder
    output), ``hist_kv`` per shard a restored (L, B, hist_len, Kv, hd)
    pair or None. Per layer and shard: kernel #1 once (self K/V of every
    head), kernel #5 twice on the shard's query heads (causal
    self-attention, non-causal cross-attention of the prompt over all
    S_enc keys); ``wo`` of both and the FFN row-parallel, summed over the
    shards in shard order. ``keep``: the positions of the captured
    hidden states, one slice per context shard, slice c taken on model
    shard c % M (default all, once per model shard). Returns
    dict(logits per shard; kv per model shard a (k, v) pair of (L, B, S,
    Kv, hd), whole (the self cache is whole along the context), when
    ``emit_kv``; hidden per slice (L, B, s, D) when ``capture_hidden``;
    cross_kv: ``cross``)."""
    c = h.cfg
    M = len(ps)
    keep = keep or [slice(None)] * M
    heads, local = _local_attn(h, M)
    S = tokens[0].shape[1]
    positions = tfm._shard_positions(tokens, pos_offset)
    cos, sin = tfm._shard_rope(h.attn, positions, pos_offset + S)
    xs = tfm.embed_shards(ps, tokens, h.lm, positions=positions,
                          end=pos_offset + S, scale=False)
    kv_len = None if hist_kv is None else int(hist_len) + S
    ks, vs = [[] for _ in ps], [[] for _ in ps]
    hidden = [[] for _ in keep]
    for li in range(c.n_layers):
        if capture_hidden:
            for j, sl in enumerate(keep):
                hidden[j].append(tfm._kept(xs[j % M], sl))
        lps = [tfm.layer_params(p["dec_blocks"], li) for p in ps]
        outs = []
        for m, (p, x) in enumerate(zip(ps, xs)):
            with on_device(x.device, m):
                q, k, v = tfm._attn_qkv(self_view(p["dec_blocks"]), li, x,
                                        h.lm, cos[m], sin[m], q_attn=local)
                if emit_kv:
                    ks[m].append(k)
                    vs[m].append(v)
                if hist_kv is not None:
                    k = torch.cat([hist_kv[m][0][li].to(k.dtype), k], dim=1)
                    v = torch.cat([hist_kv[m][1][li].to(v.dtype), v], dim=1)
                if M > 1:
                    k, v = heads.select(m, k, v)
                a = attn_lib.flash_attention(q, k, v, h.attn,
                                             q_offset=pos_offset,
                                             causal=True, kv_len=kv_len)
                outs.append(attn_lib.attn_output(lps[m]["self_attn"], a))
        xs = [x + o for x, o in zip(xs, reduce_from_shards(outs))]
        outs = []
        for m, (lp, x) in enumerate(zip(lps, xs)):
            with on_device(x.device, m):
                normed = apply_norm(lp["ln_x"], x, c.norm, c.norm_eps)
                q = attn_lib.project_q(lp["cross_attn"], normed,
                                       local or h.attn, None, None)
                ck, cv = cross[m][0][li], cross[m][1][li]
                if M > 1:
                    ck, cv = heads.select(m, ck, cv)
                a = attn_lib.flash_attention(q, ck, cv, h.attn, q_offset=0,
                                             causal=False)
                outs.append(attn_lib.attn_output(lp["cross_attn"], a))
        xs = _ffn_tail(lps, [x + o for x, o in zip(xs,
                                                   reduce_from_shards(outs))],
                       h)
    if final_logits_only:
        xs = [x[:, -1:] for x in xs]
    return {"logits": tfm.final_logits_shards(ps, xs, c),
            "kv": ([(torch.stack(k), torch.stack(v)) for k, v in zip(ks, vs)]
                   if emit_kv else None),
            "hidden": ([torch.stack(x) for x in hidden] if capture_hidden
                       else None),
            "cross_kv": cross}


def _ffn_tail(lps, xs, h: EncDecHyper):
    """``ln2``, the FFN (column- then row-parallel over the shards) and
    the residual of one decoder layer over M model shards."""
    c = h.cfg
    normed = []
    for m, (lp, x) in enumerate(zip(lps, xs)):
        with on_device(x.device, m):
            normed.append(apply_norm(lp["ln2"], x, c.norm, c.norm_eps))
    ff, _ = tfm._ffn(lps, normed, h.lm)
    return [x + f for x, f in zip(xs, ff)]


def decode_prefill(params: dict, tokens: torch.Tensor,
                   enc_out: Optional[torch.Tensor], h: EncDecHyper, *,
                   capture_hidden: bool = False, emit_kv: bool = False,
                   final_logits_only: bool = False, hist_kv=None,
                   hist_len: Optional[int] = None, cross=None,
                   pos_offset: int = 0) -> dict:
    """Decoder prefill over tokens (B, S), ``decode_prefill_shards`` on
    one shard. ``hist_kv``: restored self-K/V history, a stacked (L, B,
    hist_len, Kv, hd) pair the chunk attends over; ``cross``: the stacked
    cross K/V (L, B, S_enc, Kv, hd) pair of the slot, in place of
    projecting ``enc_out`` (which may then be None); ``pos_offset``: the
    chunk's absolute start, so the learned positions and the causal mask
    line up with the history. Returns dict(logits, kv, hidden,
    cross_kv)."""
    ckv = cross if cross is not None else cross_kv(params, enc_out, h)
    out = decode_prefill_shards(
        [params], [tokens], h, cross=[ckv], capture_hidden=capture_hidden,
        emit_kv=emit_kv, final_logits_only=final_logits_only,
        hist_kv=None if hist_kv is None else [hist_kv], hist_len=hist_len,
        pos_offset=pos_offset)
    return {"logits": out["logits"][0],
            "kv": out["kv"][0] if emit_kv else None,
            "hidden": out["hidden"][0] if capture_hidden else None,
            "cross_kv": ckv}


def _step_inputs(params: dict, cache: dict, tokens, h: EncDecHyper):
    """Embedded tokens (B, 1, D), cos/sin and (B,) int32 encoder lengths
    of a paged decode step; ``cache["enc_len"]`` may be a scalar."""
    lengths = cache["lengths"]
    B = tokens.shape[0]
    end = int(lengths.max()) + 1
    x = _embed(params, h, tokens, lengths[:, None], end)
    cos, sin = tfm.rope_at(h.attn, lengths[:, None], end)
    return x, cos, sin, _enc_lengths(cache["enc_len"], B, tokens.device)


def _enc_lengths(enc_len, B: int, device) -> torch.Tensor:
    """(B,) int32 encoder lengths from a scalar or (B,) ``enc_len``."""
    return torch.as_tensor(enc_len, device=device).to(torch.int32).reshape(
        -1).expand(B)


def decode_step_shards(ps, tokens, h: EncDecHyper, *, self_k, self_v,
                       cross_k, cross_v, enc_len, lengths, starts=None,
                       host_lengths=None, host_enc_len: Optional[int] = None,
                       host_starts=None):
    """One decode step over M model shards (one shard: ``decode_step``):
    ``ps`` and ``tokens`` (B, 1) per model shard, as
    ``decode_prefill_shards``; ``self_k``/``self_v`` (L, B, Smax, Kv, hd)
    per model shard, each shard's copy of the whole self cache (written
    in place: each shard writes the new token's K/V of every head into
    its copy), ``lengths`` (B,) per model shard; the cross cache over C
    context shards, ``cross_k``/``cross_v`` (L, B, Sc, Kv, hd), ``enc_len``
    (a scalar or (B,)) and ``starts`` (B,) the absolute position of each
    slice's first key (None: one shard) per context shard. Per layer:
    kernel #1 once per model shard (self K/V of every head), kernel #3
    once per model shard on its query heads over the whole self cache,
    and once per context shard for the cross-attention (the query of
    every head, gathered over the model shards, against each slice with
    its ``kv_start`` at the absolute length ``enc_len``, the log-sum-exp
    merged in fp32 in shard order: ``transformer.attend_slices``).
    ``host_lengths`` (B,), ``host_enc_len`` and ``host_starts`` (one int
    per context shard) on the host, where the caller knows them: then no
    value is read back from the device. Returns (logits (B, 1, V/M) per
    model shard, hidden (L, B, 1, D) per model shard)."""
    c = h.cfg
    M = len(ps)
    heads, local = _local_attn(h, M)
    B = tokens[0].shape[0]
    lens = [lengths[m].to(t.device) for m, t in enumerate(tokens)]
    end = (int(lens[0].max()) if host_lengths is None
           else max(int(n) for n in host_lengths)) + 1
    positions = [n[:, None] for n in lens]
    cos, sin = tfm._shard_rope(h.attn, positions, end)
    xs = tfm.embed_shards(ps, tokens, h.lm, positions=positions, end=end,
                          scale=False)
    enc = []
    for j, e in enumerate(enc_len):
        with on_device(cross_k[j].device, j):
            enc.append(_enc_lengths(e, B, cross_k[j].device))
    host_self = (None if host_lengths is None else
                 [int(n) + 1 for n in host_lengths])
    host_cross = None if host_enc_len is None else [int(host_enc_len)] * B
    hidden = [[] for _ in ps]
    for li in range(c.n_layers):
        for hs, x in zip(hidden, xs):
            hs.append(x)
        lps = [tfm.layer_params(p["dec_blocks"], li) for p in ps]
        outs = []
        for m, (p, x, n) in enumerate(zip(ps, xs, lens)):
            with on_device(x.device, m):
                q, k, v = tfm._attn_qkv(self_view(p["dec_blocks"]), li, x,
                                        h.lm, cos[m], sin[m], q_attn=local)
                kc, vc = self_k[m][li], self_v[m][li]
                tfm.write_step_kv(kc, vc, k, v, n)
                a_h = h.attn
                if M > 1:
                    kc, vc = heads.select(m, kc, vc)
                    a_h = dataclasses.replace(local, n_kv_heads=kc.shape[2])
                a = attn_lib.decode_attention(q, kc, vc, a_h, kv_len=n + 1,
                                              host_kv_len=host_self)
                outs.append(attn_lib.attn_output(lps[m]["self_attn"], a))
        xs = [x + o for x, o in zip(xs, reduce_from_shards(outs))]
        qs = []
        for m, (lp, x) in enumerate(zip(lps, xs)):
            with on_device(x.device, m):
                normed = apply_norm(lp["ln_x"], x, c.norm, c.norm_eps)
                qs.append(attn_lib.project_q(lp["cross_attn"], normed,
                                             local or h.attn, None, None))
        whole = tfm.attend_slices(
            gather_from_shards(qs, 2), [x[li] for x in cross_k],
            [x[li] for x in cross_v], h.attn, lengths=enc, grow=0,
            starts=starts, host_kv_len=host_cross, host_starts=host_starts,
            device=xs[0].device, dtype=xs[0].dtype)
        hs = heads.per_shard
        outs = []
        for m, (lp, x) in enumerate(zip(lps, xs)):
            o = whole.to(x.device)
            if M > 1:
                o = o[:, :, m * hs:(m + 1) * hs]
            with on_device(x.device, m):
                outs.append(attn_lib.attn_output(lp["cross_attn"], o))
        xs = _ffn_tail(lps, [x + o for x, o in zip(xs,
                                                   reduce_from_shards(outs))],
                       h)
    return (tfm.final_logits_shards(ps, xs, c),
            [torch.stack(x) for x in hidden])


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                h: EncDecHyper):
    """One decode step, ``decode_step_shards`` on one shard. cache:
    dict(self_k/self_v (L, B, Smax, Kv, hd), cross_k/cross_v (L, B,
    S_enc, Kv, hd), enc_len scalar or (B,), lengths (B,)); tokens (B,
    1). Returns (logits (B, 1, V), new cache, hidden (L, B, 1, D)); the
    new cache shares the buffers, whose self K/V this step wrote in
    place."""
    lengths = cache["lengths"]
    logits, hidden = decode_step_shards(
        [params], [tokens], h, self_k=[cache["self_k"]],
        self_v=[cache["self_v"]], cross_k=[cache["cross_k"]],
        cross_v=[cache["cross_v"]], enc_len=[cache["enc_len"]],
        lengths=[lengths])
    return logits[0], dict(cache, lengths=lengths + 1), hidden[0]


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
                    positions: torch.Tensor, end: Optional[int] = None):
    """The decoder's self K/V (L, B, S, Kv, hd) from its stacked saved
    hidden states (L, B, S, D): ``ln1`` and the restoration kernel, in one
    launch, as ``transformer.lm_restore_kv`` (``end`` =
    ``positions.max() + 1`` where the caller knows it)."""
    return tfm.lm_restore_kv({"blocks": self_view(params["dec_blocks"])},
                             hidden, h.lm, positions=positions, end=end)


# ------------------------------------------------------------- training
def _dec_block_train(p: dict, x, enc_out, h: EncDecHyper):
    """One decoder layer ``p`` for training: causal self-attention, then
    cross-attention over K/V projected from ``enc_out`` (B, S_enc, D) by
    plain products (no bias, as the reference's ``cross_kv``), then the
    FFN. Attention is kernel #5 under autograd."""
    c, a = h.cfg, h.attn
    B, Se, _ = enc_out.shape
    normed = apply_norm(p["ln1"], x, c.norm, c.norm_eps)
    q, k, v = attn_lib.project_qkv(p["self_attn"], normed, a, None, None)
    x = x + attn_lib.attn_output(p["self_attn"], attn_lib.flash_attention(
        q, k, v, a, q_offset=0, causal=True))
    ca = p["cross_attn"]
    ck = torch.matmul(enc_out, ca["wk"]).reshape(B, Se, a.n_kv_heads,
                                                 a.head_dim)
    cv = torch.matmul(enc_out, ca["wv"]).reshape(B, Se, a.n_kv_heads,
                                                 a.head_dim)
    return _cross_and_ffn(p, x, h, ck, cv, None)


def encdec_train_forward(params: dict, frames: torch.Tensor,
                         tokens: torch.Tensor, h: EncDecHyper) -> dict:
    """Training forward (the JAX package's ``encode`` then
    ``decode_prefill(..., skip_logits=True)``): frames (B, S_enc, D),
    tokens (B, S) -> dict(final_x (B, S, D) after the final norm, aux
    0.0). The encoder's blocks are ``transformer.block_train`` without a
    causal mask; each block, encoder and decoder, runs under
    ``transformer.remat``."""
    c = h.cfg
    B, Se, D = frames.shape
    x = frames.to(h.dtype) + sinusoidal_positions(Se, D, h.dtype,
                                                  frames.device)[None]
    for p in tfm.unstack_layers(params["enc_blocks"]):
        x, _ = tfm.remat(functools.partial(tfm.block_train, p, h=h.lm,
                                           cos=None, sin=None, window=None,
                                           causal=False), x)
    enc_out = apply_norm(params["enc_norm"], x, c.norm, c.norm_eps)
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = _embed(params, h, tokens, positions, S)
    for p in tfm.unstack_layers(params["dec_blocks"]):
        x = tfm.remat(functools.partial(_dec_block_train, p, h=h), x,
                      enc_out)
    return {"final_x": apply_norm(params["final_norm"], x, c.norm,
                                  c.norm_eps),
            "aux": 0.0}
