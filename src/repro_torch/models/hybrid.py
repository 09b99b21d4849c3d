"""Hybrid Mamba2 + attention stack (zamba2) over layer-stacked parameters.

The stack is a walk over *super-blocks*: each is (k-1) Mamba2 blocks and
then one full transformer (attention + MLP) block, k =
``cfg.hybrid_attn_every``; zamba2-2.7b's 54 layers are 9 super-blocks of
5 Mamba2 blocks and 1 attention block. Global layer ``s·k + j`` is Mamba2
block ``j`` of super-block ``s`` for j < k-1 and attention block ``s``
for j = k-1.

Entry points (functions over the parameter dict: ``embed``; ``mamba``
stacked (n_super, k-1, ...); ``attn`` stacked (n_super, ...);
``final_norm``):

  init_hybrid                 -> parameters
  hybrid_forward              -> full-sequence forward (prefill) from zero
                                 state, optionally capturing the hidden
                                 states and emitting the attention K/V and
                                 the Mamba2 states
  hybrid_decode_step          -> one decode token per sequence over a
                                 cache, which it updates in place
  hybrid_train_forward        -> the training forward: final hidden states
                                 for the chunked loss, each block under
                                 activation checkpointing, the attention
                                 blocks through ``transformer.block_train``
  hybrid_restore_attn_kv      -> the paper's op on the attention blocks
  hybrid_restore_mamba_states -> ssm-rescan of every Mamba2 block

``hybrid_forward`` and ``hybrid_decode_step`` are the one-shard calls of
``hybrid_forward_shards`` and ``hybrid_decode_step_shards``, which run the
same blocks over the model shards of a mesh (``distributed/
mesh_serving.py``; the Mamba2 blocks over ``ssm_heads``,
``layers/mamba.py::apply_mamba2_shards``).

The attention blocks run ``transformer.block_forward``/``block_decode``
over ``params["attn"]`` through ``HybridHyper.lm``: its row ``s`` is
attention block ``s``, so the K/V projection (the restoration kernel),
prefill attention and decode attention are the lm family's. HCache
restores the attention blocks from their saved hidden states and the
Mamba2 blocks' states as one blob (``core/hcache.py``);
``hybrid_restore_mamba_states`` is model API that no restore path calls,
as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.config.arch import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers.embedding import embed_tokens, init_embedding
from repro_torch.distributed.tp import on_device
from repro_torch.models.layers.mamba import (Mamba2Hyper, apply_mamba2,
                                             apply_mamba2_shards, init_mamba2,
                                             mamba2_conv_from_layout,
                                             mamba2_conv_to_layout)
from repro_torch.models.layers.norm import apply_norm, init_norm
from repro_torch.models.module import stacked_init
from repro_torch.models.transformer import layer_params


@dataclasses.dataclass(frozen=True)
class HybridHyper:
    cfg: ArchConfig
    dtype: torch.dtype = torch.float32

    @property
    def k(self) -> int:
        return self.cfg.hybrid_attn_every

    @property
    def n_super(self) -> int:
        return self.cfg.n_layers // self.k

    @functools.cached_property
    def mamba(self) -> Mamba2Hyper:
        c = self.cfg
        return Mamba2Hyper(d_model=c.d_model, d_state=c.ssm_state,
                           head_dim=c.ssm_headdim, d_conv=c.ssm_conv,
                           expand=c.ssm_expand)

    @functools.cached_property
    def lm(self) -> tfm.LMHyper:
        """The view the attention blocks run under; its layer rows are the
        n_super attention blocks."""
        return tfm.LMHyper(cfg=self.cfg, dtype=self.dtype)


def init_hybrid(gen: torch.Generator, h: HybridHyper, device) -> dict:
    c = h.cfg

    def mamba_block():
        return {"ln": init_norm(c.norm, c.d_model, h.dtype, device),
                "m": init_mamba2(gen, h.mamba, h.dtype, device)}

    return {
        "embed": init_embedding(gen, c.vocab_size, c.d_model, h.dtype,
                                device, c.tie_embeddings),
        "mamba": stacked_init(lambda: stacked_init(mamba_block, h.k - 1),
                              h.n_super),
        "attn": stacked_init(lambda: tfm.init_block(gen, h.lm, device),
                             h.n_super),
        "final_norm": init_norm(c.norm, c.d_model, h.dtype, device),
    }


def _mamba_params(params: dict, s: int, j: int) -> dict:
    return layer_params(layer_params(params["mamba"], s), j)


def _mamba_block(mp: dict, x, h: HybridHyper, **state):
    c = h.cfg
    normed = apply_norm(mp["ln"], x, c.norm, c.norm_eps)
    out, states = apply_mamba2(mp["m"], normed, h.mamba, **state)
    return x + out, states


def _mamba_block_shards(mps, xs, h: HybridHyper, *, init_states=None,
                        conv_states=None):
    """One Mamba2 block over M model shards (``mps`` its parameters per
    shard, ``xs`` the replicated input): (outs, each shard's states)."""
    c = h.cfg
    normed = []
    for m, (mp, x) in enumerate(zip(mps, xs)):
        with on_device(x.device, m):
            normed.append(apply_norm(mp["ln"], x, c.norm, c.norm_eps))
    outs, states = apply_mamba2_shards(
        [mp["m"] for mp in mps], normed, h.mamba, init_states=init_states,
        conv_states=conv_states)
    return [x + o for x, o in zip(xs, outs)], states


def _embed(params: dict, tokens, h: HybridHyper):
    return embed_tokens(params["embed"], tokens, scale=False,
                        d_model=h.cfg.d_model).to(h.dtype)


def hybrid_train_forward(params: dict, tokens: torch.Tensor,
                         h: HybridHyper) -> dict:
    """Training forward (the JAX package's ``hybrid_forward`` with
    ``skip_logits``): tokens (B,S) -> dict(final_x (B,S,D) after the final
    norm, aux summed over the attention blocks, as the reference's scan
    carry sums it: 0.0, their FFNs being dense). The attention blocks
    project q/k/v by plain products (``transformer.block_train``, kernel
    #5 under autograd): ``block_forward``'s K/V come from kernel #1,
    which has no backward. Each block runs under ``transformer.remat``."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    cos, sin = tfm.rope_at(h.lm.attn, positions, S)
    x = _embed(params, tokens, h)
    aux = 0.0
    for mps, ap in zip(tfm.unstack_layers(params["mamba"]),
                       tfm.unstack_layers(params["attn"])):
        for mp in tfm.unstack_layers(mps):
            x = tfm.remat(lambda xx, mp=mp: _mamba_block(mp, xx, h)[0], x)
        x, a = tfm.remat(functools.partial(tfm.block_train, ap, h=h.lm,
                                           cos=cos, sin=sin, window=None), x)
        aux = aux + a
    c = h.cfg
    return {"final_x": apply_norm(params["final_norm"], x, c.norm,
                                  c.norm_eps),
            "aux": aux}


def _by_block(xs, h: HybridHyper):
    """Per-block tensors of the (n_super·(k-1)) Mamba2 blocks stacked as
    (n_super, k-1, ...)."""
    t = torch.stack(xs)
    return t.view(h.n_super, h.k - 1, *t.shape[1:])


def hybrid_forward_shards(ps, tokens, h: HybridHyper, *,
                          capture_hidden: bool = False,
                          emit_state: bool = False,
                          final_logits_only: bool = False,
                          keep=None) -> dict:
    """Prefill forward from zero state over M model shards (one shard:
    ``hybrid_forward``): ``ps`` each shard's parameters (the attention
    blocks' query heads, ``o_in`` and ``d_ff`` and the whole K/V
    projection, as ``transformer.block_forward_shards`` takes them; the
    Mamba2 blocks' ``ssm_heads``, ``layers/mamba.py::
    mamba2_shard_params``; the table a slice of the vocabulary where M >
    1), ``tokens`` (B,S) per shard on its device. ``keep``: the positions
    whose attention K/V and hidden states are emitted, one slice per
    context shard, slice c taken on model shard c % M (default: all of
    them, once per model shard). Per layer and shard: each attention
    block launches kernel #1 once (its K/V of every head) and kernel #5
    once (its query heads); the Mamba2 blocks launch none. Returns
    dict(logits per model shard; with ``emit_state`` kv per slice a (k, v)
    pair of (n_super,B,s,Kv,hd) and mamba_states per model shard a (conv
    (n_super,k-1,B,W-1,C/M), ssm (n_super,k-1,B,H/M,P,N) fp32) pair in
    the cache's layout: the conv channels split evenly, C = I + 2GN
    (``mamba2_conv_to_layout``), the heads by shard; with
    ``capture_hidden`` mamba_hidden (n_super,k-1,B,s,D) and attn_hidden
    (n_super,B,s,D) per slice, each block's input; else None)."""
    M = len(ps)
    keep = keep or [slice(None)] * M
    S = tokens[0].shape[1]
    positions = tfm._shard_positions(tokens, 0)
    cos, sin = tfm._shard_rope(h.lm.attn, positions, S)
    xs = tfm.embed_shards(ps, tokens, h.lm, scale=False)
    m_hidden, a_hidden, ks, vs = ([[] for _ in keep] for _ in range(4))
    convs, ssms = [[] for _ in ps], [[] for _ in ps]
    for s in range(h.n_super):
        for j in range(h.k - 1):
            if capture_hidden:
                for c, sl in enumerate(keep):
                    m_hidden[c].append(tfm._kept(xs[c % M], sl))
            xs, states = _mamba_block_shards(
                [_mamba_params(p, s, j) for p in ps], xs, h)
            if emit_state:
                for m, (conv, ssm) in enumerate(states):
                    convs[m].append(conv)
                    ssms[m].append(ssm)
        if capture_hidden:
            for c, sl in enumerate(keep):
                a_hidden[c].append(tfm._kept(xs[c % M], sl))
        xs, new = tfm.block_forward_shards(
            [p["attn"] for p in ps], s, xs, h.lm, cos=cos, sin=sin,
            window=None)
        if emit_state:
            for c, sl in enumerate(keep):
                k, v = new[c % M]
                ks[c].append(tfm._kept(k, sl))
                vs[c].append(tfm._kept(v, sl))
    if final_logits_only:
        xs = [x[:, -1:] for x in xs]
    states = None
    if emit_state:
        conv = mamba2_conv_to_layout([_by_block(cv, h) for cv in convs],
                                     h.mamba)
        states = [(cv, _by_block(sm, h)) for cv, sm in zip(conv, ssms)]
    return {"logits": tfm.final_logits_shards(ps, xs, h.cfg,
                                              h.cfg.logit_softcap),
            "kv": ([(torch.stack(k), torch.stack(v)) for k, v in zip(ks, vs)]
                   if emit_state else None),
            "mamba_states": states,
            "mamba_hidden": ([_by_block(x, h) for x in m_hidden]
                             if capture_hidden else None),
            "attn_hidden": ([torch.stack(x) for x in a_hidden]
                            if capture_hidden else None)}


def hybrid_forward(params: dict, tokens: torch.Tensor, h: HybridHyper, *,
                   capture_hidden: bool = False, emit_state: bool = False,
                   final_logits_only: bool = False) -> dict:
    """Prefill forward from zero state, ``hybrid_forward_shards`` on one
    shard. tokens (B,S) int. Returns dict(logits, kv, mamba_states,
    mamba_hidden, attn_hidden): with ``emit_state`` kv a (k, v) pair of
    (n_super,B,S,Kv,hd) and mamba_states a (conv (n_super,k-1,B,W-1,C),
    ssm (n_super,k-1,B,H,P,N) fp32) pair; with ``capture_hidden``
    mamba_hidden (n_super,k-1,B,S,D) and attn_hidden (n_super,B,S,D),
    each block's input; else None."""
    out = hybrid_forward_shards([params], [tokens], h,
                                capture_hidden=capture_hidden,
                                emit_state=emit_state,
                                final_logits_only=final_logits_only)
    return {"logits": out["logits"][0],
            "kv": out["kv"][0] if emit_state else None,
            "mamba_states": out["mamba_states"][0] if emit_state else None,
            "mamba_hidden": (out["mamba_hidden"][0] if capture_hidden
                             else None),
            "attn_hidden": out["attn_hidden"][0] if capture_hidden else None}


def hybrid_decode_step_shards(ps, tokens, h: HybridHyper, *, k, v, conv, ssm,
                              lengths, starts=None, host_lengths=None,
                              host_starts=None):
    """One decode step over M model shards (one shard:
    ``hybrid_decode_step``): ``ps`` and ``tokens`` (B,1) per model shard,
    as ``hybrid_forward_shards``; the attention cache over C context
    shards, ``k``/``v`` (n_super,B,Sc,Kv,hd) written in place,
    ``lengths`` (B,) and ``starts`` (B,) per context shard
    (``transformer.block_decode_shards``: kernel #1 once per attention
    block and model shard, kernel #3 once per attention block and context
    shard); ``conv`` (n_super,k-1,B,W-1,C/M) and ``ssm``
    (n_super,k-1,B,H/M,P,N) fp32 per model shard in the cache's layout,
    updated in place (each Mamba2 block's conv state goes through
    ``mamba2_conv_from_layout``/``to_layout`` around it: two all-gathers
    of (B,W-1,C) where M > 1). ``host_lengths`` (B,) and ``host_starts``
    (one int per context shard) on the host, where the caller knows them:
    then no value is read back from the device. Returns (logits (B,1,V/M)
    per model shard, (mamba_hidden (n_super,k-1,B,1,D), attn_hidden
    (n_super,B,1,D)) per model shard)."""
    lens = [lengths[m].to(t.device) for m, t in enumerate(tokens)]
    end = (int(lens[0].max()) if host_lengths is None
           else max(int(n) for n in host_lengths)) + 1
    cos, sin = tfm._shard_rope(h.lm.attn, [n[:, None] for n in lens], end)
    xs = tfm.embed_shards(ps, tokens, h.lm, scale=False)
    m_hidden, a_hidden = [[] for _ in ps], [[] for _ in ps]
    for s in range(h.n_super):
        for j in range(h.k - 1):
            for hs, x in zip(m_hidden, xs):
                hs.append(x)
            xs, states = _mamba_block_shards(
                [_mamba_params(p, s, j) for p in ps], xs, h,
                init_states=[x[s, j] for x in ssm],
                conv_states=mamba2_conv_from_layout([x[s, j] for x in conv],
                                                    h.mamba))
            new_conv = mamba2_conv_to_layout([st[0] for st in states],
                                             h.mamba)
            for cv, sm, nc, (_, ns) in zip(conv, ssm, new_conv, states):
                cv[s, j] = nc
                sm[s, j] = ns
        for hs, x in zip(a_hidden, xs):
            hs.append(x)
        xs = tfm.block_decode_shards(
            [p["attn"] for p in ps], s, xs, h.lm,
            k_caches=[x[s] for x in k], v_caches=[x[s] for x in v],
            lengths=lengths, starts=starts, cos=cos, sin=sin, window=None,
            host_lengths=host_lengths, host_starts=host_starts)
    return (tfm.final_logits_shards(ps, xs, h.cfg, h.cfg.logit_softcap),
            [(_by_block(mh, h), torch.stack(ah))
             for mh, ah in zip(m_hidden, a_hidden)])


def hybrid_decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                       h: HybridHyper):
    """One decode step, ``hybrid_decode_step_shards`` on one shard.
    cache: dict(attn_k/attn_v (n_super,B,Smax,Kv,hd), conv
    (n_super,k-1,B,W-1,C), ssm (n_super,k-1,B,H,P,N) fp32, lengths (B,));
    tokens (B,1). Returns (logits (B,1,V), new cache, (mamba_hidden
    (n_super,k-1,B,1,D), attn_hidden (n_super,B,1,D))). The new cache
    shares its buffers with the old one, which this step updated in
    place."""
    lengths = cache["lengths"]
    logits, hidden = hybrid_decode_step_shards(
        [params], [tokens], h, k=[cache["attn_k"]], v=[cache["attn_v"]],
        conv=[cache["conv"]], ssm=[cache["ssm"]], lengths=[lengths])
    new_cache = {"attn_k": cache["attn_k"], "attn_v": cache["attn_v"],
                 "conv": cache["conv"], "ssm": cache["ssm"],
                 "lengths": lengths + 1}
    return logits[0], new_cache, hidden[0]


# ---------------------------------------------------------------- HCache ops
def hybrid_restore_attn_kv(params: dict, attn_hidden: torch.Tensor,
                           h: HybridHyper, *, positions: torch.Tensor,
                           end=None):
    """The attention blocks' K/V from their saved hidden states
    (n_super,B,S,D), positions (B,S) (``end`` = ``positions.max() + 1``
    where the caller knows it), in one launch of the restoration kernel:
    on a mesh, each shard's (n_super,B/D,S/C,D) block in one launch on
    its own parameters. Returns (k, v): (n_super,B,S,Kv,hd) each."""
    return tfm.lm_restore_kv({"blocks": params["attn"]}, attn_hidden, h.lm,
                             positions=positions, end=end)


def hybrid_restore_mamba_states(params: dict, mamba_hidden: torch.Tensor,
                                h: HybridHyper):
    """ssm-rescan: each Mamba2 block's final (conv, ssm) states recomputed
    from zero over its saved input hidden states (n_super,k-1,B,S,D).
    Returns (conv (n_super,k-1,B,W-1,C), ssm (n_super,k-1,B,H,P,N))."""
    c = h.cfg
    convs, ssms = [], []
    for s in range(h.n_super):
        for j in range(h.k - 1):
            mp = _mamba_params(params, s, j)
            normed = apply_norm(mp["ln"], mamba_hidden[s, j].to(h.dtype),
                                c.norm, c.norm_eps)
            _, (conv, ssm) = apply_mamba2(mp["m"], normed, h.mamba)
            convs.append(conv)
            ssms.append(ssm)
    conv, ssm = torch.stack(convs), torch.stack(ssms)
    return (conv.view(h.n_super, h.k - 1, *conv.shape[1:]),
            ssm.view(h.n_super, h.k - 1, *ssm.shape[1:]))
