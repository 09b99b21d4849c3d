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
  hybrid_restore_attn_kv      -> the paper's op on the attention blocks
  hybrid_restore_mamba_states -> ssm-rescan of every Mamba2 block

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
from repro_torch.models.layers.mamba import (Mamba2Hyper, apply_mamba2,
                                             init_mamba2)
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


def _embed(params: dict, tokens, h: HybridHyper):
    return embed_tokens(params["embed"], tokens, scale=False,
                        d_model=h.cfg.d_model).to(h.dtype)


def hybrid_forward(params: dict, tokens: torch.Tensor, h: HybridHyper, *,
                   capture_hidden: bool = False, emit_state: bool = False,
                   final_logits_only: bool = False) -> dict:
    """Prefill forward from zero state. tokens (B,S) int. Returns
    dict(logits, kv, mamba_states, mamba_hidden, attn_hidden): with
    ``emit_state`` kv a (k, v) pair of (n_super,B,S,Kv,hd) and
    mamba_states a (conv (n_super,k-1,B,W-1,C), ssm (n_super,k-1,B,H,P,N)
    fp32) pair; with ``capture_hidden`` mamba_hidden (n_super,k-1,B,S,D)
    and attn_hidden (n_super,B,S,D), each block's input; else None."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    cos, sin = tfm.rope_at(h.lm.attn, positions, S)
    x = _embed(params, tokens, h)
    m_hidden, a_hidden, convs, ssms, ks, vs = [], [], [], [], [], []
    for s in range(h.n_super):
        for j in range(h.k - 1):
            if capture_hidden:
                m_hidden.append(x)
            x, (conv, ssm) = _mamba_block(_mamba_params(params, s, j), x, h)
            if emit_state:
                convs.append(conv)
                ssms.append(ssm)
        if capture_hidden:
            a_hidden.append(x)
        x, (k, v) = tfm.block_forward(params["attn"], s, x, h.lm, cos=cos,
                                      sin=sin, window=None)
        if emit_state:
            ks.append(k)
            vs.append(v)
    if final_logits_only:
        x = x[:, -1:]

    def by_block(xs):
        t = torch.stack(xs)
        return t.view(h.n_super, h.k - 1, *t.shape[1:])

    return {"logits": tfm._final_logits(params, x, h.lm),
            "kv": (torch.stack(ks), torch.stack(vs)) if emit_state else None,
            "mamba_states": ((by_block(convs), by_block(ssms))
                             if emit_state else None),
            "mamba_hidden": by_block(m_hidden) if capture_hidden else None,
            "attn_hidden": torch.stack(a_hidden) if capture_hidden else None}


def hybrid_decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                       h: HybridHyper):
    """One decode step. cache: dict(attn_k/attn_v (n_super,B,Smax,Kv,hd),
    conv (n_super,k-1,B,W-1,C), ssm (n_super,k-1,B,H,P,N) fp32, lengths
    (B,)); tokens (B,1). Returns (logits (B,1,V), new cache, (mamba_hidden
    (n_super,k-1,B,1,D), attn_hidden (n_super,B,1,D))). The new cache
    shares its buffers with the old one, which this step updated in
    place."""
    lengths = cache["lengths"]
    conv, ssm = cache["conv"], cache["ssm"]
    cos, sin = tfm.rope_at(h.lm.attn, lengths[:, None])
    x = _embed(params, tokens, h)
    m_hidden, a_hidden = [], []
    for s in range(h.n_super):
        for j in range(h.k - 1):
            m_hidden.append(x)
            x, (new_conv, new_ssm) = _mamba_block(
                _mamba_params(params, s, j), x, h, conv_state=conv[s, j],
                init_state=ssm[s, j])
            conv[s, j] = new_conv
            ssm[s, j] = new_ssm
        a_hidden.append(x)
        x = tfm.block_decode(params["attn"], s, x, h.lm,
                             k_cache=cache["attn_k"][s],
                             v_cache=cache["attn_v"][s], lengths=lengths,
                             cos=cos, sin=sin, window=None)
    mh = torch.stack(m_hidden)
    new_cache = {"attn_k": cache["attn_k"], "attn_v": cache["attn_v"],
                 "conv": conv, "ssm": ssm, "lengths": lengths + 1}
    return (tfm._final_logits(params, x, h.lm), new_cache,
            (mh.view(h.n_super, h.k - 1, *mh.shape[1:]),
             torch.stack(a_hidden)))


# ---------------------------------------------------------------- HCache ops
def hybrid_restore_attn_kv(params: dict, attn_hidden: torch.Tensor,
                           h: HybridHyper, *, positions: torch.Tensor):
    """The attention blocks' K/V from their saved hidden states
    (n_super,B,S,D), positions (B,S), in one launch of the restoration
    kernel. Returns (k, v): (n_super,B,S,Kv,hd) each."""
    return tfm.lm_restore_kv({"blocks": params["attn"]}, attn_hidden, h.lm,
                             positions=positions)


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
