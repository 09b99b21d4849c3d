"""Pure Mamba1 LM (falcon-mamba-7b), attention-free, over layer-stacked
parameters.

Entry points (functions over the parameter dict):

  init_ssm_lm        -> parameters, stacked along a leading layer axis
  ssm_forward        -> full-sequence forward (prefill) from zero state,
                        optionally capturing per-layer hidden states and
                        emitting the final conv/ssm states of every layer
  ssm_train_forward  -> the training forward: final hidden states for the
                        chunked loss, each block under activation
                        checkpointing, the scan through kernel #6 under
                        autograd (``SSMScanFn``)
  ssm_decode_step    -> one decode token per sequence over a cache of
                        states, which it updates in place
  ssm_restore_states -> ssm-rescan: each layer's final states recomputed
                        from that layer's saved input hidden states

HCache keeps no per-token state for this family: the serving path saves
and restores the recurrent states whole (``core/hcache.py``);
``ssm_restore_states`` is model API that no restore path calls, as in the
JAX package. The embedding is unscaled and untied.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.config.arch import ArchConfig
from repro_torch.models.layers.embedding import (embed_tokens, init_embedding,
                                                 logits as embed_logits)
from repro_torch.models.layers.mamba import (Mamba1Hyper, apply_mamba1,
                                             init_mamba1)
from repro_torch.models.layers.norm import apply_norm, init_norm
from repro_torch.models.module import stacked_init
from repro_torch.models.transformer import (layer_params, remat,
                                            unstack_layers)


@dataclasses.dataclass(frozen=True)
class SSMHyper:
    cfg: ArchConfig
    dtype: torch.dtype = torch.float32

    @functools.cached_property
    def mamba(self) -> Mamba1Hyper:
        c = self.cfg
        return Mamba1Hyper(d_model=c.d_model, d_state=c.ssm_state,
                           d_conv=c.ssm_conv, expand=c.ssm_expand)


def init_ssm_lm(gen: torch.Generator, h: SSMHyper, device) -> dict:
    c = h.cfg

    def block():
        return {"ln": init_norm(c.norm, c.d_model, h.dtype, device),
                "m": init_mamba1(gen, h.mamba, h.dtype, device)}

    return {
        "embed": init_embedding(gen, c.vocab_size, c.d_model, h.dtype,
                                device, c.tie_embeddings),
        "blocks": stacked_init(block, c.n_layers),
        "final_norm": init_norm(c.norm, c.d_model, h.dtype, device),
    }


def _block(bp: dict, x, h: SSMHyper, **state):
    c = h.cfg
    normed = apply_norm(bp["ln"], x, c.norm, c.norm_eps)
    out, states = apply_mamba1(bp["m"], normed, h.mamba, **state)
    return x + out, states


def _embed(params: dict, tokens, h: SSMHyper):
    return embed_tokens(params["embed"], tokens, scale=False,
                        d_model=h.cfg.d_model).to(h.dtype)


def _logits(params: dict, x, h: SSMHyper):
    c = h.cfg
    x = apply_norm(params["final_norm"], x, c.norm, c.norm_eps)
    return embed_logits(params["embed"], x, true_vocab=c.vocab_size)


def ssm_train_forward(params: dict, tokens: torch.Tensor,
                      h: SSMHyper) -> dict:
    """Training forward (the JAX package's ``ssm_forward`` with
    ``skip_logits``): tokens (B,S) -> dict(final_x (B,S,D) after the final
    norm, aux 0.0); each block under ``transformer.remat``."""
    x = _embed(params, tokens, h)
    for bp in unstack_layers(params["blocks"]):
        x = remat(lambda xx, bp=bp: _block(bp, xx, h)[0], x)
    c = h.cfg
    return {"final_x": apply_norm(params["final_norm"], x, c.norm,
                                  c.norm_eps),
            "aux": 0.0}


def ssm_forward(params: dict, tokens: torch.Tensor, h: SSMHyper, *,
                capture_hidden: bool = False, emit_state: bool = False,
                final_logits_only: bool = False) -> dict:
    """Prefill forward from zero state. tokens (B,S) int. Returns
    dict(logits, hidden, states): hidden (L,B,S,D) when
    ``capture_hidden``; states a (conv (L,B,W-1,I), ssm (L,B,I,N) fp32)
    pair when ``emit_state``; else None."""
    x = _embed(params, tokens, h)
    hidden, convs, ssms = [], [], []
    for li in range(h.cfg.n_layers):
        if capture_hidden:
            hidden.append(x)
        x, (conv, ssm) = _block(layer_params(params["blocks"], li), x, h)
        if emit_state:
            convs.append(conv)
            ssms.append(ssm)
    if final_logits_only:
        x = x[:, -1:]
    return {"logits": _logits(params, x, h),
            "hidden": torch.stack(hidden) if capture_hidden else None,
            "states": ((torch.stack(convs), torch.stack(ssms))
                       if emit_state else None)}


def ssm_decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                    h: SSMHyper):
    """One decode step. cache: dict(conv (L,B,W-1,I), ssm (L,B,I,N) fp32,
    lengths (B,)); tokens (B,1). Returns (logits (B,1,V), new cache,
    hidden (L,B,1,D)). The new cache shares ``conv``/``ssm`` with the old
    one, which this step updated in place."""
    conv, ssm = cache["conv"], cache["ssm"]
    x = _embed(params, tokens, h)
    hidden = []
    for li in range(h.cfg.n_layers):
        hidden.append(x)
        x, (new_conv, _) = _block(layer_params(params["blocks"], li), x, h,
                                  conv_state=conv[li], init_state=ssm[li])
        conv[li] = new_conv
    return (_logits(params, x, h),
            {"conv": conv, "ssm": ssm, "lengths": cache["lengths"] + 1},
            torch.stack(hidden))


def ssm_restore_states(params: dict, hidden: torch.Tensor, h: SSMHyper):
    """ssm-rescan: (L,B,S,D) saved hidden states -> each layer's final
    (conv (L,B,W-1,I), ssm (L,B,I,N)) states, layer by layer from zero."""
    c = h.cfg
    convs, ssms = [], []
    for li in range(c.n_layers):
        bp = layer_params(params["blocks"], li)
        normed = apply_norm(bp["ln"], hidden[li].to(h.dtype), c.norm,
                            c.norm_eps)
        _, (conv, ssm) = apply_mamba1(bp["m"], normed, h.mamba)
        convs.append(conv)
        ssms.append(ssm)
    return torch.stack(convs), torch.stack(ssms)
