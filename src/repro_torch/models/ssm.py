"""Pure Mamba1 LM (falcon-mamba-7b), attention-free, over layer-stacked
parameters.

Entry points (functions over the parameter dict):

  init_ssm_lm        -> parameters, stacked along a leading layer axis
  ssm_forward        -> full-sequence forward (prefill) from zero state,
                        optionally capturing per-layer hidden states and
                        emitting the final conv/ssm states of every layer;
                        it is ``ssm_forward_shards`` on one shard, which
                        runs the same blocks over ``ssm_inner`` shards
                        (``distributed/mesh_serving.py``)
  ssm_train_forward  -> the training forward: final hidden states for the
                        chunked loss, each block under activation
                        checkpointing, the scan through kernel #6 under
                        autograd (``SSMScanFn``)
  ssm_decode_step    -> one decode token per sequence over a cache of
                        states, which it updates in place
                        (``ssm_decode_step_shards`` on one shard)
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
from repro_torch.models.layers.embedding import init_embedding
from repro_torch.models.layers.mamba import (Mamba1Hyper, apply_mamba1,
                                             apply_mamba1_shards,
                                             init_mamba1)
from repro_torch.models.layers.norm import apply_norm, init_norm
from repro_torch.models.module import stacked_init
from repro_torch.models.transformer import (_kept, embed_shards,
                                            final_logits_shards,
                                            layer_params, remat,
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


def _block_shards(lps, xs, h: SSMHyper, *, init_states=None,
                  conv_states=None):
    """Block over M ``ssm_inner`` shards (``apply_mamba1_shards``), ``lps``
    each shard's layer parameters: (outs, each shard's states)."""
    c = h.cfg
    normed = [apply_norm(lp["ln"], x, c.norm, c.norm_eps)
              for lp, x in zip(lps, xs)]
    outs, states = apply_mamba1_shards(
        [lp["m"] for lp in lps], normed, h.mamba, init_states=init_states,
        conv_states=conv_states)
    return [x + o for x, o in zip(xs, outs)], states


def _block(bp: dict, x, h: SSMHyper, *, init_state=None, conv_state=None):
    xs, states = _block_shards([bp], [x], h, init_states=[init_state],
                               conv_states=[conv_state])
    return xs[0], states[0]


def _embed_shards(ps, tokens, h: SSMHyper):
    """The embeddings on every shard, unscaled."""
    return embed_shards(ps, tokens, h, scale=False)


def _embed(params: dict, tokens, h: SSMHyper):
    return _embed_shards([params], [tokens], h)[0]


def _logits(params: dict, x, h: SSMHyper):
    return final_logits_shards([params], [x], h.cfg)[0]


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


def ssm_forward_shards(ps, tokens, h: SSMHyper, *,
                       capture_hidden: bool = False, emit_state: bool = False,
                       final_logits_only: bool = False, keep=None) -> dict:
    """Prefill forward from zero state over M ``ssm_inner`` shards (one
    shard: ``ssm_forward``): ``ps`` each shard's parameters (its channels,
    ``layers/mamba.py::apply_mamba1_shards``; the table a slice of the
    vocabulary where M > 1), ``tokens`` (B,S) per shard on its device.
    ``keep``: the positions of the captured hidden states, one slice per
    context shard, slice c taken on shard c % M (default: all of them,
    once per shard). Returns dict(logits per shard; hidden per slice
    (L,B,s,D) when ``capture_hidden``; states per shard a (conv
    (L,B,W-1,I/M), ssm (L,B,I/M,N) fp32) pair when ``emit_state``; else
    None)."""
    M = len(ps)
    keep = keep or [slice(None)] * M
    xs = _embed_shards(ps, tokens, h)
    hidden = [[] for _ in keep]
    convs, ssms = [[] for _ in ps], [[] for _ in ps]
    for li in range(h.cfg.n_layers):
        if capture_hidden:
            for c, sl in enumerate(keep):
                hidden[c].append(_kept(xs[c % M], sl))
        xs, states = _block_shards(
            [layer_params(p["blocks"], li) for p in ps], xs, h)
        if emit_state:
            for m, (conv, ssm) in enumerate(states):
                convs[m].append(conv)
                ssms[m].append(ssm)
    if final_logits_only:
        xs = [x[:, -1:] for x in xs]
    return {"logits": final_logits_shards(ps, xs, h.cfg),
            "hidden": ([torch.stack(x) for x in hidden] if capture_hidden
                       else None),
            "states": ([(torch.stack(cv), torch.stack(sm))
                        for cv, sm in zip(convs, ssms)]
                       if emit_state else None)}


def ssm_forward(params: dict, tokens: torch.Tensor, h: SSMHyper, *,
                capture_hidden: bool = False, emit_state: bool = False,
                final_logits_only: bool = False) -> dict:
    """Prefill forward from zero state, ``ssm_forward_shards`` on one
    shard. tokens (B,S) int. Returns dict(logits, hidden, states): hidden
    (L,B,S,D) when ``capture_hidden``; states a (conv (L,B,W-1,I), ssm
    (L,B,I,N) fp32) pair when ``emit_state``; else None."""
    out = ssm_forward_shards([params], [tokens], h,
                             capture_hidden=capture_hidden,
                             emit_state=emit_state,
                             final_logits_only=final_logits_only)
    return {"logits": out["logits"][0],
            "hidden": out["hidden"][0] if capture_hidden else None,
            "states": out["states"][0] if emit_state else None}


def ssm_decode_step_shards(ps, tokens, h: SSMHyper, *, conv, ssm):
    """One decode step over M ``ssm_inner`` shards (one shard:
    ``ssm_decode_step``): ``ps`` and ``tokens`` (B,1) per shard as
    ``ssm_forward_shards``, ``conv`` (L,B,W-1,I/M) and ``ssm``
    (L,B,I/M,N) fp32 per shard, updated in place. Returns (logits per
    shard, hidden (L,B,1,D) per shard)."""
    xs = _embed_shards(ps, tokens, h)
    hidden = [[] for _ in ps]
    for li in range(h.cfg.n_layers):
        for hs, x in zip(hidden, xs):
            hs.append(x)
        xs, states = _block_shards(
            [layer_params(p["blocks"], li) for p in ps], xs, h,
            init_states=[s[li] for s in ssm],
            conv_states=[c[li] for c in conv])
        for c, (new_conv, _) in zip(conv, states):
            c[li] = new_conv
    return (final_logits_shards(ps, xs, h.cfg),
            [torch.stack(x) for x in hidden])


def ssm_decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                    h: SSMHyper):
    """One decode step. cache: dict(conv (L,B,W-1,I), ssm (L,B,I,N) fp32,
    lengths (B,)); tokens (B,1). Returns (logits (B,1,V), new cache,
    hidden (L,B,1,D)). The new cache shares ``conv``/``ssm`` with the old
    one, which this step updated in place."""
    conv, ssm = cache["conv"], cache["ssm"]
    logits, hidden = ssm_decode_step_shards([params], [tokens], h,
                                            conv=[conv], ssm=[ssm])
    return (logits[0],
            {"conv": conv, "ssm": ssm, "lengths": cache["lengths"] + 1},
            hidden[0])


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
