"""Train step: mixed precision, chunked cross-entropy, activation
checkpointing.

  master params: fp32; each step casts the floating leaves to the model
                 dtype (bf16 on the card) differentiably, so gradients
                 land on the fp32 master
  fwd/bwd:       ``Model.forward(..., skip_logits=True)`` of any family,
                 each block recomputed in backward (the reference's
                 ``remat="full"``), attention through kernel #5 and the
                 Mamba1 scan through kernel #6 under autograd; a MoE
                 stack's load-balance aux joins the loss with
                 ``aux_weight`` (``parts["aux"]`` comes back detached)
  loss:          a loop over sequence chunks; each chunk's logits are
                 recomputed in backward, so (B, S, V) never exists at once

``state_axes`` gives every leaf of the train state its logical axes with
the ZeRO-1 rewrite (the JAX package's), which the sharded step over a
(data x model) mesh places the state by (``training/sharded.py``). A
model laid out for a model axis that pads its query heads has its padded
slices' gradients masked to zero before AdamW, so they stay zero (the
reference lets them train).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.distributed.collectives import (copy_to_shards,
                                                 max_over_shards,
                                                 reduce_from_shards)
from repro_torch.launch import exec_cost
from repro_torch.models.layers.embedding import logits as embed_logits
from repro_torch.models.model import Model
from repro_torch.models.transformer import remat
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state, opt_axes_tree)
from repro_torch.training.tree import (tree_leaves, tree_map, tree_paths,
                                       tree_unflatten)


def _chunk_ce(embeds: List[dict], xs, ts, softcap, true_vocab):
    """Sum over the chunk's rows of logsumexp(logits) - logits[target],
    over M model shards, vocab-parallel (one shard: the whole table):
    shard m's table holds a slice of the vocabulary; the row max (held
    out of the gradient) and the exp-sum run over every shard's columns,
    the label's logit comes from the shard that owns it. The sum on
    every shard."""
    lgs, firsts, first = [], [], 0
    for e, x in zip(embeds, copy_to_shards(xs)):
        lgs.append(embed_logits(e, x, softcap=softcap, true_vocab=true_vocab,
                                first_col=first).float())
        firsts.append(first)
        first += lgs[-1].shape[-1]
    mx = max_over_shards([lg.amax(dim=-1, keepdim=True) for lg in lgs])
    sums = reduce_from_shards([torch.sum(torch.exp(lg - m), dim=-1)
                               for lg, m in zip(lgs, mx)])
    labels = []
    for lg, t, f in zip(lgs, ts, firsts):
        n = lg.shape[-1]
        local = t - f
        own = (local >= 0) & (local < n)
        lab = torch.gather(lg, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        labels.append(torch.where(own, lab, torch.zeros_like(lab)))
    labels = reduce_from_shards(labels)
    return [torch.sum(torch.log(s) + m[..., 0] - lab)
            for s, m, lab in zip(sums, mx, labels)]


def chunked_ce_loss_shards(embeds: List[dict], final_xs, targets, *,
                           softcap: Optional[float],
                           true_vocab: Optional[int], n_chunks: int,
                           denom: int):
    """The CE sum over (B,S) targets from final hidden states (B,S,D),
    over M model shards (``_chunk_ce``; each list holds one entry per
    shard), divided by ``denom``, on every shard: ``n_chunks`` sequence
    chunks (fewer when S does not divide), each under ``transformer.
    remat``, so backward recomputes a chunk's logits instead of keeping
    (B, S, V) alive."""
    M = len(final_xs)
    S = final_xs[0].shape[1]
    while S % n_chunks:
        n_chunks -= 1
    C = S // n_chunks
    total = []
    for m, x in enumerate(final_xs):
        with exec_cost.shard(m):
            total.append(torch.zeros((), dtype=torch.float32,
                                     device=x.device))
    for i in range(n_chunks):
        cut = slice(i * C, (i + 1) * C)
        loss = remat(
            lambda *a: _chunk_ce(embeds, list(a[:M]), list(a[M:]), softcap,
                                 true_vocab),
            *[x[:, cut] for x in final_xs], *[t[:, cut] for t in targets])
        total = [a + b for a, b in zip(total, loss)]
    return [t / denom for t in total]


def chunked_ce_loss(embed_params: dict, final_x, targets, *,
                    softcap: Optional[float],
                    true_vocab: Optional[int] = None, n_chunks: int = 8):
    """Mean CE over (B,S) targets from final hidden states (B,S,D):
    ``chunked_ce_loss_shards`` on one shard."""
    B, S, _ = final_x.shape
    return chunked_ce_loss_shards([embed_params], [final_x], [targets],
                                  softcap=softcap, true_vocab=true_vocab,
                                  n_chunks=n_chunks, denom=B * S)[0]


@dataclasses.dataclass
class Trainer:
    """One model's loss, gradient and AdamW step."""

    model: Model
    opt: AdamWConfig = AdamWConfig()
    loss_chunks: int = 8
    aux_weight: float = 0.01          # MoE load-balance loss weight

    def init_state(self, seed: int = 0) -> dict:
        """{"params": fp32 master from ``Model.init(seed)``, "opt": zeroed
        AdamW state}."""
        params = tree_map(lambda x: x.float(), self.model.init(seed))
        return {"params": params,
                "opt": init_opt_state(params,
                                      error_feedback=self.opt.error_feedback)}

    def state_axes(self, axes, state, data_size: int = 1) -> dict:
        """The logical axes of every leaf of ``state`` (ZeRO-1): params,
        m, v (and ef) by ``opt_axes_tree`` over ``axes`` (``Model.
        param_axes()``), the step count a scalar."""
        p_axes = opt_axes_tree(axes, state["params"], data_size)
        opt = {"m": p_axes, "v": p_axes, "step": ()}
        if "ef" in state["opt"]:
            opt["ef"] = p_axes
        return {"params": p_axes, "opt": opt}

    def mask_padded(self, grads):
        """``grads`` with the padded query heads' slices zeroed (the
        gradients as they are when no head is padded)."""
        masks = self.model.head_pad_masks()
        if not masks:
            return grads
        leaves = [g * masks[p].to(g.dtype) if p in masks else g
                  for p, g in tree_paths(grads)]
        return tree_unflatten(grads, leaves)

    def loss_fn(self, params_f32, batch) -> Tuple[torch.Tensor, Dict]:
        """(total loss, {"ce", "aux"}) with the floating leaves cast to the
        model dtype inside the graph."""
        compute = tree_map(
            lambda x: x.to(self.model.dtype) if x.is_floating_point() else x,
            params_f32)
        out = self.model.forward(compute, batch, skip_logits=True)
        c = self.model.cfg
        loss = chunked_ce_loss(compute["embed"], out["final_x"],
                               batch["targets"], softcap=c.logit_softcap,
                               true_vocab=c.vocab_size,
                               n_chunks=self.loss_chunks)
        aux = out.get("aux", 0.0)
        return loss + self.aux_weight * aux, {"ce": loss, "aux": aux}

    def value_and_grad(self, params_f32, batch):
        """(loss, parts, grads): ``loss_fn`` and the gradient of its total
        with respect to every leaf of ``params_f32`` (fp32, same tree;
        padded heads' slices zero, ``mask_padded``)."""
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params_f32)]
        params = tree_unflatten(params_f32, leaves)
        with torch.enable_grad():
            loss, parts = self.loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        parts = {k: v.detach() if isinstance(v, torch.Tensor) else v
                 for k, v in parts.items()}
        return (loss.detach(), parts,
                self.mask_padded(tree_unflatten(params_f32, grads)))

    def train_step(self, state: dict, batch: dict) -> Tuple[dict, Dict]:
        """(new state, metrics: loss, ce, aux, grad_norm)."""
        loss, parts, grads = self.value_and_grad(state["params"], batch)
        with torch.no_grad():
            new_params, new_opt, om = adamw_update(
                state["params"], grads, state["opt"], self.opt)
        return ({"params": new_params, "opt": new_opt},
                {"loss": loss, **parts, **om})
