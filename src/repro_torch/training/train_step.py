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

ZeRO sharding of the optimizer state (the JAX package's ``state_axes``)
waits for the multi-GPU port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.models.layers.embedding import logits as embed_logits
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)
from repro_torch.training.tree import tree_leaves, tree_map, tree_unflatten


def _chunk_ce(embed_params: dict, x, t, softcap, true_vocab):
    """Sum over the chunk's rows of logsumexp(logits) - logits[target];
    the row max is held out of the gradient."""
    lg = embed_logits(embed_params, x, softcap=softcap,
                      true_vocab=true_vocab).float()
    m = lg.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lg - m), dim=-1)) + m[..., 0]
    label = torch.gather(lg, -1, t[..., None])[..., 0]
    return torch.sum(lse - label)


def chunked_ce_loss(embed_params: dict, final_x, targets, *,
                    softcap: Optional[float],
                    true_vocab: Optional[int] = None, n_chunks: int = 8):
    """Mean CE over (B,S) targets from final hidden states (B,S,D), in
    ``n_chunks`` sequence chunks (fewer when S does not divide), each
    under ``torch.utils.checkpoint``: backward recomputes a chunk's logits
    instead of keeping (B, S, V) alive."""
    B, S, _ = final_x.shape
    while S % n_chunks:
        n_chunks -= 1
    C = S // n_chunks
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=final_x.device)
    for i in range(n_chunks):
        x, t = final_x[:, i * C:(i + 1) * C], targets[:, i * C:(i + 1) * C]
        args = (embed_params, x, t, softcap, true_vocab)
        total = total + (torch.utils.checkpoint.checkpoint(
            _chunk_ce, *args, use_reentrant=False, preserve_rng_state=False)
            if remat else _chunk_ce(*args))
    return total / (B * S)


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
        with respect to every leaf of ``params_f32`` (fp32, same tree)."""
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
        return loss.detach(), parts, tree_unflatten(params_f32, grads)

    def train_step(self, state: dict, batch: dict) -> Tuple[dict, Dict]:
        """(new state, metrics: loss, ce, aux, grad_norm)."""
        loss, parts, grads = self.value_and_grad(state["params"], batch)
        with torch.no_grad():
            new_params, new_opt, om = adamw_update(
                state["params"], grads, state["opt"], self.opt)
        return ({"params": new_params, "opt": new_opt},
                {"loss": loss, **parts, **om})
