"""AdamW over the port's parameter trees, with ZeRO-1 axis metadata.

Global-norm clipping, decoupled weight decay, bias correction and an
optional bf16 error-feedback buffer (the gradient's quantisation error to
bf16, folded into the next step), as the JAX package's
``training/optimizer.py`` computes them, in fp32 over plain tensor ops.
The update is functional: it returns new parameter and moment trees and
leaves its inputs as they were.

``opt_axes``/``opt_axes_tree`` are the JAX package's ZeRO-1 axes (the
largest unnamed, divisible dimension of each optimizer leaf maps to
"opt_fsdp", which the rules put on the data axis): ``Trainer.
state_axes`` lays the master and moments out by them, and the sharded
step (``training/sharded.py``) runs ``adamw_apply`` on each device's
part with the clip scale of the whole gradient's norm.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.training.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    error_feedback: bool = False


def init_opt_state(params, *, error_feedback: bool = False) -> dict:
    """Zeroed m and v (and ``ef``) shaped like ``params``, and the step
    count, an int32 scalar on the parameters' device."""
    dev = tree_leaves(params)[0].device
    state = {"m": tree_map(torch.zeros_like, params),
             "v": tree_map(torch.zeros_like, params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if error_feedback:
        state["ef"] = tree_map(torch.zeros_like, params)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, on the device."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_scale(gnorm: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """The factor that clips a gradient of global norm ``gnorm`` to
    ``cfg.grad_clip`` (1 below it)."""
    return torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)


def adamw_apply(params, grads, state, cfg: AdamWConfig,
                scale: torch.Tensor) -> Tuple[Any, dict]:
    """One AdamW step over trees whose gradients already hold the error
    feedback, scaled by ``scale`` (``clip_scale``): (new_params,
    new_state). Elementwise, so it runs on any part of the trees."""
    step = state["step"] + 1
    grads = tree_map(lambda g: g * scale, grads)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def m_of(g, m):
        return cfg.b1 * m + (1 - cfg.b1) * g.float()

    def v_of(g, v):
        return cfg.b2 * v + (1 - cfg.b2) * torch.square(g.float())

    new_m = tree_map(m_of, grads, state["m"])
    new_v = tree_map(v_of, grads, state["v"])

    def p_of(p, m, v):
        mh, vh = m / b1c, v / b2c
        return p - cfg.lr * (mh / (torch.sqrt(vh) + cfg.eps)
                             + cfg.weight_decay * p)

    new_params = tree_map(p_of, params, new_m, new_v)
    new_state = {"m": new_m, "v": new_v, "step": step}
    if cfg.error_feedback:
        # the error of the bf16-quantised gradient actually applied
        new_state["ef"] = tree_map(
            lambda g: g - g.to(torch.bfloat16).float(), grads)
    return new_params, new_state


def adamw_update(params, grads, state, cfg: AdamWConfig
                 ) -> Tuple[Any, dict, dict]:
    """fp32 params/grads trees -> (new_params, new_state, metrics)."""
    if cfg.error_feedback:
        grads = tree_map(lambda g, e: g.float() + e, grads, state["ef"])
    gnorm = global_norm(grads)
    new_params, new_state = adamw_apply(params, grads, state, cfg,
                                        clip_scale(gnorm, cfg))
    return new_params, new_state, {"grad_norm": gnorm}


# ------------------------------------------------------------ ZeRO-1 axes
def opt_axes(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
             data_size: int) -> Tuple[Optional[str], ...]:
    """A parameter's logical axes for optimizer/master storage: the
    largest unsharded dimension divisible by ``data_size`` becomes
    "opt_fsdp" (ZeRO-1)."""
    best, best_dim = None, 0
    for i, (ax, d) in enumerate(zip(axes, shape)):
        if ax is None and d % data_size == 0 and d > best_dim:
            best, best_dim = i, d
    if best is None:
        return axes
    new = list(axes)
    new[best] = "opt_fsdp"
    return tuple(new)


def opt_axes_tree(axes_tree, shapes_tree, data_size: int):
    """``opt_axes`` over a tree of axis tuples and a tree of the same
    structure whose leaves have ``.shape``."""
    return tree_map(lambda a, s: opt_axes(a, tuple(s.shape), data_size),
                    axes_tree, shapes_tree)
