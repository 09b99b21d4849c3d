"""Parameter containers and initialisers.

Parameters are plain nested dicts of tensors with the JAX package's tree
layout (``repro/models/module.py``), so a converted JAX tree and a tree
initialised here are interchangeable. Per-layer parameters are stacked
along a leading layer axis. Initialisation draws from an explicit
``torch.Generator`` with the JAX package's scales; the two frameworks give
different numbers from the same seed.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def normal_init(gen: torch.Generator, shape: Sequence[int], dtype,
                scale: float, device) -> torch.Tensor:
    """N(0, scale²) drawn in fp32 on ``device``, then cast."""
    x = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def dense_param(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
                scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return normal_init(gen, (d_in, d_out), dtype, scale, device)


def bias_param(d: int, dtype, device) -> torch.Tensor:
    return torch.zeros(d, dtype=dtype, device=device)


def scale_param(d: int, dtype, device, value: float = 1.0) -> torch.Tensor:
    return torch.full((d,), value, dtype=dtype, device=device)


def stacked_init(per_layer_init: Callable[[], dict], n: int) -> dict:
    """Run a per-layer init ``n`` times and stack each leaf along a new
    leading layer axis. The stack is filled layer by layer, so at most one
    layer's temporaries exist beside it."""
    first = per_layer_init()

    def alloc(x):
        if isinstance(x, dict):
            return {k: alloc(v) for k, v in x.items()}
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        out[0] = x
        return out

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i] = v

    stacked = alloc(first)
    del first
    for i in range(1, n):
        fill(stacked, per_layer_init(), i)
    return stacked


def count_params(tree: dict) -> int:
    return sum(count_params(v) if isinstance(v, dict) else v.numel()
               for v in tree.values())


# ------------------------------------------------------------ logical axes
# Each parameter leaf's logical axes by its name, without the leading
# "layers" axes of a stack (one per stacking level), as the JAX package's
# init functions ``box`` them. A MoE block's FFN (under "moe") and a
# Mamba2 block (a dict with "gate_norm") name some leaves otherwise.
_LEAF_AXES = {
    "table": ("vocab", "d_model"), "unembed": ("d_model", "vocab"),
    "positions": (None, "d_model"),
    "scale": (None,), "bias": (None,),
    "wq": ("d_model", "qkv_out"), "wk": ("d_model", "kv_out"),
    "wv": ("d_model", "kv_out"), "wo": ("o_in", "d_model"),
    "bq": ("qkv_out",), "bk": ("kv_out",), "bv": ("kv_out",),
    "w_up": ("d_model", "d_ff"), "w_gate": ("d_model", "d_ff"),
    "w_down": ("d_ff", "d_model"),
    "in_proj": ("d_model", "ssm_inner"), "conv_w": ("ssm_inner", "conv_w"),
    "conv_b": ("ssm_inner",), "x_proj": ("ssm_inner", None),
    "dt_proj": ("dt_rank", "ssm_inner"), "dt_bias": ("ssm_inner",),
    "a_log": ("ssm_inner", "ssm_state"), "d_skip": ("ssm_inner",),
    "out_proj": ("ssm_inner", "d_model"), "gate_norm": (None,),
}
_MOE_AXES = {"router": ("d_model", "experts"),
             "w_up": ("experts", "d_model", "d_ff"),
             "w_gate": ("experts", "d_model", "d_ff"),
             "w_down": ("experts", "d_ff", "d_model")}
_MAMBA2_AXES = {"dt_bias": ("ssm_heads",), "a_log": ("ssm_heads",),
                "d_skip": ("ssm_heads",)}


def param_axes(tree: dict, _path: str = "", _table=None) -> dict:
    """The tree of logical-axis tuples of a parameter tree (any leaves
    with ``.dim()``): the JAX package's ``split(model.init(...))[1]``."""
    out = {}
    for k, v in tree.items():
        path = f"{_path}/{k}"
        if isinstance(v, dict):
            table = (_MOE_AXES if k == "moe"
                     else _MAMBA2_AXES if "gate_norm" in v else None)
            out[k] = param_axes(v, path, table)
            continue
        base = (_table or {}).get(k, _LEAF_AXES.get(k))
        if base is None or v.dim() < len(base):
            raise KeyError(f"no logical axes for parameter {path} of "
                           f"rank {v.dim()}")
        out[k] = ("layers",) * (v.dim() - len(base)) + base
    return out
