"""Feed-forward: SiLU-GLU (llama style) and the plain 2-layer variant."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.module import dense_param

ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, glu: bool,
             dtype, device) -> dict:
    p = {
        "w_up": dense_param(gen, d_model, d_ff, dtype, device),
        "w_down": dense_param(gen, d_ff, d_model, dtype, device),
    }
    if glu:
        p["w_gate"] = dense_param(gen, d_model, d_ff, dtype, device)
    return p


def apply_mlp(p: dict, x: torch.Tensor, activation: str):
    act = ACTS[activation]
    up = torch.matmul(x, p["w_up"])
    if "w_gate" in p:
        up = act(torch.matmul(x, p["w_gate"])) * up
    else:
        up = act(up)
    return torch.matmul(up, p["w_down"])
