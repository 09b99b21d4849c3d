"""Token embedding and output head. The table's vocabulary is padded to a
multiple of 128; padded logit columns are masked so they never win."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.module import normal_init

VOCAB_PAD = 128


def padded_vocab(vocab: int) -> int:
    return (vocab + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype,
                   device, tie: bool) -> dict:
    vp = padded_vocab(vocab)
    p = {"table": normal_init(gen, (vp, d_model), dtype, 1.0, device)}
    if not tie:
        p["unembed"] = normal_init(gen, (d_model, vp), dtype,
                                   d_model ** -0.5, device)
    return p


def embed_tokens(p: dict, ids: torch.Tensor, *, scale: bool, d_model: int):
    x = p["table"][ids]
    if scale:
        x = x * torch.tensor(d_model ** 0.5, dtype=x.dtype)
    return x


def logits(p: dict, x: torch.Tensor, *, softcap: Optional[float] = None,
           true_vocab: Optional[int] = None):
    if "unembed" in p:
        out = torch.matmul(x, p["unembed"])
    else:
        out = torch.matmul(x, p["table"].t())
    if softcap is not None:
        out = torch.tanh(out.float() / softcap) * softcap
    vp = out.shape[-1]
    if true_vocab is not None and vp != true_vocab:
        pad = torch.arange(vp, device=out.device) >= true_vocab
        out = out.masked_fill(pad, -1e30)
    return out
