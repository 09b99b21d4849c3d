"""Token embedding, learned absolute positions (OPT, the whisper decoder)
and output head. The table's vocabulary is padded to a multiple of 128;
padded logit columns are masked so they never win."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.module import normal_init

VOCAB_PAD = 128
MAX_POSITIONS = 8192     # learned position rows (the JAX package's default)


def padded_vocab(vocab: int) -> int:
    return (vocab + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype,
                   device, tie: bool, max_positions: int = 0) -> dict:
    """``max_positions > 0`` adds a learned position table of that many
    rows (N(0, 0.02²), as the JAX package draws it)."""
    vp = padded_vocab(vocab)
    p = {"table": normal_init(gen, (vp, d_model), dtype, 1.0, device)}
    if not tie:
        p["unembed"] = normal_init(gen, (d_model, vp), dtype,
                                   d_model ** -0.5, device)
    if max_positions:
        p["positions"] = normal_init(gen, (max_positions, d_model), dtype,
                                     0.02, device)
    return p


def embed_tokens(p: dict, ids: torch.Tensor, *, scale: bool, d_model: int,
                 first_row: Optional[int] = None):
    """The rows ``ids`` of the table. ``first_row`` set: the table is a
    model shard's rows [first_row, first_row + n) of a vocab-sharded one,
    and an id outside them gives zeros (the shards' lookups sum to the
    whole one)."""
    table = p["table"]
    if first_row is None:
        x = table[ids]
    else:
        n = table.shape[0]
        local = ids - first_row
        own = (local >= 0) & (local < n)
        x = table[local.clamp(0, n - 1)]
        x = torch.where(own[..., None], x, torch.zeros_like(x))
    if scale:
        x = x * torch.tensor(d_model ** 0.5, dtype=x.dtype)
    return x


def positional(p: dict, positions: torch.Tensor, end: int):
    """Learned absolute positions: rows ``positions`` of the table.
    ``end`` is ``positions.max() + 1``, which the caller knows on the host
    (reading it from the device would wait for it). A position past the
    table raises; the JAX package's ``jnp.take`` would clamp it."""
    n = p["positions"].shape[0]
    if end > n:
        raise IndexError(f"position {end - 1} is past the {n}-row learned "
                         "position table")
    return p["positions"][positions.long()]


def logits(p: dict, x: torch.Tensor, *, softcap: Optional[float] = None,
           true_vocab: Optional[int] = None, first_col: int = 0):
    """x (..., D) -> logits over the table's rows; ``first_col`` is the
    vocabulary index of its first row (a model shard's slice of a
    vocab-sharded table). Columns at or past ``true_vocab`` (the padding)
    are masked."""
    if "unembed" in p:
        out = torch.matmul(x, p["unembed"])
    else:
        out = torch.matmul(x, p["table"].t())
    if softcap is not None:
        out = torch.tanh(out.float() / softcap) * softcap
    vp = out.shape[-1]
    if true_vocab is not None and first_col + vp > true_vocab:
        col = first_col + torch.arange(vp, device=out.device)
        out = out.masked_fill(col >= true_vocab, -1e30)
    return out
