"""Attention: GQA / MHA with causal, sliding-window and softcap masking.

Prefill attention (``kernels.ops.flash_attention``) and decode attention
over a contiguous cache (``kernels.ops.decode_attention``) or a paged
pool (``kernels.ops.decode_attention_paged``) all go through the kernel
dispatcher: the CUDA kernels on the card, their plain PyTorch versions on
the CPU. K and V are not projected here: ``models/transformer.py``
projects them through the restoration kernel, so prefill and restoration
share one K/V code path.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers.rope import apply_rope_tables
from repro_torch.models.module import bias_param, dense_param, normal_init


@dataclasses.dataclass(frozen=True)
class AttnHyper:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None


def init_attention(gen: torch.Generator, d_model: int, h: AttnHyper, dtype,
                   device) -> dict:
    qd = h.n_heads * h.head_dim
    kvd = h.n_kv_heads * h.head_dim
    scale = d_model ** -0.5
    p = {
        "wq": normal_init(gen, (d_model, qd), dtype, scale, device),
        "wk": dense_param(gen, d_model, kvd, dtype, device, scale),
        "wv": dense_param(gen, d_model, kvd, dtype, device, scale),
        "wo": normal_init(gen, (qd, d_model), dtype, qd ** -0.5, device),
    }
    if h.qkv_bias:
        p["bq"] = bias_param(qd, dtype, device)
        p["bk"] = bias_param(kvd, dtype, device)
        p["bv"] = bias_param(kvd, dtype, device)
    return p


def project_q(p: dict, x: torch.Tensor, h: AttnHyper, cos, sin):
    """x (B,S,D) -> q (B,S,H,hd), RoPE applied from cos/sin (B,S,hd/2)."""
    B, S, _ = x.shape
    q = torch.matmul(x, p["wq"])
    if h.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, S, h.n_heads, h.head_dim)
    if h.use_rope:
        q = apply_rope_tables(q, cos, sin)
    return q


@functools.lru_cache(maxsize=256)
def _prefill_lens(B: int, q_offset: int, kv_len: int, device: torch.device):
    """(q_offset, kv_len) as (B,) int32 device tensors, uploaded once per
    distinct prefill shape: a fresh upload per layer would make the host
    wait for the device every layer."""
    t = torch.tensor([[q_offset] * B, [kv_len] * B], dtype=torch.int32,
                     device=device)
    return t[0], t[1]


def flash_attention(q, k, v, h: AttnHyper, *, q_offset: int, causal: bool,
                    window: Optional[int] = None,
                    kv_len: Optional[int] = None):
    """Prefill attention through the kernel dispatcher
    (``kernels.ops.flash_attention``). q (B,Sq,H,hd), k/v (B,Skv,Kv,hd)
    -> (B,Sq,H,hd); query row i sits at position ``q_offset + i``, and
    ``kv_len`` (default Skv) keys are live."""
    B, Skv = q.shape[0], k.shape[1]
    qo, kl = _prefill_lens(B, int(q_offset),
                           Skv if kv_len is None else int(kv_len), q.device)
    return ops.flash_attention(q, k, v, qo, kl, causal=causal,
                               softcap=h.attn_softcap, window=window)


def decode_attention(q, k_cache, v_cache, h: AttnHyper, *, kv_len,
                     window: Optional[int] = None):
    """One decode token per sequence. q (B,1,H,hd); caches (B,Smax,Kv,hd),
    read in place; kv_len (B,) int live lengths including the new token."""
    B, _, H, hd = q.shape
    Kv = h.n_kv_heads
    qg = q.reshape(B * Kv, H // Kv, hd)
    lens = kv_len.to(torch.int32).repeat_interleave(Kv).contiguous()
    out = ops.decode_attention(qg, k_cache, v_cache, lens,
                               softcap=h.attn_softcap, window=window)
    return out.reshape(B, 1, H, hd)


def attn_output(p: dict, attn: torch.Tensor):
    """attn (B,S,H,hd) -> (B,S,D) through the output projection."""
    B, S, H, hd = attn.shape
    return torch.matmul(attn.reshape(B, S, H * hd), p["wo"])


def decode_attention_paged(q, k_pool, v_pool, block_table, h: AttnHyper, *,
                           kv_len, window: Optional[int] = None):
    """One decode token per sequence over a paged pool. q (B,1,H,hd); pools
    (NB,bs,Kv,hd) of this layer, read in place; block_table (B,MB) int32;
    kv_len (B,) int live lengths including the new token."""
    B, _, H, hd = q.shape
    Kv = h.n_kv_heads
    qg = q.reshape(B * Kv, H // Kv, hd)
    lens = kv_len.to(torch.int32).repeat_interleave(Kv).contiguous()
    out = ops.decode_attention_paged(qg, k_pool, v_pool, block_table, lens,
                                     softcap=h.attn_softcap, window=window)
    return out.reshape(B, 1, H, hd)
