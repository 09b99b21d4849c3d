"""Attention: GQA / MHA with causal, sliding-window and softcap masking.

Prefill attention is ``flash_attention`` below, a chunked online-softmax
written in plain torch ops (the counterpart of the JAX package's
``flash_attention_jnp``). Decode attention goes through the kernel
dispatcher (``kernels.ops.decode_attention``). K and V are not projected
here: ``models/transformer.py`` projects them through the restoration
kernel, so prefill and restoration share one K/V code path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers.rope import apply_rope_tables
from repro_torch.models.module import bias_param, dense_param, normal_init

NEG_INF = -2.0e38


@dataclasses.dataclass(frozen=True)
class AttnHyper:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None
    chunk: int = 1024            # kv chunk of the prefill path


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


def _mask_bias(q_pos, kv_pos, *, causal: bool, window: Optional[int],
               kv_len=None):
    """Additive bias (B,1,1,Sq,Skv): 0 where attendable, NEG_INF elsewhere.
    q_pos (B,Sq) absolute query positions; kv_pos (Skv,); kv_len None, an
    int, or (B,)."""
    qp = q_pos[:, :, None]
    kp = kv_pos[None, None, :]
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    if kv_len is not None:
        if isinstance(kv_len, int):
            ok &= kp < kv_len
        else:
            ok &= kp < kv_len.reshape(-1, 1, 1)
    bias = torch.where(ok, 0.0, NEG_INF).float()
    return bias[:, None, None, :, :]


def _scores(q, k, softcap):
    """q (B,Sq,Kv,g,hd), k (B,C,Kv,hd) -> (B,Kv,g,Sq,C) fp32."""
    s = torch.einsum("bqkgh,bckh->bkgqc", q.float(), k.float())
    s = s * q.shape[-1] ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    return s


def flash_attention(q, k, v, h: AttnHyper, *, q_positions, causal: bool,
                    window: Optional[int] = None, kv_len=None):
    """Chunked online-softmax attention in plain torch ops.

    q (B,Sq,H,hd), k/v (B,Skv,Kv,hd) -> (B,Sq,H,hd). The K/V chunks are a
    Python loop (``jax.lax.scan`` in the JAX package)."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    Kv = h.n_kv_heads
    g = H // Kv
    qg = q.reshape(B, Sq, Kv, g, hd)
    C = min(h.chunk, Skv)
    n_chunks = (Skv + C - 1) // C
    if n_chunks * C != Skv and kv_len is None:
        kv_len = Skv          # mask the short last chunk's padding
    m = torch.full((B, Kv, g, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Kv, g, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for idx in range(n_chunks):
        kc, vc = k[:, idx * C:(idx + 1) * C], v[:, idx * C:(idx + 1) * C]
        c = kc.shape[1]
        if c < C:
            pad = (0, 0, 0, 0, 0, C - c)
            kc = torch.nn.functional.pad(kc, pad)
            vc = torch.nn.functional.pad(vc, pad)
        s = _scores(qg, kc, h.attn_softcap)
        kv_pos = idx * C + torch.arange(C, device=q.device)
        s = s + _mask_bias(q_positions, kv_pos, causal=causal,
                           window=window, kv_len=kv_len)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(v.dtype).float(),
                          vc.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


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
