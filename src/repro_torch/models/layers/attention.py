"""Attention: GQA / MHA with causal, sliding-window and softcap masking.

Prefill attention (``kernels.ops.flash_attention``) and decode attention
over a contiguous cache (``kernels.ops.decode_attention``) or a paged
pool (``kernels.ops.decode_attention_paged``) all go through the kernel
dispatcher: the CUDA kernels on the card, their plain PyTorch versions on
the CPU. In serving K and V are not projected here:
``models/transformer.py`` projects them through the restoration kernel,
so prefill and restoration share one K/V code path; the training forward
projects them by plain products (``project_qkv``).
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
    padded_heads: int = 0        # query heads padded for a model axis; 0: none

    @property
    def q_heads(self) -> int:
        """Query heads as the projections lay them out: ``padded_heads``
        when the model axis pads them, else ``n_heads``."""
        return self.padded_heads or self.n_heads

    @property
    def group(self) -> int:
        return self.q_heads // self.n_kv_heads


def live_q_columns(h: AttnHyper) -> torch.Tensor:
    """(q_heads·hd,) bool: the query columns of real heads. Padding grows
    each KV head's group of query heads; the first n_heads/n_kv_heads of
    every group are real (the JAX package's layout)."""
    qd = h.q_heads * h.head_dim
    return (torch.arange(qd) % (h.group * h.head_dim)
            < (h.n_heads // h.n_kv_heads) * h.head_dim)


def init_attention(gen: torch.Generator, d_model: int, h: AttnHyper, dtype,
                   device) -> dict:
    """wq, wk, wv, wo (and bq, bk, bv); with padded heads the padded
    columns of wq and rows of wo are zero."""
    qd = h.q_heads * h.head_dim
    kvd = h.n_kv_heads * h.head_dim
    scale = d_model ** -0.5
    wq = normal_init(gen, (d_model, qd), dtype, scale, device)
    wk = dense_param(gen, d_model, kvd, dtype, device, scale)
    wv = dense_param(gen, d_model, kvd, dtype, device, scale)
    wo = normal_init(gen, (qd, d_model), dtype, qd ** -0.5, device)
    if h.q_heads != h.n_heads:
        live = live_q_columns(h).to(device)
        wq = wq * live[None, :].to(dtype)
        wo = wo * live[:, None].to(dtype)
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if h.qkv_bias:
        p["bq"] = bias_param(qd, dtype, device)
        p["bk"] = bias_param(kvd, dtype, device)
        p["bv"] = bias_param(kvd, dtype, device)
    return p


def project_q(p: dict, x: torch.Tensor, h: AttnHyper, cos, sin):
    """x (B,S,D) -> q (B,S,H,hd) (H = ``q_heads``), RoPE applied from
    cos/sin (B,S,hd/2)."""
    B, S, _ = x.shape
    q = torch.matmul(x, p["wq"])
    if h.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, S, h.q_heads, h.head_dim)
    if h.use_rope:
        q = apply_rope_tables(q, cos, sin)
    return q


def project_kv(p: dict, x: torch.Tensor, h: AttnHyper):
    """x (B,S,D) -> k, v (B,S,cols) by plain products, biases added: every
    K/V column, or a model shard's slice of them."""
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if h.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def kv_heads(k: torch.Tensor, v: torch.Tensor, h: AttnHyper, cos, sin):
    """k, v (B,S,n·hd) -> (B,S,n,hd) each, RoPE on k from cos/sin
    (B,S,hd/2)."""
    B, S, _ = k.shape
    k = k.reshape(B, S, -1, h.head_dim)
    v = v.reshape(B, S, -1, h.head_dim)
    if h.use_rope:
        k = apply_rope_tables(k, cos, sin)
    return k, v


def project_qkv(p: dict, x: torch.Tensor, h: AttnHyper, cos, sin):
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,Kv,hd) by plain products, RoPE
    on q and k from cos/sin (B,S,hd/2): the training forward's projection
    (the JAX package's ``project_qkv``); serving projects K/V through the
    restoration kernel instead (``transformer._attn_qkv``)."""
    k, v = kv_heads(*project_kv(p, x, h), h, cos, sin)
    return project_q(p, x, h, cos, sin), k, v


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
    ``kv_len`` (default Skv) keys are live. Under autograd (grad enabled
    and an input that requires grad) it goes through
    ``ops.flash_attention_autograd``, the same kernel with a backward."""
    B, Skv = q.shape[0], k.shape[1]
    host = (int(q_offset), Skv if kv_len is None else int(kv_len))
    qo, kl = _prefill_lens(B, *host, q.device)
    fn = ops.flash_attention
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        fn = ops.flash_attention_autograd
    return fn(q, k, v, qo, kl, causal=causal, softcap=h.attn_softcap,
              window=window, host_lens=host)


def decode_attention(q, k_cache, v_cache, h: AttnHyper, *, kv_len,
                     window: Optional[int] = None, kv_start=None,
                     return_lse: bool = False, host_kv_len=None,
                     host_kv_start: Optional[int] = None):
    """One decode token per sequence. q (B,1,H,hd); caches (B,Smax,Kv,hd),
    read in place; kv_len (B,) int live lengths including the new token.
    ``kv_start`` (B,) int: the caches are a context slice holding
    absolute positions [kv_start, kv_start + Smax) (``kv_len`` and
    ``window`` stay absolute); ``return_lse`` returns the slice's partial
    in fp32 and its log-sum-exp per head (B, H) fp32, for
    ``merge_partials``. ``host_kv_len`` (B,) and ``host_kv_start`` (one
    int for every row): the same on the host, where the caller knows
    them (the counted path, ``launch/exec_cost.py``)."""
    B, _, H, hd = q.shape
    Kv = h.n_kv_heads
    qg = q.reshape(B * Kv, H // Kv, hd)
    lens = kv_len.to(torch.int32).repeat_interleave(Kv).contiguous()
    starts = (None if kv_start is None else
              kv_start.to(torch.int32).repeat_interleave(Kv).contiguous())
    out = ops.decode_attention(qg, k_cache, v_cache, lens,
                               softcap=h.attn_softcap, window=window,
                               kv_start=starts, return_lse=return_lse,
                               host_kv_len=_rows(host_kv_len, Kv),
                               host_kv_start=host_kv_start)
    if not return_lse:
        return out.reshape(B, 1, H, hd)
    out, lse = out
    return out.reshape(B, 1, H, hd), lse.reshape(B, H)


def merge_partials(outs, lses, dtype=None):
    """The decode attention of a row over its context slices, from each
    slice's fp32 partial (B,1,H,hd) and log-sum-exp (B,H) in slice order
    (``decode_attention(..., kv_start, return_lse=True)``), merged in
    fp32 in that order: lse = logsumexp_c lse_c and out = sum_c
    exp(lse_c - lse) out_c, rounded once to ``dtype`` (default the
    partials'). A row no slice holds a key of gives zeros. One slice
    without an lse: its partial as it is."""
    if len(outs) == 1 and lses[0] is None:
        return outs[0]
    top = lses[0]
    for x in lses[1:]:
        top = torch.maximum(top, x)
    top = torch.where(torch.isinf(top), torch.zeros_like(top), top)
    ws = [torch.exp(x - top) for x in lses]
    total = ws[0]
    for w in ws[1:]:
        total = total + w
    inv = torch.where(total > 0, 1.0 / total, torch.zeros_like(total))
    acc = None
    for o, w in zip(outs, ws):
        term = o.float() * (w * inv)[:, None, :, None]
        acc = term if acc is None else acc + term
    return acc.to(dtype or outs[0].dtype)


def attn_output(p: dict, attn: torch.Tensor):
    """attn (B,S,H,hd) -> (B,S,D) through the output projection."""
    B, S, H, hd = attn.shape
    return torch.matmul(attn.reshape(B, S, H * hd), p["wo"])


def _rows(host, Kv: int):
    """Per-batch host lengths repeated for each KV head's row."""
    return None if host is None else [int(n) for n in host
                                      for _ in range(Kv)]


def decode_attention_paged(q, k_pool, v_pool, block_table, h: AttnHyper, *,
                           kv_len, window: Optional[int] = None,
                           host_kv_len=None):
    """One decode token per sequence over a paged pool. q (B,1,H,hd); pools
    (NB,bs,Kv,hd) of this layer, read in place; block_table (B,MB) int32;
    kv_len (B,) int live lengths including the new token."""
    B, _, H, hd = q.shape
    Kv = h.n_kv_heads
    qg = q.reshape(B * Kv, H // Kv, hd)
    lens = kv_len.to(torch.int32).repeat_interleave(Kv).contiguous()
    out = ops.decode_attention_paged(qg, k_pool, v_pool, block_table, lens,
                                     softcap=h.attn_softcap, window=window,
                                     host_kv_len=_rows(host_kv_len, Kv))
    return out.reshape(B, 1, H, hd)
