"""Prefill (flash) attention: a block of queries against a key range.

q ``(B, Sq, H, hd)``, k/v ``(B, Skv, Kv, hd)`` in the model's own layouts;
query head h reads kv head ``h // (H // Kv)`` (GQA). ``q_offset (B,)``
int32 is the absolute position of query row 0 (the restored history's
length in a prefill over history), ``kv_len (B,)`` int32 the number of
live keys. Key j is visible to query i of batch b iff ``j < kv_len[b]``,
and ``j <= q_offset[b] + i`` when ``causal``, and
``j > q_offset[b] + i - window`` with a ``window``; ``softcap`` squashes
the logits before masking. Returns ``(B, Sq, H, hd)`` in q's dtype.

With ``q_offset = 0`` and ``kv_len = Skv`` this is what the JAX package's
``flash_attention_pallas`` computes; with an offset it is what its model
runs for a prefill over restored history (``flash_attention_jnp``).

``flash_attention_cuda`` launches the hand-written kernel
(``csrc/flash_attention.cu``), which reads all three tensors in place
through their strides; ``flash_attention_plain`` is the plain PyTorch
version, a chunked online softmax. ``kernels.ops`` picks one by device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0e38
HEAD_DIMS = (64, 128)
TILE = 64            # keys per online-softmax step, as the kernel walks them
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches so far; chip_smoke.py resets and reads it
launches = 0


def flash_attention_plain(q, k, v, q_offset, kv_len, *, causal: bool = True,
                          softcap: Optional[float] = None,
                          window: Optional[int] = None):
    """Plain PyTorch version: online softmax over key chunks of ``TILE``
    in fp32, P rounded to v's dtype before P @ V (as the JAX package's
    ``flash_attention_jnp`` does over its chunks). The chunk is the
    kernel's key tile, so in bf16 P is rounded against the same running
    maxima as in the kernel."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    g = H // Kv
    dev = q.device
    qg = q.reshape(B, Sq, Kv, g, hd).float()
    qp = (q_offset.to(dev).long()[:, None]
          + torch.arange(Sq, device=dev)[None, :])[:, :, None]   # (B,Sq,1)
    kl = kv_len.to(dev).long()[:, None, None]
    C = min(TILE, Skv)
    m = torch.full((B, Kv, g, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Kv, g, Sq, hd), dtype=torch.float32, device=dev)
    for c0 in range(0, Skv, C):
        kc, vc = k[:, c0:c0 + C], v[:, c0:c0 + C]
        n = kc.shape[1]
        if n < C:
            pad = (0, 0, 0, 0, 0, C - n)
            kc = torch.nn.functional.pad(kc, pad)
            vc = torch.nn.functional.pad(vc, pad)
        s = torch.einsum("bqkgh,bckh->bkgqc", qg, kc.float()) * hd ** -0.5
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        kp = (c0 + torch.arange(C, device=dev))[None, None, :]    # (1,1,C)
        ok = kp < kl
        if causal:
            ok = ok & (kp <= qp)
        if window is not None:
            ok = ok & (kp > qp - window)
        s = s + torch.where(ok, 0.0, NEG_INF).float()[:, None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(v.dtype).float(),
                          vc.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def _strides(name: str, t: torch.Tensor, vec: int):
    if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous last dimension, strides "
                         f"that are multiples of {vec} and a 16-byte "
                         "aligned start")
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention_cuda(q, k, v, q_offset, kv_len, *, causal: bool = True,
                         softcap: Optional[float] = None,
                         window: Optional[int] = None):
    """Launch the CUDA kernel; same contract as the plain version."""
    global launches
    if q.device.type != "cuda":
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    dtype, dev = q.dtype, q.device
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D")
    B, Sq, H, hd = q.shape
    _, Skv, Kv, _ = k.shape
    if hd not in HEAD_DIMS or H % Kv:
        raise ValueError(f"unsupported hd={hd}, H={H}, Kv={Kv}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on {dev}")
        if tuple(t.shape) != (B, Skv, Kv, hd):
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        if t.device != dev or t.dtype != torch.int32 \
                or tuple(t.shape) != (B,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B,) int32 "
                             "tensor on q's device")
    vec = 16 // q.element_size()
    qs, ks, vs = (_strides(n, t, vec) for n, t in
                  (("q", q), ("k", k), ("v", v)))
    out = torch.empty((B, Sq, H, hd), dtype=dtype, device=dev)
    if B == 0 or Sq == 0 or Skv == 0:
        return out.zero_()
    lib = _build.library()
    lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_offset.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), B, Sq, Skv, H, Kv, hd, *qs, *ks,
        *vs, hd ** -0.5, float(softcap) if softcap is not None else 0.0,
        int(bool(causal)), int(window) if window is not None else 0,
        _DTYPE_CODE[dtype], torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return out
