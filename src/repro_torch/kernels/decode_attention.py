"""Single-token decode attention against a contiguous KV cache.

q ``(BKv, G, hd)``: one query token, G query heads per kv head. The cache
is either ``(BKv, Smax, hd)`` or the model's own ``(B, Smax, Kv, hd)``
layout with ``BKv = B·Kv`` (row ``b·Kv + h`` reads batch b, kv head h).
``kv_len (BKv,)`` int32 counts the live positions. Positions at or past
``kv_len``, and with a ``window`` those at or before ``kv_len - 1 -
window``, get no weight; ``softcap`` squashes the logits before masking.
Returns ``(BKv, G, hd)`` in q's dtype.

``decode_attention_cuda`` launches the hand-written kernel
(``csrc/decode_attention.cu``), which reads the 4-D cache in place
through its strides; ``decode_attention_plain`` is the plain PyTorch
version. ``kernels.ops`` picks one by device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_GROUP = 16
MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches so far; chip_smoke.py resets and reads it
launches = 0


def _as_rows(cache: torch.Tensor) -> torch.Tensor:
    """(B, Smax, Kv, hd) -> (B·Kv, Smax, hd); 3-D caches pass through."""
    if cache.dim() == 3:
        return cache
    B, S, Kv, hd = cache.shape
    return cache.permute(0, 2, 1, 3).reshape(B * Kv, S, hd)


def decode_attention_plain(q, k, v, kv_len, *,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None):
    """Plain PyTorch version (fp32 scores and softmax). Like the kernel it
    reads only positions below the longest ``kv_len``, so its result does
    not depend on the cache's spare capacity."""
    live = max(int(kv_len.max()), 1) if kv_len.numel() else 1
    k, v = _as_rows(k[:, :live]), _as_rows(v[:, :live])
    s = torch.einsum("bgh,bkh->bgk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    kl = kv_len.to(q.device).long()[:, None, None]
    mask = kpos < kl
    if window is not None:
        mask &= kpos > kl - 1 - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgk,bkh->bgh", p, v.float()).to(q.dtype)


def decode_attention_cuda(q, k, v, kv_len, *,
                          softcap: Optional[float] = None,
                          window: Optional[int] = None):
    """Launch the CUDA kernel; same contract as the plain version."""
    global launches
    if q.device.type != "cuda":
        raise ValueError("decode_attention_cuda needs CUDA tensors")
    dtype, dev = q.dtype, q.device
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {dtype}")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError("q must be a contiguous (BKv, G, hd) tensor")
    BKv, G, hd = q.shape
    if not 1 <= G <= MAX_GROUP or not 8 <= hd <= MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"unsupported G={G} or hd={hd}")
    strides = []
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on {dev}")
        if t.dim() == 3:
            if t.shape[0] != BKv or t.shape[2] != hd:
                raise ValueError(f"{name} has shape {tuple(t.shape)}")
            n_kv = 1
            sb, ss, sh = t.stride(0), t.stride(1), 0
        elif t.dim() == 4:
            B, _, n_kv, thd = t.shape
            if B * n_kv != BKv or thd != hd:
                raise ValueError(f"{name} has shape {tuple(t.shape)}")
            sb, ss, sh = t.stride(0), t.stride(1), t.stride(2)
        else:
            raise ValueError(f"{name} must be 3-D or 4-D")
        if t.stride(-1) != 1 or (sb | ss | sh) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dimension, "
                             "strides that are multiples of 8 and a "
                             "16-byte aligned start")
        strides.append((t.shape[1], n_kv, sb, ss, sh))
    (smax, n_kv, sb, ss, sh), (vsmax, vn_kv, vsb, vss, vsh) = strides
    if (smax, n_kv) != (vsmax, vn_kv):
        raise ValueError("k and v shapes differ")
    if kv_len.device != dev or kv_len.dtype != torch.int32 \
            or tuple(kv_len.shape) != (BKv,) or not kv_len.is_contiguous():
        raise ValueError("kv_len must be a contiguous (BKv,) int32 tensor "
                         "on q's device")
    out = torch.empty_like(q)
    if BKv == 0:
        return out
    lib = _build.library()
    lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), BKv, G, hd, n_kv, smax, sb, ss, sh, vsb, vss, vsh,
        hd ** -0.5, float(softcap) if softcap is not None else 0.0,
        int(window) if window is not None else 0, _DTYPE_CODE[dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return out
