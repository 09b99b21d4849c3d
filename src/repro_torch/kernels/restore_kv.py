"""Grouped restoration projection: K/V of G layers from their hidden states.

``restore_kv_grouped`` computes, for each group row g,

    K[g] = RoPE(hidden[g] @ wk[rows[g]] + bk[rows[g]])
    V[g] =      hidden[g] @ wv[rows[g]] + bv[rows[g]]

with fp32 accumulation and the result in hidden's dtype. The weights are
whole ``(A, D, KV)`` stacks indexed by ``rows``: gathering ``wk[rows]``
eagerly would copy G·D·KV elements per weight before every call.

``restore_kv_grouped_cuda`` launches the hand-written kernel
(``csrc/restore_kv.cu``); ``restore_kv_grouped_plain`` is the plain
PyTorch version of the same function; ``kernels.ops`` picks one by
device. The plain version accumulates over D one rank-1 update at a time,
so every output row is computed by the same elementwise arithmetic
wherever it sits in the batch: restored K/V then equals prefill K/V
bitwise on the CPU too, where a library matmul picks a different blocking
for each row count. ``rows`` must lie in ``[0, A)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_HEAD_DIMS = (64, 80, 96, 128)

# kernel launches so far; chip_smoke.py resets and reads it
launches = 0


def _rotate_half(k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 head_dim: int) -> torch.Tensor:
    """k (G, S, KV) fp32; cos/sin (S, hd/2) -> k with each head rotated."""
    G, S, KV = k.shape
    kh = k.reshape(G, S, KV // head_dim, head_dim)
    x1, x2 = kh[..., :head_dim // 2], kh[..., head_dim // 2:]
    c = cos[None, :, None, :].float()
    s = sin[None, :, None, :].float()
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], -1).reshape(G, S, KV)


def restore_kv_grouped_plain(hidden, wk, wv, bk, bv, rows, cos, sin, *,
                             head_dim: int, use_rope: bool = True):
    """Plain PyTorch version. hidden (G,S,D); wk/wv (A,D,KV); bk/bv (A,KV)
    or None; rows (G,) int; cos/sin (S, hd/2) fp32 -> K, V (G,S,KV)."""
    G, S, D = hidden.shape
    KV = wk.shape[-1]
    rows = rows.to(device=hidden.device, dtype=torch.long)
    h = hidden.float()
    k = torch.zeros(G, S, KV, dtype=torch.float32, device=hidden.device)
    v = torch.zeros_like(k)
    for d in range(D):
        hd_col = h[:, :, d:d + 1]
        k = k + hd_col * wk[rows, d].float()[:, None, :]
        v = v + hd_col * wv[rows, d].float()[:, None, :]
    if bk is not None:
        k = k + bk[rows].float()[:, None, :]
        v = v + bv[rows].float()[:, None, :]
    if use_rope:
        k = _rotate_half(k, cos, sin, head_dim)
    return k.to(hidden.dtype), v.to(hidden.dtype)


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def restore_kv_grouped_cuda(hidden, wk, wv, bk, bv, rows, cos, sin, *,
                            head_dim: int, use_rope: bool = True):
    """Launch the CUDA kernel; same contract as the plain version."""
    global launches
    if hidden.device.type != "cuda":
        raise ValueError("restore_kv_grouped_cuda needs CUDA tensors")
    dtype, dev = hidden.dtype, hidden.device
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {dtype}")
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"unsupported head_dim {head_dim}")
    if hidden.dim() != 3:
        raise ValueError("hidden must be (G, S, D)")
    G, S, D = hidden.shape
    A, _, KV = wk.shape
    if KV % head_dim:
        raise ValueError(f"KV={KV} is not a multiple of head_dim")
    _check("hidden", hidden, (G, S, D), dtype, dev)
    _check("wk", wk, (A, D, KV), dtype, dev)
    _check("wv", wv, (A, D, KV), dtype, dev)
    if (bk is None) != (bv is None):
        raise ValueError("bk and bv must both be given or both be None")
    if bk is not None:
        _check("bk", bk, (A, KV), dtype, dev)
        _check("bv", bv, (A, KV), dtype, dev)
    _check("rows", rows, (G,), torch.int32, dev)
    _check("cos", cos, (S, head_dim // 2), torch.float32, dev)
    _check("sin", sin, (S, head_dim // 2), torch.float32, dev)
    if dtype == torch.bfloat16 and (
            D % 8 or any(t.data_ptr() % 16 for t in (hidden, wk, wv))):
        raise ValueError("bf16 needs D a multiple of 8 and 16-byte aligned "
                         "hidden, wk and wv")
    k = torch.empty(G, S, KV, dtype=dtype, device=dev)
    v = torch.empty_like(k)
    if G == 0 or S == 0:
        return k, v
    lib = _build.library()
    lib.restore_kv_grouped(
        hidden.data_ptr(), wk.data_ptr(), wv.data_ptr(),
        bk.data_ptr() if bk is not None else 0,
        bv.data_ptr() if bv is not None else 0,
        rows.data_ptr(), cos.data_ptr(), sin.data_ptr(), k.data_ptr(),
        v.data_ptr(), G, S, D, KV, head_dim, int(use_rope),
        _DTYPE_CODE[dtype], torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return k, v

