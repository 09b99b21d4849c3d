"""Kernel dispatch by device: the hand-written CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors. There is no switch to
skip the kernel on the card."""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import restore_kv as _rkv


def restore_kv_grouped(hidden, wk, wv, bk, bv, rows, cos, sin, *,
                       head_dim: int, use_rope: bool = True):
    """See ``kernels/restore_kv.py``."""
    fn = (_rkv.restore_kv_grouped_cuda if hidden.device.type == "cuda"
          else _rkv.restore_kv_grouped_plain)
    return fn(hidden, wk, wv, bk, bv, rows, cos, sin, head_dim=head_dim,
              use_rope=use_rope)


def decode_attention(q, k, v, kv_len, *, softcap=None, window=None):
    """See ``kernels/decode_attention.py``."""
    fn = (_dec.decode_attention_cuda if q.device.type == "cuda"
          else _dec.decode_attention_plain)
    return fn(q, k, v, kv_len, softcap=softcap, window=window)
