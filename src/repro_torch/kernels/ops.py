"""Kernel dispatch by device: the hand-written CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors. There is no switch to
skip the kernel on the card."""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import restore_kv as _rkv
from repro_torch.kernels import ssm_update as _ssm


def restore_kv_grouped(hidden, wk, wv, bk, bv, rows, cos, sin, *,
                       head_dim: int, use_rope: bool = True):
    """See ``kernels/restore_kv.py``."""
    fn = (_rkv.restore_kv_grouped_cuda if hidden.device.type == "cuda"
          else _rkv.restore_kv_grouped_plain)
    return fn(hidden, wk, wv, bk, bv, rows, cos, sin, head_dim=head_dim,
              use_rope=use_rope)


def decode_attention(q, k, v, kv_len, *, softcap=None, window=None,
                     kv_start=None, return_lse=False):
    """See ``kernels/decode_attention.py``."""
    fn = (_dec.decode_attention_cuda if q.device.type == "cuda"
          else _dec.decode_attention_plain)
    return fn(q, k, v, kv_len, softcap=softcap, window=window,
              kv_start=kv_start, return_lse=return_lse)


def decode_attention_paged(q, k_pool, v_pool, block_table, kv_len, *,
                           softcap=None, window=None):
    """See ``kernels/decode_attention.py``."""
    fn = (_dec.decode_attention_paged_cuda if q.device.type == "cuda"
          else _dec.decode_attention_paged_plain)
    return fn(q, k_pool, v_pool, block_table, kv_len, softcap=softcap,
              window=window)


def flash_attention(q, k, v, q_offset, kv_len, *, causal=True, softcap=None,
                    window=None):
    """See ``kernels/flash_attention.py``."""
    fn = (_fa.flash_attention_cuda if q.device.type == "cuda"
          else _fa.flash_attention_plain)
    return fn(q, k, v, q_offset, kv_len, causal=causal, softcap=softcap,
              window=window)


def flash_attention_autograd(q, k, v, q_offset, kv_len, *, causal=True,
                             softcap=None, window=None):
    """``flash_attention`` under autograd (``FlashAttentionFn``): the same
    dispatch forward, the plain backward."""
    return _fa.FlashAttentionFn.apply(q, k, v, q_offset, kv_len, causal,
                                      softcap, window)


def ssm_update(h, dt, x, A, B, C, d_skip, *, h_out=None):
    """See ``kernels/ssm_update.py``."""
    fn = (_ssm.ssm_update_cuda if h.device.type == "cuda"
          else _ssm.ssm_update_plain)
    return fn(h, dt, x, A, B, C, d_skip, h_out=h_out)


def ssm_scan(h, dt, x, A, B, C, d_skip):
    """See ``kernels/ssm_update.py``."""
    fn = (_ssm.ssm_scan_cuda if h.device.type == "cuda"
          else _ssm.ssm_scan_plain)
    return fn(h, dt, x, A, B, C, d_skip)


def ssm_scan_autograd(h, dt, x, A, B, C, d_skip):
    """``ssm_scan`` under autograd (``SSMScanFn``): the same dispatch
    forward, one launch per 128-token chunk, the plain backward. h is not
    written; returns (y, the final state)."""
    return _ssm.SSMScanFn.apply(h, dt, x, A, B, C, d_skip)
