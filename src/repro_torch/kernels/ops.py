"""Kernel dispatch by device: the hand-written CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors, and for ``meta``
tensors (the dry-run's placeholder devices) only the output's shapes and
dtypes. No other device is taken, and there is no switch to skip the
kernel on the card.

Every launch reports to the counter in force (``launch/exec_cost.py``):
the kernel, one launch, its cost from its module's ``*_cost`` formula,
and its outputs. While a CPU tensor runs the plain version the counter is
paused, so a count on the CPU, on ``meta`` and on the card agree. The
decode and prefill costs depend on each row's lengths: the caller passes
them from the host (``host_kv_len``, ``host_lens``); without them a CPU
or CUDA count reads them from the device, and a ``meta`` count refuses.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import restore_kv as _rkv
from repro_torch.kernels import ssm_update as _ssm
from repro_torch.launch import exec_cost

_KINDS = ("cuda", "cpu", "meta")


def _kind(t: torch.Tensor) -> str:
    if t.device.type not in _KINDS:
        raise ValueError(f"the kernels take CUDA, CPU or meta tensors, "
                         f"not {t.device}")
    return t.device.type


def _launch(name: str, like: torch.Tensor, inputs, cuda, plain, meta,
            cost):
    """``cuda``/``plain``/``meta`` by ``like``'s device; with a counter
    in force, run it paused and report one launch of ``name`` at
    ``cost()``."""
    kind = _kind(like)
    run = cuda if kind == "cuda" else plain if kind == "cpu" else meta
    if exec_cost.active() is None:
        return run()
    with exec_cost.paused():
        out = run()
        if kind == "cpu":       # in the kernel's layout, as the card
            out = _contiguous(out)
        flops, nbytes = cost()
    exec_cost.report_kernel(name, flops, nbytes, out, inputs)
    return out


def _contiguous(out):
    if isinstance(out, tuple):
        return tuple(_contiguous(t) for t in out)
    return out.contiguous() if isinstance(out, torch.Tensor) else out


def _host(values, t: torch.Tensor, what: str) -> list:
    """``values`` (an int for every row, or one per row) as a list of
    ``t.numel()`` ints; None reads ``t`` (a sync on the card)."""
    n = t.numel()
    if values is None:
        if t.device.type == "meta":
            raise ValueError(f"counting on meta needs the host {what}")
        return [int(x) for x in t.tolist()]
    if isinstance(values, int):
        return [values] * n
    values = [int(x) for x in values]
    if len(values) != n:
        raise ValueError(f"{len(values)} host {what} for {n} rows")
    return values


def restore_kv_grouped(hidden, wk, wv, bk, bv, rows, cos, sin, *,
                       head_dim: int, use_rope: bool = True):
    """See ``kernels/restore_kv.py``."""
    G, S, D = hidden.shape
    KV = wk.shape[-1]

    def run(fn):
        return lambda: fn(hidden, wk, wv, bk, bv, rows, cos, sin,
                          head_dim=head_dim, use_rope=use_rope)

    def meta():
        k = torch.empty((G, S, KV), dtype=hidden.dtype, device=hidden.device)
        return k, torch.empty_like(k)

    return _launch(
        "restore_kv_grouped", hidden, (hidden, wk, wv),
        run(_rkv.restore_kv_grouped_cuda), run(_rkv.restore_kv_grouped_plain),
        meta, lambda: _rkv.restore_cost(
            G, S, D, KV, head_dim, bias=bk is not None, rope=use_rope,
            elem_bytes=hidden.element_size()))


def decode_attention(q, k, v, kv_len, *, softcap=None, window=None,
                     kv_start=None, return_lse=False, host_kv_len=None,
                     host_kv_start=None):
    """See ``kernels/decode_attention.py``. ``host_kv_len`` (and
    ``host_kv_start`` with ``kv_start``): the same values on the host,
    for the count."""
    BKv, G, hd = q.shape

    def run(fn):
        return lambda: fn(q, k, v, kv_len, softcap=softcap, window=window,
                          kv_start=kv_start, return_lse=return_lse)

    def meta():
        out = torch.empty_like(q, dtype=torch.float32 if return_lse
                               else q.dtype)
        if not return_lse:
            return out
        return out, torch.empty((BKv, G), dtype=torch.float32,
                                device=q.device)

    def cost():
        lens = _host(host_kv_len, kv_len, "lengths")
        starts = (None if kv_start is None
                  else _host(host_kv_start, kv_start, "slice starts"))
        live = _dec.live_keys(lens, k.shape[1], window, starts)
        return _dec.decode_cost(G, hd, live, elem_bytes=q.element_size(),
                                return_lse=return_lse,
                                kv_start=kv_start is not None)

    return _launch("decode_attention", q, (q, k, v),
                   run(_dec.decode_attention_cuda),
                   run(_dec.decode_attention_plain), meta, cost)


def decode_attention_paged(q, k_pool, v_pool, block_table, kv_len, *,
                           softcap=None, window=None, host_kv_len=None):
    """See ``kernels/decode_attention.py``."""
    BKv, G, hd = q.shape

    def run(fn):
        return lambda: fn(q, k_pool, v_pool, block_table, kv_len,
                          softcap=softcap, window=window)

    def cost():
        lens = _host(host_kv_len, kv_len, "lengths")
        bs, MB = k_pool.shape[1], block_table.shape[1]
        live = _dec.live_keys(lens, MB * bs, window)
        per = BKv // max(block_table.shape[0], 1)
        pages = 0
        for n in lens[::per]:
            lo, hi = _dec.slice_range(n, MB * bs, window)
            pages += (-(-hi // bs) - lo // bs) if hi > lo else 0
        return _dec.decode_cost(G, hd, live, elem_bytes=q.element_size(),
                                table_entries=pages)

    return _launch("decode_attention_paged", q, (q, k_pool, v_pool),
                   run(_dec.decode_attention_paged_cuda),
                   run(_dec.decode_attention_paged_plain),
                   lambda: torch.empty_like(q), cost)


def flash_attention(q, k, v, q_offset, kv_len, *, causal=True, softcap=None,
                    window=None, host_lens=None):
    """See ``kernels/flash_attention.py``. ``host_lens``: (q_offset,
    kv_len) on the host (each an int for the whole batch or one per
    row), for the count."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]

    def run(fn):
        return lambda: fn(q, k, v, q_offset, kv_len, causal=causal,
                          softcap=softcap, window=window)

    def cost():
        qo, kl = host_lens if host_lens is not None else (None, None)
        return _fa.flash_cost(
            B, Sq, Skv, H, Kv, hd,
            offsets=_host(qo, q_offset, "query offsets"),
            kv_lens=_host(kl, kv_len, "lengths"), causal=causal,
            window=window, elem_bytes=q.element_size())

    return _launch("flash_attention", q, (q, k, v),
                   run(_fa.flash_attention_cuda),
                   run(_fa.flash_attention_plain),
                   lambda: torch.empty((B, Sq, H, hd), dtype=q.dtype,
                                       device=q.device), cost)


def flash_attention_autograd(q, k, v, q_offset, kv_len, *, causal=True,
                             softcap=None, window=None, host_lens=None):
    """``flash_attention`` under autograd (``FlashAttentionFn``): the same
    dispatch forward, the plain backward."""
    return _fa.FlashAttentionFn.apply(q, k, v, q_offset, kv_len, causal,
                                      softcap, window, host_lens)


def ssm_update(h, dt, x, A, B, C, d_skip, *, h_out=None):
    """See ``kernels/ssm_update.py``."""
    Bt, I, N = h.shape

    def run(fn):
        return lambda: fn(h, dt, x, A, B, C, d_skip, h_out=h_out)

    def meta():
        return (torch.empty_like(h) if h_out is None else h_out,
                torch.empty(x.shape, dtype=x.dtype, device=x.device))

    return _launch("ssm_update", h, (h, dt, x, h_out),
                   run(_ssm.ssm_update_cuda), run(_ssm.ssm_update_plain),
                   meta, lambda: _ssm.scan_cost(Bt, I, N, 1,
                                                x.element_size()))


def ssm_scan(h, dt, x, A, B, C, d_skip, *, y=None):
    """See ``kernels/ssm_update.py``; ``y``: the output's buffer (default
    a new one)."""
    Bt, S, I = x.shape
    N = h.shape[-1]

    def run(fn):
        return lambda: fn(h, dt, x, A, B, C, d_skip, y=y)

    def meta():
        return (torch.empty(x.shape, dtype=x.dtype, device=x.device)
                if y is None else y)

    return _launch("ssm_update", h, (h, dt, x, y),
                   run(_ssm.ssm_scan_cuda), run(_ssm.ssm_scan_plain), meta,
                   lambda: _ssm.scan_cost(Bt, I, N, S, x.element_size()))


def ssm_scan_autograd(h, dt, x, A, B, C, d_skip):
    """``ssm_scan`` under autograd (``SSMScanFn``): the same dispatch
    forward, one launch per 128-token chunk, the plain backward. h is not
    written; returns (y, the final state)."""
    return _ssm.SSMScanFn.apply(h, dt, x, A, B, C, d_skip)
