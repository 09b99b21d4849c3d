"""Mamba1 state update (the ``ssm`` family's recurrence), one token:

    h' = exp(dt ⊙ A) ⊙ h + (dt ⊙ x) ⊗ B
    y  = h' · C + D ⊙ x

h ``(Bt, I, N)`` fp32, dt ``(Bt, I)`` fp32, x ``(Bt, I)``, A ``(I, N)``
fp32, B and C ``(Bt, N)``, D ``(I,)``; returns h' (fp32) and y in x's
dtype, as the JAX package's ``ssm_update_pallas`` does. x, B, C and D are
fp32 or bf16, all of one dtype.

``ssm_update_cuda`` launches the hand-written kernel
(``csrc/ssm_update.cu``); ``ssm_update_plain`` is the plain PyTorch
version (the JAX package's ``kernels/ref.py::ssm_update_ref``).
``ssm_scan_cuda`` and ``ssm_scan_plain`` run the update over a sequence,
one token at a time, for the Mamba1 layer: dt/x ``(Bt, S, I)``, B/C
``(Bt, S, N)`` (read through their strides, so column views of a larger
projection need no copy) give y ``(Bt, S, I)``, and h is carried in
place. The scan validates its arguments once and then launches the kernel
S times. ``kernels.ops`` picks the kernel or the plain version by device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

STATE_SIZES = (4, 8, 16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches so far; chip_smoke.py resets and reads it
launches = 0


def ssm_update_plain(h, dt, x, A, B, C, d_skip, *,
                     h_out: Optional[torch.Tensor] = None):
    """Plain PyTorch version; writes h' into ``h_out`` when given (it may
    be ``h`` itself). Returns (h', y)."""
    dtf, xf = dt.float(), x.float()
    dA = torch.exp(dtf[:, :, None] * A[None].float())
    h_new = dA * h + (dtf * xf)[:, :, None] * B[:, None, :].float()
    y = (h_new * C[:, None, :].float()).sum(-1) \
        + d_skip[None].float() * xf
    if h_out is not None:
        h_out.copy_(h_new)
        h_new = h_out
    return h_new, y.to(x.dtype)


def ssm_scan_plain(h, dt, x, A, B, C, d_skip):
    """The update over S tokens; h is updated in place. Returns y."""
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    for t in range(x.shape[1]):
        _, y[:, t] = ssm_update_plain(h, dt[:, t], x[:, t], A, B[:, t],
                                      C[:, t], d_skip, h_out=h)
    return y


def _check(h, dt, x, A, B, C, d_skip, h_out, y):
    """Raise on what the kernel does not take; returns (Bt, I, N, dtype
    code). dt/x/B/C/y are (Bt, S, ·) with a contiguous last dimension."""
    if h.device.type != "cuda":
        raise ValueError("ssm_update_cuda needs CUDA tensors")
    dev, dtype = h.device, x.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {dtype}")
    if h.dim() != 3 or h.dtype != torch.float32 or not h.is_contiguous():
        raise ValueError("h must be a contiguous (Bt, I, N) fp32 tensor")
    Bt, I, N = h.shape
    if N not in STATE_SIZES:
        raise ValueError(f"unsupported state size N={N}")
    if x.dim() != 3 or x.shape[0] != Bt:
        raise ValueError(f"x has shape {tuple(x.shape)}")
    lead = tuple(x.shape[:2])
    for name, t, want, dt_ in (("dt", dt, I, torch.float32),
                               ("x", x, I, dtype), ("B", B, N, dtype),
                               ("C", C, N, dtype), ("y", y, I, dtype)):
        if t.device != dev or t.dtype != dt_:
            raise TypeError(f"{name} must be {dt_} on {dev}")
        if tuple(t.shape) != lead + (want,) or t.stride(-1) != 1:
            raise ValueError(f"{name} must be {lead + (want,)} with a "
                             "contiguous last dimension")
    for name, t, shape, dt_ in (("A", A, (I, N), torch.float32),
                                ("d_skip", d_skip, (I,), dtype),
                                ("h_out", h_out, (Bt, I, N), torch.float32)):
        if t.device != dev or t.dtype != dt_ or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {dt_} "
                             f"tensor on {dev}")
    if h.data_ptr() % 16 or h_out.data_ptr() % 16 or A.data_ptr() % 16:
        raise ValueError("h, h_out and A need 16-byte aligned starts")
    return Bt, I, N, _DTYPE_CODE[dtype]


def _run(h, h_out, dt, x, A, B, C, d_skip, y) -> None:
    """Check once, then launch the kernel once per token of the (Bt, S, ·)
    inputs, h' of token s feeding token s + 1 through ``h_out``."""
    global launches
    Bt, I, N, code = _check(h, dt, x, A, B, C, d_skip, h_out, y)
    lib = _build.library()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    seq = (dt, x, B, C, y)
    (dt0, x0, b0, c0, y0) = (t.data_ptr() for t in seq)
    (dts, xs, bs, cs, ys) = (t.stride(1) * t.element_size() for t in seq)
    rows = [t.stride(0) for t in seq]
    hp, op, ap, dp = (h.data_ptr(), h_out.data_ptr(), A.data_ptr(),
                      d_skip.data_ptr())
    for s in range(x.shape[1]):
        lib.ssm_update(hp, op, dt0 + s * dts, x0 + s * xs, ap, b0 + s * bs,
                       c0 + s * cs, dp, y0 + s * ys, Bt, I, N, *rows, code,
                       stream)
        launches += 1
        hp = op


def ssm_update_cuda(h, dt, x, A, B, C, d_skip, *,
                    h_out: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel; same contract as the plain version."""
    h_out = torch.empty_like(h) if h_out is None else h_out
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _run(h, h_out, dt[:, None], x[:, None], A, B[:, None], C[:, None],
         d_skip, y[:, None])
    return h_out, y


def ssm_scan_cuda(h, dt, x, A, B, C, d_skip):
    """The update over S tokens, one kernel launch per token, h updated in
    place; the arguments are checked once. Returns y (Bt, S, I)."""
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _run(h, h, dt, x, A, B, C, d_skip, y)
    return y
