"""Mamba1 state update (the ``ssm`` family's recurrence), one token:

    h' = exp(dt ⊙ A) ⊙ h + (dt ⊙ x) ⊗ B
    y  = h' · C + D ⊙ x

h ``(Bt, I, N)`` fp32, dt ``(Bt, I)`` fp32, x ``(Bt, I)``, A ``(I, N)``
fp32, B and C ``(Bt, N)``, D ``(I,)``; returns h' (fp32) and y in x's
dtype, as the JAX package's ``ssm_update_pallas`` does. x, B, C and D are
fp32 or bf16, all of one dtype.

``ssm_scan_cuda`` runs the update over a sequence for the Mamba1 layer in
one launch of the hand-written scan kernel (``csrc/ssm_update.cu``),
which holds the state on chip from the first token to the last: dt/x
``(Bt, S, I)``, B/C ``(Bt, S, N)`` (read through their strides, so column
views of a larger projection need no copy) give y ``(Bt, S, I)``, and h
is carried in place. ``ssm_update_cuda`` is the same launch at S = 1.
``ssm_scan_plan`` fixes the launch's grid, lanes per row and staging from
the shapes alone; ``scan_cost`` counts its operations and bytes.
``ssm_update_plain`` is the plain PyTorch version (the JAX package's
``kernels/ref.py::ssm_update_ref``) and ``ssm_scan_plain`` runs it token
by token; ``kernels.ops`` picks the kernel or the plain version by device.

``SSMScanFn`` puts the scan under autograd for the training forward. Its
forward launches the kernel (the plain scan on a CPU tensor) once per
``CHUNK`` tokens, the reference's remat chunk, on a copy of the initial
state, and saves the state at each chunk's start; its backward is plain
PyTorch, as the reference differentiates its jnp scan: from the last
chunk to the first it recomputes the chunk's steps from the saved state
with the functional ``ssm_update_plain`` and back-propagates the chunk's
output gradient together with the state gradient carried in from the
chunk after it (about 35 small launches per token). No kernel of the
reference has a backward, so there is no hand-written one here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build

STATE_SIZES = (4, 8, 16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 128          # compute threads per block
PRODUCER = 32          # the copy warp beside them (prefill only)
STAGE_TOKENS = 64      # tokens per slot of the copy ring, at most
STAGES = 2             # slots in the ring, at most
BATCH = 4              # tokens whose inputs a thread holds in registers
MAX_BATCH = 65535      # the grid's y dimension
CHUNK = 128            # SSMScanFn's tokens per launch and recompute

# kernel launches so far; chip_smoke.py resets and reads it
launches = 0


@dataclass(frozen=True)
class ScanPlan:
    """How one launch of the scan kernel is cut. Compute thread ``(r, k)``
    of block ``(bx, b)`` holds states ``4k .. 4k + 3`` of row ``i = bx·rows
    + r`` of batch row ``b`` for all S tokens. With ``stages`` > 0 a copy
    warp stages the tokens ``tokens`` at a time in a ring of ``stages``
    shared-memory slots; with 0 (S <= BATCH, decode) each thread reads its
    tokens from device memory. y of a token sums each lane's four products
    in n order, then the lanes' partials over the xor ``masks`` in turn
    (``lanes`` depends on N alone, so a token's bits do not depend on S,
    Bt or the staging)."""
    lanes: int                   # lanes per row, N / 4
    rows: int                    # rows per block
    tokens: int                  # tokens per slot
    stages: int                  # slots in the ring; 0: no ring
    threads: int                 # threads per block
    grid: Tuple[int, int]        # (row blocks, Bt)
    smem_bytes: int

    @property
    def masks(self) -> Tuple[int, ...]:
        """The y reduction's shuffle masks, in the order applied."""
        out, m = [], self.lanes // 2
        while m:
            out.append(m)
            m //= 2
        return tuple(out)

    def stage_ranges(self, S: int) -> List[Tuple[int, int]]:
        """The [start, end) tokens of each staged chunk, in scan order."""
        return [(t, min(t + self.tokens, S))
                for t in range(0, S, self.tokens)]

    def lane_states(self, bx: int, b: int, thread: int, I: int):
        """(b, i, n range) that a thread holds, or None past row I."""
        r, k = divmod(thread, self.lanes)
        i = bx * self.rows + r
        return (b, i, range(4 * k, 4 * k + 4)) if i < I else None


def ssm_scan_plan(Bt: int, I: int, N: int, S: int,
                  dtype: torch.dtype) -> ScanPlan:
    """The kernel's plan for one launch, from the shapes alone."""
    if N not in STATE_SIZES:
        raise ValueError(f"unsupported state size N={N}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {dtype}")
    if not 1 <= Bt <= MAX_BATCH or I < 1 or S < 1:
        raise ValueError(f"unsupported shape Bt={Bt}, I={I}, S={S}")
    es = dtype.itemsize
    lanes = N // 4
    rows = THREADS // lanes
    tokens = min(STAGE_TOKENS, -(-S // BATCH) * BATCH)
    # a decode-sized launch (S <= BATCH) reads its tokens straight from
    # device memory: no ring (stages 0), no shared memory
    stages = 0 if S <= BATCH else min(STAGES, -(-S // tokens) + 1)
    # a slot: dt, x, B, C as copied, and bf16 x, B, C widened to fp32;
    # then room for the register loads that run a batch past a chunk
    widened = tokens * (rows + 2 * N) * 4 if es == 2 else 0
    slot = tokens * (rows * 4 + rows * es + 2 * N * es) + widened
    smem = stages * slot + BATCH * rows * 4 if stages else 0
    return ScanPlan(lanes=lanes, rows=rows, tokens=tokens, stages=stages,
                    threads=THREADS + (PRODUCER if stages else 0),
                    grid=(-(-I // rows), Bt), smem_bytes=smem)


def scan_cost(Bt: int, I: int, N: int, S: int,
              elem_bytes: int) -> Tuple[int, int]:
    """(operations, bytes) of a scan over S tokens: ~7 operations and one
    exp (counted as one) per state and token, 3 more per row; the state
    read and written once (fp32), A (fp32) and D read once, and per token
    dt (fp32) and x read, y written and B, C read (``elem_bytes`` each)."""
    flops = Bt * S * I * (7 * N + 3)
    nbytes = (2 * Bt * I * N * 4 + I * N * 4 + elem_bytes * I
              + S * Bt * (I * 4 + 2 * I * elem_bytes + 2 * N * elem_bytes))
    return flops, nbytes


def ssm_update_plain(h, dt, x, A, B, C, d_skip, *,
                     h_out: Optional[torch.Tensor] = None):
    """Plain PyTorch version; writes h' into ``h_out`` when given (it may
    be ``h`` itself). Returns (h', y). Computes in fp32 (in fp64 for
    fp64 inputs, which ``SSMScanFn``'s gradient check uses)."""
    f = torch.promote_types(x.dtype, torch.float32)
    dtf, xf = dt.to(f), x.to(f)
    dA = torch.exp(dtf[:, :, None] * A[None].to(f))
    h_new = dA * h + (dtf * xf)[:, :, None] * B[:, None, :].to(f)
    y = (h_new * C[:, None, :].to(f)).sum(-1) \
        + d_skip[None].to(f) * xf
    if h_out is not None:
        h_out.copy_(h_new)
        h_new = h_out
    return h_new, y.to(x.dtype)


def ssm_scan_plain(h, dt, x, A, B, C, d_skip, *, y=None):
    """The update over S tokens; h is updated in place. Returns y (written
    into ``y`` when given)."""
    if y is None:
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
    """Check, then launch the scan kernel once over all S tokens of the
    (Bt, S, ·) inputs, the state carried from h into ``h_out``."""
    global launches
    Bt, I, N, code = _check(h, dt, x, A, B, C, d_skip, h_out, y)
    S = x.shape[1]
    if S == 0:
        return
    plan = ssm_scan_plan(Bt, I, N, S, x.dtype)
    lib = _build.library()
    strides = [s for t in (dt, x, B, C, y) for s in t.stride()[:2]]
    lib.ssm_update(h.data_ptr(), h_out.data_ptr(), dt.data_ptr(),
                   x.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                   d_skip.data_ptr(), y.data_ptr(), Bt, I, N, S, *strides,
                   code, plan.tokens, plan.stages,
                   torch.cuda.current_stream(h.device).cuda_stream)
    launches += 1


def ssm_update_cuda(h, dt, x, A, B, C, d_skip, *,
                    h_out: Optional[torch.Tensor] = None):
    """The scan kernel at S = 1; same contract as the plain version."""
    h_out = torch.empty_like(h) if h_out is None else h_out
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _run(h, h_out, dt[:, None], x[:, None], A, B[:, None], C[:, None],
         d_skip, y[:, None])
    return h_out, y


def ssm_scan_cuda(h, dt, x, A, B, C, d_skip, *, y=None):
    """The update over S tokens in one kernel launch, h updated in place.
    Returns y (Bt, S, I), written into ``y`` when given."""
    if y is None:
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _run(h, h, dt, x, A, B, C, d_skip, y)
    return y


class SSMScanFn(torch.autograd.Function):
    """Kernel #6 under autograd: ``apply(h0, dt, x, A, B, C, d_skip)`` ->
    (y (Bt, S, I), the final state (Bt, I, N)), the inputs as
    ``ssm_scan_*`` takes them. h0 is not written. The forward launches
    the kernel once per ``CHUNK`` tokens (bitwise the one-launch scan's
    result) and saves the (Bt, ceil(S/CHUNK), I, N) chunk-start states;
    the backward recomputes each chunk from its start state under autograd
    through ``ssm_update_plain`` and returns the gradients of h0, dt, x,
    A, B, C and d_skip in their own dtypes."""

    @staticmethod
    def forward(ctx, h0, dt, x, A, B, C, d_skip):
        Bt, S, _ = x.shape
        h = h0.detach().clone()
        starts = h.new_empty((Bt, -(-S // CHUNK)) + tuple(h.shape[1:]))
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        from repro_torch.kernels import ops
        from repro_torch.launch import exec_cost
        ctx.shard = exec_cost.current()
        for c, s0 in enumerate(range(0, S, CHUNK)):
            starts[:, c] = h
            sl = slice(s0, min(s0 + CHUNK, S))
            ops.ssm_scan(h, dt[:, sl], x[:, sl], A, B[:, sl], C[:, sl],
                         d_skip, y=y[:, sl])
        ctx.save_for_backward(starts, dt, x, A, B, C, d_skip)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        from repro_torch.launch import exec_cost
        with exec_cost.at(ctx.shard):
            return SSMScanFn._backward(ctx, dy, dh)

    @staticmethod
    def _backward(ctx, dy, dh):
        starts, dt, x, A, B, C, d_skip = ctx.saved_tensors
        S = x.shape[1]
        f = starts.dtype
        g = dh.to(f)             # the state gradient carried backwards
        grads = {n: torch.empty_like(t) for n, t in
                 (("dt", dt), ("x", x), ("B", B), ("C", C))}
        dA = torch.zeros(A.shape, dtype=f, device=A.device)
        dD = torch.zeros(d_skip.shape, dtype=f, device=d_skip.device)
        for c in reversed(range(starts.shape[1])):
            sl = slice(c * CHUNK, min((c + 1) * CHUNK, S))
            with torch.enable_grad():
                leaves = [starts[:, c].detach(), dt[:, sl].detach(),
                          x[:, sl].detach(), A.detach().to(f),
                          B[:, sl].detach(), C[:, sl].detach(),
                          d_skip.detach().to(f)]
                for t in leaves:
                    t.requires_grad_(True)
                hs, dt_, x_, A_, B_, C_, D_ = leaves
                # widened once per chunk and cut into steps by ``unbind``,
                # whose backward stacks the steps' gradients in one op
                # (a select per step would zero-fill the chunk each time)
                ys = []
                for d, xt, b, ct in zip(*(t.to(f).unbind(1)
                                          for t in (dt_, x_, B_, C_))):
                    hs, yt = ssm_update_plain(hs, d, xt, A_, b, ct, D_)
                    ys.append(yt)
                got = torch.autograd.grad(
                    (torch.stack(ys, 1), hs), leaves,
                    (dy[:, sl].to(f), g))
            g = got[0]
            for n, t in zip(("dt", "x"), got[1:3]):
                grads[n][:, sl] = t
            for n, t in zip(("B", "C"), got[4:6]):
                grads[n][:, sl] = t
            dA += got[3]
            dD += got[6]
        return (g.to(starts.dtype), grads["dt"], grads["x"],
                dA.to(A.dtype), grads["B"], grads["C"],
                dD.to(d_skip.dtype))
