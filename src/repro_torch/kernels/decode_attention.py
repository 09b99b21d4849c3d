"""Single-token decode attention against a contiguous or a paged KV cache.

q ``(BKv, G, hd)``: one query token, G query heads per kv head. The cache
is either ``(BKv, Smax, hd)`` or the model's own ``(B, Smax, Kv, hd)``
layout with ``BKv = B·Kv`` (row ``b·Kv + h`` reads batch b, kv head h).
``kv_len (BKv,)`` int32 counts the live positions. Positions at or past
``kv_len``, and with a ``window`` those at or before ``kv_len - 1 -
window``, get no weight; ``softcap`` squashes the logits before masking.
Returns ``(BKv, G, hd)`` in q's dtype.

Paged: the same attention over a physical page pool addressed through a
block table. The pool is either one head's ``(NB, bs, hd)`` with a table
``(BKv, MB)``, or a layer's ``(NB, bs, Kv, hd)`` with a table ``(B, MB)``
(row ``b·Kv + h`` reads table row b, head h). Logical position p of a
row lives in page ``table[row, p // bs]`` at offset ``p % bs``; entries
``>= NB`` are unallocated sentinels, which are clamped on read and can
only alias positions at or past ``kv_len``.

A row with no live position (``kv_len <= 0``) gives zeros, as the Pallas
kernels give (their zero accumulator divided by ``max(l, 1e-30)``).

``decode_attention_cuda`` and ``decode_attention_paged_cuda`` launch the
hand-written split-K kernel (``csrc/decode_attention.cu``; one kernel
body, two address policies, so paged and contiguous give the same bits),
which reads the cache or pool in place through its strides, on the plan
``decode_plan`` makes from host shapes; ``decode_attention_plain`` and
``decode_attention_paged_plain`` are the plain PyTorch versions.
``kernels.ops`` picks one by device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_GROUP = 16
MAX_HEAD_DIM = 256     # any multiple of 8 up to this
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The split plan: every row's live range is cut at multiples of
# SPLIT_KEYS, whatever the head size, batch or capacity; the kernel stages
# 32-key tiles (TILE_KEYS), so a split is a whole number of tiles. Of 64,
# 128 and 256, 128 was the best at the main path's shapes on an H100
# (PERF.md, kernels #3/#4).
SPLIT_KEYS = 128
TILE_KEYS = 32

# kernel launches so far (contiguous, paged); chip_smoke.py resets and
# reads them
launches = 0
paged_launches = 0


@dataclass(frozen=True)
class DecodePlan:
    """How the kernel cuts one launch: each row's live keys at multiples of
    ``split_keys`` (one block each); ``splits`` split slots per row in the
    grid, enough for the capacity."""
    split_keys: int
    splits: int

    def row_splits(self, kv_len: int,
                   window: Optional[int] = None) -> List[Tuple[int, int]]:
        """The [start, end) key ranges of one row's live splits."""
        n = int(kv_len)
        lo = max(n - window, 0) if window and window > 0 else 0
        S = self.split_keys
        return [(max(s * S, lo), min((s + 1) * S, n))
                for s in range(lo // S, -(-n // S))] if n > lo else []


def decode_plan(smax: int) -> DecodePlan:
    """The kernel's plan for one launch over a cache of ``smax`` slots
    (``MB·bs`` for a pool). The split boundaries are the same for every
    launch, never depending on the batch, the other rows, the capacity or
    the address policy, so a row gives the same bits in every launch that
    holds it; ``smax`` only sets how many split slots the grid has."""
    return DecodePlan(split_keys=SPLIT_KEYS,
                      splits=max(-(-int(smax) // SPLIT_KEYS), 1))


# per device: the kernel's merge tickets (one int32 per row), zeros
# between launches, as every launch leaves them. Launches on one device
# must not overlap in time (the port runs them on one stream).
_tickets = {}


def _scratch(plan: DecodePlan, BKv: int, G: int, hd: int, dev):
    """The split workspace (fp32 partials, allocated per launch) and the
    tickets; empty when the plan has one split per row."""
    if plan.splits == 1:
        return None, None, None
    t = _tickets.get(dev.index)
    if t is None or t.numel() < BKv:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode attention: run one launch of this "
                               "width before capturing it in a graph")
        t = _tickets[dev.index] = torch.zeros(max(BKv, 1024),
                                              dtype=torch.int32, device=dev)
    return (torch.empty(BKv * plan.splits * G * hd, dtype=torch.float32,
                        device=dev),
            torch.empty(BKv * plan.splits * G * 2, dtype=torch.float32,
                        device=dev), t)


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _as_rows(cache: torch.Tensor) -> torch.Tensor:
    """(B, Smax, Kv, hd) -> (B·Kv, Smax, hd); 3-D caches pass through."""
    if cache.dim() == 3:
        return cache
    B, S, Kv, hd = cache.shape
    return cache.permute(0, 2, 1, 3).reshape(B * Kv, S, hd)


def decode_attention_plain(q, k, v, kv_len, *,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None):
    """Plain PyTorch version (fp32 scores and softmax), one row at a time.
    Like the kernel, a row reads only its own live positions, so its result
    depends neither on the cache's spare capacity nor on the other rows'
    lengths: a session decoded beside others gives the bits it gives
    alone. A row with ``kv_len <= 0`` gives zeros."""
    k, v = _as_rows(k), _as_rows(v)
    out = torch.empty_like(q)
    scale = q.shape[-1] ** -0.5
    for r, n in enumerate(kv_len.tolist()):
        n = min(int(n), k.shape[1])
        if n <= 0:                   # no live position: zeros
            out[r] = 0
            continue
        s = (q[r].float() @ k[r, :n].float().T) * scale        # (G, n)
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        if window is not None:
            kpos = torch.arange(n, device=q.device)
            s = torch.where(kpos > n - 1 - window, s,
                            torch.full_like(s, NEG_INF))
        out[r] = (torch.softmax(s, dim=-1) @ v[r, :n].float()).to(q.dtype)
    return out


def decode_attention_cuda(q, k, v, kv_len, *,
                          softcap: Optional[float] = None,
                          window: Optional[int] = None):
    """Launch the CUDA kernel; same contract as the plain version."""
    global launches
    dtype, dev = q.dtype, q.device
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {dtype}")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError("q must be a contiguous (BKv, G, hd) tensor")
    BKv, G, hd = q.shape
    if not 1 <= G <= MAX_GROUP or not 8 <= hd <= MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"unsupported G={G} or hd={hd}")
    if dev.type != "cuda":
        raise ValueError("decode_attention_cuda needs CUDA tensors")
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
    plan = decode_plan(smax)
    ws_acc, ws_ml, tickets = _scratch(plan, BKv, G, hd, dev)
    lib = _build.library()
    lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), _ptr(ws_acc), _ptr(ws_ml), _ptr(tickets), BKv, G,
        hd, n_kv, smax, sb, ss, sh, vsb, vss, vsh, hd ** -0.5,
        float(softcap) if softcap is not None else 0.0,
        int(window) if window is not None else 0, _DTYPE_CODE[dtype],
        plan.splits, plan.split_keys,
        torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return out


def _gather_pages(pool: torch.Tensor, table: torch.Tensor, n_pages: int):
    """The logical layout of the first ``n_pages`` table columns: a
    (rows, n_pages·bs, ...) copy of the pool's pages, sentinels clamped."""
    tbl = table[:, :n_pages].clamp(max=pool.shape[0] - 1).long()
    rows = tbl.shape[0]
    return pool[tbl].reshape(rows, n_pages * pool.shape[1], *pool.shape[2:])


def decode_attention_paged_plain(q, k_pool, v_pool, block_table, kv_len, *,
                                 softcap: Optional[float] = None,
                                 window: Optional[int] = None):
    """Plain PyTorch version: gather the pages that hold live positions
    into the logical layout, then the contiguous plain version, so the two
    give the same bits for the same logical cache."""
    bs = k_pool.shape[1]
    live = max(int(kv_len.max()), 0) if kv_len.numel() else 0
    n_pages = min(-(-live // bs), block_table.shape[1])
    table = block_table.to(k_pool.device)
    return decode_attention_plain(
        q, _gather_pages(k_pool, table, n_pages),
        _gather_pages(v_pool, table, n_pages), kv_len, softcap=softcap,
        window=window)


def decode_attention_paged_cuda(q, k_pool, v_pool, block_table, kv_len, *,
                                softcap: Optional[float] = None,
                                window: Optional[int] = None):
    """Launch the CUDA kernel on the pool; same contract as the plain
    version."""
    global paged_launches
    dtype, dev = q.dtype, q.device
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {dtype}")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError("q must be a contiguous (BKv, G, hd) tensor")
    BKv, G, hd = q.shape
    if not 1 <= G <= MAX_GROUP or not 8 <= hd <= MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"unsupported G={G} or hd={hd}")
    if dev.type != "cuda":
        raise ValueError("decode_attention_paged_cuda needs CUDA tensors")
    if k_pool.dim() not in (3, 4) or k_pool.shape != v_pool.shape:
        raise ValueError("pools must be equal (NB, bs, hd) or "
                         "(NB, bs, Kv, hd) tensors")
    NB, bs = k_pool.shape[0], k_pool.shape[1]
    n_kv = 1 if k_pool.dim() == 3 else k_pool.shape[2]
    strides = []
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.device != dev or t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on {dev}")
        if t.shape[-1] != hd:
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
        sblk, soff = t.stride(0), t.stride(1)
        sh = 0 if t.dim() == 3 else t.stride(2)
        if t.stride(-1) != 1 or (sblk | soff | sh) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dimension, "
                             "strides that are multiples of 8 and a "
                             "16-byte aligned start")
        strides += [sblk, soff, sh]
    if block_table.device != dev or block_table.dtype != torch.int32 \
            or block_table.dim() != 2 or not block_table.is_contiguous() \
            or block_table.shape[0] * n_kv != BKv:
        raise ValueError("block_table must be a contiguous (BKv / Kv, MB) "
                         "int32 tensor on q's device")
    if kv_len.device != dev or kv_len.dtype != torch.int32 \
            or tuple(kv_len.shape) != (BKv,) or not kv_len.is_contiguous():
        raise ValueError("kv_len must be a contiguous (BKv,) int32 tensor "
                         "on q's device")
    out = torch.empty_like(q)
    MB = block_table.shape[1]
    if BKv == 0 or MB == 0:
        return out
    plan = decode_plan(MB * bs)
    ws_acc, ws_ml, tickets = _scratch(plan, BKv, G, hd, dev)
    lib = _build.library()
    lib.decode_attention_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        _ptr(ws_acc), _ptr(ws_ml), _ptr(tickets), BKv, G, hd, n_kv, NB, bs,
        MB, *strides, hd ** -0.5,
        float(softcap) if softcap is not None else 0.0,
        int(window) if window is not None else 0, _DTYPE_CODE[dtype],
        plan.splits, plan.split_keys,
        torch.cuda.current_stream(dev).cuda_stream)
    paged_launches += 1
    return out
