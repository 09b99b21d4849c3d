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

``flash_plan`` fixes how the bf16 kernel cuts one launch into blocks, from
host shapes alone (never from the values of ``q_offset`` or ``kv_len``),
so equal shapes give equal bits.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 64, 80, 96, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
N_SM = 132           # H100 SXM
MAX_SPLITS = 16      # key-range splits of one block's rows (csrc MAX_SPLITS)

# kernel launches so far, in all and by (B, Sq, Skv); chip_smoke.py resets
# and reads them
launches = 0
shapes: collections.Counter = collections.Counter()


# (head_pad, key tile, ring stages) the kernel is instantiated for: rows
# load as 64-column boxes; 64-key tiles at hd 256, where the output
# accumulators take the registers
_TILES = {64: (64, 128, 4), 128: (128, 128, 2), 256: (256, 64, 2)}


def _tiles(head_dim: int) -> tuple:
    return _TILES[64 if head_dim <= 64 else 128 if head_dim <= 128 else 256]


def key_tile(head_dim: int) -> int:
    """Keys per online-softmax step, as the bf16 kernel walks them."""
    return _tiles(head_dim)[1]


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How one bf16 launch is cut into blocks.

    Block (x, y) serves batch ``x // Kv``, kv head ``x % Kv``; y counts
    (query tile, head block, split) with the split fastest and the query
    tiles from the last (the longest causal rows) down, so blocks start
    in that order across all heads. Each block has two consumer
    warpgroups of 64 query rows: with ``heads_per_block`` 1 they are rows
    0-63 and 64-127 of one head's 128-row tile; with 2 (GQA) rows 0-63 of
    two heads of the kv group, which then read each K/V tile once.
    A split takes the keys ``[s·split_keys, (s+1)·split_keys)``; with more
    than one, each writes an fp32 partial that a second kernel merges in
    split order."""
    head_pad: int          # columns per row as loaded: 64-column boxes
    key_tile: int
    stages: int
    heads_per_block: int
    q_tiles: int
    head_blocks: int
    splits: int
    split_keys: int
    grid: tuple

    @property
    def rows_per_block(self) -> int:
        return 128 // self.heads_per_block

    @property
    def args(self) -> tuple:
        """The plan as the C entry takes it."""
        return (self.head_pad, self.key_tile, self.stages,
                self.heads_per_block, self.q_tiles, self.head_blocks,
                self.splits, self.split_keys)

    def block(self, y: int):
        """(query tile, head block, split) of block row ``y``."""
        split = y % self.splits
        y //= self.splits
        return self.q_tiles - 1 - y // self.head_blocks, \
            y % self.head_blocks, split

    def warpgroups(self, y: int, group: int):
        """[(head in group, clamped; whether it is a head of its own;
        first query row)] of block row ``y``'s two warpgroups."""
        qt, hb, _ = self.block(y)
        q0 = qt * self.rows_per_block
        out = []
        for w in range(2):
            j = hb * self.heads_per_block + (w if self.heads_per_block == 2
                                             else 0)
            out.append((min(j, group - 1), j < group,
                        q0 + (0 if self.heads_per_block == 2 else 64 * w)))
        return out


@functools.lru_cache(maxsize=4096)
def flash_plan(B: int, Sq: int, Skv: int, H: int, Kv: int,
               head_dim: int) -> FlashPlan:
    """The bf16 kernel's plan for one launch, from host shapes only. A
    launch whose blocks fill fewer than the SMs splits each block's key
    range into the number of splits that least delays the last block
    (waves of blocks times key tiles per split), the fewest on a tie."""
    if head_dim not in HEAD_DIMS or Kv < 1 or H % Kv:
        raise ValueError(f"unsupported hd={head_dim}, H={H}, Kv={Kv}")
    hdp, bn, stages = _tiles(head_dim)
    group = H // Kv
    hpb = 2 if group >= 2 else 1
    q_tiles = -(-Sq // (128 // hpb))
    head_blocks = -(-group // hpb)
    base = B * Kv * head_blocks * q_tiles
    n_kt = -(-Skv // bn)
    splits, tps = 1, n_kt
    if base < N_SM:
        cost = None
        for n in range(1, min(MAX_SPLITS, n_kt) + 1):
            t = -(-n_kt // n)
            n_eff = -(-n_kt // t)
            c = -(-base * n_eff // N_SM) * t
            if cost is None or c < cost:
                cost, splits, tps = c, n_eff, t
    return FlashPlan(head_pad=hdp, key_tile=bn, stages=stages,
                     heads_per_block=hpb, q_tiles=q_tiles,
                     head_blocks=head_blocks, splits=splits,
                     split_keys=tps * bn,
                     grid=(B * Kv, q_tiles * head_blocks * splits))


@functools.lru_cache(maxsize=4096)
def _pairs_one(off: int, kv_len: int, Sq: int, causal: bool,
               window: Optional[int]) -> int:
    import numpy as np
    p = off + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(p + 1, kv_len) if causal else np.full(Sq, kv_len)
    lo = (np.maximum(p - window + 1, 0) if window
          else np.zeros(Sq, np.int64))
    return int(np.maximum(hi - lo, 0).sum())


def flash_pairs(offsets, kv_lens, Sq: int, *, causal: bool = True,
                window: Optional[int] = None) -> int:
    """(query, key) pairs the kernel must visit over the batch: query i
    of batch b at position p = offsets[b] + i sees the keys below
    min(p + 1, kv_lens[b]) (below kv_lens[b] when not ``causal``), from
    p - window + 1 with a ``window``."""
    return sum(_pairs_one(int(o), int(k), int(Sq), bool(causal),
                          None if not window else int(window))
               for o, k in zip(offsets, kv_lens))


def flash_cost(B: int, Sq: int, Skv: int, H: int, Kv: int, hd: int, *,
               offsets, kv_lens, causal: bool = True,
               window: Optional[int] = None,
               elem_bytes: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one launch: 4·hd operations per head and
    visible (query, key) pair (``flash_pairs``; two products at 2 per
    multiply-add); q read and the output written once, K and V of the
    Skv keys read once, q_offset and kv_len read once."""
    flops = 4 * hd * H * flash_pairs(offsets, kv_lens, Sq, causal=causal,
                                     window=window)
    nbytes = elem_bytes * B * (2 * Sq * H * hd + 2 * Skv * Kv * hd) + 8 * B
    return flops, nbytes


def flash_attention_plain(q, k, v, q_offset, kv_len, *, causal: bool = True,
                          softcap: Optional[float] = None,
                          window: Optional[int] = None):
    """Plain PyTorch version, rounding where the bf16 kernel rounds: the
    keys cut into the kernel plan's key-range splits (one split where the
    kernel does not split or does not take hd), an online softmax in fp32
    over key chunks of ``key_tile(hd)`` within each split, P rounded to
    v's dtype before P @ V against its split's running max (as the JAX
    package's ``flash_attention_jnp`` does over its chunks), and the
    splits' (max, sum, output) merged in split order. Masked logits are
    taken out by selection, as in the kernel."""
    out, _ = _plain_walk(q, k, v, q_offset, kv_len, causal=causal,
                         softcap=softcap, window=window)
    return out.to(q.dtype)


def flash_p_rounding_bound(q, k, v, q_offset, kv_len, *, causal: bool = True,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None):
    """Per output element (fp32, q's shape), Σ_j ulp_bf16(p_j)·|v_j| / l
    from the plain version's own p and l, carried through the same
    rescalings: the most that two roundings of P to bf16 from fp32 values
    that differ in their last bits (the kernel's ex2 and summation order
    against the plain version's) can move an output. Zero where P is not
    rounded (v in fp32)."""
    _, bound = _plain_walk(q, k, v, q_offset, kv_len, causal=causal,
                           softcap=softcap, window=window, with_bound=True)
    return bound


def _bf16_ulp(p: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values around each p >= 0 (0 at p = 0)."""
    _, e = torch.frexp(p)                      # p = m·2^e, 0.5 <= m < 1
    return torch.where(p > 0, torch.ldexp(torch.ones_like(p), e - 8),
                       torch.zeros_like(p))


def _plain_walk(q, k, v, q_offset, kv_len, *, causal, softcap, window,
                with_bound: bool = False):
    """The plain version's output in fp32 (B, Sq, H, hd), and with
    ``with_bound`` the P-rounding bound of ``flash_p_rounding_bound``."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    g = H // Kv
    dev = q.device
    rounds = with_bound and v.dtype != torch.float32
    qg = q.reshape(B, Sq, Kv, g, hd).float()
    qp = (q_offset.to(dev).long()[:, None]
          + torch.arange(Sq, device=dev)[None, :])[:, :, None]   # (B,Sq,1)
    kl = kv_len.to(dev).long()[:, None, None]
    C = min(key_tile(hd), Skv)
    span = (flash_plan(B, Sq, Skv, H, Kv, hd).split_keys
            if hd in HEAD_DIMS else Skv)
    inf = torch.tensor(float("-inf"), device=dev)
    parts = []
    for s0 in range(0, Skv, span):
        m = torch.full((B, Kv, g, Sq), float("-inf"), device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Kv, g, Sq, hd), dtype=torch.float32, device=dev)
        bnd = torch.zeros_like(acc) if rounds else None
        for c0 in range(s0, min(s0 + span, Skv), C):
            kc, vc = k[:, c0:c0 + C], v[:, c0:c0 + C]
            n = kc.shape[1]
            if n < C:
                pad = (0, 0, 0, 0, 0, C - n)
                kc = torch.nn.functional.pad(kc, pad)
                vc = torch.nn.functional.pad(vc, pad)
            s = torch.einsum("bqkgh,bckh->bkgqc", qg, kc.float()) * hd ** -0.5
            if softcap is not None:
                s = torch.tanh(s / softcap) * softcap
            kp = (c0 + torch.arange(C, device=dev))[None, None, :]  # (1,1,C)
            ok = kp < kl
            if causal:
                ok = ok & (kp <= qp)
            if window is not None:
                ok = ok & (kp > qp - window)
            s = torch.where(ok[:, None, None], s, inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            mu = torch.where(m_new == inf, 0.0, m_new)   # no key yet
            p = torch.exp(s - mu[..., None])
            corr = torch.exp(m - mu)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(v.dtype).float(),
                              vc.float())
            acc = acc * corr[..., None] + pv
            if rounds:
                bnd = bnd * corr[..., None] + torch.einsum(
                    "bkgqc,bckh->bkgqh", _bf16_ulp(p), vc.float().abs())
            m = m_new
        parts.append((m, l, acc, bnd))
    m = torch.stack([x[0] for x in parts]).amax(dim=0)
    mu = torch.where(m == inf, 0.0, m)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    bnd = torch.zeros_like(acc)
    for m_s, l_s, acc_s, bnd_s in parts:           # the kernel's merge order
        w = torch.exp(m_s - mu)
        l = l + l_s * w
        acc = acc + acc_s * w[..., None]
        if rounds:
            bnd = bnd + bnd_s * w[..., None]
    l = torch.clamp(l, min=1e-30)[..., None]

    def heads(t):
        return t.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)

    return heads(acc / l), (heads(bnd / l) if with_bound else None)


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
    dtype, dev = q.dtype, q.device
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D")
    B, Sq, H, hd = q.shape
    _, Skv, Kv, _ = k.shape
    if hd not in HEAD_DIMS or Kv < 1 or H % Kv:
        raise ValueError(f"unsupported hd={hd}, H={H}, Kv={Kv}")
    if dev.type != "cuda":
        raise ValueError("flash_attention_cuda needs CUDA tensors")
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
    plan, part_o, part_ml = (0,) * 8, None, None
    if dtype == torch.bfloat16:
        fp = flash_plan(B, Sq, Skv, H, Kv, hd)
        plan = fp.args
        if fp.splits > 1:
            part_o = torch.empty((fp.splits, B, Sq, H, hd),
                                 dtype=torch.float32, device=dev)
            part_ml = torch.empty((fp.splits, B, Sq, H, 2),
                                  dtype=torch.float32, device=dev)
    lib = _build.library()
    lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_offset.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(),
        0 if part_o is None else part_o.data_ptr(),
        0 if part_ml is None else part_ml.data_ptr(), B, Sq, Skv, H, Kv, hd,
        *qs, *ks, *vs, hd ** -0.5,
        float(softcap) if softcap is not None else 0.0, int(bool(causal)),
        int(window) if window is not None else 0, _DTYPE_CODE[dtype], *plan,
        torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    shapes[B, Sq, Skv] += 1
    return out


# ------------------------------------------------------------- backward
def _backward_rows(B: int, H: int, Skv: int) -> int:
    """Query rows per block of the plain backward: (B, H, rows, Skv) fp32
    score blocks of at most 2^25 elements (128 MB)."""
    return max(16, (1 << 25) // max(B * H * Skv, 1))


def flash_attention_backward_plain(q, k, v, dout, q_offset, kv_len, *,
                                   causal: bool = True,
                                   softcap: Optional[float] = None,
                                   window: Optional[int] = None,
                                   host_lens=None):
    """dq, dk, dv of ``flash_attention`` (the exact softmax attention its
    kernel computes) for the output cotangent ``dout`` (B, Sq, H, hd), in
    plain PyTorch: the softmax probabilities are recomputed from q and k
    in fp32, one block of query rows at a time (``_backward_rows``), so no
    all-heads (Sq, Skv) matrix is held at once; each block reads only the
    keys its rows can see. dk/dv sum over the query heads of each kv head
    (GQA); a row that sees no key gets zero gradient, as its output is
    zero. ``host_lens``: (q_offset, kv_len) on the host, each an int for
    the batch or one per row (read from the tensors when None). Returns
    tensors in q's, k's and v's dtypes."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    g = H // Kv
    dev = q.device
    scale = hd ** -0.5
    qg = q.reshape(B, Sq, Kv, g, hd)
    dog = dout.reshape(B, Sq, Kv, g, hd)
    qo = q_offset.to(dev).long()
    kl = kv_len.to(dev).long()
    if host_lens is None:
        qo_lo, qo_hi = int(qo.min()), int(qo.max())
        kl_hi = min(int(kl.max()), Skv)
    else:
        hq, hk = ([x] if isinstance(x, int) else list(x) for x in host_lens)
        qo_lo, qo_hi = min(hq), max(hq)
        kl_hi = min(max(hk), Skv)
    dq = torch.zeros((B, Sq, Kv, g, hd), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Skv, Kv, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    rows = _backward_rows(B, H, Skv)
    for r0 in range(0, Sq, rows):
        r1 = min(r0 + rows, Sq)
        k1 = min(kl_hi, qo_hi + r1) if causal else kl_hi
        k0 = max(0, qo_lo + r0 - window + 1) if window is not None else 0
        if k1 <= k0:
            continue
        qb = qg[:, r0:r1].float()
        dob = dog[:, r0:r1].float()
        kb, vb = k[:, k0:k1].float(), v[:, k0:k1].float()
        s = torch.einsum("bqkgh,bckh->bkgqc", qb, kb) * scale
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = t * softcap
        qp = (qo[:, None] + torch.arange(r0, r1, device=dev))[:, :, None]
        kp = torch.arange(k0, k1, device=dev)[None, None, :]
        ok = kp < kl[:, None, None]
        if causal:
            ok = ok & (kp <= qp)
        if window is not None:
            ok = ok & (kp > qp - window)
        ok = ok[:, None, None]                              # (B,1,1,R,C)
        s = torch.where(ok, s, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(m == float("-inf"), 0.0, m)         # no key seen
        p = torch.exp(s - m)
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        dp = torch.einsum("bqkgh,bckh->bkgqc", dob, vb)
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        if softcap is not None:
            ds = ds * (1.0 - t * t)
        dv[:, k0:k1] += torch.einsum("bkgqc,bqkgh->bckh", p, dob)
        dq[:, r0:r1] = torch.einsum("bkgqc,bckh->bqkgh", ds, kb) * scale
        dk[:, k0:k1] += torch.einsum("bkgqc,bqkgh->bckh", ds, qb) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """Kernel #5 under autograd. The forward is the prefill-attention
    dispatch (the CUDA kernel on a CUDA tensor, the plain version on a CPU
    one); the backward is ``flash_attention_backward_plain``. q_offset
    and kv_len get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_len, causal, softcap, window,
                host_lens=None):
        from repro_torch.kernels import ops
        from repro_torch.launch import exec_cost
        ctx.save_for_backward(q, k, v, q_offset, kv_len)
        ctx.mask = (causal, softcap, window, host_lens)
        ctx.shard = exec_cost.current()
        return ops.flash_attention(q, k, v, q_offset, kv_len, causal=causal,
                                   softcap=softcap, window=window,
                                   host_lens=host_lens)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_offset, kv_len = ctx.saved_tensors
        from repro_torch.launch import exec_cost
        causal, softcap, window, host_lens = ctx.mask
        with exec_cost.at(ctx.shard):
            dq, dk, dv = flash_attention_backward_plain(
                q, k, v, dout, q_offset, kv_len, causal=causal,
                softcap=softcap, window=window, host_lens=host_lens)
        return dq, dk, dv, None, None, None, None, None, None
