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

``tile_plan`` fixes how the bf16 kernel cuts one launch into blocks. The
fields that fix the order of each output element's sum over D (the MMA
instruction, its k-depth, the D slice per ring stage, no split of D) are
the same for every shape; only the block's rows, its columns and the
ring's depth follow the shape, so prefill, decode and restoration give
the same bits.
"""
from __future__ import annotations

import collections
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_HEAD_DIMS = (16, 64, 80, 96, 128, 256)

# kernel launches so far, in all and by (G, S); chip_smoke.py resets and
# reads them
launches = 0
shapes: collections.Counter = collections.Counter()

PIECE = 32          # columns of one weight box; a wgmma (m64n64k16)
#                     takes the two boxes of a column pair
STAGE_D = 64        # D rows per ring stage
N_SM = 132          # H100 SXM
# (consumer warpgroups, pairs per matrix per block, K and V in one block,
# ring stages): the plans the kernel is instantiated for
STREAM = (1, 1, False, 6)         # bytes-bound: narrow blocks, 2 per SM
STREAM_DEEP = (1, 1, False, 12)   # the same in one wave, a deeper ring
GEMM = (2, 2, True, 4)            # operations-bound: 128 x 256 tiles


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How one bf16 launch is cut into blocks.

    A *pair* is two 32-column pieces of K or of V: columns
    ``first .. first+width`` and the same shifted by ``head_dim // 2``, so
    every RoPE partner (c, c + hd/2) lies in one pair. Block (x, y, z)
    computes token rows ``x*block_m .. +block_m`` of group row z for the
    pairs ``slots(y)``."""
    # the same for every shape: they fix each element's sum over D
    mma: str
    k_depth: int
    stage_d: int
    split_d: int
    # follow the shape
    warpgroups: int
    pairs_per_block: int
    both: bool
    stages: int
    grid: tuple
    head_dim: int
    kv: int
    pairs_per_head: int
    n_pairs: int

    ORDER_FIELDS = ("mma", "k_depth", "stage_d", "split_d")

    @property
    def block_m(self) -> int:
        return 64 * self.warpgroups

    @property
    def args(self) -> tuple:
        """The plan as the C entry takes it."""
        return (self.warpgroups, self.pairs_per_block, int(self.both),
                self.stages)

    def slots(self, y: int):
        """[(matrix 0 = K / 1 = V, pair)] of block column ``y``."""
        npb = self.pairs_per_block
        if self.both:
            return [(m, y * npb + q) for m in (0, 1) for q in range(npb)]
        out = []
        for q in range(npb):
            idx = y * npb + q
            mat = int(idx >= self.n_pairs)
            out.append((mat, idx - mat * self.n_pairs))
        return out

    def pair_columns(self, pair: int):
        """(first column, width): the pair's columns are first + [0, width)
        and first + head_dim // 2 + [0, width)."""
        half = self.head_dim // 2
        head, j = divmod(pair, self.pairs_per_head)
        a = j * PIECE
        return head * self.head_dim + a, min(PIECE, half - a)


def make_plan(kind: tuple, G: int, S: int, KV: int,
              head_dim: int) -> TilePlan:
    """The plan of one of the kinds above (``STREAM``, ``STREAM_DEEP``,
    ``GEMM``) for one launch."""
    if head_dim not in SUPPORTED_HEAD_DIMS or KV % head_dim:
        raise ValueError(f"unsupported head_dim {head_dim} for KV={KV}")
    wg, npb, both, stages = kind
    pph = -(-(head_dim // 2) // PIECE)
    n_pairs = KV // head_dim * pph
    if n_pairs % npb:
        raise ValueError(f"{n_pairs} column pairs do not split by {npb}")
    cols = (n_pairs if both else 2 * n_pairs) // npb
    return TilePlan(mma="wgmma.m64n64k16.f32.bf16.bf16", k_depth=16,
                    stage_d=STAGE_D, split_d=1, warpgroups=wg,
                    pairs_per_block=npb, both=both, stages=stages,
                    grid=(-(-S // (64 * wg)), cols, G), head_dim=head_dim,
                    kv=KV, pairs_per_head=pph, n_pairs=n_pairs)


@functools.lru_cache(maxsize=1024)
def tile_plan(G: int, S: int, KV: int, head_dim: int) -> TilePlan:
    """The bf16 kernel's tile plan for one launch. Operations-bound shapes
    get 128 x 256 tiles (one head of K and one of V) when they fill at
    least three quarters of the SMs; the rest get 64-row blocks owning one
    64-column pair of K or of V, so even S = 1 streams the weights through
    2 * KV / 64 blocks, with a 12-stage ring when they fit in one wave.
    D, the depth of every sum, does not enter the plan."""
    plan = make_plan(STREAM, G, S, KV, head_dim)
    n_pairs = plan.n_pairs
    wg, npb = GEMM[:2]
    if (n_pairs % npb == 0
            and G * -(-S // (64 * wg)) * (n_pairs // npb) >= N_SM * 3 // 4):
        return make_plan(GEMM, G, S, KV, head_dim)
    if plan.grid[0] * plan.grid[1] * plan.grid[2] <= N_SM:
        return make_plan(STREAM_DEEP, G, S, KV, head_dim)
    return plan


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
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def validate_operands(hidden, wk, wv, bk, bv, rows, cos, sin, *,
                      head_dim: int):
    """Raise on anything the kernel does not take, before any launch:
    dtype, head size, shapes, contiguity, and for bf16 the 16-byte
    alignment and strides that TMA needs. Returns (G, S, D, A, KV)."""
    dtype, dev = hidden.dtype, hidden.device
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {dtype}")
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"unsupported head_dim {head_dim}")
    if hidden.dim() != 3 or wk.dim() != 3:
        raise ValueError("hidden must be (G, S, D) and wk (A, D, KV)")
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
            D % 8 or (hidden.data_ptr() | wk.data_ptr() | wv.data_ptr()) % 16):
        raise ValueError("bf16 needs D a multiple of 8 and 16-byte aligned "
                         "hidden, wk and wv (TMA strides and addresses)")
    return G, S, D, A, KV


def restore_kv_grouped_cuda(hidden, wk, wv, bk, bv, rows, cos, sin, *,
                            head_dim: int, use_rope: bool = True):
    """Launch the CUDA kernel; same contract as the plain version."""
    global launches
    if hidden.device.type != "cuda":
        raise ValueError("restore_kv_grouped_cuda needs CUDA tensors")
    G, S, D, A, KV = validate_operands(hidden, wk, wv, bk, bv, rows, cos,
                                       sin, head_dim=head_dim)
    dtype = hidden.dtype
    k = torch.empty(G, S, KV, dtype=dtype, device=hidden.device)
    v = torch.empty_like(k)
    if G == 0 or S == 0:
        return k, v
    plan = (tile_plan(G, S, KV, head_dim).args
            if dtype == torch.bfloat16 else (0,) * 4)
    lib = _build.library()
    lib.restore_kv_grouped(
        hidden.data_ptr(), wk.data_ptr(), wv.data_ptr(),
        bk.data_ptr() if bk is not None else 0,
        bv.data_ptr() if bv is not None else 0,
        rows.data_ptr(), cos.data_ptr(), sin.data_ptr(), k.data_ptr(),
        v.data_ptr(), G, S, D, KV, A, head_dim, int(use_rope),
        _DTYPE_CODE[dtype], *plan,
        torch.cuda.current_stream(hidden.device).cuda_stream)
    launches += 1
    shapes[G, S] += 1
    return k, v
