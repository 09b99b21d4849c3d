"""The bf16 restoration kernel's tile plan (``kernels/restore_kv.py``).

The CUDA kernel runs only on a GPU; what decides its bits and its
coverage is the plan it is launched with, computed here in Python. These
tests hold the plan to the kernel's contract: the fields that fix the
order of each output element's sum over D are the same for every S and
G; the column map covers every column of K and of V once and keeps each
RoPE pair (c, c + hd/2) in one tile; bytes-bound llama2-7b shapes get at
least 128 blocks; operands TMA cannot take raise before any launch. A
plain fp32 walk of the plan's tiles and column map, with the kernel's
epilogue index maths, gives ``restore_kv_grouped_plain``'s output
bitwise, and that plain version is held against the JAX oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import restore_kv as rkv

SEQS = (1, 4, 16, 128, 300, 1024, 2048)
GROUPS = (1, 8)
# llama2-7b, llama2-13b, opt-30b, the odd head sizes, gemma2-9b (8 kv
# heads of 256), the smoke configs (4 kv heads of 16, or one), qwen2-7b
# and starcoder2-15b (4 kv heads of 128), and qwen2.5-14b (8 of 128)
WIDTHS = ((4096, 128), (5120, 128), (7168, 128), (768, 96), (640, 80),
          (2048, 256), (64, 16), (16, 16), (512, 128), (1024, 128))
ALL = [(S, G, KV, hd) for S in SEQS for G in GROUPS for KV, hd in WIDTHS]
IDS = [f"S{S}-G{G}-KV{KV}-hd{hd}" for S, G, KV, hd in ALL]


def _plan(S, G, KV, hd):
    return rkv.tile_plan(G, S, KV, hd)


def _blocks(plan):
    """[(x, y, z)] of the launch grid."""
    gx, gy, gz = plan.grid
    return [(x, y, z) for z in range(gz) for y in range(gy)
            for x in range(gx)]


def _column_tiles(plan):
    """Per matrix, the column tiles of one token tile: one list of written
    columns per (y, pair slot); the pair's two pieces are one tile."""
    tiles = {0: [], 1: []}
    half = plan.head_dim // 2
    for y in range(plan.grid[1]):
        for mat, pair in plan.slots(y):
            first, width = plan.pair_columns(pair)
            cols = list(range(first, first + width)) + list(
                range(first + half, first + half + width))
            tiles[mat].append(cols)
    return tiles


@pytest.mark.parametrize("S,G,KV,hd", ALL, ids=IDS)
def test_sum_order_fields_do_not_depend_on_S_or_G(S, G, KV, hd):
    plan = _plan(S, G, KV, hd)
    ref = _plan(1, 1, KV, hd)
    for name in rkv.TilePlan.ORDER_FIELDS:
        assert getattr(plan, name) == getattr(ref, name), name
    assert plan.mma == "wgmma.m64n64k16.f32.bf16.bf16"
    assert (plan.k_depth, plan.stage_d, plan.split_d) == (16, 64, 1)
    assert plan.args in (rkv.STREAM, rkv.STREAM_DEEP, rkv.GEMM)


@pytest.mark.parametrize("S,G,KV,hd", ALL, ids=IDS)
def test_column_map_covers_each_column_once(S, G, KV, hd):
    plan = _plan(S, G, KV, hd)
    for mat, tiles in _column_tiles(plan).items():
        cols = [c for t in tiles for c in t]
        assert sorted(cols) == list(range(KV)), f"matrix {mat}"
    # every token row of every group row lies in exactly one token tile
    assert plan.grid[2] == G
    assert (plan.grid[0] - 1) * plan.block_m < S <= plan.grid[0] * \
        plan.block_m


@pytest.mark.parametrize("S,G,KV,hd", ALL, ids=IDS)
def test_rope_pairs_lie_in_one_tile(S, G, KV, hd):
    plan = _plan(S, G, KV, hd)
    half = hd // 2
    for tile in _column_tiles(plan)[0]:
        got = set(tile)
        for c in tile:
            partner = c + half if c % hd < half else c - half
            assert partner in got, (c, partner)


@pytest.mark.parametrize("S", [s for s in SEQS if s <= 128])
@pytest.mark.parametrize("G", GROUPS)
def test_bytes_bound_llama_shapes_fill_the_card(S, G):
    plan = _plan(S, G, 4096, 128)
    gx, gy, gz = plan.grid
    assert gx * gy * gz >= 128


def test_operations_bound_shapes_take_the_large_tile():
    assert _plan(1024, 8, 4096, 128).args == (2, 2, 1, 4)
    assert _plan(2000, 1, 4096, 128).args == (2, 2, 1, 4)
    assert _plan(1, 1, 4096, 128).args == (1, 1, 0, 12)
    assert _plan(128, 1, 4096, 128).args == (1, 1, 0, 6)


def _cpu_operands(dtype=torch.bfloat16, G=2, S=8, D=64, KV=256, hd=128, A=3):
    g = torch.Generator().manual_seed(0)
    hidden = torch.randn(G, S, D, generator=g).to(dtype)
    wk = torch.randn(A, D, KV, generator=g).to(dtype)
    wv = torch.randn(A, D, KV, generator=g).to(dtype)
    rows = torch.tensor([0, 2][:G], dtype=torch.int32)
    cos = torch.randn(S, hd // 2, generator=g)
    sin = torch.randn(S, hd // 2, generator=g)
    return [hidden, wk, wv, None, None, rows, cos, sin]


def _misaligned(t):
    """t's values at an address 2 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    off = next(i for i in range(8)
               if (buf.data_ptr() + i * t.element_size()) % 16 == 2)
    out = buf[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _break(case, ops):
    if case == "hidden misaligned":
        ops[0] = _misaligned(ops[0])
    elif case == "wk misaligned":
        ops[1] = _misaligned(ops[1])
    elif case == "wv misaligned":
        ops[2] = _misaligned(ops[2])
    elif case == "hidden not contiguous":
        ops[0] = ops[0].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "wk not contiguous":
        ops[1] = ops[1].transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "D not a multiple of 8":
        ops[0] = ops[0][..., :60].contiguous()
        ops[1] = ops[1][:, :60].contiguous()
        ops[2] = ops[2][:, :60].contiguous()
    elif case == "rows not int32":
        ops[5] = ops[5].long()
    elif case == "head_dim unsupported":
        pass
    return ops


BREAKS = ("hidden misaligned", "wk misaligned", "wv misaligned",
          "hidden not contiguous", "wk not contiguous",
          "D not a multiple of 8", "rows not int32", "head_dim unsupported")


@pytest.mark.parametrize("case", BREAKS)
def test_operands_tma_cannot_take_raise_before_launch(case, monkeypatch):
    ops = _break(case, _cpu_operands())
    hd = 112 if case == "head_dim unsupported" else 128
    monkeypatch.setattr(rkv._build, "library", lambda: pytest.fail(
        "the kernels were built for a call that must raise"))
    with pytest.raises((ValueError, TypeError)):
        rkv.validate_operands(*ops, head_dim=hd)


def test_valid_operands_pass_validation():
    ops = _cpu_operands()
    assert rkv.validate_operands(*ops, head_dim=128) == (2, 8, 64, 3, 256)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        rkv.restore_kv_grouped_cuda(*_cpu_operands(), head_dim=128)


# ------------------------------------------------- plain walk of the plan
def tiled_walk(plan, hidden, wk, wv, bk, bv, rows, cos, sin, use_rope):
    """The kernel's computation in plain PyTorch, tile by tile: per block,
    its token rows (zero past S), its pieces' 32 columns (zero past KV),
    a sum over D from 0 upward, then bias, RoPE on the pair's two pieces
    and a store of the columns the column map gives the block. fp32 sums
    in the plain version's order, so the result must equal it bitwise."""
    G, S, D = hidden.shape
    KV, hd = plan.kv, plan.head_dim
    half = hd // 2
    out = [torch.full((G, S, KV), float("nan")) for _ in range(2)]
    hpad = torch.zeros(G, plan.grid[0] * plan.block_m, D)
    hpad[:, :S] = hidden.float()
    stacks = [torch.cat([w.float(), torch.zeros(w.shape[0], D, rkv.PIECE)],
                        -1) for w in (wk, wv)]
    biases = (bk, bv)
    for x, y, z in _blocks(plan):
        m0 = x * plan.block_m
        h = hpad[z, m0:m0 + plan.block_m]
        row = int(rows[z])
        for mat, pair in plan.slots(y):
            first, width = plan.pair_columns(pair)
            pieces = []
            for col in (first, first + half):
                w = stacks[mat][row, :, col:col + rkv.PIECE]
                acc = torch.zeros(plan.block_m, rkv.PIECE)
                for d in range(D):
                    acc = acc + h[:, d:d + 1] * w[d][None, :]
                if biases[mat] is not None:
                    b = torch.cat([biases[mat][row].float(),
                                   torch.zeros(rkv.PIECE)])
                    acc = acc + b[col:col + rkv.PIECE][None, :]
                pieces.append(acc)
            x1, x2 = pieces
            if mat == 0 and use_rope:
                f = first % hd
                n = min(plan.block_m, S - m0)
                c = torch.zeros(plan.block_m, rkv.PIECE)
                s = torch.zeros(plan.block_m, rkv.PIECE)
                c[:n, :width] = cos[m0:m0 + n, f:f + width].float()
                s[:n, :width] = sin[m0:m0 + n, f:f + width].float()
                x1, x2 = x1 * c - x2 * s, x1 * s + x2 * c
            n = min(plan.block_m, S - m0)
            out[mat][z, m0:m0 + n, first:first + width] = x1[:n, :width]
            out[mat][z, m0:m0 + n, first + half:first + half + width] = \
                x2[:n, :width]
    return [o.to(hidden.dtype) for o in out]


WALKS = [(kind, hd, bias, rope, S, G)
         for kind in ("STREAM", "STREAM_DEEP", "GEMM")
         for hd, bias, rope, S, G in ((128, False, True, 70, 2),
                                      (96, True, True, 5, 1),
                                      (80, True, False, 130, 1),
                                      (80, False, True, 3, 2),
                                      (64, True, True, 64, 1),
                                      (16, True, True, 70, 2),
                                      (256, False, True, 3, 1))]


@pytest.mark.parametrize("kind,hd,bias,rope,S,G", WALKS)
def test_tiled_walk_gives_the_plain_bits(kind, hd, bias, rope, S, G):
    rng = np.random.default_rng(hd * 7 + S)
    D, A = 24, 3
    KV = 2 * hd
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    hidden, wk, wv = f(G, S, D), f(A, D, KV) * D ** -0.5, \
        f(A, D, KV) * D ** -0.5
    bk, bv = (f(A, KV), f(A, KV)) if bias else (None, None)
    rows = torch.tensor([2, 0][:G], dtype=torch.int32)
    pos = torch.arange(S) + 11
    inv = 1.0 / (10000.0 ** (torch.arange(0, hd, 2).float() / hd))
    ang = pos[:, None].float() * inv[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    plan = rkv.make_plan(getattr(rkv, kind), G, S, KV, hd)
    got = tiled_walk(plan, hidden, wk, wv, bk, bv, rows, cos, sin, rope)
    want = rkv.restore_kv_grouped_plain(hidden, wk, wv, bk, bv, rows, cos,
                                        sin, head_dim=hd, use_rope=rope)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    # and the plain version is the JAX oracle's function
    r = rows.long()
    j = lambda t: None if t is None else jnp.asarray(  # noqa: E731
        t[r].numpy())
    jk, jv = jref.restore_kv_grouped_ref(
        jnp.asarray(hidden.numpy()), j(wk), j(wv), j(bk), j(bv),
        jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()), head_dim=hd,
        use_rope=rope)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jk), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jv), atol=1e-5,
                               rtol=1e-5)
