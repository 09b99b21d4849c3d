"""The bf16 prefill-attention kernel's plan (``kernels/flash_attention.py``).

The CUDA kernel runs only on a GPU; what decides which queries and keys
each block takes, and how key-range splits are merged, is the plan it is
launched with, computed here in Python from host shapes alone. These tests
hold the plan to the kernel's contract: every output row is written by
exactly one warpgroup (once per split); splits cover the keys once, on key
tiles; the main path's short chunks over long histories fill the card;
every head size maps onto a kernel instantiation. A plain walk of the
plan, with the kernel's key ranges, tile skipping, masking, online softmax
in registers' order of tiles and the merge in split order, gives
``flash_attention_plain``'s output for any ``q_offset`` / ``kv_len``
values under the one plan its shapes give. Tolerance: atol = rtol = 1e-5
in fp32, where only the order of the sums differs."""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

TOL = dict(atol=1e-5, rtol=1e-5)
# the (head_pad, key tile, stages) instantiations of csrc/flash_attention.cu
INSTANTIATIONS = {(64, 128, 4), (128, 128, 2), (256, 64, 2)}

# (B, Sq, Skv, H, Kv, hd): the llama2-7b main path (1024- and 2000-token
# self-prefills, 256 over 2016 of history, 128 over 1900, one replayed
# decode token over 2000), engine chunks,
# GQA shapes of the reference registry, and the smoke configs
SHAPES = [(1, 1024, 1024, 32, 32, 128), (1, 2000, 2000, 32, 32, 128),
          (1, 256, 2272, 32, 32, 128), (1, 128, 2028, 32, 32, 128),
          (1, 128, 128, 32, 32, 128), (4, 80, 2000, 32, 32, 128),
          (1, 512, 4096, 28, 4, 128), (1, 300, 300, 16, 8, 256),
          (2, 200, 520, 8, 2, 64), (1, 24, 24, 4, 4, 16),
          (1, 24, 48, 4, 1, 16), (1, 77, 500, 32, 32, 80),
          (1, 33, 700, 12, 4, 96), (1, 1, 2001, 32, 32, 128)]
IDS = ["B{}-Sq{}-Skv{}-H{}-Kv{}-hd{}".format(*s) for s in SHAPES]


def _rows(plan, B, Sq, H, Kv):
    """[(b, head, row, split)] written by the valid warpgroups of the plan
    (rows past Sq are computed but not stored)."""
    group = H // Kv
    out = []
    for x in range(plan.grid[0]):
        b, kvh = divmod(x, Kv)
        for y in range(plan.grid[1]):
            _, _, split = plan.block(y)
            for j, valid, row0 in plan.warpgroups(y, group):
                if not valid:
                    continue
                for r in range(row0, min(row0 + 64, Sq)):
                    out.append((b, kvh * group + j, r, split))
    return out


@pytest.mark.parametrize("B,Sq,Skv,H,Kv,hd", SHAPES, ids=IDS)
def test_every_row_is_written_once_per_split(B, Sq, Skv, H, Kv, hd):
    plan = fa.flash_plan(B, Sq, Skv, H, Kv, hd)
    rows = _rows(plan, B, Sq, H, Kv)
    want = [(b, h, r, s) for b in range(B) for h in range(H)
            for r in range(Sq) for s in range(plan.splits)]
    assert sorted(rows) == want


@pytest.mark.parametrize("B,Sq,Skv,H,Kv,hd", SHAPES, ids=IDS)
def test_splits_cover_the_keys_once_on_key_tiles(B, Sq, Skv, H, Kv, hd):
    plan = fa.flash_plan(B, Sq, Skv, H, Kv, hd)
    assert plan.key_tile == fa.key_tile(hd)
    assert plan.split_keys % plan.key_tile == 0
    assert 1 <= plan.splits <= fa.MAX_SPLITS
    # the last split reaches Skv and no split is empty of keys
    assert (plan.splits - 1) * plan.split_keys < Skv \
        <= plan.splits * plan.split_keys
    assert (plan.head_pad, plan.key_tile, plan.stages) in INSTANTIATIONS
    assert plan.head_pad >= hd and plan.head_pad % 64 == 0


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_every_head_size_has_an_instantiation(hd):
    plan = fa.flash_plan(1, 64, 64, 4, 2, hd)
    assert (plan.head_pad, plan.key_tile, plan.stages) in INSTANTIATIONS
    assert plan.head_pad - hd < 64


def test_main_path_shapes():
    """Long self-prefills fill the card with 128-row blocks and no split;
    a short chunk over a long history splits its keys instead of running
    on 32 or 64 of the 132 SMs."""
    for Sq in (1024, 2000):
        p = fa.flash_plan(1, Sq, Sq, 32, 32, 128)
        assert p.splits == 1 and p.heads_per_block == 1
        assert p.grid[0] * p.grid[1] >= fa.N_SM
    for Sq, Skv in ((128, 2028), (256, 2272)):
        p = fa.flash_plan(1, Sq, Skv, 32, 32, 128)
        assert p.splits > 1
        assert fa.N_SM * 3 // 4 <= p.grid[0] * p.grid[1] <= fa.N_SM
    # GQA: two heads of a kv group per block read each K/V tile once
    assert fa.flash_plan(1, 512, 512, 16, 8, 256).heads_per_block == 2


def test_plan_depends_on_host_shapes_only():
    """The plan's inputs are the six shapes: nothing a launch reads from
    the device (q_offset, kv_len) can reach it, so equal shapes give equal
    blocks, equal key ranges per block and equal bits (the engine's two
    backends, the recompute replay)."""
    params = inspect.signature(fa.flash_plan.__wrapped__).parameters
    assert list(params) == ["B", "Sq", "Skv", "H", "Kv", "head_dim"]
    assert all(p.annotation in (int, "int") for p in params.values())
    fa.flash_plan.cache_clear()
    a = fa.flash_plan(1, 128, 2028, 32, 32, 128)
    fa.flash_plan.cache_clear()
    assert fa.flash_plan(1, 128, 2028, 32, 32, 128) == a


# ------------------------------------------------- plain walk of the plan
def plan_walk(plan, q, k, v, q_offset, kv_len, *, causal, softcap, window):
    """The kernel's computation in plain PyTorch, block by block and
    warpgroup by warpgroup: the block's key range (causal frontier,
    kv_len, window, its split), key tiles from the first one the range
    reaches, the select-based mask, the online softmax (running max and
    sum) over the tiles, and with splits the fp32 partials merged in split
    order. fp32 throughout."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    group = H // Kv
    bn = plan.key_tile
    scale = hd ** -0.5
    part_o = torch.zeros(plan.splits, B, Sq, H, hd)
    part_m = torch.full((plan.splits, B, Sq, H), float("-inf"))
    part_l = torch.zeros(plan.splits, B, Sq, H)
    written = torch.zeros(plan.splits, B, Sq, H, dtype=torch.int64)
    for x in range(plan.grid[0]):
        b, kvh = divmod(x, Kv)
        qoff, klen = int(q_offset[b]), min(int(kv_len[b]), Skv)
        for y in range(plan.grid[1]):
            qt, _, split = plan.block(y)
            q0 = qt * plan.rows_per_block
            nq = min(plan.rows_per_block, Sq - q0)
            kend = min(klen, qoff + q0 + nq) if causal else klen
            kbeg = max(0, qoff + q0 - window + 1) if window else 0
            kbeg = max(kbeg, split * plan.split_keys)
            kend = min(kend, (split + 1) * plan.split_keys)
            t_first = kbeg // bn * bn
            ntiles = -(-(kend - t_first) // bn) if kend > kbeg else 0
            for j, valid, row0 in plan.warpgroups(y, group):
                head = kvh * group + j
                qw = torch.zeros(64, hd)
                n = max(min(64, Sq - row0), 0)
                qw[:n] = q[b, row0:row0 + n, head]
                qp = qoff + row0 + torch.arange(64)[:, None]
                m = torch.full((64,), float("-inf"))
                l = torch.zeros(64)
                o = torch.zeros(64, hd)
                for it in range(ntiles):
                    t0 = t_first + it * bn
                    kt = torch.zeros(bn, hd)
                    vt = torch.zeros(bn, hd)
                    live = max(min(bn, klen - t0), 0)
                    kt[:live] = k[b, t0:t0 + live, kvh]
                    vt[:live] = v[b, t0:t0 + live, kvh]
                    s = (qw @ kt.T) * scale
                    if softcap:
                        s = torch.tanh(s / softcap) * softcap
                    kp = t0 + torch.arange(bn)[None, :]
                    ok = kp < klen
                    if causal:
                        ok = ok & (kp <= qp)
                    if window:
                        ok = ok & (kp > qp - window)
                    s = torch.where(ok, s, torch.tensor(float("-inf")))
                    m_new = torch.maximum(m, s.amax(-1))
                    mu = torch.where(m_new == float("-inf"), 0.0, m_new)
                    p = torch.exp(s - mu[:, None])
                    corr = torch.exp(m - mu)
                    l = l * corr + p.sum(-1)
                    o = o * corr[:, None] + p @ vt
                    m = m_new
                if valid and n:
                    part_o[split, b, row0:row0 + n, head] = o[:n]
                    part_m[split, b, row0:row0 + n, head] = m[:n]
                    part_l[split, b, row0:row0 + n, head] = l[:n]
                    written[split, b, row0:row0 + n, head] += 1
    assert bool((written == 1).all())
    mx = part_m.amax(0)
    mu = torch.where(mx == float("-inf"), 0.0, mx)
    out = torch.zeros(B, Sq, H, hd)
    lsum = torch.zeros(B, Sq, H)
    for s in range(plan.splits):             # the kernel's merge order
        w = torch.exp(part_m[s] - mu)
        lsum = lsum + part_l[s] * w
        out = out + part_o[s] * w[..., None]
    return out / torch.clamp(lsum, min=1e-30)[..., None]


# (B, Sq, Skv, H, Kv, hd, offsets, live lengths, causal, softcap, window)
WALKS = [
    (2, 40, 300, 4, 2, 16, (250, 200), (290, 240), True, None, None),
    (1, 300, 300, 2, 2, 16, (0,), (300,), True, None, None),
    (2, 70, 200, 6, 2, 16, (120, 100), (190, 170), True, 20.0, 48),
    (1, 50, 180, 3, 3, 80, (110,), (160,), True, None, 30),
    (2, 20, 150, 4, 1, 256, (100, 130), (120, 150), True, None, None),
    (1, 60, 140, 4, 4, 96, (0,), (140,), False, None, None),
]
WALK_IDS = [f"walk{i}-hd{w[5]}" for i, w in enumerate(WALKS)]


@pytest.mark.parametrize("n_sm", [fa.N_SM, 4])
@pytest.mark.parametrize("case", WALKS, ids=WALK_IDS)
def test_plan_walk_gives_the_plain_result(case, n_sm, monkeypatch):
    """With the card's SM count these small launches split their keys;
    with 4 SMs most do not. Two sets of offsets and live lengths run under
    the one plan their shapes give."""
    B, Sq, Skv, H, Kv, hd, offs, lens, causal, softcap, window = case
    monkeypatch.setattr(fa, "N_SM", n_sm)
    fa.flash_plan.cache_clear()
    try:
        plan = fa.flash_plan(B, Sq, Skv, H, Kv, hd)
    finally:
        fa.flash_plan.cache_clear()
    rng = np.random.default_rng(Skv + hd + H)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, k, v = f(B, Sq, H, hd), f(B, Skv, Kv, hd), f(B, Skv, Kv, hd)
    for shift in (0, 3):
        qo = torch.tensor([max(o - shift, 0) for o in offs],
                          dtype=torch.int32)
        kl = torch.tensor([n - shift for n in lens], dtype=torch.int32)
        kw = dict(causal=causal, softcap=softcap, window=window)
        got = plan_walk(plan, q, k, v, qo, kl, **kw)
        want = fa.flash_attention_plain(q, k, v, qo, kl, **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_unsupported_head_size_has_no_plan():
    with pytest.raises(ValueError, match="hd"):
        fa.flash_plan(1, 64, 64, 4, 4, 112)
