"""The decode kernels' split plan (``kernels/decode_attention.py::
decode_plan``), from host shapes only.

Kernels #3 and #4 cut each row's live keys at fixed boundaries, multiples
of the plan's split length, one block per split, and merge the splits in
split order. The engine's recompute replay needs a row's bits to depend on
the row alone, so the boundaries must not move with the batch, the other
rows, the capacity or the address policy. A plain walk of the plan
(each split's softmax in fp32 against its own max, the splits merged in
split order, as the kernel computes) is held against the plain version
and against the Pallas kernel in interpret mode, fp32, at atol = rtol =
1e-5: only the order of the sums differs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas
from repro_torch.kernels import decode_attention as tdec

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lengths(S):
    return (-3, 0, 1, S - 1, S, S + 1, 2 * S, 3 * S + 17, 4096, 8192)


@pytest.mark.parametrize("window", [None, 0, 1, 37, 300, 5000])
@pytest.mark.parametrize("smax", [1, 1030, 8192])
def test_row_splits_tile_the_live_range(smax, window):
    """A row's splits cover [window start, kv_len) exactly, without gap or
    overlap, each inside one span of split_keys keys and cut only at its
    multiples, a whole number of the kernel's key tiles; a row with
    kv_len <= 0 has none; the grid has room for every split of a row as
    long as the capacity."""
    plan = tdec.decode_plan(smax)
    S = plan.split_keys
    assert S >= tdec.TILE_KEYS and S % tdec.TILE_KEYS == 0
    assert plan.splits * S >= smax > (plan.splits - 1) * S
    for n in _lengths(S):
        splits = plan.row_splits(n, window)
        if n <= 0:
            assert splits == []
            continue
        lo = max(n - window, 0) if window else 0
        assert splits[0][0] == lo and splits[-1][1] == n
        assert all(b == c for (_, b), (c, _) in zip(splits, splits[1:]))
        for a, b in splits:
            assert a < b and a // S == (b - 1) // S
            assert (a == lo or a % S == 0) and (b == n or b % S == 0)
        if n <= smax:
            assert len(splits) <= plan.splits


@pytest.mark.parametrize("window", [None, 300])
def test_row_splits_ignore_capacity_and_policy(window):
    """The plan takes the capacity alone (a paged launch passes its MB·bs
    slots), never the batch or the rows' lengths; a row's splits are the
    same at every capacity that holds it, contiguous or paged, and only
    the number of split slots in the grid follows the capacity."""
    alone = tdec.decode_plan(1030)
    for smax in (1, 4096, 8192, 2560, 160 * 16, 7 * 16):
        plan = tdec.decode_plan(smax)
        assert plan.split_keys == alone.split_keys
        assert plan.splits == max(-(-smax // plan.split_keys), 1)
        for n in _lengths(plan.split_keys):
            assert plan.row_splits(n, window) == alone.row_splits(n, window)


def _plan_walk(q, k, v, kv_len, plan, softcap=None, window=None):
    """The kernel's arithmetic in plain PyTorch: per split, fp32 scores,
    the split's max m, P = exp(s - m), l = sum P and acc = P V; then the
    splits merged in split order against the largest max. A row without
    live keys gives zeros."""
    out = torch.zeros_like(q)
    scale = q.shape[-1] ** -0.5
    for r, n in enumerate(kv_len.tolist()):
        parts = []
        for a, b in plan.row_splits(min(n, k.shape[1]), window):
            s = (q[r].float() @ k[r, a:b].float().T) * scale
            if softcap is not None:
                s = torch.tanh(s / softcap) * softcap
            m = s.max(-1, keepdim=True).values
            p = torch.exp(s - m)
            parts.append((m, p.sum(-1, keepdim=True), p @ v[r, a:b].float()))
        if not parts:
            continue
        mg = torch.stack([m for m, _, _ in parts]).max(0).values
        l = torch.zeros_like(mg)
        acc = torch.zeros_like(parts[0][2])
        for m, ls, a in parts:
            w = torch.exp(m - mg)
            l = l + ls * w
            acc = acc + a * w
        out[r] = (acc / l).to(q.dtype)
    return out


@pytest.mark.parametrize("window,softcap", [(None, None), (200, 30.0)])
@pytest.mark.parametrize("G", [1, 4, 5, 7, 12])
@pytest.mark.parametrize("hd", [16, 80, 256])
def test_plan_walk_matches_plain_and_pallas(hd, G, window, softcap):
    """Rows from no key to three splits and more (lengths 0, 5, one split,
    one split and a key, 1030, the whole 1536-slot cache), fp32."""
    rng = np.random.default_rng(hd + G)
    Smax, BKv = 1536, 6
    plan = tdec.decode_plan(Smax)
    S = plan.split_keys
    q = rng.standard_normal((BKv, G, hd)).astype(np.float32)
    k = rng.standard_normal((BKv, Smax, hd)).astype(np.float32)
    v = rng.standard_normal((BKv, Smax, hd)).astype(np.float32)
    kv_len = np.array([0, 5, S, S + 1, 1030, Smax], np.int32)
    assert len(plan.row_splits(Smax)) >= 3
    t = [torch.from_numpy(a) for a in (q, k, v, kv_len)]
    walk = _plan_walk(*t, plan, softcap=softcap, window=window)
    plain = tdec.decode_attention_plain(*t, softcap=softcap, window=window)
    pallas = decode_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v, kv_len)), softcap=softcap,
        window=window, interpret=True)
    np.testing.assert_allclose(walk.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(walk.numpy(), np.asarray(pallas), **TOL)
    assert not walk[0].any()
