"""Kernel #3's plain version over a slice of a context-split cache
(``kv_start``) with the log-sum-exp (``return_lse``), and the merge of
the slices' partials (``layers/attention.py::merge_partials``).

Merging M slices' partials equals the unsplit plain decode within 1e-6
(fp32), slices with no live key of a row included (a short row, a
window that ends before a slice); without the new arguments the plain
version gives the bits of the pre-slice version (kept here as
``_plain_before``), and with them its output before the rounding; the
lse is the logsumexp of the row's logits."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import ops
from repro_torch.models.layers.attention import (AttnHyper,
                                                 decode_attention,
                                                 merge_partials)

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain_before(q, k, v, kv_len, *, softcap=None, window=None):
    """The plain version as it was before ``kv_start``/``return_lse``."""
    k, v = dec._as_rows(k), dec._as_rows(v)
    out = torch.empty_like(q)
    scale = q.shape[-1] ** -0.5
    for r, n in enumerate(kv_len.tolist()):
        n = min(int(n), k.shape[1])
        if n <= 0:
            out[r] = 0
            continue
        s = (q[r].float() @ k[r, :n].float().T) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        if window is not None:
            kpos = torch.arange(n, device=q.device)
            s = torch.where(kpos > n - 1 - window, s,
                            torch.full_like(s, dec.NEG_INF))
        out[r] = (torch.softmax(s, dim=-1) @ v[r, :n].float()).to(q.dtype)
    return out


def _case(B, Kv, G, Smax, hd, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B * Kv, G, hd, generator=g).to(dtype)
    k = torch.randn(B, Smax, Kv, hd, generator=g).to(dtype)
    v = torch.randn(B, Smax, Kv, hd, generator=g).to(dtype)
    return q, k, v


# lengths: empty, inside the first slice, on a boundary, the whole cache,
# past it (clamped as the unsplit kernel clamps it)
LENS = (0, 5, 24, 37, 48, 60)


@pytest.mark.parametrize("window", [None, 7, 16, 30])
@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_without_the_new_arguments_the_bits_are_unchanged(window, softcap,
                                                           dtype):
    q, k, v = _case(len(LENS), 2, 3, 48, 16, 0, dtype)
    lens = torch.tensor(LENS, dtype=torch.int32).repeat_interleave(2)
    got = dec.decode_attention_plain(q, k, v, lens, softcap=softcap,
                                     window=window)
    want = _plain_before(q, k, v, lens, softcap=softcap, window=window)
    assert torch.equal(got, want)
    # with the lse, the same output before its rounding
    out, lse = dec.decode_attention_plain(q, k, v, lens, softcap=softcap,
                                          window=window, return_lse=True)
    assert out.dtype == lse.dtype == torch.float32
    assert torch.equal(out.to(dtype), want)


@pytest.mark.parametrize("window", [None, 7, 16, 30])
@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("M", [2, 3, 4])
def test_merged_slices_equal_the_unsplit_plain_decode(window, softcap, M):
    B, Kv, G, Smax, hd = len(LENS), 2, 3, 48, 16
    q, k, v = _case(B, Kv, G, Smax, hd, M)
    lens = torch.tensor(LENS, dtype=torch.int32)
    h = AttnHyper(n_heads=Kv * G, n_kv_heads=Kv, head_dim=hd,
                  attn_softcap=softcap)
    qh = q.reshape(B, 1, Kv * G, hd)
    # the unsplit call clamps kv_len to the capacity; the slices are given
    # the clamped length, as the mesh decode gives it
    want = decode_attention(qh, k, v, h, kv_len=lens, window=window)
    size = Smax // M
    outs, lses = [], []
    for c in range(M):
        sl = slice(c * size, (c + 1) * size)
        start = torch.full((B,), c * size, dtype=torch.int32)
        o, lse = decode_attention(qh, k[:, sl].contiguous(),
                                  v[:, sl].contiguous(), h,
                                  kv_len=lens.clamp(max=Smax), window=window,
                                  kv_start=start, return_lse=True)
        outs.append(o)
        lses.append(lse)
    got = merge_partials(outs, lses)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    # a row no slice holds a key of: zeros, every lse -inf
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert all(bool(torch.isneginf(x[0]).all()) for x in lses)


def test_lse_is_the_logsumexp_of_the_logits_over_the_live_keys():
    B, Kv, G, Smax, hd = 3, 1, 2, 40, 16
    q, k, v = _case(B, Kv, G, Smax, hd, 7)
    lens = torch.tensor([40, 40, 40], dtype=torch.int32)
    start = torch.tensor([0, 10, 30], dtype=torch.int32)
    window = 12
    out, lse = ops.decode_attention(q, k[:, :10].contiguous(),
                                    v[:, :10].contiguous(), lens,
                                    window=window, kv_start=start,
                                    return_lse=True)
    scale = hd ** -0.5
    for r in range(B):
        lo = max(40 - window - int(start[r]), 0)
        hi = min(40 - int(start[r]), 10)
        if hi <= lo:                 # rows 0 and 1: the window ends later
            assert torch.isneginf(lse[r]).all()
            assert torch.equal(out[r], torch.zeros_like(out[r]))
            continue
        s = (q[r] @ k[r, lo:hi, 0].T) * scale
        np.testing.assert_allclose(lse[r].numpy(),
                                   torch.logsumexp(s, -1).numpy(),
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("start,n,window,want", [
    (None, 50, None, (0, 40)),       # unsplit: clamped to the cache
    (None, 50, 16, (24, 40)),        # the window from the clamped length
    (40, 50, None, (0, 10)),         # a slice: absolute, cut to it
    (40, 50, 16, (0, 10)),
    (20, 50, 16, (14, 30)),
    (0, 30, 8, (22, 30)),
    (30, 20, None, (0, -10)),        # empty: hi <= lo
])
def test_slice_range(start, n, window, want):
    assert dec.slice_range(n, 40, window, start) == want


def test_merge_of_one_partial_is_the_partial():
    x = torch.randn(2, 1, 4, 8)
    assert merge_partials([x], [None]) is x
