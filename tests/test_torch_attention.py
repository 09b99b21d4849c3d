"""The port's paged decode attention (kernel #4) and prefill flash
attention (kernel #5) against the JAX package's kernels and oracles.

The plain PyTorch versions (what a CPU tensor runs) are held against the
Pallas kernels in interpret mode and the jnp oracles, on the same numpy
inputs. Tolerance: atol = rtol = 1e-5 in fp32, where only the order of
the sums differs; in bf16 one bf16 ulp of the larger value against the
jnp oracles, since each side rounds its own fp32 result once. The bf16
Pallas paged kernel rounds its softmax weights to bf16 before P @ V,
which its oracle does not, so in bf16 it is held to the tolerance the JAX
package's own tests hold it to against that oracle (``_tol`` in
tests/test_kernels.py: atol = rtol = 2e-2). The CUDA kernels run only on
a GPU; ``chip_smoke.py`` holds them against these plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_paged_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.layers.attention import AttnHyper as JaxAttnHyper
from repro.models.layers.attention import flash_attention_jnp
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_within_one_bf16_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), float(
        np.max(np.abs(got - want) / ulp))


def _to_torch(a, dtype):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _to_jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


# ------------------------------------------------------- #4: paged decode
def _paged_inputs(G, bs, MB, seed, hd=32):
    """A permuted physical pool full of junk, with sentinel table entries
    past each row's live pages (as tests/test_kernels.py builds it)."""
    rng = np.random.default_rng(seed)
    BKv = 3
    S = MB * bs
    q = rng.normal(size=(BKv, G, hd))
    k = rng.normal(size=(BKv, S, hd))
    v = rng.normal(size=(BKv, S, hd))
    kl = rng.integers(1, S, BKv).astype(np.int32)
    NB = BKv * MB + 3
    perm = rng.permutation(NB)[:BKv * MB]
    k_pool = rng.normal(size=(NB, bs, hd))
    v_pool = rng.normal(size=(NB, bs, hd))
    table = np.full((BKv, MB), NB + 5, np.int32)
    for b in range(BKv):
        for j in range(MB):
            if j * bs < kl[b]:
                p = perm[b * MB + j]
                table[b, j] = p
                k_pool[p] = k[b, j * bs:(j + 1) * bs]
                v_pool[p] = v[b, j * bs:(j + 1) * bs]
    return q, k, v, k_pool, v_pool, table, kl


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("G,bs,MB", [(1, 16, 4), (4, 8, 8), (7, 32, 3)])
def test_paged_decode_plain_matches_jax(G, bs, MB, dtype):
    _check_paged_decode(G, bs, MB, dtype)


def _check_paged_decode(G, bs, MB, dtype, hd=32):
    q, k, v, k_pool, v_pool, table, kl = _paged_inputs(
        G, bs, MB, G + bs + hd - 32, hd)
    t = lambda a: _to_torch(a, dtype)  # noqa: E731
    j = lambda a: _to_jax(a, dtype)  # noqa: E731
    got = ops.decode_attention_paged(
        t(q), t(k_pool), t(v_pool), torch.from_numpy(table),
        torch.from_numpy(kl))
    jargs = (j(q), j(k_pool), j(v_pool), jnp.asarray(table), jnp.asarray(kl))
    oracle = jref.decode_attention_paged_ref(*jargs)
    pallas = decode_attention_paged_pallas(*jargs, interpret=True)
    got = got.float().numpy()
    if dtype == "fp32":
        for want in (oracle, pallas):
            np.testing.assert_allclose(got, np.asarray(want), **TOL)
    else:
        _assert_within_one_bf16_ulp(got, oracle)
        np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                                   atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hd", [16, 80, 256])
def test_paged_decode_plain_matches_jax_at_head_sizes(hd, dtype):
    """The head sizes of the smoke configs, zamba2 and gemma2."""
    _check_paged_decode(4, 16, 4, dtype, hd)


@pytest.mark.parametrize("lens", [(0, 5, 0), (0, 0, 0)])
@pytest.mark.parametrize("G,bs", [(1, 16), (4, 8)])
def test_paged_decode_plain_gives_zeros_at_kv_len_zero(G, bs, lens):
    """Rows of lengths [0, 5, 0] and [0, 0, 0] (fp32, hd 16) over a pool
    whose tables still map pages: a row with no live position gives
    zeros, as the Pallas kernel in interpret mode gives, and the other
    rows agree with it. The jnp oracle ``decode_attention_paged_ref`` is
    not the oracle here: over a row with every position masked it
    averages v over the gathered positions, which neither kernel
    computes."""
    q, _, _, k_pool, v_pool, table, _ = _paged_inputs(G, bs, 4, 60 + G,
                                                      hd=16)
    kl = np.array(lens, np.int32)
    got = ops.decode_attention_paged(
        *(_to_torch(a, "fp32") for a in (q, k_pool, v_pool)),
        torch.from_numpy(table), torch.from_numpy(kl))
    pallas = decode_attention_paged_pallas(
        *(_to_jax(a, "fp32") for a in (q, k_pool, v_pool)),
        jnp.asarray(table), jnp.asarray(kl), interpret=True)
    assert not got[torch.from_numpy(kl == 0)].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("window,softcap", [(None, None), (10, 30.0)])
def test_paged_decode_plain_equals_contiguous_bitwise(window, softcap):
    """On the model's (NB, bs, Kv, hd) pool with a (B, MB) table, paged
    decode gives the bits of contiguous decode on the gathered layout."""
    rng = np.random.default_rng(5)
    B, Kv, G, hd, bs, MB = 2, 3, 2, 16, 8, 5
    NB = B * MB + 2
    pool_k = torch.from_numpy(rng.normal(size=(NB, bs, Kv, hd))).float()
    pool_v = torch.from_numpy(rng.normal(size=(NB, bs, Kv, hd))).float()
    table = np.full((B, MB), NB, np.int32)       # sentinel = NB
    perm = rng.permutation(NB)
    lens = np.array([33, 9], np.int32)
    for b in range(B):
        for j in range(-(-int(lens[b]) // bs)):
            table[b, j] = perm[b * MB + j]
    q = torch.from_numpy(rng.normal(size=(B * Kv, G, hd))).float()
    kv_len = torch.from_numpy(np.repeat(lens, Kv))
    tbl = torch.from_numpy(table)
    paged = ops.decode_attention_paged(q, pool_k, pool_v, tbl, kv_len,
                                       window=window, softcap=softcap)
    idx = tbl.clamp(max=NB - 1).long()
    k = pool_k[idx].reshape(B, MB * bs, Kv, hd)
    v = pool_v[idx].reshape(B, MB * bs, Kv, hd)
    contiguous = ops.decode_attention(q, k, v, kv_len, window=window,
                                      softcap=softcap)
    assert torch.equal(paged, contiguous)


# ----------------------------------------------------- #5: flash attention
@pytest.mark.parametrize("Sq,Skv,hd,group", [(64, 64, 16, 1), (64, 64, 32, 2),
                                             (32, 96, 16, 4), (64, 160, 80, 2),
                                             (32, 192, 256, 1)])
@pytest.mark.parametrize("kwargs", [dict(causal=True), dict(causal=False),
                                    dict(causal=True, window=24),
                                    dict(causal=True, softcap=30.0)])
def test_flash_plain_matches_pallas_aligned(Sq, Skv, hd, group, kwargs):
    """q_offset = 0 and kv_len = Skv: the function ``flash_attention_pallas``
    computes. Pallas folds batch and heads into rows: q row h uses kv row
    h // group, which is one batch of H = BKv·group heads here."""
    rng = np.random.default_rng(Sq + Skv + hd + group)
    BKv = 2
    q = rng.normal(size=(BKv * group, Sq, hd)).astype(np.float32)
    k = rng.normal(size=(BKv, Skv, hd)).astype(np.float32)
    v = rng.normal(size=(BKv, Skv, hd)).astype(np.float32)
    four_d = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a.transpose(1, 0, 2))[None])
    got = ops.flash_attention(
        four_d(q), four_d(k), four_d(v), torch.zeros(1, dtype=torch.int32),
        torch.full((1,), Skv, dtype=torch.int32), **kwargs)
    got = got[0].numpy().transpose(1, 0, 2)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    pallas = flash_attention_pallas(jq, jk, jv, group=group, interpret=True,
                                    **kwargs)
    oracle = jref.flash_attention_ref(jq, jk, jv, group=group, **kwargs)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hist,Sq,window,softcap,group", [
    (40, 8, None, None, 1), (37, 16, None, 20.0, 2), (50, 12, 24, None, 4),
    (0, 24, None, None, 2)])
def test_flash_plain_matches_jnp_with_offset(hist, Sq, window, softcap,
                                             group, dtype):
    """A prefill over restored history: queries at hist + [0, Sq), keys
    [0, hist + Sq) live in a longer buffer, batch rows with different
    offsets; what the JAX model's ``flash_attention_jnp`` computes."""
    _check_flash_vs_jnp(hist, Sq, window, softcap, group, dtype, 16)


@pytest.mark.parametrize("hist,Sq,window,softcap,group", [
    (150, 12, None, 30.0, 2), (140, 20, 48, None, 1)])
@pytest.mark.parametrize("hd", [16, 80, 256])
def test_flash_plain_matches_jnp_at_head_sizes(hd, hist, Sq, window,
                                               softcap, group):
    """The head sizes of the smoke configs, zamba2 and gemma2, over more
    keys than one key tile, in fp32. (The bf16 one-ulp criterion above
    holds while both sides' fp32 results agree far below a bf16 ulp; at
    hd 256 some outputs cancel to near zero, where the two sides' bf16 P
    roundings already differ by more than one ulp of the output while
    both stay ~1e-5 from the fp32 result.)"""
    _check_flash_vs_jnp(hist, Sq, window, softcap, group, "fp32", hd)


def _check_flash_vs_jnp(hist, Sq, window, softcap, group, dtype, hd):
    rng = np.random.default_rng(hist + Sq + group + hd - 16)
    B, Kv = 2, 2
    H = Kv * group
    Skv = hist + Sq + 5                          # junk past kv_len
    q = rng.normal(size=(B, Sq, H, hd))
    k = rng.normal(size=(B, Skv, Kv, hd))
    v = rng.normal(size=(B, Skv, Kv, hd))
    offs = np.array([hist, max(hist - 3, 0)], np.int32)
    lens = offs + Sq
    t = lambda a: _to_torch(a, dtype)  # noqa: E731
    got = ops.flash_attention(t(q), t(k), t(v), torch.from_numpy(offs),
                              torch.from_numpy(lens), causal=True,
                              softcap=softcap, window=window)
    # the same key chunks, so that in bf16 both round P against the same
    # running maxima
    h = JaxAttnHyper(n_heads=H, n_kv_heads=Kv, head_dim=hd, padded_heads=H,
                     attn_softcap=softcap, chunk=tfa.key_tile(hd))
    want = flash_attention_jnp(
        _to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype), h,
        q_positions=jnp.asarray(offs[:, None] + np.arange(Sq)[None]),
        causal=True, window=window, kv_len=jnp.asarray(lens))
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        _assert_within_one_bf16_ulp(got.float().numpy(), want)


# -------------------------------------------- #5: P-rounding bound
def _dominant_row(seed, hd, Skv=96, top=0.14):
    """bf16 q, k, v for one query over Skv keys whose last key carries a
    softmax weight of about ``top`` (the rest random), as in the card
    check's fragile draw: the query's scores are k[:, 0] exactly."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(1, Skv, 1, hd))
    s = k[0, :-1, 0, 0]
    rest = np.exp(s).sum()
    k[0, -1, 0, 0] = np.log(top / (1 - top) * rest)
    q = np.zeros((1, 1, 1, hd))
    q[0, 0, 0, 0] = hd ** 0.5
    v = rng.normal(size=(1, Skv, 1, hd))
    off = torch.tensor([Skv - 1], dtype=torch.int32)
    return (_to_torch(q, "bf16"), _to_torch(k, "bf16"), _to_torch(v, "bf16"),
            off)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("hd", [16, 128])
def test_flash_p_rounding_bound_covers_bf16_p(hd, seed):
    """The plain version with P rounded to bf16 and with P kept in fp32
    (both outputs in fp32, the same scores, maxima and sums) differ by no
    more than ``flash_p_rounding_bound`` at any element, on a row with one
    dominant weight (~0.14, where a bf16 ulp of p is ~0.001)."""
    q, k, v, off = _dominant_row(seed, hd)
    Skv = k.shape[1]
    kl = torch.tensor([Skv], dtype=torch.int32)
    logits = (q.float()[0, 0, 0] @ k.float()[0, :, 0].T) * hd ** -0.5
    assert 0.1 < float(torch.softmax(logits, -1).max()) < 0.2
    walk = dict(causal=True, softcap=None, window=None)
    rounded, _ = tfa._plain_walk(q, k, v, off, kl, **walk)
    exact, _ = tfa._plain_walk(q, k, v.float(), off, kl, **walk)
    bound = tfa.flash_p_rounding_bound(q, k, v, off, kl)
    assert float(bound.min()) > 0
    assert bool(((rounded - exact).abs() <= bound).all())
    assert torch.equal(tfa.flash_attention_plain(q, k, v, off, kl),
                       rounded.to(q.dtype))
    # no rounding of P in fp32: the bound is zero there
    zero = tfa.flash_p_rounding_bound(q.float(), k.float(), v.float(), off,
                                      kl)
    assert not bool(zero.any())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("hd", [16, 128])
def test_flash_p_rounding_bound_fails_a_dropped_key(hd, seed):
    """An output that leaves out one live key (the dominant one, past
    kv_len) lies outside the bound: the check still catches a fault."""
    q, k, v, off = _dominant_row(seed, hd)
    Skv = k.shape[1]
    kl = torch.tensor([Skv], dtype=torch.int32)
    want = tfa.flash_attention_plain(q, k, v, off, kl).float()
    bound = tfa.flash_p_rounding_bound(q, k, v, off, kl)
    dropped = tfa.flash_attention_plain(
        q, k, v, off, torch.tensor([Skv - 1], dtype=torch.int32)).float()
    assert bool(((dropped - want).abs() > bound).any())


# ------------------------------------------------------------- dispatch
def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """CPU tensors never build or launch a kernel; the CUDA wrappers
    refuse CPU tensors instead of falling back."""
    def no_build():
        raise AssertionError("kernel build attempted for CPU tensors")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(tdec, "paged_launches", 0)
    monkeypatch.setattr(tfa, "launches", 0)
    q, _, _, k_pool, v_pool, table, kl = _paged_inputs(1, 8, 4, 0)
    t = lambda a: _to_torch(a, "fp32")  # noqa: E731
    args = (t(q), t(k_pool), t(v_pool), torch.from_numpy(table),
            torch.from_numpy(kl))
    ops.decode_attention_paged(*args)
    x = torch.zeros(1, 4, 2, 64)
    lens = (torch.zeros(1, dtype=torch.int32),
            torch.full((1,), 4, dtype=torch.int32))
    ops.flash_attention(x, x, x, *lens)
    assert tdec.paged_launches == 0 and tfa.launches == 0
    with pytest.raises(ValueError):
        tdec.decode_attention_paged_cuda(*args)
    with pytest.raises(ValueError):
        tfa.flash_attention_cuda(x, x, x, *lens)


def test_kernel_sources_are_built_together():
    """Every kernel this slice launches is compiled by the one build."""
    assert {"flash_attention.cu", "decode_attention.cu",
            "restore_kv.cu"} <= set(_build.KERNEL_SOURCES)
    assert {"hc_flash_attention", "hc_decode_attention_paged"} \
        <= set(_build._ARGTYPES)
    binding = (_build.CSRC / "binding.cpp").read_text()
    for name in ("flash_attention", "decode_attention_paged"):
        assert f'm.def("{name}"' in binding
