"""The port's kernel modules against the JAX package's kernels.

The plain PyTorch versions (what a CPU tensor runs) are held against the
JAX oracles in ``repro/kernels/ref.py`` and the Pallas kernels run in
interpret mode, on the same numpy inputs. Tolerance: atol = rtol = 1e-5
in fp32, where only the order of the sums differs. The CUDA kernels
themselves run only on a GPU; ``chip_smoke.py`` holds them against these
plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.restore_kv import restore_kv_grouped_pallas
from repro.models.layers.rope import rope_angles as jax_rope_angles
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import restore_kv as trkv

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _restore_inputs(G, hd, bias, seed):
    rng = np.random.default_rng(seed)
    S, D, A = 32, 64, 5
    KV = 2 * hd
    hidden = rng.standard_normal((G, S, D)).astype(np.float32)
    wk = (rng.standard_normal((A, D, KV)) * D ** -0.5).astype(np.float32)
    wv = (rng.standard_normal((A, D, KV)) * D ** -0.5).astype(np.float32)
    bk = rng.standard_normal((A, KV)).astype(np.float32) if bias else None
    bv = rng.standard_normal((A, KV)).astype(np.float32) if bias else None
    rows = np.array([3, 0, 4][:G], np.int32)      # not the identity
    cos, sin = (np.array(t) for t in
                jax_rope_angles(jnp.arange(S) + 7, hd, 10000.0))
    return hidden, wk, wv, bk, bv, rows, cos, sin


@pytest.mark.parametrize("hd", [16, 80, 96, 256])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("G", [1, 3])
def test_restore_kv_grouped_plain_matches_jax(G, bias, hd):
    hidden, wk, wv, bk, bv, rows, cos, sin = _restore_inputs(G, hd, bias,
                                                             G * 10 + hd)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    k, v = ops.restore_kv_grouped(t(hidden), t(wk), t(wv), t(bk), t(bv),
                                  t(rows), t(cos), t(sin), head_dim=hd)
    j = lambda a: None if a is None else jnp.asarray(a[rows])  # noqa: E731
    jargs = (jnp.asarray(hidden), j(wk), j(wv), j(bk), j(bv),
             jnp.asarray(cos), jnp.asarray(sin))
    rk, rv = jref.restore_kv_grouped_ref(*jargs, head_dim=hd)
    pk, pv = restore_kv_grouped_pallas(*jargs, head_dim=hd, interpret=True)
    for got, want in ((k, rk), (v, rv), (k, pk), (v, pv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _decode_inputs(G, seed, Smax=64, hd=16):
    rng = np.random.default_rng(seed)
    BKv = 6
    q = rng.standard_normal((BKv, G, hd)).astype(np.float32)
    k = rng.standard_normal((BKv, Smax, hd)).astype(np.float32)
    v = rng.standard_normal((BKv, Smax, hd)).astype(np.float32)
    kv_len = np.array([1, 17, 33, 64, 40, 5], np.int32)    # ragged
    return q, k, v, kv_len


@pytest.mark.parametrize("G,window,softcap", [
    (1, None, None), (4, None, None), (4, 8, None), (1, None, 30.0),
    (4, 12, 20.0)])
def test_decode_attention_plain_matches_jax(G, window, softcap):
    _check_decode(G, window, softcap, 16)


@pytest.mark.parametrize("G,window,softcap", [(1, None, None),
                                               (4, 12, 20.0)])
@pytest.mark.parametrize("hd", [80, 256])
def test_decode_attention_plain_matches_jax_at_head_sizes(hd, G, window,
                                                          softcap):
    """The head sizes of zamba2 and gemma2 (the smoke configs' 16 is the
    test above's)."""
    _check_decode(G, window, softcap, hd)


def _check_decode(G, window, softcap, hd):
    q, k, v, kv_len = _decode_inputs(G, G + (window or 0) + hd - 16, hd=hd)
    got = ops.decode_attention(*(torch.from_numpy(a) for a in
                                 (q, k, v, kv_len)),
                               softcap=softcap, window=window)
    jargs = tuple(jnp.asarray(a) for a in (q, k, v, kv_len))
    want = jref.decode_attention_ref(*jargs, softcap=softcap, window=window)
    pallas = decode_attention_pallas(*jargs, softcap=softcap, window=window,
                                     block_k=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("G,window,softcap", [(1, None, None), (4, None, None),
                                               (4, 12, 20.0)])
def test_decode_attention_plain_gives_zeros_at_kv_len_zero(G, window,
                                                           softcap):
    """Rows of lengths [0, 5, 0, 64, 17, 1] (fp32, hd 16): a row with no
    live position gives zeros, as the Pallas kernel in interpret mode
    gives (its zero accumulator divided by max(l, 1e-30)), and the other
    rows agree with it. The jnp oracle ``decode_attention_ref`` is not
    the oracle here: over a row with every position masked it averages v
    over Smax, which neither kernel computes."""
    q, k, v, _ = _decode_inputs(G, 40 + G)
    kv_len = np.array([0, 5, 0, 64, 17, 1], np.int32)
    got = ops.decode_attention(*(torch.from_numpy(a) for a in
                                 (q, k, v, kv_len)),
                               softcap=softcap, window=window)
    pallas = decode_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v, kv_len)), softcap=softcap,
        window=window, block_k=16, interpret=True)
    assert not got[torch.from_numpy(kv_len == 0)].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_decode_attention_reads_the_model_cache_layout():
    """A (B, Smax, Kv, hd) cache gives what its (B·Kv, Smax, hd) rows
    give: row b·Kv + h is batch b, kv head h."""
    q, k, v, kv_len = _decode_inputs(2, 3)
    B, Kv = 3, 2
    k4 = k.reshape(B, Kv, -1, k.shape[-1]).transpose(0, 2, 1, 3)
    v4 = v.reshape(B, Kv, -1, v.shape[-1]).transpose(0, 2, 1, 3)
    t = torch.from_numpy
    rows = ops.decode_attention(t(q), t(k), t(v), t(kv_len), window=20)
    cache = ops.decode_attention(t(q), t(np.ascontiguousarray(k4)),
                                 t(np.ascontiguousarray(v4)), t(kv_len),
                                 window=20)
    assert torch.equal(rows, cache)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU tensors never build or launch a kernel; the CUDA wrappers
    refuse CPU tensors instead of falling back."""
    def no_build():
        raise AssertionError("kernel build attempted for CPU tensors")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(trkv, "launches", 0)
    monkeypatch.setattr(tdec, "launches", 0)
    hidden, wk, wv, _, _, rows, cos, sin = _restore_inputs(3, 16, False, 0)
    args = [torch.from_numpy(a) for a in (hidden, wk, wv)] + [None, None] \
        + [torch.from_numpy(a) for a in (rows, cos, sin)]
    ops.restore_kv_grouped(*args, head_dim=16)
    q, k, v, kv_len = (torch.from_numpy(a) for a in _decode_inputs(1, 0))
    ops.decode_attention(q, k, v, kv_len)
    assert trkv.launches == 0 and tdec.launches == 0
    with pytest.raises(ValueError):
        trkv.restore_kv_grouped_cuda(*args, head_dim=16)
    with pytest.raises(ValueError):
        tdec.decode_attention_cuda(q, k, v, kv_len)


# ---------------------------------------------------------- head sizes
def _configs():
    """(name, head size) of every attention config of the reference
    registry and of each port-registered config's smoke reduction."""
    from repro.configs import REGISTRY as JAX_REGISTRY
    from repro_torch.config.arch import reduced_for_smoke
    from repro_torch.configs import REGISTRY
    out = [(f"ref:{n}", c.head_dim_) for n, c in sorted(JAX_REGISTRY.items())
           if c.n_heads]
    out += [(f"smoke:{n}", reduced_for_smoke(c).head_dim_)
            for n, c in sorted(REGISTRY.items()) if c.n_heads]
    return out


def _decode_takes(hd):
    return 8 <= hd <= tdec.MAX_HEAD_DIM and hd % 8 == 0


@pytest.mark.parametrize("name,hd", _configs())
def test_kernels_take_every_registered_head_size(name, hd):
    """Each kernel with a head dimension takes the head size of every
    model the reference registers and of every smoke config the port
    serves: restoration (#1), decode and paged decode (#3, #4), prefill
    attention (#5)."""
    from repro_torch.kernels import flash_attention as tfa
    assert hd in trkv.SUPPORTED_HEAD_DIMS, name
    assert _decode_takes(hd), name
    assert hd in tfa.HEAD_DIMS, name


def test_head_size_sets_match_across_kernels():
    """Restoration and prefill take one set, which decode's bound covers."""
    from repro_torch.kernels import flash_attention as tfa
    assert set(trkv.SUPPORTED_HEAD_DIMS) == set(tfa.HEAD_DIMS) \
        == {16, 64, 80, 96, 128, 256}
    assert all(_decode_takes(hd) for hd in tfa.HEAD_DIMS)


@pytest.mark.parametrize("hd", [12, 112, 264])
def test_wrappers_refuse_unsupported_head_sizes(hd, monkeypatch):
    """A head size outside a kernel's set raises before any build or
    launch; there is no fallback to the plain version. (Decode takes any
    multiple of 8 up to 256, so 112 is refused only by the others.)"""
    from repro_torch.kernels import flash_attention as tfa
    monkeypatch.setattr(_build, "library", lambda: pytest.fail(
        "the kernels were built for a call that must raise"))
    x = torch.zeros(1, 4, 2, hd)
    lens = (torch.zeros(1, dtype=torch.int32),
            torch.full((1,), 4, dtype=torch.int32))
    with pytest.raises(ValueError, match=f"hd={hd}"):
        tfa.flash_attention_cuda(x, x, x, *lens)
    hidden, wk, wv, _, _, rows, _, _ = _restore_inputs(1, 16, False, 0)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="head_dim"):
        trkv.validate_operands(t(hidden), t(wk), t(wv), None, None, t(rows),
                               torch.zeros(32, hd // 2),
                               torch.zeros(32, hd // 2), head_dim=hd)
    if _decode_takes(hd):
        return
    q = torch.zeros(2, 1, hd)
    kv = torch.zeros(2, 8, hd)
    n = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"hd={hd}"):
        tdec.decode_attention_cuda(q, kv, kv, n)
    with pytest.raises(ValueError, match=f"hd={hd}"):
        tdec.decode_attention_paged_cuda(
            q, kv.reshape(2, 8, hd), kv.reshape(2, 8, hd),
            torch.zeros(2, 1, dtype=torch.int32), n)
