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


@pytest.mark.parametrize("hd", [16, 80, 96])
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


def _decode_inputs(G, seed, Smax=64):
    rng = np.random.default_rng(seed)
    BKv, hd = 6, 16
    q = rng.standard_normal((BKv, G, hd)).astype(np.float32)
    k = rng.standard_normal((BKv, Smax, hd)).astype(np.float32)
    v = rng.standard_normal((BKv, Smax, hd)).astype(np.float32)
    kv_len = np.array([1, 17, 33, 64, 40, 5], np.int32)    # ragged
    return q, k, v, kv_len


@pytest.mark.parametrize("G,window,softcap", [
    (1, None, None), (4, None, None), (4, 8, None), (1, None, 30.0),
    (4, 12, 20.0)])
def test_decode_attention_plain_matches_jax(G, window, softcap):
    q, k, v, kv_len = _decode_inputs(G, G + (window or 0))
    got = ops.decode_attention(*(torch.from_numpy(a) for a in
                                 (q, k, v, kv_len)),
                               softcap=softcap, window=window)
    jargs = tuple(jnp.asarray(a) for a in (q, k, v, kv_len))
    want = jref.decode_attention_ref(*jargs, softcap=softcap, window=window)
    pallas = decode_attention_pallas(*jargs, softcap=softcap, window=window,
                                     block_k=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
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
