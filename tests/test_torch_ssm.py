"""The port's ssm family (falcon-mamba) against the JAX package's.

Kernel #6: ``ssm_update_plain`` (the plain version beside the CUDA
kernel, which runs only on a card) against the JAX package's Pallas
kernel in interpret mode, at ``tests/test_kernels.py``'s shapes, rtol =
atol = 3e-5 as there. The Mamba1 layer, ``ssm_forward`` (logits, hidden
states, conv and ssm states), ``ssm_decode_step`` and
``ssm_restore_states`` against the JAX model on the same weights: one
JAX smoke model (falcon-mamba-7b reduced: 4 layers, d=64, I=128, N=16,
fp32) per module, its weights carried into the port by
``from_jax_params``; atol 1e-4 (fp32, the frameworks sum in another
order; measured differences are ~1e-6)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke
from repro.configs import get_arch
from repro.kernels.ssm_update import ssm_update_pallas
from repro.models import Model as JaxModel
from repro.models import ssm as jax_ssm
from repro.models.layers import mamba as jax_mamba
from repro.models.module import split
from repro_torch.configs import get_arch as port_get_arch
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_update as ssm_k
from repro_torch.models import Model
from repro_torch.models import ssm as port_ssm
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers import mamba as port_mamba
from repro_torch.models.transformer import layer_params

ATOL = 1e-4
KERNEL_TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.fixture(scope="module")
def pair(rules):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = reduced_for_smoke(get_arch("falcon-mamba-7b"))
    jm = JaxModel(cfg, rules=rules, dtype=jnp.float32, remat="none")
    jparams, _ = split(jm.init(jax.random.PRNGKey(0)))
    tm = Model(cfg, device="cpu")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    yield cfg, jm, jparams, tm, tparams
    torch.set_num_threads(n)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def _ssm_inputs(rng, Bt, I, N, S=None):
    """The inputs of ``tests/test_kernels.py::test_ssm_update_sweep``, with
    a token axis when S is given."""
    lead = (Bt,) if S is None else (Bt, S)
    return dict(
        h=rng.normal(size=(Bt, I, N)).astype(np.float32),
        dt=rng.uniform(0.01, 0.2, size=lead + (I,)).astype(np.float32),
        x=rng.normal(size=lead + (I,)).astype(np.float32),
        A=-rng.uniform(0.5, 2.0, size=(I, N)).astype(np.float32),
        B=rng.normal(size=lead + (N,)).astype(np.float32),
        C=rng.normal(size=lead + (N,)).astype(np.float32),
        d_skip=np.ones((I,), np.float32))


ORDER = ("h", "dt", "x", "A", "B", "C", "d_skip")


# ------------------------------------------------------------ kernel #6
@pytest.mark.parametrize("Bt,I,N", [(1, 64, 16), (2, 128, 8), (3, 96, 4)])
def test_ssm_update_plain_matches_pallas(Bt, I, N):
    a = _ssm_inputs(np.random.default_rng(Bt * 1000 + I), Bt, I, N)
    want = ssm_update_pallas(*(jnp.asarray(a[k]) for k in ORDER),
                             interpret=True)
    got = ssm_k.ssm_update_plain(*(torch.from_numpy(a[k]) for k in ORDER))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KERNEL_TOL)
    # into the state's own buffer (as the decode step runs it), via ops
    h = torch.from_numpy(a["h"].copy())
    h_new, y = ops.ssm_update(h, *(torch.from_numpy(a[k]) for k in ORDER[1:]),
                              h_out=h)
    assert h_new is h
    assert torch.equal(h, got[0]) and torch.equal(y, got[1])


def test_ssm_scan_plain_is_the_update_token_by_token():
    """The scan over S tokens, reading B and C as column views of one
    projection (as the Mamba1 layer passes them), equals S calls of the
    Pallas kernel that carry the state."""
    Bt, S, I, N = 2, 5, 96, 16
    a = _ssm_inputs(np.random.default_rng(3), Bt, I, N, S)
    proj = np.concatenate([np.zeros((Bt, S, 3), np.float32), a["B"], a["C"]],
                          -1)
    tproj = torch.from_numpy(proj)
    h = torch.from_numpy(a["h"].copy())
    y = ops.ssm_scan(h, torch.from_numpy(a["dt"]), torch.from_numpy(a["x"]),
                     torch.from_numpy(a["A"]), tproj[..., 3:3 + N],
                     tproj[..., 3 + N:], torch.from_numpy(a["d_skip"]))
    hj = jnp.asarray(a["h"])
    for t in range(S):
        hj, yj = ssm_update_pallas(hj, a["dt"][:, t], a["x"][:, t], a["A"],
                                   a["B"][:, t], a["C"][:, t], a["d_skip"],
                                   interpret=True)
        np.testing.assert_allclose(y[:, t].numpy(), np.asarray(yj),
                                   **KERNEL_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **KERNEL_TOL)


def test_ssm_update_cuda_refuses_cpu_tensors():
    for S in (None, 2):
        a = _ssm_inputs(np.random.default_rng(0), 1, 64, 16, S)
        args = [torch.from_numpy(a[k]) for k in ORDER]
        fn = ssm_k.ssm_update_cuda if S is None else ssm_k.ssm_scan_cuda
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)


# ------------------------------------------------------------ the layer
def test_mamba1_layer_matches_jax(pair):
    cfg, jm, jparams, tm, tparams = pair
    bp_j = jax.tree.map(lambda a: a[0], jparams["blocks"]["m"])
    bp_t = layer_params(tparams["blocks"], 0)["m"]
    x = np.random.default_rng(5).normal(size=(2, 13, cfg.d_model)).astype(
        np.float32)
    jout, (jconv, jssm) = jax_mamba.apply_mamba1(bp_j, jnp.asarray(x),
                                                 jm.h.mamba, jm.rules)
    tout, (tconv, tssm) = port_mamba.apply_mamba1(bp_t, torch.from_numpy(x),
                                                  tm.h.mamba)
    _close(tout, jout)
    _close(tconv, jconv)
    _close(tssm, jssm)
    # a decode step on those states
    x1 = np.random.default_rng(6).normal(size=(2, 1, cfg.d_model)).astype(
        np.float32)
    jout, (jconv, jssm) = jax_mamba.decode_mamba1_step(
        bp_j, jnp.asarray(x1), jm.h.mamba, jm.rules, conv_state=jconv,
        ssm_state=jssm)
    tout, (tconv, tssm2) = port_mamba.decode_mamba1_step(
        bp_t, torch.from_numpy(x1), tm.h.mamba, conv_state=tconv,
        ssm_state=tssm)
    assert tssm2 is tssm                  # the state is updated in place
    _close(tout, jout)
    _close(tconv, jconv)
    _close(tssm, jssm)


def test_causal_conv1d_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(12, 4)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32)
    for state in (None, st):
        jy, js = jax_mamba.causal_conv1d(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            None if state is None else jnp.asarray(state))
        ty, ts = port_mamba.causal_conv1d(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            None if state is None else torch.from_numpy(state))
        _close(ty, jy)
        _close(ts, js)


# ------------------------------------------------------------ the model
def test_ssm_forward_matches_jax(pair):
    cfg, jm, jparams, tm, tparams = pair
    toks = _tokens(cfg, (2, 21), 1)
    jout = jax_ssm.ssm_forward(jparams, jnp.asarray(toks), jm.h,
                               capture_hidden=True, emit_state=True)
    tout = port_ssm.ssm_forward(tparams, torch.from_numpy(toks), tm.h,
                                capture_hidden=True, emit_state=True)
    _close(tout["logits"], jout["logits"])
    _close(tout["hidden"], jout["hidden"])
    _close(tout["states"][0], jout["states"][0])
    _close(tout["states"][1], jout["states"][1])
    # the facade's prefill: last position only, the same states
    pre = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(pre["logits"], tout["logits"][:, -1:])
    assert torch.equal(pre["states"][1], tout["states"][1])
    assert pre["hidden"] is None


def test_ssm_decode_steps_match_jax(pair):
    cfg, jm, jparams, tm, tparams = pair
    toks = _tokens(cfg, (2, 11), 4)
    jout = jm.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tout = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    jc = {"conv": jout["states"][0], "ssm": jout["states"][1],
          "lengths": jnp.asarray([11, 11], jnp.int32)}
    tc = {"conv": tout["states"][0], "ssm": tout["states"][1],
          "lengths": torch.tensor([11, 11], dtype=torch.int32)}
    tok = np.asarray(jnp.argmax(jout["logits"][:, -1], -1),
                     np.int64)[:, None]
    for _ in range(3):
        jl, jc, jh = jm.decode_step_full(jparams, jc, jnp.asarray(tok))
        tl, tc, th = tm.decode_step_full(tparams, tc, torch.from_numpy(tok))
        _close(tl, jl)
        _close(th, jh)
        _close(tc["conv"], jc["conv"])
        _close(tc["ssm"], jc["ssm"])
        assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int64)[:, None]
        assert torch.equal(torch.argmax(tl[:, -1], -1),
                           torch.from_numpy(tok[:, 0]))


def test_ssm_restore_states_matches_jax(pair):
    """ssm-rescan from the captured hidden states gives the prefill's own
    states (bitwise: the same calls on the same inputs) and the JAX
    package's rescan."""
    cfg, jm, jparams, tm, tparams = pair
    toks = _tokens(cfg, (1, 17), 8)
    tout = port_ssm.ssm_forward(tparams, torch.from_numpy(toks), tm.h,
                                capture_hidden=True, emit_state=True)
    conv, ssm = tm.restore_ssm_states(tparams, tout["hidden"])
    assert torch.equal(conv, tout["states"][0])
    assert torch.equal(ssm, tout["states"][1])
    jconv, jssm = jax_ssm.ssm_restore_states(
        jparams, jnp.asarray(tout["hidden"].numpy()), jm.h)
    _close(conv, jconv)
    _close(ssm, jssm)


# ----------------------------------------------------- weights, facade
def test_convert_requires_every_ssm_key(pair):
    cfg, _, jparams, _, _ = pair
    for path in (("blocks", "m", "a_log"), ("blocks", "ln", "scale"),
                 ("embed", "unembed")):
        tree = jax.tree.map(np.asarray, jparams)
        node = tree
        for key in path[:-1]:
            node = node[key]
        del node[path[-1]]
        with pytest.raises(KeyError, match="/".join(path)):
            from_jax_params(tree, cfg, device="cpu")


def test_convert_keeps_a_log_fp32(pair):
    cfg, _, jparams, _, _ = pair
    p = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu",
                        dtype=torch.bfloat16)
    assert p["blocks"]["m"]["a_log"].dtype == torch.float32
    assert p["blocks"]["m"]["in_proj"].dtype == torch.bfloat16


def test_ssm_facade_caches_and_flags(pair):
    cfg, jm, _, tm, _ = pair
    m = tm.h.mamba
    cache = tm.init_cache(3, 999)
    assert cache["conv"].shape == (cfg.n_layers, 3, m.d_conv - 1, m.d_inner)
    assert cache["conv"].dtype == tm.dtype
    assert cache["ssm"].shape == (cfg.n_layers, 3, m.d_inner, m.d_state)
    assert cache["ssm"].dtype == torch.float32
    assert cache["lengths"].dtype == torch.int32
    with pytest.raises(NotImplementedError, match="lm-family"):
        tm.init_paged_cache(2, 8, 16, 4)
    flags = ("chunkable", "supports_resume", "supports_paged",
             "supports_recompute", "kv_names", "n_state_blobs")
    assert ([getattr(tm.adapter, f) for f in flags]
            == [getattr(jm.adapter, f) for f in flags])
    with pytest.raises(ValueError, match="no K/V"):
        tm.adapter.prefill_kv({}, 0)


def test_full_size_config_is_registered():
    cfg = port_get_arch("falcon-mamba-7b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.vocab_size,
            cfg.ssm_state, cfg.ssm_expand * cfg.d_model) == (
                "ssm", 64, 4096, 65024, 16, 8192)
    assert (dataclasses.asdict(cfg)
            == dataclasses.asdict(get_arch("falcon-mamba-7b")))


def test_random_init_runs_on_the_cpu(pair):
    cfg, _, _, tm, tparams = pair
    params = tm.init(0)
    assert (jax.tree.map(lambda t: (tuple(t.shape), t.dtype), params)
            == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tparams))
    out = tm.prefill(params, {"tokens": torch.from_numpy(
        _tokens(cfg, (1, 6), 2))})
    assert bool(out["logits"].isfinite().all())
