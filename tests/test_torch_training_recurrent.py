"""The port's training path for the recurrent families (falcon-mamba-7b,
ssm; zamba2-2.7b, hybrid) and kernel #6 under autograd against the JAX
package's, on the same inputs, under ``test_torch_training.py``'s
tolerances (fp32: a loss within a relative 1e-5, each gradient leaf
within 1e-4 of its largest magnitude).

``SSMScanFn`` (``kernels/ssm_update.py``) passes
``torch.autograd.gradcheck`` in float64 across chunk boundaries (the
chunk cut to 3 tokens), and the Mamba1 layer's gradients under it match
``jax.grad`` of the reference's ``apply_mamba1`` (its own remat chunks of
128) at S = 1, 127, 128 and 300. Serving never reaches it: prefill and
decode outputs carry no ``grad_fn``. The Mamba2 block masks its segment
sums before the exp, where the reference masks after: its gradients stay
finite where the reference's turn NaN."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.configs import get_arch as jax_arch
from repro.models import Model as JaxModel
from repro.models.layers import mamba as jax_mamba
from repro.models.module import split
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_update as ssu
from repro_torch.models import Model
from repro_torch.models.layers import mamba as port_mamba
from repro_torch.models.transformer import layer_params
from test_torch_training import _close_leaf
from test_torch_training_lm_families import (check_logits,
                                             check_loss_and_grads,
                                             check_three_steps, make_pair)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ kernel #6 under autograd
def _scan_inputs(rng, Bt, S, I, N, dtype=np.float64):
    return [torch.from_numpy(a.astype(dtype)) for a in (
        rng.normal(size=(Bt, I, N)),                    # h0
        rng.uniform(0.01, 0.3, size=(Bt, S, I)),        # dt
        rng.normal(size=(Bt, S, I)),                    # x
        -rng.uniform(0.5, 2.0, size=(I, N)),            # A
        rng.normal(size=(Bt, S, N)),                    # B
        rng.normal(size=(Bt, S, N)),                    # C
        rng.normal(size=(I,)))]                         # d_skip


def test_ssm_scan_fn_gradcheck(monkeypatch):
    """Float64 gradients of y and the final state with respect to every
    input, 7 tokens in chunks of 3 (the last one partial)."""
    monkeypatch.setattr(ssu, "CHUNK", 3)
    inputs = [t.requires_grad_(True)
              for t in _scan_inputs(np.random.default_rng(0), 2, 7, 3, 4)]
    assert torch.autograd.gradcheck(ssu.SSMScanFn.apply, inputs)


@pytest.mark.parametrize("S", [1, 5, 6, 7])
def test_ssm_scan_fn_forward_is_the_scan(monkeypatch, S):
    """The chunked forward gives the one-pass scan's y and final state bit
    for bit, and leaves h0 as it was."""
    monkeypatch.setattr(ssu, "CHUNK", 3)
    args = _scan_inputs(np.random.default_rng(S), 2, S, 5, 4, np.float32)
    h0 = args[0].clone()
    y, h = ssu.SSMScanFn.apply(*args)
    h_ref = h0.clone()
    y_ref = ssu.ssm_scan_plain(h_ref, *args[1:])
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
    assert torch.equal(args[0], h0)


@pytest.fixture(scope="module")
def mamba1(rules):
    """Layer 0 of the JAX falcon-mamba-7b smoke model (d=64, I=128, N=16)
    as numpy, its hyper-parameters in both packages."""
    cfg = jax_reduced(jax_arch("falcon-mamba-7b"))
    jm = JaxModel(cfg, rules=rules, dtype=jnp.float32, remat="none")
    jparams, _ = split(jm.init(jax.random.PRNGKey(0)))
    jp = jax.tree.map(lambda a: np.asarray(a[0]), jparams["blocks"]["m"])
    th = Model(reduced_for_smoke(get_arch("falcon-mamba-7b")),
               device="cpu").h.mamba
    return jm.h.mamba, jp, th


@pytest.mark.parametrize("S", [1, 127, 128, 300])
def test_mamba1_gradients_match_jax(mamba1, rules, monkeypatch, S):
    """Every parameter's, the input's and the initial state's gradient of
    a loss over the layer's output and final state, against ``jax.grad``;
    S = 300 is three chunks, the last partial."""
    jh, jp, th = mamba1
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, jh.d_model)).astype(np.float32)
    h0 = rng.normal(size=(2, jh.d_inner, jh.d_state)).astype(np.float32)
    cy = rng.normal(size=(2, S, jh.d_model)).astype(np.float32)
    ch = rng.normal(size=(2, jh.d_inner, jh.d_state)).astype(np.float32)

    def jf(p, xx, hh):
        y, (_, h) = jax_mamba.apply_mamba1(p, xx, jh, rules, init_state=hh)
        return jnp.sum(y * cy) + jnp.sum(h * ch)

    jgp, jgx, jgh = jax.grad(jf, argnums=(0, 1, 2))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jnp.asarray(h0))
    calls = []
    scan = ops.ssm_scan_autograd
    monkeypatch.setattr(ops, "ssm_scan_autograd",
                        lambda *a: calls.append(1) or scan(*a))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in jp.items()}
    tx = torch.tensor(x, requires_grad=True)
    th0 = torch.tensor(h0, requires_grad=True)
    y, (_, h) = port_mamba.apply_mamba1(tp, tx, th, init_state=th0)
    ((y * torch.from_numpy(cy)).sum() + (h * torch.from_numpy(ch)).sum()
     ).backward()
    assert calls == [1]
    assert torch.equal(th0.detach(), torch.from_numpy(h0))   # not written
    _close_leaf("dx", tx.grad, jgx)
    _close_leaf("dh0", th0.grad, jgh)
    for k in jp:
        _close_leaf(f"d{k}", tp[k].grad, jgp[k])
        assert torch.count_nonzero(tp[k].grad) > 0, k


def test_scan_routes_through_autograd_only_when_needed(monkeypatch):
    """The serving twin of ``test_attention_routes_through_autograd_only_
    when_needed``: the layer takes ``SSMScanFn`` only with grad enabled
    and an input that requires grad; the model's prefill and decode never
    do, and their outputs carry no ``grad_fn``."""
    calls = []
    scan = ops.ssm_scan_autograd
    monkeypatch.setattr(ops, "ssm_scan_autograd",
                        lambda *a: calls.append(1) or scan(*a))
    cfg = reduced_for_smoke(get_arch("falcon-mamba-7b"))
    model = Model(cfg, device="cpu")
    params = model.init(0)
    p = layer_params(params["blocks"], 0)["m"]
    x = torch.randn(1, 9, cfg.d_model)
    assert port_mamba.apply_mamba1(p, x, model.h.mamba)[0].grad_fn is None
    x.requires_grad_(True)
    with torch.no_grad():
        assert port_mamba.apply_mamba1(p, x, model.h.mamba)[0].grad_fn \
            is None
    assert calls == []
    out = port_mamba.apply_mamba1(p, x, model.h.mamba)[0]
    assert out.grad_fn is not None and calls == [1]
    calls.clear()
    toks = torch.from_numpy(np.arange(12)[None] % cfg.vocab_size)
    pre = model.prefill(params, {"tokens": toks})
    assert pre["logits"].grad_fn is None
    conv, ssm = pre["states"]
    cache = {"conv": conv.clone(), "ssm": ssm.clone(),
             "lengths": torch.tensor([12])}
    before = cache["ssm"].clone()
    lg, cache, hidden = model.decode_step_full(params, cache, toks[:, :1])
    assert lg.grad_fn is None and hidden.grad_fn is None
    assert not torch.equal(cache["ssm"], before)     # updated in place
    assert calls == []


def test_mamba2_gradients_stay_finite_where_the_reference_overflows(rules):
    """With |A| = 1000 the segment sums above the diagonal reach ~1e3 and
    overflow fp32 in the exp: the reference's ``jax.grad`` is NaN there,
    the port's gradient finite, and the outputs agree."""
    cfg = jax_reduced(jax_arch("zamba2-2.7b"))
    jm = JaxModel(cfg, rules=rules, dtype=jnp.float32, remat="none")
    jparams, _ = split(jm.init(jax.random.PRNGKey(0)))
    jp = jax.tree.map(lambda a: np.asarray(a[0, 0]), jparams["mamba"]["m"])
    jp["a_log"] = np.full_like(jp["a_log"], np.log(1000.0))
    th = Model(reduced_for_smoke(get_arch("zamba2-2.7b")),
               device="cpu").h.mamba
    x = np.random.default_rng(3).normal(
        size=(2, 40, cfg.d_model)).astype(np.float32)

    def jf(p):
        return jnp.sum(jax_mamba.apply_mamba2(p, jnp.asarray(x), jm.h.mamba,
                                              rules)[0])

    jy = jax.jit(lambda p: jax_mamba.apply_mamba2(
        p, jnp.asarray(x), jm.h.mamba, rules)[0])(
        jax.tree.map(jnp.asarray, jp))
    jg = jax.jit(jax.grad(jf))(jax.tree.map(jnp.asarray, jp))
    assert np.isnan(np.asarray(jg["a_log"])).any()
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in jp.items()}
    ty = port_mamba.apply_mamba2(tp, torch.from_numpy(x), th)[0]
    ty.sum().backward()
    _close_leaf("y", ty, jy)
    for k, t in tp.items():
        assert bool(t.grad.isfinite().all()), k
    assert torch.count_nonzero(tp["a_log"].grad) > 0


# ------------------------------------------------- loss, grads, steps
CONFIGS = ("falcon-mamba-7b", "zamba2-2.7b")


@pytest.fixture(scope="module", params=CONFIGS)
def pair(request, rules):
    return make_pair(request.param, rules)


def test_loss_and_every_gradient_match_jax(pair, monkeypatch):
    cfg = pair[0]
    grads = check_loss_and_grads(pair, monkeypatch)
    if cfg.family == "ssm":     # through SSMScanFn's backward only
        m = grads["blocks"]["m"]
        for k in ("a_log", "dt_proj", "x_proj", "conv_w"):
            for li in range(cfg.n_layers):
                assert torch.count_nonzero(m[k][li]) > 0, (k, li)
    else:
        a_log = grads["mamba"]["m"]["a_log"]
        assert bool((a_log.flatten(0, 1).abs().amax(-1) > 0).all())
        for w in ("wq", "wk", "wv"):  # through kernel #5's backward
            for s in range(grads["attn"]["attn"][w].shape[0]):
                assert torch.count_nonzero(grads["attn"]["attn"][w][s]) > 0


def test_three_train_steps_match_jax(pair, monkeypatch):
    check_three_steps(pair, monkeypatch)


def test_forward_logits_match_jax(pair):
    assert check_logits(pair)["aux"] == 0.0
