"""The port's training path for the MoE and VLM stacks against the JAX
package's, on the same inputs (the dense configs are in
``test_torch_training.py``, whose tolerances and leaf rules hold here).

granite-moe-1b-a400m and grok-1-314b (softcapped attention) add the
GShard load-balance aux of every MoE layer to the loss
(``Trainer.aux_weight``); internvl2-26b's batch carries patch embeddings
(2, 4, D) x 0.02 in place of its first four tokens'. Loss, ce, aux, every
gradient leaf, three AdamW steps and the forward logits are held against
the JAX ``Trainer`` in fp32.

A token whose k-th and (k+1)-th router probabilities (or first and
second, which pick the aux's top-1 expert) lie within the frameworks'
rounding of each other can be routed differently in the two: its
experts, and the gradients through them, then differ by a whole expert's
contribution, and the comparison is ill-posed. The tests assert that no
token of the batch lies within ROUTER_MARGIN of such a tie
(``_assert_off_router_ties``), as the dense tests assert for relu kinks.

The helpers here (``make_pair``, ``check_*``) also serve the recurrent
and enc-dec families' files."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.configs import get_arch as jax_arch
from repro.models import Model as JaxModel
from repro.training import AdamWConfig as JaxAdamW
from repro.training import Trainer as JaxTrainer
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.configs import get_arch
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params, from_jax_train_state
from repro_torch.models.layers import moe
from repro_torch.training import AdamWConfig, Trainer
from repro_torch.training.tree import tree_paths
from test_torch_training import LEAF_REL, LOSS_RTOL, _close_leaf, _close_trees

ROUTER_MARGIN = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_pair(name, rules, *, frames=32):
    """(cfg, JAX trainer, JAX state, the port's trainer, numpy batch) of
    ``name``'s smoke config, seq 32, batch 2, seeded from 0: patches for
    a VLM, ``frames`` frame embeddings for an enc-dec."""
    jcfg = jax_reduced(jax_arch(name))
    jm = JaxModel(jcfg, rules=rules, model_axis=1, dtype=jnp.float32,
                  remat="full")
    jt = JaxTrainer(jm, rules, JaxAdamW(lr=1e-3), loss_chunks=4)
    jstate, _ = jt.init_state(jax.random.PRNGKey(0))
    cfg = reduced_for_smoke(get_arch(name))
    tt = Trainer(Model(cfg, device="cpu"), AdamWConfig(lr=1e-3),
                 loss_chunks=4)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 33))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patches"] = (rng.normal(size=(2, 4, cfg.d_model))
                            * 0.02).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = (rng.normal(size=(2, frames, cfg.d_model))
                           * 0.1).astype(np.float32)
    return cfg, jt, jstate, tt, batch


def jbatch(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
            for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_off_router_ties(monkeypatch, tt, params, batch):
    """Assert that every token's top-(K+1) router probabilities of every
    MoE layer are at least ROUTER_MARGIN apart at ranks 1/2 and K/K+1."""
    if not tt.model.cfg.n_experts:
        return
    gaps = []
    route = moe.route

    def spy(p, x, h):
        out = route(p, x, h)
        top = torch.topk(out[2], min(h.top_k + 1, h.n_experts), dim=-1)[0]
        gaps.append(float((top[..., 0] - top[..., 1]).min()))
        if h.top_k < h.n_experts:
            gaps.append(float((top[..., h.top_k - 1]
                               - top[..., h.top_k]).min()))
        return out

    monkeypatch.setattr(moe, "route", spy)
    with torch.no_grad():
        tt.model.forward(params, tbatch(batch), skip_logits=True)
    monkeypatch.undo()
    assert gaps and min(gaps) > ROUTER_MARGIN, gaps


def check_loss_and_grads(pair, monkeypatch):
    """Loss, ce, aux and every gradient leaf against ``jax.value_and_grad``
    of the JAX ``Trainer.loss_fn``; returns the port's gradients."""
    cfg, jt, jstate, tt, batch = pair
    (jl, jparts), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jstate["params"], jbatch(batch))
    tstate = from_jax_train_state(jax.tree.map(np.asarray, jstate), cfg,
                                  device="cpu")
    _assert_off_router_ties(monkeypatch, tt, tstate["params"], batch)
    loss, parts, grads = tt.value_and_grad(tstate["params"], tbatch(batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["ce"]), float(jparts["ce"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]),
                               rtol=LOSS_RTOL)
    assert not isinstance(parts["aux"], torch.Tensor) \
        or parts["aux"].grad_fn is None
    want = from_jax_params(jax.tree.map(np.asarray, jg), cfg, device="cpu")
    assert [p for p, _ in tree_paths(grads)] == \
        [p for p, _ in tree_paths(want)]
    _close_trees(grads, want)
    return grads


# Elements that ``check_three_steps`` holds only to Adam's step bound, per
# config: the counts it finds on a CPU with a quarter's margin, each
# within the tenth of all elements that ``test_torch_training.py`` allows
LOOSE_AT_MOST = {"granite-moe-1b-a400m": 15_458, "grok-1-314b": 802,
                 "internvl2-26b": 999, "falcon-mamba-7b": 1_172,
                 "zamba2-2.7b": 5_063, "whisper-medium": 19_915}
# the most of one zero-initialised leaf that the drift rule may loosen
DRIFT_SHARE = 0.25


def check_three_steps(pair, monkeypatch):
    """Three AdamW steps against the jitted JAX ``train_step``, under
    ``test_torch_training.py``'s rule for elements whose update direction
    the gradient comparison does not fix: elements whose gradient was
    within the tolerance of zero at some step are held only to Adam's step
    bound (2·lr a step). One more rule holds in zero-initialised leaves
    alone (zamba2's ``conv_b``), whose parameters after three steps are
    the steps themselves, so that LEAF_REL of them is below what fp32's
    rounding does to a step that Adam divides by a small gradient: there,
    elements whose gradient the two frameworks give so differently (the
    port's against the JAX ``loss_fn``'s at the same step) that lr times
    the summed relative differences exceeds half the parameter tolerance
    are held to the step bound too, at most DRIFT_SHARE of the leaf. The
    loose elements of a config number at most LOOSE_AT_MOST."""
    cfg, jt, jstate, tt, batch = pair
    tstate = from_jax_train_state(jax.tree.map(np.asarray, jstate), cfg,
                                  device="cpu")
    zero = {p: not bool(v.any()) for p, v in tree_paths(tstate["params"])}
    step = jax.jit(jt.train_step)
    jgrad = jax.jit(jax.grad(lambda p, b: jt.loss_fn(p, b)[0]))
    near, drift = {}, {}
    for _ in range(3):
        _assert_off_router_ties(monkeypatch, tt, tstate["params"], batch)
        _, _, grads = tt.value_and_grad(tstate["params"], tbatch(batch))
        jg = dict(tree_paths(from_jax_params(
            jax.tree.map(np.asarray, jgrad(jstate["params"], jbatch(batch))),
            cfg, device="cpu")))
        for p, g in tree_paths(grads):
            n = (g != 0) & (g.abs() < LEAF_REL * g.abs().max())
            d = ((g - jg[p]).abs() / jg[p].abs()).nan_to_num(0.0)
            near[p] = near[p] | n if p in near else n
            drift[p] = drift[p] + d if p in drift else d
        jstate, jm = step(jstate, jbatch(batch))
        tstate, tm = tt.train_step(tstate, tbatch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    want = dict(tree_paths(from_jax_train_state(
        jax.tree.map(np.asarray, jstate), cfg, device="cpu")["params"]))
    assert int(tstate["opt"]["step"]) == 3
    n_loose = n_all = 0
    for path, got in tree_paths(tstate["params"]):
        err = (got - want[path]).abs()
        tol = LEAF_REL * float(want[path].abs().max())
        loose = near[path]
        if zero[path]:
            drifted = tt.opt.lr * drift[path] > tol / 2
            assert float(drifted.float().mean()) <= DRIFT_SHARE, path
            loose = loose | drifted
        assert float(err[~loose].max()) <= tol, path
        assert float(err.max()) <= 2 * 3 * tt.opt.lr, path
        n_loose, n_all = n_loose + int(loose.sum()), n_all + err.numel()
    assert n_loose <= min(LOOSE_AT_MOST[cfg.name], 0.1 * n_all), \
        (n_loose, n_all)


def check_logits(pair):
    """The forward logits (and aux) against the JAX model's forward."""
    cfg, jt, jstate, tt, batch = pair
    jout = jt.model.forward(jstate["params"], jbatch(batch))
    tparams = from_jax_params(jax.tree.map(np.asarray, jstate["params"]),
                              cfg, device="cpu")
    tout = tt.model.forward(tparams, tbatch(batch))
    _close_leaf("logits", tout["logits"], jout["logits"])
    np.testing.assert_allclose(float(tout["aux"]), float(jout["aux"]),
                               rtol=LOSS_RTOL)
    return tout


CONFIGS = ("granite-moe-1b-a400m", "grok-1-314b", "internvl2-26b")


@pytest.fixture(scope="module", params=CONFIGS)
def pair(request, rules):
    return make_pair(request.param, rules)


def test_loss_aux_and_every_gradient_match_jax(pair, monkeypatch):
    cfg = pair[0]
    grads = check_loss_and_grads(pair, monkeypatch)
    blocks = grads["blocks"]
    for li in range(cfg.n_layers):
        for w in ("wq", "wk", "wv"):      # through kernel #5's backward
            assert torch.count_nonzero(blocks["attn"][w][li]) > 0, (w, li)
        if cfg.n_experts:                 # through the combine and the aux
            g = blocks["moe"]["router"][li]
            assert bool(g.isfinite().all()) and torch.count_nonzero(g) > 0


def test_three_train_steps_match_jax(pair, monkeypatch):
    check_three_steps(pair, monkeypatch)


def test_forward_logits_match_jax(pair):
    tout = check_logits(pair)
    if pair[0].n_experts:
        assert float(tout["aux"]) > 0
    else:
        assert tout["aux"] == 0.0


def test_patches_reach_the_loss():
    """A VLM's patch embeddings enter the training forward: other patches
    give another loss, the same patches the same loss bit for bit."""
    cfg = reduced_for_smoke(get_arch("internvl2-26b"))
    tt = Trainer(Model(cfg, device="cpu"), AdamWConfig(lr=1e-3))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 17))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "patches": (rng.normal(size=(2, 4, cfg.d_model))
                         * 0.02).astype(np.float32)}
    params = tt.init_state(0)["params"]
    with torch.no_grad():
        a = tt.loss_fn(params, tbatch(batch))[0]
        b = tt.loss_fn(params, tbatch(batch))[0]
        moved = dict(batch, patches=batch["patches"] * 3)
        c = tt.loss_fn(params, tbatch(moved))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_moe_recompute_routes_as_the_forward(monkeypatch):
    """Under activation checkpointing each MoE layer's routing runs twice,
    in the forward and in backward's recompute: both must pick the same
    slots, or the gradient silently belongs to another routing. The
    layers' slots in recompute order mirror the forward's."""
    cfg = reduced_for_smoke(get_arch("granite-moe-1b-a400m"))
    tt = Trainer(Model(cfg, device="cpu"), AdamWConfig(lr=1e-3),
                 loss_chunks=4)
    state = tt.init_state(0)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 33))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    slots = []
    route = moe.route

    def spy(p, x, h):
        out = route(p, x, h)
        slots.append(out[1].clone())
        return out

    monkeypatch.setattr(moe, "route", spy)
    _, parts, _ = tt.value_and_grad(state["params"], tbatch(batch))
    L = cfg.n_layers
    assert len(slots) == 2 * L
    for li in range(L):
        assert torch.equal(slots[li], slots[2 * L - 1 - li]), li
    assert float(parts["aux"]) > 0
