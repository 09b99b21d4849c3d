"""The port's training path against the JAX package's, on the same inputs.

Seeded numpy inputs go through both packages in fp32; parameters and
train states are carried across with ``from_jax_params`` /
``from_jax_train_state``. Tolerances (fp32; the frameworks sum in other
orders): a loss within a relative 1e-5; each gradient leaf, and each
parameter leaf after AdamW steps, within 1e-4 of that leaf's largest
magnitude (``_close_leaf``); kernel #5's gradients within 1e-5 of their
largest magnitude against float64 autograd through a naive attention,
and within 1e-4 against ``jax.grad`` of the JAX package's
``flash_attention_jnp``. The batch is drawn from seed 0; for opt-30b's
relu the tests first assert that no pre-activation lies within 1e-5 of
zero (``_assert_off_relu_kinks``), where the comparison is ill-posed.
After AdamW steps, an element whose gradient was at some step within the
gradient tolerance of zero (below 1e-4 of its leaf's largest) has an
update direction that tolerance does not fix (Adam divides by the
gradient's own size): such elements are held only to Adam's step bound,
2·lr per step (``test_three_train_steps_match_jax``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.configs import get_arch as jax_arch
from repro.models import Model as JaxModel
from repro.models.layers.attention import AttnHyper as JaxAttnHyper
from repro.models.layers.attention import flash_attention_jnp
from repro.training import AdamWConfig as JaxAdamW
from repro.training import Trainer as JaxTrainer
from repro.training import chunked_ce_loss as jax_ce
from repro.training.optimizer import adamw_update as jax_adamw
from repro.training.optimizer import init_opt_state as jax_init_opt
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params, from_jax_train_state
from repro_torch.models.layers import attention as tattn
from repro_torch.training import AdamWConfig, Trainer, chunked_ce_loss
from repro_torch.training.optimizer import adamw_update, init_opt_state
from repro_torch.training.tree import tree_paths

LOSS_RTOL = 1e-5
LEAF_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close_leaf(name, got, want, rel=LEAF_REL):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max abs err {err} > {rel} x {scale}"


def _close_trees(got: dict, want: dict, rel=LEAF_REL):
    got_p, want_p = tree_paths(got), dict(tree_paths(want))
    for path, leaf in got_p:
        _close_leaf(path, leaf, want_p[path], rel)


# ------------------------------------------------------ chunked CE loss
@pytest.mark.parametrize("softcap,vocab,tie", [(None, 256, False),
                                               (30.0, 200, False),
                                               (None, 200, True)])
def test_chunked_ce_loss_and_grads_match_jax(rules, softcap, vocab, tie):
    rng = np.random.default_rng(0)
    B, S, D, Vp = 2, 24, 32, 256
    embed = {"table": rng.normal(size=(Vp, D)).astype(np.float32) * 0.3}
    if not tie:
        embed["unembed"] = rng.normal(size=(D, Vp)).astype(np.float32) * 0.3
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    tgt = rng.integers(0, vocab, (B, S))

    def jloss(e, xx):
        return jax_ce(e, xx, jnp.asarray(tgt, jnp.int32), rules,
                      softcap=softcap, true_vocab=vocab, n_chunks=4)

    jl, (jge, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, embed), jnp.asarray(x))
    te = {k: _t(v).requires_grad_(True) for k, v in embed.items()}
    tx = _t(x).requires_grad_(True)
    tl = chunked_ce_loss(te, tx, torch.from_numpy(tgt), softcap=softcap,
                         true_vocab=vocab, n_chunks=4)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=LOSS_RTOL)
    _close_leaf("d/dfinal_x", tx.grad, jgx)
    head = "table" if tie else "unembed"
    _close_leaf(f"d/d{head}", te[head].grad, jge[head])
    if not tie:              # the input table takes no part in the loss
        assert te["table"].grad is None and not np.any(jge["table"])
    if vocab < Vp:           # padded columns take no gradient
        pad = te["unembed"].grad[:, vocab:] if not tie \
            else te["table"].grad[vocab:]
        assert torch.count_nonzero(pad) == 0


# -------------------------------------------- kernel #5 under autograd
def _visible(qo, kl, Sq, Skv, causal, window):
    """(B, Sq, Skv) bool: which keys each query row sees."""
    qp = qo[:, None, None] + np.arange(Sq)[None, :, None]
    kp = np.arange(Skv)[None, None, :]
    ok = kp < kl[:, None, None]
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    return ok


def _naive(q, k, v, ok, softcap):
    """Dense attention in q's dtype; rows that see no key give zero."""
    B, Sq, H, hd = q.shape
    g = H // k.shape[2]
    kk = k.repeat_interleave(g, 2)
    vv = v.repeat_interleave(g, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * hd ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    okt = torch.from_numpy(ok)[:, None]
    s = torch.where(okt, s, torch.tensor(float("-inf"), dtype=s.dtype))
    p = torch.softmax(s, dim=-1)
    p = torch.where(okt.any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv)


FLASH_CASES = {   # B, Sq, Skv, H, Kv, hd, offsets, kv_lens, causal, window, softcap
    "causal": (2, 40, 40, 4, 4, 16, (0, 0), (40, 40), True, None, None),
    "gqa window softcap": (2, 40, 40, 4, 2, 16, (0, 0), (40, 40), True, 8,
                           20.0),
    "hd80 gqa": (1, 33, 33, 6, 2, 80, (0,), (33,), True, None, None),
    "offset kv_len": (2, 24, 60, 4, 2, 16, (36, 20), (60, 44), True, None,
                      None),
    "masked rows": (2, 24, 60, 4, 1, 16, (50, 10), (30, 34), True, 6, 10.0),
    "non-causal": (2, 20, 36, 4, 2, 16, (0, 0), (36, 30), False, None, None),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_grads(case):
    B, Sq, Skv, H, Kv, hd, offs, lens, causal, window, softcap = \
        FLASH_CASES[case]
    rng = np.random.default_rng(7)
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Kv, hd)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Kv, hd)).astype(np.float32)
    dout = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    qo, kl = np.asarray(offs), np.asarray(lens)
    ok = np.broadcast_to(_visible(qo, kl, Sq, Skv, causal, window),
                         (B, Sq, Skv)).copy()
    live = ok.any(-1)                                      # (B, Sq)
    if case == "masked rows":
        assert not live.all() and live.any()
    dout = dout * live[:, :, None, None]
    # the port: FlashAttentionFn (plain forward on the CPU), plain backward
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.FlashAttentionFn.apply(
        tq, tk, tv, torch.tensor(offs, dtype=torch.int32),
        torch.tensor(lens, dtype=torch.int32), causal, softcap, window)
    out.backward(_t(dout))
    # float64 autograd through dense attention
    nq, nk, nv = (torch.from_numpy(a.astype(np.float64)).requires_grad_(True)
                  for a in (q, k, v))
    ref = _naive(nq, nk, nv, ok, softcap)
    ref.backward(torch.from_numpy(dout.astype(np.float64)))
    _close_leaf("out", out, ref.detach().numpy(), 1e-5)
    for name, got, want in (("dq", tq, nq), ("dk", tk, nk), ("dv", tv, nv)):
        _close_leaf(name, got.grad, want.grad.numpy(), 1e-5)
        assert torch.count_nonzero(got.grad) > 0
    assert torch.count_nonzero(tq.grad[torch.from_numpy(~live)]) == 0
    # jax.grad of the JAX package's jnp attention, on the rows that see a
    # key (the cotangent is zero elsewhere; the jnp version does not zero
    # a row that sees nothing)
    h = JaxAttnHyper(n_heads=H, n_kv_heads=Kv, head_dim=hd, padded_heads=H,
                     attn_softcap=softcap, chunk=16)
    qpos = jnp.asarray(qo[:, None] + np.arange(Sq)[None, :])
    w = None if window is None else jnp.asarray(window)

    def jf(a, b, c):
        o = flash_attention_jnp(a, b, c, h, q_positions=qpos, causal=causal,
                                window=w, kv_len=jnp.asarray(kl))
        return jnp.sum(o * dout)

    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    for name, got, want in zip(("dq", "dk", "dv"), (tq, tk, tv), jg):
        _close_leaf(f"{name} vs jax", got.grad, want)


def test_attention_routes_through_autograd_only_when_needed():
    h = tattn.AttnHyper(n_heads=4, n_kv_heads=2, head_dim=16)
    q = torch.randn(1, 8, 4, 16)
    k, v = torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2, 16)
    assert tattn.flash_attention(q, k, v, h, q_offset=0,
                                 causal=True).grad_fn is None
    q.requires_grad_(True)
    with torch.no_grad():
        assert tattn.flash_attention(q, k, v, h, q_offset=0,
                                     causal=True).grad_fn is None
    out = tattn.flash_attention(q, k, v, h, q_offset=0, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"


# ------------------------------------------------- loss, grads, steps
CONFIGS = ("qwen2-7b", "gemma2-9b", "opt-30b")


@pytest.fixture(scope="module", params=CONFIGS)
def pair(request, rules):
    name = request.param
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
    return cfg, jt, jstate, tt, batch


RELU_MARGIN = 1e-6


def _assert_off_relu_kinks(monkeypatch, tt, params, batch):
    """A relu pre-activation within the two frameworks' rounding of zero
    opens its gate on one side only, and the gradients then differ by
    that unit's whole contribution: the comparison is ill-posed there.
    Assert that no pre-activation of this batch lies within RELU_MARGIN
    of zero (opt-30b's relu; the GLU configs have no kink)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers.mlp import apply_mlp
    if tt.model.cfg.ffn_activation != "relu":
        return
    low = []

    def spy(p, x, act):
        low.append(float(torch.matmul(x, p["w_up"]).abs().min()))
        return apply_mlp(p, x, act)

    monkeypatch.setattr(tfm, "apply_mlp", spy)
    with torch.no_grad():
        tt.model.forward(params, _tbatch(batch), skip_logits=True)
    monkeypatch.undo()
    assert min(low) > RELU_MARGIN, low


def _jbatch(batch):
    return {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_loss_and_every_gradient_match_jax(pair, monkeypatch):
    cfg, jt, jstate, tt, batch = pair
    (jl, jparts), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jstate["params"], _jbatch(batch))
    np_state = jax.tree.map(np.asarray, jstate)
    tstate = from_jax_train_state(np_state, cfg, device="cpu")
    _assert_off_relu_kinks(monkeypatch, tt, tstate["params"], batch)
    loss, parts, grads = tt.value_and_grad(tstate["params"], _tbatch(batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["ce"]), float(jparts["ce"]),
                               rtol=LOSS_RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, jg), cfg, device="cpu")
    assert [p for p, _ in tree_paths(grads)] == \
        [p for p, _ in tree_paths(want)]
    _close_trees(grads, want)
    # the attention projections get their gradient through kernel #5
    for w in ("wq", "wk", "wv"):
        g = grads["blocks"]["attn"][w]
        for li in range(cfg.n_layers):
            assert torch.count_nonzero(g[li]) > 0, (w, li)


def test_three_train_steps_match_jax(pair, monkeypatch):
    cfg, jt, jstate, tt, batch = pair
    tstate = from_jax_train_state(jax.tree.map(np.asarray, jstate), cfg,
                                  device="cpu")
    step = jax.jit(jt.train_step)
    loose = None         # elements with a gradient within LEAF_REL of 0
    for i in range(3):
        _assert_off_relu_kinks(monkeypatch, tt, tstate["params"], batch)
        _, _, grads = tt.value_and_grad(tstate["params"], _tbatch(batch))
        near = {p: (g != 0) & (g.abs() < LEAF_REL * g.abs().max())
                for p, g in tree_paths(grads)}
        loose = near if loose is None else {p: loose[p] | near[p]
                                            for p in near}
        jstate, jm = step(jstate, _jbatch(batch))
        tstate, tm = tt.train_step(tstate, _tbatch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    want = dict(tree_paths(from_jax_train_state(
        jax.tree.map(np.asarray, jstate), cfg, device="cpu")["params"]))
    assert int(tstate["opt"]["step"]) == 3
    n_loose = n_all = 0
    for path, got in tree_paths(tstate["params"]):
        err = (got - want[path]).abs()
        ok = ~loose[path]
        assert float(err[ok].max()) <= LEAF_REL * float(
            want[path].abs().max()), path
        assert float(err.max()) <= 2 * 3 * tt.opt.lr, path
        n_loose, n_all = n_loose + int((~ok).sum()), n_all + ok.numel()
    assert n_loose <= 0.1 * n_all, (n_loose, n_all)


def test_forward_logits_match_jax(pair, rules):
    cfg, jt, jstate, tt, batch = pair
    jout = jt.model.forward(jstate["params"], _jbatch(batch))
    tparams = from_jax_params(jax.tree.map(np.asarray, jstate["params"]),
                              cfg, device="cpu")
    tout = tt.model.forward(tparams, _tbatch(batch))
    _close_leaf("logits", tout["logits"], jout["logits"])
    assert tout["aux"] == 0.0


# ------------------------------------------------------------- AdamW
@pytest.mark.parametrize("error_feedback", [False, True])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])    # unclipped, clipped
def test_adamw_update_matches_jax(error_feedback, grad_scale):
    rng = np.random.default_rng(11)
    shapes = {"a": (8, 16), "b": {"c": (16,), "d": (3, 4, 5)}}

    def tree(scale):
        def draw(s):
            return s if isinstance(s, dict) else \
                (rng.normal(size=s) * scale).astype(np.float32)
        return {k: ({kk: draw(vv) for kk, vv in v.items()}
                    if isinstance(v, dict) else draw(v))
                for k, v in shapes.items()}

    params = tree(1.0)
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0,
               error_feedback=error_feedback)
    jp = jax.tree.map(jnp.asarray, params)
    js = jax_init_opt(jp, error_feedback=error_feedback)
    tp = jax.tree.map(_t, params)
    ts = init_opt_state(tp, error_feedback=error_feedback)
    for _ in range(3):
        grads = tree(grad_scale)
        jp, js, jm = jax_adamw(jp, jax.tree.map(jnp.asarray, grads), js,
                               JaxAdamW(**cfg))
        tp, ts, tm = adamw_update(tp, jax.tree.map(_t, grads), ts,
                                  AdamWConfig(**cfg))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    _close_trees(tp, jp, 1e-6)
    for key in ("m", "v") + (("ef",) if error_feedback else ()):
        _close_trees(ts[key], js[key], 1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
