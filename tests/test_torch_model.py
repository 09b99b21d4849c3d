"""The port's lm model against the JAX package's, on the same weights.

One JAX smoke model (llama2-7b reduced: 4 layers, d=64, 4 heads of 16,
fp32) is built per module; its parameter tree is carried into the port by
``from_jax_params``. Tolerance: atol 1e-4 on logits, hidden states and
K/V (fp32; the frameworks sum in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke
from repro.configs import get_arch
from repro.models import Model as JaxModel
from repro.models.module import split
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.sampling import sample

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair(rules):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = reduced_for_smoke(get_arch("llama2-7b"))
    jm = JaxModel(cfg, rules=rules, dtype=jnp.float32, remat="none")
    jparams, _ = split(jm.init(jax.random.PRNGKey(0)))
    np_tree = jax.tree.map(np.asarray, jparams)
    tm = Model(cfg, device="cpu")
    yield cfg, jm, jparams, tm, from_jax_params(np_tree, cfg, device="cpu")
    torch.set_num_threads(n)


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n),
                                                dtype=np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def test_convert_requires_every_key(pair):
    cfg, _, jparams, _, _ = pair
    tree = jax.tree.map(np.asarray, jparams)
    del tree["blocks"]["attn"]["wk"]
    with pytest.raises(KeyError):
        from_jax_params(tree, cfg, device="cpu")


def test_prefill_logits_hidden_kv_match_jax(pair):
    cfg, jm, jparams, tm, tparams = pair
    toks = _tokens(cfg, 24, 1)
    jout = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                      capture_hidden=True)
    tout = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                      capture_hidden=True)
    _close(tout["logits"], jout["logits"])
    _close(tout["hidden"], jout["hidden"])
    _close(tout["kv"][0], jout["kv"][0])
    _close(tout["kv"][1], jout["kv"][1])
    # the paper's op: K/V restored from the captured hidden states
    pos = torch.arange(24)[None]
    rk, rv = tm.restore_kv_from_hidden(tparams, tout["hidden"],
                                       positions=pos)
    assert torch.equal(rk, tout["kv"][0]) and torch.equal(rv, tout["kv"][1])
    jk, jv = jm.restore_kv_from_hidden(jparams, jout["hidden"],
                                       positions=jnp.arange(24)[None])
    _close(rk, jk)
    _close(rv, jv)


def test_prefill_over_restored_history_matches_jax(pair):
    cfg, jm, jparams, tm, tparams = pair
    hist, new = _tokens(cfg, 20, 2), _tokens(cfg, 8, 3)
    jh = jm.prefill(jparams, {"tokens": jnp.asarray(hist)})
    th = tm.prefill(tparams, {"tokens": torch.from_numpy(hist)})
    jout = jm.prefill(jparams, {"tokens": jnp.asarray(new)},
                      capture_hidden=True, hist_kv=jh["kv"], hist_len=20)
    tout = tm.prefill(tparams, {"tokens": torch.from_numpy(new)},
                      capture_hidden=True, hist_kv=th["kv"], hist_len=20)
    _close(tout["logits"], jout["logits"])
    _close(tout["hidden"], jout["hidden"])
    _close(tout["kv"][0], jout["kv"][0])
    _close(tout["kv"][1], jout["kv"][1])


def test_decode_steps_match_jax(pair):
    cfg, jm, jparams, tm, tparams = pair
    toks = _tokens(cfg, 12, 4)
    jout = jm.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tout = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    ctx = 32

    def pad(x):
        return jnp.pad(x, ((0, 0), (0, 0), (0, ctx - 12), (0, 0), (0, 0)))

    jc = {"k": pad(jout["kv"][0]), "v": pad(jout["kv"][1]),
          "lengths": jnp.asarray([12], jnp.int32)}
    tc = {"k": torch.from_numpy(np.array(jc["k"])),
          "v": torch.from_numpy(np.array(jc["v"])),
          "lengths": torch.tensor([12], dtype=torch.int32)}
    tc["k"][:, :, :12] = tout["kv"][0]
    tc["v"][:, :, :12] = tout["kv"][1]
    tok = jnp.argmax(jout["logits"][:, -1], -1).astype(jnp.int32)[:, None]
    for _ in range(3):
        jl, jc, jh = jm.decode_step_full(jparams, jc, tok)
        tl, tc, th = tm.decode_step_full(
            tparams, tc, torch.from_numpy(np.array(tok)))
        _close(tl, jl)
        _close(th, jh)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
        assert int(tc["lengths"][0]) == int(jc["lengths"][0])
        tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        assert int(sample(tl)[0]) == int(tok[0, 0])


def test_temperature_sampling_follows_the_generator():
    logits = torch.tensor([[[0.0, 3.0, -2.0, 1.0]]]).repeat(512, 1, 1)
    draw = lambda: sample(logits, temperature=0.7,  # noqa: E731
                          generator=torch.Generator().manual_seed(5))
    a, b = draw(), draw()
    assert torch.equal(a, b) and a.dtype == torch.int32
    freq = torch.bincount(a.long(), minlength=4).float() / 512
    want = torch.softmax(logits[0, 0] / 0.7, -1)
    assert float((freq - want).abs().max()) < 0.08
