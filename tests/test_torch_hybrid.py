"""The port's hybrid family (zamba2-2.7b: Mamba2 blocks with an attention
block every 6) held against the JAX package on the same weights.

One JAX model at ``reduced_for_smoke`` size (12 layers, attention at
layers 5 and 11, d=64, 4 heads of 16, Mamba2 with 8 heads of 16 and a
state of 16, fp32) per module, its ``split(model.init(PRNGKey(0)))``
weights carried into the port by ``from_jax_params``; inputs from numpy
seeds. Tolerance: atol 1e-4 (the ``ssm`` tests' fp32 tolerance; the
frameworks sum in another order). Inside the port the gates are bitwise:
restored attention K/V equal the prefill's and the live cache's on every
token, restored states equal the live ones.

The reference's restore of a session that decoded raises: its decode
rows are filed under layers 0 and 1 instead of 5 and 11 (ROADMAP queue
3). The port files them under the adapter's ``decode_layers``; a test
shows both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.config.hardware import PAPER_A100 as JAX_A100
from repro.configs import get_arch as jax_get_arch
from repro.core.hcache import HCacheManager as JaxManager
from repro.models import Model as JaxModel
from repro.models import hybrid as jhybrid
from repro.models.layers import mamba as jmamba
from repro.models.module import split
from repro.storage import ChunkStore as JaxStore
from repro.storage import make_array as jax_make_array
from repro_torch.config.arch import BlockKind
from repro_torch.config.hardware import PAPER_A100
from repro_torch.configs import REGISTRY, get_arch
from repro_torch.core.hcache import HCacheManager
from repro_torch.models import Model
from repro_torch.models import hybrid as thybrid
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers import mamba as tmamba
from repro_torch.storage import ChunkStore, make_array

ARCH = "zamba2-2.7b"
ATOL = 1e-4
N = 40


@pytest.fixture(scope="module")
def pair(rules):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = jax_reduced(jax_get_arch(ARCH))
    jm = JaxModel(cfg, rules=rules, dtype=jnp.float32, remat="none")
    jparams, _ = split(jm.init(jax.random.PRNGKey(0)))
    tm = Model(cfg, device="cpu")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    yield cfg, jm, jparams, tm, tparams
    torch.set_num_threads(n)


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n),
                                                dtype=np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def _greedy(logits):
    return torch.argmax(logits[:, -1], -1)[:, None]


def port_manager(tm, **kw):
    return HCacheManager(tm, ChunkStore(make_array("dram", 4),
                                        chunk_tokens=16), hw=PAPER_A100, **kw)


def jax_manager(jm, **kw):
    return JaxManager(jm, JaxStore(jax_make_array("dram", 4),
                                   chunk_tokens=16), hw=JAX_A100,
                      store_dtype=np.float32, **kw)


def _live(out, n):
    """A B=1 decode cache of the prefill's K/V and states, ``n`` tokens
    of room."""
    k, v = out["kv"]
    pad = (0, 0, 0, 0, 0, n - k.shape[2])
    conv, ssm = out["mamba_states"]
    return {"attn_k": torch.nn.functional.pad(k, pad),
            "attn_v": torch.nn.functional.pad(v, pad),
            "conv": conv.clone(), "ssm": ssm.clone(),
            "lengths": torch.tensor([k.shape[2]], dtype=torch.int32)}


def _jax_live(jm, out, n):
    """The JAX model's B=1 decode cache of a prefill's K/V and states,
    ``n`` tokens of room."""
    cache = jax.tree.map(np.array, jm.init_cache(1, n))
    S = out["kv"][0].shape[2]
    cache["attn_k"][:, :, :S] = np.asarray(out["kv"][0])
    cache["attn_v"][:, :, :S] = np.asarray(out["kv"][1])
    cache["conv"], cache["ssm"] = map(np.asarray, out["mamba_states"])
    cache["lengths"] = np.asarray([S], np.int32)
    return jax.tree.map(jnp.asarray, cache)


# ------------------------------------------------------------ the registry
def test_registry_holds_the_reference_config():
    cfg = get_arch(ARCH)
    assert REGISTRY[ARCH] is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_arch(ARCH))
    assert (cfg.family, cfg.source) == ("hybrid", "arXiv:2411.15242")


def test_model_builds_at_the_published_size():
    """The published config builds (no weights drawn): 9 super-blocks of
    5 Mamba2 blocks and one attention block, the reference adapter's
    flags, and the decode stack's rows named by their global layers."""
    cfg = get_arch(ARCH)
    m = Model(cfg, device="cpu")
    ad = m.adapter
    assert m.kind == "hybrid" and (m.h.k, m.h.n_super) == (6, 9)
    assert (m.h.mamba.n_heads, m.h.mamba.head_dim, m.h.mamba.d_state,
            m.h.mamba.conv_channels) == (80, 64, 64, 5248)
    assert not (ad.chunkable or ad.supports_resume or ad.supports_paged
                or ad.supports_recompute)
    assert (ad.kv_names, ad.n_state_blobs) == (("attn_k", "attn_v"), 1)
    attn = [li for li, k in enumerate(cfg.block_kinds())
            if k == BlockKind.ATTENTION]
    assert ad.decode_layers(9) == attn == list(range(5, 54, 6))
    assert [ad.kv_row(li) for li in attn] == list(range(9))


# --------------------------------------------------------------- the layer
@pytest.mark.parametrize("S,carry", [(1, False), (1, True), (37, False),
                                     (37, True), (200, False), (200, True)])
def test_apply_mamba2_matches_jax(pair, rules, S, carry):
    """One Mamba2 block: outputs and the (conv, ssm) states, from zero or
    from the states of a 21-token run before; S = 200 is not a multiple
    of the 128-token chunk (two chunks, the second padded)."""
    cfg, jm, jparams, tm, tparams = pair
    jp = jax.tree.map(lambda a: a[1, 2], jparams["mamba"]["m"])
    tp = thybrid._mamba_params(tparams, 1, 2)["m"]
    rng = np.random.default_rng(S + carry)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jstate, tstate = {}, {}
    if carry:
        x0 = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
        _, (jc, js) = jmamba.apply_mamba2(jp, jnp.asarray(x0), jm.h.mamba,
                                          rules)
        _, (tc, ts) = tmamba.apply_mamba2(tp, _t(x0), tm.h.mamba)
        _close(tc, jc)
        _close(ts, js)
        jstate = {"conv_state": jc, "init_state": js}
        tstate = {"conv_state": tc, "init_state": ts}
    jy, (jc, js) = jmamba.apply_mamba2(jp, jnp.asarray(x), jm.h.mamba, rules,
                                       **jstate)
    ty, (tc, ts) = tmamba.apply_mamba2(tp, _t(x), tm.h.mamba, **tstate)
    assert ts.dtype == torch.float32 and ts.shape == (2, 8, 16, 16)
    _close(ty, jy)
    _close(tc, jc)
    _close(ts, js)


# --------------------------------------------------------------- the model
@pytest.mark.parametrize("S", [N, 150])
def test_forward_matches_jax(pair, S):
    """Every position's logits, both hidden stacks, the attention K/V and
    the Mamba2 states; 150 tokens cross the chunk."""
    cfg, jm, jparams, tm, tparams = pair
    toks = _tokens(cfg, S, S)
    jout = jhybrid.hybrid_forward(jparams, jnp.asarray(toks), jm.h,
                                  capture_hidden=True, emit_state=True)
    tout = thybrid.hybrid_forward(tparams, _t(toks).long(), tm.h,
                                  capture_hidden=True, emit_state=True)
    for key in ("logits", "mamba_hidden", "attn_hidden"):
        assert tout[key].shape == jout[key].shape, key
        _close(tout[key], jout[key])
    for got, want in zip(tout["kv"] + tout["mamba_states"],
                         jout["kv"] + jout["mamba_states"]):
        _close(got, want)
    last = tm.prefill(tparams, {"tokens": _t(toks).long()})
    _close(last["logits"], jout["logits"][:, -1:])


def test_decode_steps_match_jax(pair):
    """A 40-token prefill, then 6 greedy decode steps in each framework
    on its own cache: logits, both hidden stacks and the cache."""
    cfg, jm, jparams, tm, tparams = pair
    toks = _tokens(cfg, N, 1)
    jout = jm.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tout = tm.prefill(tparams, {"tokens": _t(toks).long()})
    jcache = _jax_live(jm, jout, 64)
    tcache = _live(tout, 64)
    tok = _greedy(tout["logits"])
    for _ in range(6):
        jlg, jcache, (jmh, jah) = jm.decode_step_full(
            jparams, jcache, jnp.asarray(tok.numpy(), jnp.int32))
        tlg, tcache, (tmh, tah) = tm.decode_step_full(tparams, tcache, tok)
        _close(tlg, jlg)
        _close(tmh, jmh)
        _close(tah, jah)
        for key in ("attn_k", "attn_v", "conv", "ssm", "lengths"):
            _close(tcache[key], jcache[key])
        assert torch.equal(_greedy(tlg), torch.from_numpy(
            np.array(jnp.argmax(jlg[:, -1], -1))).long()[:, None])
        tok = _greedy(tlg)


def test_restore_ops_match_jax(pair):
    """``hybrid_restore_attn_kv`` and ``hybrid_restore_mamba_states``
    against the reference's; in the port the restored K/V equal the
    prefill's bitwise."""
    cfg, jm, jparams, tm, tparams = pair
    toks = _tokens(cfg, N, 2)
    tout = thybrid.hybrid_forward(tparams, _t(toks).long(), tm.h,
                                  capture_hidden=True, emit_state=True)
    pos = np.arange(N)[None]
    jk, jv = jhybrid.hybrid_restore_attn_kv(
        jparams, jnp.asarray(tout["attn_hidden"].numpy()), jm.h,
        positions=jnp.asarray(pos))
    tk, tv = tm.restore_kv_from_hidden(tparams, tout["attn_hidden"],
                                       positions=_t(pos))
    _close(tk, jk)
    _close(tv, jv)
    assert torch.equal(tk, tout["kv"][0]) and torch.equal(tv, tout["kv"][1])
    jc, js = jhybrid.hybrid_restore_mamba_states(
        jparams, jnp.asarray(tout["mamba_hidden"].numpy()), jm.h)
    tc, ts = tm.restore_ssm_states(tparams, tout["mamba_hidden"])
    _close(tc, jc)
    _close(ts, js)
    for got, want in zip((tc, ts), tout["mamba_states"]):
        _close(got, want.numpy())


# ----------------------------------------------------------------- restore
@pytest.mark.parametrize("override", ["hidden", "kv", None])
def test_restore_without_decode_matches_jax(pair, override):
    """Save a prefill, restore it, take the next token: the port's
    restored cache and next-token logits against the JAX manager's."""
    cfg, jm, jparams, tm, tparams = pair
    toks = _tokens(cfg, N, 3)
    jmgr = jax_manager(jm, schedule_override=override)
    jmgr.save_prefill("s", toks[0], jm.prefill(
        jparams, {"tokens": jnp.asarray(toks)}, capture_hidden=True))
    want = jmgr.restore(jparams, "s").cache
    mgr = port_manager(tm, schedule_override=override)
    try:
        out = tm.prefill(tparams, {"tokens": _t(toks).long()},
                         capture_hidden=True)
        mgr.save_prefill("s", toks[0], out)
        res = mgr.restore(tparams, "s", capacity=N + 1)
    finally:
        mgr.close()
    got = res.cache
    assert set(got) == {"attn_k", "attn_v", "conv", "ssm", "lengths"}
    for key in ("attn_k", "attn_v"):
        assert torch.equal(got[key][:, :, :N], out["kv"][key == "attn_v"])
        _close(got[key][:, :, :N], want[key])
    for key in ("conv", "ssm"):
        _close(got[key], want[key])
    tok = _greedy(out["logits"])
    jlg, _ = jm.decode_step(jparams, {
        **want, "attn_k": jnp.pad(want["attn_k"],
                                  ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))),
        "attn_v": jnp.pad(want["attn_v"],
                          ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0)))},
        jnp.asarray(tok.numpy(), jnp.int32))
    tlg, _ = tm.decode_step(tparams, got, tok)
    _close(tlg, jlg)


def _decoded_session(tm, tparams, mgr, toks, steps):
    """The fault-1 recipe on the port: prefill, save, ``steps`` decode
    steps each saved by ``save_decode_hidden``, pause. Returns the live
    cache at the pause and the next token to feed."""
    out = tm.prefill(tparams, {"tokens": _t(toks).long()},
                     capture_hidden=True)
    mgr.save_prefill("s", toks[0], out)
    live = _live(out, 64)
    tok, fed = _greedy(out["logits"]), []
    for _ in range(steps):
        fed.append(int(tok[0, 0]))
        lengths = live["lengths"].clone()
        lg, live, hidden = tm.decode_step_full(tparams, live, tok)
        mgr.save_decode_hidden(["s"], tm.adapter.decode_hidden(hidden),
                               lengths.numpy())
        tok = _greedy(lg)
    mgr.save_session_pause("s", live, N + steps, tokens_tail=fed)
    return live, tok


@pytest.mark.parametrize("override", ["hidden", "kv", None])
def test_restore_after_decode_is_bitwise(pair, override):
    """40 prefill tokens, 6 decoded ones saved row by row, pause, evict,
    restore: attn_k/attn_v equal the live cache on all 46 tokens, prefill
    and decode rows alike, conv and ssm whole; decoding on from the
    restored cache gives the never-evicted logits bitwise."""
    cfg, jm, jparams, tm, tparams = pair
    mgr = port_manager(tm, schedule_override=override)
    try:
        live, tok = _decoded_session(tm, tparams, mgr, _tokens(cfg, N, 1), 6)
        ref = {k: t.clone() for k, t in live.items()}
        del live
        res = mgr.restore(tparams, "s", capacity=64)
    finally:
        mgr.close()
    assert res.n_tokens == N + 6 and res.cache["lengths"].tolist() == [46]
    for key in ("attn_k", "attn_v"):
        assert torch.equal(res.cache[key][:, :, :46], ref[key][:, :, :46])
    for key in ("conv", "ssm"):
        assert torch.equal(res.cache[key], ref[key])
    for _ in range(4):
        lg_r, res.cache = tm.decode_step(tparams, res.cache, tok)
        lg_g, ref = tm.decode_step(tparams, ref, tok)
        assert torch.equal(lg_r, lg_g)
        tok = _greedy(lg_g)


def test_decode_rows_are_filed_under_the_attention_layers(pair):
    """``save_decode_hidden`` files row s of the attention stack under
    global layer 6s + 5, so layers 5 and 11 hold every token."""
    cfg, jm, jparams, tm, tparams = pair
    mgr = port_manager(tm, schedule_override="hidden")
    try:
        _decoded_session(tm, tparams, mgr, _tokens(cfg, N, 1), 2)
        store = mgr.store
        assert [li for li in range(cfg.n_layers)
                if store.layer_available("s", "h", li, N + 2)] == [5, 11]
    finally:
        mgr.close()


def test_reference_restore_of_a_decoded_session_raises(pair):
    """The reference fault (ROADMAP queue 3), in the issue's recipe: the
    JAX manager files the decode rows of layers 5 and 11 under layers 0
    and 1, so its restore of the paused 46-token session fails to fit
    the 40 prefill rows into 46 positions. The port restores the same
    session (``test_restore_after_decode_is_bitwise``)."""
    cfg, jm, jparams, tm, tparams = pair
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (1, N), 0,
                                         cfg.vocab_size), np.int32)
    jmgr = jax_manager(jm, schedule_override="hidden")
    out = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                     capture_hidden=True)
    jmgr.save_prefill("s", toks[0], out)
    cache = _jax_live(jm, out, 64)
    tok = jnp.argmax(out["logits"][:, -1], -1)[:, None].astype(jnp.int32)
    fed = []
    for _ in range(6):
        fed.append(int(tok[0, 0]))
        lengths = np.asarray(cache["lengths"])
        lg, cache, hidden = jm.decode_step_full(jparams, cache, tok)
        jmgr.save_decode_hidden(["s"], jm.adapter.decode_hidden(hidden),
                                lengths)
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    jmgr.saver.drain()
    jmgr.save_session_pause("s", cache, N + 6,
                            tokens_tail=np.asarray(fed, np.int32))
    store = jmgr.store
    assert all(store.layer_available("s", "h", li, N) for li in (5, 11))
    assert not any(store.layer_available("s", "h", li, N + 6)
                   for li in range(cfg.n_layers))
    with pytest.raises(ValueError, match="could not broadcast"):
        jmgr.restore(jparams, "s")
