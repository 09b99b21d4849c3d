"""The port's restoration path: task graph and replay against the JAX
package, restored K/V bitwise equal to prefill K/V inside the port, the
restored cache against JAX ``HCacheManager.restore`` (atol 1e-5, fp32),
and the quickstart lifecycle over two rounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.config.hardware import PAPER_H800 as JAX_H800
from repro.configs import get_arch as jax_get_arch
from repro.core import cost_model as jcost
from repro.core import restoration as jrest
from repro.core.hcache import HCacheManager as JaxManager
from repro.models import Model as JaxModel
from repro.models.module import split
from repro.storage import ChunkStore as JaxStore
from repro.storage import make_array as jax_make_array
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.config.hardware import PAPER_H800
from repro_torch.configs import get_arch
from repro_torch.core import cost_model as tcost
from repro_torch.core import restoration as trest
from repro_torch.core.hcache import HCacheManager
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params
from repro_torch.storage import ChunkStore, make_array

N = 40


@pytest.fixture(scope="module")
def port():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = reduced_for_smoke(get_arch("llama2-7b"))
    model = Model(cfg, device="cpu")
    yield cfg, model, model.init(0)
    torch.set_num_threads(n)


def _manager(model, override=None, group=8, store=None):
    store = store or ChunkStore(make_array("ssd", 4), chunk_tokens=16)
    return HCacheManager(model, store, schedule_override=override,
                         restore_group_size=group)


def _prefill(cfg, model, params, n=N, seed=1):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, n)))
    return toks, model.prefill(params, {"tokens": toks}, capture_hidden=True)


def _decode(model, params, cache, tok, steps):
    seq = []
    for _ in range(steps):
        seq.append(int(tok[0, 0]))
        lg, cache = model.decode_step(params, cache, tok)
        tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
    return seq, cache


def _cache_from(out, capacity):
    k, v = out["kv"]
    n = k.shape[2]
    cache = {name: torch.zeros(t.shape[:2] + (capacity,) + t.shape[3:])
             for name, t in (("k", k), ("v", v))}
    cache["k"][:, :, :n], cache["v"][:, :, :n] = k, v
    cache["lengths"] = torch.tensor([n], dtype=torch.int32)
    return cache


# ------------------------------------------------------------- task graph
METHODS = [("recompute", "hidden", "kv", "hidden"), ("hidden",) * 6,
           ("recompute", "recompute", "hidden", "hidden", "hidden", "kv"),
           ("kv",) * 3]


@pytest.mark.parametrize("group", [1, 2, 3, 8])
@pytest.mark.parametrize("methods", METHODS)
def test_compile_tasks_and_replay_match_jax(methods, group):
    cfg = jax_get_arch("llama2-7b")
    jt = jrest.compile_tasks(methods, group_size=group)
    tt = trest.compile_tasks(methods, group_size=group)
    assert [(t.kind, t.layer, t.dep, t.layers, t.deps) for t in tt] == \
        [(t.kind, t.layer, t.dep, t.layers, t.deps) for t in jt]
    times_j = [jcost.method_times(c, JAX_H800)
               for c in jcost.layer_costs(cfg, 1024)]
    times_t = [tcost.method_times(c, PAPER_H800)
               for c in tcost.layer_costs(get_arch("llama2-7b"), 1024)]
    order = [i for i, t in enumerate(tt) if t.stream == "compute"] + \
        [i for i, t in enumerate(tt) if t.stream == "io"]
    for kw in ({}, {"order": order}, {"dispatch_overhead": 1e-5}):
        a = jrest.replay(jt, times_j, **kw)
        b = trest.replay(tt, times_t, **kw)
        assert (a.makespan, a.io_busy, a.compute_busy) == \
            (b.makespan, b.io_busy, b.compute_busy)


# ---------------------------------------------- bitwise restore == prefill
@pytest.mark.parametrize("override", ["hidden", "kv", "recompute", None])
def test_restored_kv_is_prefill_kv_bitwise(port, override):
    cfg, model, params = port
    toks, out = _prefill(cfg, model, params)
    mgr = _manager(model, override)
    try:
        mgr.save_prefill("s", toks[0].numpy(), out)
        res = mgr.restore(params, "s")
    finally:
        mgr.close()
    assert torch.equal(res.cache["k"], out["kv"][0])
    assert torch.equal(res.cache["v"], out["kv"][1])
    assert int(res.cache["lengths"][0]) == N


def test_group_sizes_give_identical_bytes(port):
    cfg, model, params = port
    toks, out = _prefill(cfg, model, params, n=37, seed=2)
    caches = []
    for group in (1, 2, 8):
        mgr = _manager(model, "hidden", group)
        try:
            mgr.save_prefill("s", toks[0].numpy(), out)
            ex = mgr.begin_restore(params, "s", trest.CacheAssembler(model))
            ex.run()
        finally:
            mgr.close()
        # the executor's timeline is the replay of what it ran
        assert ex.timeline() == trest.replay(
            ex.tasks, ex.times, ex.executed,
            dispatch_overhead=ex.dispatch_overhead)
        assert sum(t.kind == "project" for t in ex.tasks) == -(-4 // group)
        caches.append(ex.sink.cache)
    for c in caches[1:]:
        assert torch.equal(c["k"], caches[0]["k"])
        assert torch.equal(c["v"], caches[0]["v"])
    assert torch.equal(caches[0]["k"], out["kv"][0])


# ------------------------------------------------ port against the JAX path
def test_restored_cache_matches_jax_manager(port, rules):
    jcfg = jax_reduced(jax_get_arch("llama2-7b"))
    jm = JaxModel(jcfg, rules=rules, dtype=jnp.float32, remat="none")
    jparams, _ = split(jm.init(jax.random.PRNGKey(0)))
    cfg, model, _ = port
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, N),
                                             dtype=np.int32)
    jout = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                      capture_hidden=True)
    jmgr = JaxManager(jm, JaxStore(jax_make_array("dram", 4),
                                   chunk_tokens=16),
                      hw=JAX_H800, schedule_override="hidden",
                      store_dtype=np.float32)
    jmgr.save_prefill("s", toks[0], jout)
    jres = jmgr.restore(jparams, "s")
    tout = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                         capture_hidden=True)
    mgr = _manager(model, "hidden")
    try:
        mgr.save_prefill("s", toks[0], tout)
        res = mgr.restore(params, "s")
    finally:
        mgr.close()
    for name in ("k", "v"):
        np.testing.assert_allclose(res.cache[name].numpy(),
                                   np.asarray(jres.cache[name]), atol=1e-5,
                                   rtol=0)


# ---------------------------------------------------- quickstart lifecycle
@pytest.mark.parametrize("override", ["hidden", "kv", "recompute"])
def test_two_round_lifecycle_matches_never_evicted_cache(port, override):
    """Round 0: prefill, save, decode 6 tokens saving their hidden states,
    evict, restore, greedy decode == the never-evicted cache (MATCH).
    Round 1: 10 new tokens prefilled over the restored history and
    appended with save_prefill(start=n), decode, restore again: the cache
    and the greedy continuation match the never-evicted ones."""
    cfg, model, params = port
    mgr = _manager(model, override)
    cap = 96
    try:
        toks, out = _prefill(cfg, model, params, n=30, seed=4)
        mgr.save_prefill("s", toks[0].numpy(), out)
        ref = _cache_from(out, cap)
        tok = torch.argmax(out["logits"][:, -1], -1).to(torch.int32)[:, None]
        for rnd in range(2):
            inputs = []
            for _ in range(6):
                inputs.append(int(tok[0, 0]))
                lengths = ref["lengths"].clone()
                lg, ref, hidden = model.decode_step_full(params, ref, tok)
                mgr.save_decode_hidden(["s"], hidden, lengths)
                tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
            n = int(ref["lengths"][0])
            mgr.save_session_pause("s", ref, n, tokens_tail=inputs)
            res = mgr.restore(params, "s", capacity=cap)
            # recompute replays the prefill and decode segments, so every
            # method restores the decoded history bitwise
            for name in ("k", "v"):
                assert torch.equal(res.cache[name][:, :, :n],
                                   ref[name][:, :, :n])
            ref_copy = {k: v.clone() for k, v in ref.items()}
            seq_r, _ = _decode(model, params, res.cache, tok, 6)
            seq_g, _ = _decode(model, params, ref_copy, tok, 6)
            assert seq_r == seq_g, "MISMATCH"
            if rnd == 0:
                # round 1: new tokens over the restored history
                new = torch.from_numpy(np.random.default_rng(5).integers(
                    0, cfg.vocab_size, (1, 10)))
                hist = (res.cache["k"][:, :, :n], res.cache["v"][:, :, :n])
                out = model.prefill(params, {"tokens": new},
                                    capture_hidden=True, hist_kv=hist,
                                    hist_len=n)
                ref_out = model.prefill(
                    params, {"tokens": new},
                    hist_kv=(ref["k"][:, :, :n], ref["v"][:, :, :n]),
                    hist_len=n)
                assert torch.equal(torch.argmax(out["logits"][:, -1], -1),
                                   torch.argmax(ref_out["logits"][:, -1],
                                                -1))
                mgr.save_prefill("s", new[0].numpy(), out, start=n)
                ref["k"][:, :, n:n + 10] = ref_out["kv"][0]
                ref["v"][:, :, n:n + 10] = ref_out["kv"][1]
                ref["lengths"] = torch.tensor([n + 10], dtype=torch.int32)
                tok = torch.argmax(ref_out["logits"][:, -1],
                                   -1).to(torch.int32)[:, None]
        assert mgr.store.get_manifest("s")["n_tokens"] == 30 + 6 + 10 + 6
    finally:
        mgr.close()


def test_evict_drops_the_session(port):
    cfg, model, params = port
    toks, out = _prefill(cfg, model, params, n=16, seed=6)
    mgr = _manager(model, "hidden")
    try:
        mgr.save_prefill("s", toks[0].numpy(), out)
        assert mgr.sessions() == ["s"]
        mgr.evict("s")
        assert mgr.sessions() == []
        with pytest.raises(KeyError):
            mgr.restore(params, "s")
    finally:
        mgr.close()


def test_pause_without_new_tokens_keeps_kv_layers_restorable(port):
    """A pause or retire that adds no token since the last save (the
    engine retires a session whose tokens were all saved) appends no
    K/V tail to ``kv``-method layers, and the session still restores the
    prefill's K/V bitwise."""
    cfg, model, params = port
    toks, out = _prefill(cfg, model, params, n=24, seed=7)
    mgr = _manager(model, "kv")
    try:
        mgr.save_prefill("s", toks[0].numpy(), out)
        mgr.save_session_pause("s", _cache_from(out, 32), 24,
                               tokens_tail=np.zeros(0, np.int32))
        res = mgr.restore(params, "s")
    finally:
        mgr.close()
    assert torch.equal(res.cache["k"], out["kv"][0])
    assert torch.equal(res.cache["v"], out["kv"][1])
