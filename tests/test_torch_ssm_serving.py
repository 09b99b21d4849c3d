"""The port's ssm family (falcon-mamba) through the HCache lifecycle and
the continuous-batching engine, against the JAX package.

- Lifecycle: prefill, save, decode (saving hidden states), pause dump,
  evict, restore: the restored conv and ssm states equal the live ones
  bitwise, and decoding from them gives the never-evicted bits.
- The engine at ``max_batch=1`` gives the JAX engine's greedy tokens.
- At ``max_batch=4`` with 6 sessions the JAX engine is wrong (every
  prefill state lands in slot 0; ROADMAP queue 3), so the port's tokens
  are held against a direct greedy by the JAX *model* over each session's
  stream, and each retired session's stored states against the JAX
  model's prefill over the manifest's tokens (atol 1e-4, fp32).
- A second round of a stored session is refused (the JAX package's
  second round restarts the recurrence from zero state), and the paged
  backend refuses the family.

One JAX smoke model (falcon-mamba-7b reduced, fp32) per module; its
weights are carried into the port by ``from_jax_params``. Greedy tokens
must be equal: the two frameworks' logits differ by ~1e-6 here, far
below the gaps between the top logits of these random weights."""
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
from repro.models.module import split
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.storage import ChunkStore as JaxStore
from repro.storage import make_array as jax_make_array
from repro_torch.config.hardware import PAPER_A100, PAPER_H800
from repro_torch.configs import get_arch
from repro_torch.core.hcache import HCacheManager
from repro_torch.core.restoration import compile_tasks
from repro_torch.core.scheduler import solve
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import (ContiguousBackend, InferenceEngine, Request,
                                 make_backend)
from repro_torch.storage import ChunkStore, make_array

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair(rules):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = jax_reduced(jax_get_arch("falcon-mamba-7b"))
    jm = JaxModel(cfg, rules=rules, dtype=jnp.float32, remat="none")
    jparams, _ = split(jm.init(jax.random.PRNGKey(0)))
    tm = Model(cfg, device="cpu")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    yield cfg, jm, jparams, tm, tparams
    torch.set_num_threads(n)


def port_manager(tm, **kw):
    return HCacheManager(tm, ChunkStore(make_array("dram", 4),
                                        chunk_tokens=16), hw=PAPER_A100, **kw)


def port_engine(pair, **kw):
    _, _, _, tm, tparams = pair
    defaults = dict(max_batch=1, max_seq=128, prefill_chunk=8)
    defaults.update(kw)
    return InferenceEngine(tm, tparams, port_manager(tm), **defaults)


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


def jax_greedy(jm, jparams, prompt, n_new):
    """Direct greedy decoding by the JAX model: one prefill over the
    prompt, then B=1 decode steps on its states."""
    out = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)[None]})
    cache = {"conv": out["states"][0], "ssm": out["states"][1],
             "lengths": jnp.asarray([len(prompt)], jnp.int32)}
    toks = [int(jnp.argmax(out["logits"][0, -1]))]
    while len(toks) < n_new:
        lg, cache = jm.decode_step(jparams, cache,
                                   jnp.asarray([[toks[-1]]], jnp.int32))
        toks.append(int(jnp.argmax(lg[0, -1])))
    return toks


# ------------------------------------------------------------- lifecycle
@pytest.mark.parametrize("override", [None, "hidden", "kv"])
def test_lifecycle_restores_states_bitwise(pair, override):
    """Save -> decode -> pause dump -> evict -> restore, under every
    schedule: per-layer methods are no-ops for Mamba1 layers, the blob
    carries the whole state."""
    cfg, _, _, tm, tparams = pair
    mgr = port_manager(tm, schedule_override=override)
    prompt = _prompts(cfg, [19], 3)[0]
    try:
        out = tm.prefill(tparams, {"tokens": torch.from_numpy(prompt)[None]},
                         capture_hidden=True)
        mgr.save_prefill("s", prompt, out)
        live = {"conv": out["states"][0], "ssm": out["states"][1],
                "lengths": torch.tensor([19], dtype=torch.int32)}
        tok = torch.argmax(out["logits"][:, -1], -1)[:, None]
        fed = []
        for _ in range(4):
            fed.append(int(tok[0, 0]))
            lengths = live["lengths"].clone()
            lg, live, hidden = tm.decode_step_full(tparams, live, tok)
            mgr.save_decode_hidden(["s"], hidden, lengths.numpy())
            tok = torch.argmax(lg[:, -1], -1)[:, None]
        mgr.save_session_pause("s", live, 23, tokens_tail=fed)
        ref = {k: t.clone() for k, t in live.items()}
        del live                                   # evict the device state
        res = mgr.restore(tparams, "s")
        assert res.n_tokens == 23
        assert res.cache["lengths"].tolist() == [23]
        for key in ("conv", "ssm"):
            assert res.cache[key].dtype == ref[key].dtype
            assert torch.equal(res.cache[key], ref[key])
        got, want = [], []
        for cache, seq in ((res.cache, got), (ref, want)):
            t = tok
            for _ in range(4):
                lg, cache, _ = tm.decode_step_full(tparams, cache, t)
                t = torch.argmax(lg[:, -1], -1)[:, None]
                seq.append(lg)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    finally:
        mgr.close()


def test_restore_graph_is_per_layer_kv_plus_one_blob():
    """falcon-mamba-7b at 1024 tokens under the paper's H800: every layer
    gets ``kv`` and the graph is 64 ``io_kv`` tasks and one ``blob``."""
    cfg = get_arch("falcon-mamba-7b")
    plan = solve(cfg, 1024, PAPER_H800, allow_recompute=False)
    assert plan.methods == ("kv",) * 64
    kinds = [t.kind for t in compile_tasks(plan.methods, n_blobs=1,
                                           group_size=8)]
    assert kinds == ["io_kv"] * 64 + ["blob"]


def test_restored_states_match_the_jax_manager(pair):
    """The JAX manager's restore of the same prompt gives the same states
    (to fp32 noise) as the port's."""
    cfg, jm, jparams, tm, tparams = pair
    prompt = _prompts(cfg, [15], 4)[0]
    jmgr = JaxManager(jm, JaxStore(jax_make_array("dram", 4),
                                   chunk_tokens=16), hw=JAX_A100,
                      store_dtype=np.float32)
    jmgr.save_prefill("s", prompt, jm.prefill(
        jparams, {"tokens": jnp.asarray(prompt)[None]}))
    want = jmgr.restore(jparams, "s").cache
    mgr = port_manager(tm)
    try:
        mgr.save_prefill("s", prompt, tm.prefill(
            tparams, {"tokens": torch.from_numpy(prompt)[None]}))
        got = mgr.restore(tparams, "s").cache
    finally:
        mgr.close()
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0)


# ---------------------------------------------------------------- engine
def test_engine_batch1_matches_the_jax_engine(pair):
    cfg, jm, jparams, _, _ = pair
    prompts = _prompts(cfg, [13, 9, 21], 5)
    reqs = [(f"s{i}", p, n) for i, (p, n) in enumerate(zip(prompts,
                                                           (4, 6, 3)))]
    jmgr = JaxManager(jm, JaxStore(jax_make_array("dram", 4),
                                   chunk_tokens=16), hw=JAX_A100,
                      store_dtype=np.float32)
    results = []
    for eng, req in ((JaxEngine(jm, jparams, jmgr, max_batch=1, max_seq=128,
                                prefill_chunk=8), JaxRequest),
                     (port_engine(pair), Request)):
        for sid, prompt, n in reqs:
            eng.submit(req(sid, prompt, max_new_tokens=n))
        eng.run()
        results.append({sid: eng.result(sid) for sid, _, _ in reqs})
        eng.close()
    assert results[0] == results[1]
    assert [len(results[1][sid]) for sid, _, _ in reqs] == [4, 6, 3]


def test_engine_batch4_matches_direct_jax_greedy(pair):
    """6 sessions over 4 slots: admissions while others decode, a
    session that finishes at its prefill (1 token) and then sits beside
    the decode batch until retired. Tokens equal the JAX model's direct
    greedy; each retired session's stored states equal the JAX model's
    prefill states over the stream the manifest says is stored (the
    prompt and every generated token but the last)."""
    cfg, jm, jparams, _, _ = pair
    prompts = _prompts(cfg, [13, 9, 21, 6, 17, 11], 6)
    n_new = (5, 7, 1, 4, 6, 3)
    eng = port_engine(pair, max_batch=4)
    try:
        for i, (p, n) in enumerate(zip(prompts, n_new)):
            eng.submit(Request(f"s{i}", p, max_new_tokens=n))
        eng.run()
        assert eng.metrics.concurrent_peak == 4
        store = eng.mgr.store
        for i, (p, n) in enumerate(zip(prompts, n_new)):
            got = eng.result(f"s{i}")
            assert got == jax_greedy(jm, jparams, p, n), f"s{i}"
            man = store.get_manifest(f"s{i}")
            stream = np.concatenate([p, np.asarray(got[:-1], np.int32)])
            assert man["n_tokens"] == len(stream)
            assert np.array_equal(store.get_blob(f"s{i}", "tok", 0),
                                  stream)
            out = jm.prefill(jparams, {"tokens": jnp.asarray(stream)[None]})
            for key, want in zip(("state_conv", "state_ssm"),
                                 out["states"]):
                np.testing.assert_allclose(
                    store.get_blob(f"s{i}", key, 0), np.asarray(want),
                    atol=ATOL, rtol=0, err_msg=f"s{i} {key}")
    finally:
        eng.close()


def test_second_round_of_a_stored_session_is_refused(pair):
    cfg = pair[0]
    p1, p2 = _prompts(cfg, [12, 5], 7)
    eng = port_engine(pair)
    try:
        eng.submit(Request("a", p1, max_new_tokens=3))
        eng.run()
        with pytest.raises(NotImplementedError, match="restored state"):
            eng.submit(Request("a", p2, max_new_tokens=3))
        # a round that was queued before the first one was stored
        eng.submit(Request("b", p1, max_new_tokens=2))
        eng.submit(Request("b", p2, max_new_tokens=2))
        with pytest.raises(NotImplementedError, match="restored state"):
            eng.run()
    finally:
        eng.close()


# -------------------------------------------------------------- backends
def test_write_states_lands_in_the_views_own_slot(pair):
    _, _, _, tm, _ = pair
    kv = ContiguousBackend(tm, 3, 64)
    piece = {key: torch.randn((t.shape[0], 1) + tuple(t.shape[2:]),
                              generator=torch.Generator().manual_seed(i))
             for i, (key, t) in enumerate(kv.state.items())}
    kv.view(1).write_states(piece)
    for key, t in kv.state.items():
        assert torch.equal(t[:, 1], piece[key][:, 0])
        assert not t[:, 0].any() and not t[:, 2].any()
    snap = kv.view(1).snapshot()
    assert set(snap) == {"conv", "ssm"}
    assert all(torch.equal(snap[k][:, 0], piece[k][:, 0]) for k in piece)


def test_decode_keeps_the_states_of_inactive_slots(pair):
    _, _, _, tm, tparams = pair
    kv = ContiguousBackend(tm, 3, 64)
    for key, t in kv.state.items():
        t.copy_(torch.randn(t.shape, generator=torch.Generator()
                            .manual_seed(9)))
    before = {k: t.clone() for k, t in kv.state.items()}
    kv.decode(tparams, np.array([[3], [4], [5]]),
              active=np.array([True, False, True]))
    for key, t in kv.state.items():
        assert torch.equal(t[:, 1], before[key][:, 1])
        assert not torch.equal(t[:, 0], before[key][:, 0])


def test_paged_backend_refuses_ssm(pair):
    _, _, _, tm, _ = pair
    with pytest.raises(NotImplementedError, match="lm-family"):
        make_backend("paged", tm, 2, 128)


def test_serve_runs_falcon_mamba_on_the_cpu(tmp_path, capsys):
    metrics = tmp_path / "m.json"
    serve.main(["--device", "cpu", "--arch", "falcon-mamba-7b", "--rounds",
                "1", "--sessions", "5", "--prompt-len", "12", "--gen", "3",
                "--metrics-json", str(metrics)])
    out = capsys.readouterr().out
    assert "falcon-mamba-7b: 4 layers" in out
    assert out.count("round 0 user") == 5 and metrics.exists()
    for argv, err in ((["--rounds", "2"], SystemExit),
                      (["--rounds", "1", "--backend", "paged"],
                       NotImplementedError)):
        with pytest.raises(err):
            serve.main(["--device", "cpu", "--arch", "falcon-mamba-7b",
                        *argv])
