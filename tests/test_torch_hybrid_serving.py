"""The port's hybrid family (zamba2-2.7b) through the contiguous engine and
its backend, against the JAX package.

- The engine at ``max_batch=4`` with 6 sessions gives each session the
  tokens of a direct greedy by the JAX *model* over its own prompt, and
  each retired session restores to the JAX model's prefill over the
  stream its manifest says is stored (atol 1e-4, fp32). The JAX engine
  is wrong there: its contiguous backend writes every hybrid session's
  prefill states into batch slot 0 (ROADMAP queue 3), which a test shows
  beside the port's backend.
- At ``max_batch=1`` the JAX engine is right and the port gives its
  tokens.
- A second round of a stored session is refused (the reference's second
  round restarts the recurrence from zero state), and the paged backend
  refuses the family, as the reference's does.

One JAX smoke model (zamba2-2.7b reduced, fp32) per module; its weights
are carried into the port by ``from_jax_params``. Greedy tokens must be
equal: the two frameworks' logits differ by ~1e-6 here, far below the
gaps between the top logits of these random weights."""
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
from repro.serving.kv_cache import ContiguousBackend as JaxContiguous
from repro.storage import ChunkStore as JaxStore
from repro.storage import make_array as jax_make_array
from repro_torch.config.hardware import PAPER_A100
from repro_torch.core.hcache import HCacheManager
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import (ContiguousBackend, InferenceEngine, Request,
                                 make_backend)
from repro_torch.storage import ChunkStore, make_array

ARCH = "zamba2-2.7b"
ATOL = 1e-4


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


def port_engine(pair, **kw):
    _, _, _, tm, tparams = pair
    defaults = dict(max_batch=1, max_seq=128, prefill_chunk=8)
    defaults.update(kw)
    mgr = HCacheManager(tm, ChunkStore(make_array("dram", 4),
                                       chunk_tokens=16), hw=PAPER_A100)
    return InferenceEngine(tm, tparams, mgr, **defaults)


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


def jax_greedy(jm, jparams, prompt, n_new):
    """Direct greedy decoding by the JAX model: one prefill over the
    prompt, then B=1 decode steps on its cache."""
    S = len(prompt)
    out = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)[None]})
    cache = jax.tree.map(np.array, jm.init_cache(1, S + n_new))
    cache["attn_k"][:, :, :S] = np.asarray(out["kv"][0])
    cache["attn_v"][:, :, :S] = np.asarray(out["kv"][1])
    cache["conv"], cache["ssm"] = map(np.asarray, out["mamba_states"])
    cache["lengths"] = np.asarray([S], np.int32)
    cache = jax.tree.map(jnp.asarray, cache)
    toks = [int(jnp.argmax(out["logits"][0, -1]))]
    while len(toks) < n_new:
        lg, cache = jm.decode_step(jparams, cache,
                                   jnp.asarray([[toks[-1]]], jnp.int32))
        toks.append(int(jnp.argmax(lg[0, -1])))
    return toks


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
    greedy; each retired session's restore (attention K/V and states)
    equals the JAX model's prefill over the stored stream (the prompt and
    every generated token but the last)."""
    cfg, jm, jparams, _, tparams = pair
    prompts = _prompts(cfg, [13, 9, 21, 6, 17, 11], 6)
    n_new = (5, 7, 1, 4, 6, 3)
    eng = port_engine(pair, max_batch=4)
    try:
        for i, (p, n) in enumerate(zip(prompts, n_new)):
            eng.submit(Request(f"s{i}", p, max_new_tokens=n))
        eng.run()
        assert eng.metrics.concurrent_peak == 4
        for i, (p, n) in enumerate(zip(prompts, n_new)):
            sid = f"s{i}"
            got = eng.result(sid)
            assert got == jax_greedy(jm, jparams, p, n), sid
            stream = np.concatenate([p, np.asarray(got[:-1], np.int32)])
            assert eng.mgr.store.get_manifest(sid)["n_tokens"] == len(stream)
            res = eng.mgr.restore(tparams, sid).cache
            want = jm.prefill(jparams, {"tokens": jnp.asarray(stream)[None]})
            S = len(stream)
            for got_t, want_t in ((res["attn_k"][:, :, :S], want["kv"][0]),
                                  (res["attn_v"][:, :, :S], want["kv"][1]),
                                  (res["conv"], want["mamba_states"][0]),
                                  (res["ssm"], want["mamba_states"][1])):
                np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                                           atol=ATOL, rtol=0, err_msg=sid)
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
    finally:
        eng.close()


# -------------------------------------------------------------- backends
def _prefill_states(pair, n=20):
    cfg, jm, jparams, tm, tparams = pair
    toks = _prompts(cfg, [n], 8)[0][None]
    jout = jm.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tout = tm.prefill(tparams, {"tokens": torch.from_numpy(toks).long()})
    return jout["mamba_states"], tout["mamba_states"]


def test_write_states_lands_in_the_views_own_slot(pair):
    """The issue's recipe for the reference fault (ROADMAP queue 3): the
    JAX backend takes a hybrid state's first axis for its batch axis, so
    slot 1's prefill states land in slot 0 and slot 1 stays zero. The
    port's backend writes them into slot 1 (batch axis 2), and the view's
    snapshot reads them back."""
    _, jm, _, tm, _ = pair
    (jconv, jssm), (conv, ssm) = _prefill_states(pair)
    jb = JaxContiguous(jm, 2, 64)
    jb.view(1).write_states({"conv": jconv, "ssm": jssm})
    assert float(jnp.abs(jb.cache["ssm"][:, :, 1]).sum()) == 0.0
    assert float(jnp.abs(jb.cache["ssm"][:, :, 0]).sum()) == pytest.approx(
        float(jnp.abs(jssm).sum()))
    kv = ContiguousBackend(tm, 3, 64)
    kv.view(1).write_states({"conv": conv, "ssm": ssm})
    for key, piece in (("conv", conv), ("ssm", ssm)):
        t = kv.state[key]
        assert torch.equal(t[:, :, 1], piece[:, :, 0])
        assert not t[:, :, 0].any() and not t[:, :, 2].any()
    snap = kv.view(1).snapshot()
    assert set(snap) == {"attn_k", "attn_v", "conv", "ssm"}
    assert torch.equal(snap["conv"], conv) and torch.equal(snap["ssm"], ssm)
    assert snap["attn_k"].shape == (2, 1, 64, 4, 16)


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
        assert torch.equal(t[:, :, 1], before[key][:, :, 1])
        assert not torch.equal(t[:, :, 0], before[key][:, :, 0])


def test_paged_backend_refuses_hybrid(pair):
    _, _, _, tm, _ = pair
    with pytest.raises(NotImplementedError, match="lm-family"):
        make_backend("paged", tm, 2, 128)


def test_serve_runs_zamba2_on_the_cpu(tmp_path, capsys):
    metrics = tmp_path / "m.json"
    serve.main(["--device", "cpu", "--arch", ARCH, "--rounds", "1",
                "--sessions", "5", "--prompt-len", "12", "--gen", "3",
                "--metrics-json", str(metrics)])
    out = capsys.readouterr().out
    assert f"{ARCH}: 12 layers" in out
    assert out.count("round 0 user") == 5 and metrics.exists()
    for argv, err in ((["--rounds", "2"], SystemExit),
                      (["--rounds", "1", "--backend", "paged"],
                       NotImplementedError)):
        with pytest.raises(err):
            serve.main(["--device", "cpu", "--arch", ARCH, *argv])
