"""The remaining dense configs of the JAX package's registry (qwen2-7b,
qwen2.5-14b, starcoder2-15b, gemma2-9b) and opt-30b in the port, held
against the JAX package on the same weights.

Each is built at ``reduced_for_smoke`` size (4 layers, 4 heads of 16,
fp32) from the reference's own ``init`` through ``from_jax_params``.
Together they take the transformer's paths that llama2-7b does not: QKV
bias (all but gemma2), LayerNorm with a bias and a plain GELU FFN
(starcoder2), and gemma2's local window on every other layer (16 tokens
at smoke size, so prompts here run past it), attention and logit
softcaps, post-norms, embedding scale and tied embeddings; opt-30b
takes learned absolute positions (no RoPE) in prefill, over history, in
decode on both caches and in the recompute replay. Tolerance:
atol 1e-4 on logits, hidden states and K/V (the frameworks sum in
another order); greedy tokens equal; restored K/V bitwise equal to what
prefill (or decode) emitted; paged tokens equal to contiguous."""
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
from repro.models.module import split
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.storage import ChunkStore as JaxStore
from repro.storage import make_array as jax_make_array
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.config.hardware import PAPER_A100
from repro_torch.configs import REGISTRY, get_arch
from repro_torch.core.hcache import HCacheManager
from repro_torch.launch import serve as serve_cli
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import InferenceEngine, Request
from repro_torch.storage import ChunkStore, make_array

NAMES = ("qwen2-7b", "qwen2.5-14b", "starcoder2-15b", "gemma2-9b",
         "opt-30b")
SOURCES = {"opt-30b": "arXiv:2205.01068",
           "qwen2-7b": "arXiv:2407.10671",
           "qwen2.5-14b": "hf:Qwen/Qwen2.5-14B",
           "starcoder2-15b": "arXiv:2402.19173",
           "gemma2-9b": "arXiv:2408.00118"}
ATOL = 1e-4
N = 40                    # prompt tokens: past gemma2's smoke window of 16


@pytest.fixture(scope="module", params=NAMES)
def pair(request, rules):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = jax_reduced(jax_get_arch(request.param))
    jm = JaxModel(cfg, rules=rules, dtype=jnp.float32, remat="none")
    jparams, _ = split(jm.init(jax.random.PRNGKey(0)))
    tcfg = reduced_for_smoke(get_arch(request.param))
    tm = Model(tcfg, device="cpu")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    yield tcfg, jm, jparams, tm, tparams
    torch.set_num_threads(n)


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n),
                                                dtype=np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def _greedy(logits):
    return torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]


# ------------------------------------------------------------ the registry
@pytest.mark.parametrize("name", NAMES)
def test_registry_holds_the_reference_config(name):
    cfg = get_arch(name)
    assert REGISTRY[name] is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_arch(name))
    assert cfg.source == SOURCES[name]
    assert cfg.family == "dense"


def test_the_smoke_configs_take_the_paths_llama2_does_not(pair):
    cfg = pair[0]
    if cfg.name == "gemma2-9b":
        assert cfg.local_window == 16 and cfg.layer_pattern == "LG"
        assert tfm.layer_windows(pair[3].h) == [16, None, 16, None]
        assert cfg.tie_embeddings and cfg.embedding_scale
        assert cfg.post_attn_norm and cfg.attn_softcap and \
            cfg.logit_softcap
    elif cfg.name == "opt-30b":
        assert not cfg.use_rope and cfg.norm == "layernorm"
        assert pair[4]["embed"]["positions"].shape == (8192, cfg.d_model)
    else:
        assert cfg.qkv_bias and "bk" in pair[4]["blocks"]["attn"]
    if cfg.name == "starcoder2-15b":
        assert cfg.norm == "layernorm" and not cfg.ffn_glu
        assert "bias" in pair[4]["blocks"]["ln1"]


# --------------------------------------------------------------- the model
def test_prefill_logits_hidden_kv_match_jax(pair):
    cfg, jm, jparams, tm, tparams = pair
    toks = _tokens(cfg, N, 1)
    jout = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                      capture_hidden=True)
    tout = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                      capture_hidden=True)
    _close(tout["logits"], jout["logits"])
    _close(tout["hidden"], jout["hidden"])
    _close(tout["kv"][0], jout["kv"][0])
    _close(tout["kv"][1], jout["kv"][1])
    # every position's logits (softcap and tied head included)
    full = tfm.lm_forward(tparams, torch.from_numpy(toks), tm.h)["logits"]
    _close(full[:, -1:], jout["logits"])
    assert torch.isfinite(full).all() and full.shape[1] == N
    # the paper's op, bias rows included: restored K/V is prefill's bits
    pos = torch.arange(N)[None]
    rk, rv = tm.restore_kv_from_hidden(tparams, tout["hidden"],
                                       positions=pos)
    assert torch.equal(rk, tout["kv"][0]) and torch.equal(rv, tout["kv"][1])
    jk, jv = jm.restore_kv_from_hidden(jparams, jout["hidden"],
                                       positions=jnp.arange(N)[None])
    _close(rk, jk)
    _close(rv, jv)


def test_prefill_over_restored_history_matches_jax(pair):
    """12 new tokens over 24 of history: gemma2's local layers mask the
    history beyond 16 tokens back."""
    cfg, jm, jparams, tm, tparams = pair
    hist, new = _tokens(cfg, 24, 2), _tokens(cfg, 12, 3)
    jh = jm.prefill(jparams, {"tokens": jnp.asarray(hist)})
    th = tm.prefill(tparams, {"tokens": torch.from_numpy(hist)})
    jout = jm.prefill(jparams, {"tokens": jnp.asarray(new)},
                      capture_hidden=True, hist_kv=jh["kv"], hist_len=24)
    tout = tm.prefill(tparams, {"tokens": torch.from_numpy(new)},
                      capture_hidden=True, hist_kv=th["kv"], hist_len=24)
    _close(tout["logits"], jout["logits"])
    _close(tout["hidden"], jout["hidden"])
    _close(tout["kv"][0], jout["kv"][0])
    _close(tout["kv"][1], jout["kv"][1])


def test_greedy_decode_matches_jax(pair):
    """12 prompt tokens, then 10 greedy steps: the decode steps cross
    gemma2's window, so the local layers drop their oldest keys."""
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
    jtok = jnp.argmax(jout["logits"][:, -1], -1).astype(jnp.int32)[:, None]
    ttok = _greedy(tout["logits"])
    jseq, tseq = [], []
    for _ in range(10):
        jseq.append(int(jtok[0, 0]))
        tseq.append(int(ttok[0, 0]))
        jl, jc, jh = jm.decode_step_full(jparams, jc, jtok)
        tl, tc, th = tm.decode_step_full(tparams, tc, ttok)
        _close(tl, jl)
        _close(th, jh)
        _close(tc["k"], jc["k"])
        jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = _greedy(tl)
    assert tseq == jseq
    assert int(tc["lengths"][0]) == int(jc["lengths"][0]) == 22


# ------------------------------------------------------------ restoration
def _manager(model, override, group=8):
    return HCacheManager(model, ChunkStore(make_array("ssd", 4),
                                           chunk_tokens=16),
                         schedule_override=override,
                         restore_group_size=group)


@pytest.mark.parametrize("override,group", [("hidden", 1), ("hidden", 8),
                                            ("recompute", 8), ("kv", 8),
                                            (None, 8)])
def test_restored_kv_is_prefill_kv_bitwise(pair, override, group):
    cfg, _, _, tm, tparams = pair
    toks = torch.from_numpy(_tokens(cfg, N, 5))
    out = tm.prefill(tparams, {"tokens": toks}, capture_hidden=True)
    mgr = _manager(tm, override, group)
    try:
        mgr.save_prefill("s", toks[0].numpy(), out)
        res = mgr.restore(tparams, "s")
    finally:
        mgr.close()
    assert torch.equal(res.cache["k"], out["kv"][0])
    assert torch.equal(res.cache["v"], out["kv"][1])
    assert int(res.cache["lengths"][0]) == N


@pytest.mark.parametrize("override", ["hidden", "recompute"])
def test_restore_after_decode_matches_the_never_evicted_cache(pair,
                                                              override):
    """Prefill 30, decode 8 saving hidden states, pause, evict, restore:
    the K/V of the decoded history is the live cache's bits (the
    recompute replay runs the local window as decode ran it), and greedy
    decoding from it gives the never-evicted cache's tokens (MATCH)."""
    cfg, _, _, tm, tparams = pair
    toks = torch.from_numpy(_tokens(cfg, 30, 6))
    out = tm.prefill(tparams, {"tokens": toks}, capture_hidden=True)
    mgr = _manager(tm, override)
    cap = 64
    try:
        mgr.save_prefill("s", toks[0].numpy(), out)
        live = tm.init_cache(1, cap)
        live["k"][:, :, :30], live["v"][:, :, :30] = out["kv"]
        live["lengths"] = torch.tensor([30], dtype=torch.int32)
        tok, inputs = _greedy(out["logits"]), []
        for _ in range(8):
            inputs.append(int(tok[0, 0]))
            lengths = live["lengths"].clone()
            lg, live, hidden = tm.decode_step_full(tparams, live, tok)
            mgr.save_decode_hidden(["s"], hidden, lengths)
            tok = _greedy(lg)
        mgr.save_session_pause("s", live, 38, tokens_tail=inputs)
        res = mgr.restore(tparams, "s", capacity=cap)
    finally:
        mgr.close()
    for name in ("k", "v"):
        assert torch.equal(res.cache[name][:, :, :38], live[name][:, :, :38])
    seqs = []
    for cache in (res.cache, {k: v.clone() for k, v in live.items()}):
        t, seq = tok, []
        for _ in range(6):
            seq.append(int(t[0, 0]))
            lg, cache = tm.decode_step(tparams, cache, t)
            t = _greedy(lg)
        seqs.append(seq)
    assert seqs[0] == seqs[1], "MISMATCH"


# ----------------------------------------------------------------- engine
def _serve(engine, rounds, request_cls):
    out = []
    for reqs in rounds:
        for sid, prompt, n in reqs:
            engine.submit(request_cls(sid, prompt, max_new_tokens=n))
        engine.run()
        out.append({sid: engine.result(sid) for sid, _, _ in reqs})
    metrics = engine.metrics
    engine.close()
    return out, metrics


def test_engine_matches_jax_on_both_backends(pair):
    """3 sessions x 2 rounds over 2 slots with mid-stream eviction: the
    port's contiguous and paged engines give the JAX engine's tokens
    (prompts of 18-30 tokens in chunks of 8, so chunks and decode steps
    cross gemma2's window)."""
    cfg, jm, jparams, tm, tparams = pair
    rng = np.random.default_rng(7)
    rounds = [[(f"s{i}", rng.integers(0, cfg.vocab_size, n).astype(
        np.int32), 5) for i, n in enumerate((30, 18, 24))],
        [(f"s{i}", rng.integers(0, cfg.vocab_size, 6).astype(np.int32), 4)
         for i in range(3)]]
    kw = dict(max_batch=2, max_seq=96, prefill_chunk=8, preempt_quantum=3)
    jmgr = JaxManager(jm, JaxStore(jax_make_array("dram", 4),
                                   chunk_tokens=16),
                      hw=JAX_A100, schedule_override="hidden",
                      store_dtype=np.float32)
    want, jmetrics = _serve(JaxEngine(jm, jparams, jmgr, **kw), rounds,
                            JaxRequest)
    for backend in ("contiguous", "paged"):
        mgr = HCacheManager(tm, ChunkStore(make_array("dram", 4),
                                           chunk_tokens=16),
                            hw=PAPER_A100, schedule_override="hidden")
        got, metrics = _serve(InferenceEngine(tm, tparams, mgr,
                                              backend=backend, **kw),
                              rounds, Request)
        assert got == want, backend
        assert metrics.preemptions == jmetrics.preemptions > 0
        assert metrics.restored_tokens == jmetrics.restored_tokens > 0


def test_serve_cli_serves_two_rounds(pair, capsys):
    name = pair[0].name
    serve_cli.main(["--arch", name, "--device", "cpu", "--sessions", "2",
                    "--rounds", "2", "--prompt-len", "20", "--gen", "3",
                    "--max-seq", "64"])
    out = capsys.readouterr().out
    assert out.startswith(f"{name}: 4 layers")
    for rnd in range(2):
        for s in range(2):
            assert f"round {rnd} user{s}: 3 tokens" in out
    assert "recoverable sessions: ['user0', 'user1']" in out
