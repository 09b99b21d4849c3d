"""The MoE configs (granite-moe-1b-a400m, grok-1-314b) and the VLM
backbone (internvl2-26b) in the port, held against the JAX package on the
same weights.

Each is built at ``reduced_for_smoke`` size (4 layers, 4 heads of 16,
fp32; granite and grok with 4 experts, top-2, expert d_ff 32; internvl
with 8 patch positions) from the reference's own ``init`` through
``from_jax_params``. Tolerance: atol 1e-4 on logits, hidden states and
K/V (the frameworks sum in another order); greedy tokens equal; restored
K/V bitwise equal to what the port's prefill emitted. Every MoE case
asserts that each token's k-th and (k+1)-th router probabilities lie more
than 1e-4 apart, so fp32 rounding cannot flip its expert choice between
the frameworks.

Patches: internvl's prefill with patch embeddings matches the
reference's; the port's restore of a patched session rebuilds its
recompute layers with the stored patches, so it equals the prefill's K/V,
where the reference's own restore (tokens only) does not."""
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
from repro.storage import ChunkStore as JaxStore
from repro.storage import make_array as jax_make_array
from repro_torch.config.arch import ArchConfig, reduced_for_smoke
from repro_torch.config.hardware import PAPER_A100
from repro_torch.configs import REGISTRY, get_arch
from repro_torch.core.hcache import HCacheManager
from repro_torch.launch import serve as serve_cli
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers import moe as tmoe
from repro_torch.storage import ChunkStore, make_array
from test_torch_engine import MixedPlanManager

NAMES = ("granite-moe-1b-a400m", "grok-1-314b", "internvl2-26b")
SOURCES = {"granite-moe-1b-a400m": ("moe",
                                    "hf:ibm-granite/granite-3.0-1b-a400m-base"),
           "grok-1-314b": ("moe", "hf:xai-org/grok-1"),
           "internvl2-26b": ("vlm", "arXiv:2404.16821")}
VLM = "internvl2-26b"
ATOL = 1e-4
MARGIN = 1e-4
N = 40
_BUILT = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(name, rules):
    """(port cfg, JAX model, JAX params, port model, port params) of
    ``name`` at smoke size, built once per process."""
    if name not in _BUILT:
        cfg = jax_reduced(jax_get_arch(name))
        jm = JaxModel(cfg, rules=rules, dtype=jnp.float32, remat="none")
        jparams, _ = split(jm.init(jax.random.PRNGKey(0)))
        tcfg = reduced_for_smoke(get_arch(name))
        tm = Model(tcfg, device="cpu")
        tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                  device="cpu")
        _BUILT[name] = (tcfg, jm, jparams, tm, tparams)
    return _BUILT[name]


@pytest.fixture(scope="module", params=NAMES)
def pair(request, rules):
    return _build(request.param, rules)


@pytest.fixture(scope="module")
def vlm(rules):
    return _build(VLM, rules)


@pytest.fixture
def margins(monkeypatch):
    """The smallest gap between a token's k-th and (k+1)-th router
    probability over every MoE call of the test (a list, one per call)."""
    seen = []
    route = tmoe.route

    def spy(p, x, h):
        probs = torch.softmax(torch.matmul(x.float(), p["router"].float()),
                              -1)
        top = torch.topk(probs, h.top_k + 1, dim=-1).values
        seen.append(float((top[..., h.top_k - 1]
                           - top[..., h.top_k]).min()))
        return route(p, x, h)

    monkeypatch.setattr(tmoe, "route", spy)
    return seen


def _well_posed(cfg, seen):
    if cfg.n_experts:
        assert seen and min(seen) > MARGIN, min(seen)
    else:
        assert not seen


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n),
                                                dtype=np.int32)


def _patches(cfg, seed):
    return (np.random.default_rng(seed).standard_normal(
        (1, cfg.frontend_dim, cfg.d_model)) * 0.5).astype(np.float32)


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
    assert (cfg.family, cfg.source) == SOURCES[name]


@pytest.mark.parametrize("name", NAMES)
def test_model_builds_at_the_published_size(name):
    cfg = get_arch(name)
    m = Model(cfg, device="cpu")
    assert m.kind == "lm" and m.adapter.supports_recompute
    assert (m.h.moe is None) == (cfg.family == "vlm")
    if m.h.moe is not None:
        assert (m.h.moe.n_experts, m.h.moe.top_k, m.h.moe.d_ff) == (
            cfg.n_experts, cfg.experts_per_token, cfg.d_ff)


@pytest.mark.parametrize("name", ["zamba2-2.7b", "whisper-medium"])
def test_hybrid_and_encdec_are_not_ported(name):
    """What the two families still refuse, as the reference does or as
    its faults require: the hybrid cache does not page; an enc-dec stack
    gets no recompute layer from the planner, and its engine refuses
    prefix sharing."""
    cfg = ArchConfig(**dataclasses.asdict(jax_get_arch(name)))
    assert cfg.family == "hybrid" or cfg.is_encoder_decoder
    if cfg.family == "hybrid":
        model = Model(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="lm-family"):
            model.init_paged_cache(2, 8, 16, 4)
        return
    from repro_torch.serving import InferenceEngine
    model = Model(reduced_for_smoke(cfg), device="cpu")
    mgr = HCacheManager(model, ChunkStore(make_array("dram", 2)))
    try:
        assert not model.adapter.supports_recompute
        for n in (128, 4096):
            assert "recompute" not in mgr.plan(n).methods
        with pytest.raises(NotImplementedError, match="prefix sharing"):
            InferenceEngine(model, model.init(0), mgr, backend="paged",
                            prefix_sharing=True)
    finally:
        mgr.close()


# --------------------------------------------------------------- the model
def test_prefill_logits_hidden_kv_match_jax(pair, margins):
    cfg, jm, jparams, tm, tparams = pair
    toks = _tokens(cfg, N, 1)
    jout = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                      capture_hidden=True)
    tout = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                      capture_hidden=True)
    _well_posed(cfg, margins)
    _close(tout["logits"], jout["logits"])
    _close(tout["hidden"], jout["hidden"])
    _close(tout["kv"][0], jout["kv"][0])
    _close(tout["kv"][1], jout["kv"][1])
    pos = torch.arange(N)[None]
    rk, rv = tm.restore_kv_from_hidden(tparams, tout["hidden"],
                                       positions=pos)
    assert torch.equal(rk, tout["kv"][0]) and torch.equal(rv, tout["kv"][1])


def test_prefill_over_restored_history_matches_jax(pair, margins):
    """12 new tokens over 24 of history: the MoE capacity follows the
    12-token segment."""
    cfg, jm, jparams, tm, tparams = pair
    hist, new = _tokens(cfg, 24, 2), _tokens(cfg, 12, 3)
    jh = jm.prefill(jparams, {"tokens": jnp.asarray(hist)})
    th = tm.prefill(tparams, {"tokens": torch.from_numpy(hist)})
    jout = jm.prefill(jparams, {"tokens": jnp.asarray(new)},
                      capture_hidden=True, hist_kv=jh["kv"], hist_len=24)
    tout = tm.prefill(tparams, {"tokens": torch.from_numpy(new)},
                      capture_hidden=True, hist_kv=th["kv"], hist_len=24)
    _well_posed(cfg, margins)
    _close(tout["logits"], jout["logits"])
    _close(tout["hidden"], jout["hidden"])
    _close(tout["kv"][0], jout["kv"][0])
    _close(tout["kv"][1], jout["kv"][1])


def test_greedy_decode_matches_jax(pair, margins):
    """12 prompt tokens, then 10 greedy steps (S = 1: capacity 1, every
    expert's slot computed)."""
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
    _well_posed(cfg, margins)
    assert tseq == jseq


# ------------------------------------------------------------ restoration
def _manager(model, override=None, cls=HCacheManager):
    return cls(model, ChunkStore(make_array("ssd", 4), chunk_tokens=16),
               hw=PAPER_A100, schedule_override=override)


def _padded(x, ctx):
    out = torch.zeros(x.shape[:2] + (ctx,) + x.shape[3:], dtype=x.dtype)
    out[:, :, :x.shape[2]] = x
    return out


@pytest.mark.parametrize("override", ["hidden", "kv", None])
def test_restore_then_decode_matches_ground_truth(pair, override, margins):
    """As the reference's test_hcache does: restore, decode one token from
    the restored cache, and hold its logits against the JAX model's step
    from its own prefill's cache; the restored K/V is the port prefill's
    bits."""
    cfg, jm, jparams, tm, tparams = pair
    toks = _tokens(cfg, N, 5)
    jpre = jm.prefill(jparams, {"tokens": jnp.asarray(toks)})
    pre = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                     capture_hidden=True)
    mgr = _manager(tm, override)
    try:
        mgr.save_prefill("sess", toks[0], pre)
        res = mgr.restore(tparams, "sess")
    finally:
        mgr.close()
    assert torch.equal(res.cache["k"], pre["kv"][0])
    assert torch.equal(res.cache["v"], pre["kv"][1])
    nt = _greedy(pre["logits"])
    cache = {"k": _padded(res.cache["k"], 64), "v": _padded(res.cache["v"],
                                                            64),
             "lengths": torch.tensor([N], dtype=torch.int32)}
    lg, _ = tm.decode_step(tparams, cache, nt)
    jc = {"k": jnp.pad(jpre["kv"][0], ((0, 0), (0, 0), (0, 64 - N),
                                       (0, 0), (0, 0))),
          "v": jnp.pad(jpre["kv"][1], ((0, 0), (0, 0), (0, 64 - N),
                                       (0, 0), (0, 0))),
          "lengths": jnp.asarray([N], jnp.int32)}
    jl, _ = jm.decode_step(jparams, jc, jnp.asarray(nt.numpy()))
    _well_posed(cfg, margins)
    _close(lg, jl)


# ----------------------------------------------------------------- patches
def _patched_prefill(vlm, seed=6):
    cfg, jm, jparams, tm, tparams = vlm
    toks, patches = _tokens(cfg, N, seed), _patches(cfg, seed)
    jout = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                "patches": jnp.asarray(patches)},
                      capture_hidden=True)
    tout = tm.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                "patches": torch.from_numpy(patches)},
                      capture_hidden=True)
    return toks, patches, jout, tout


def test_patched_prefill_matches_jax(vlm):
    cfg, jm, jparams, tm, tparams = vlm
    toks, patches, jout, tout = _patched_prefill(vlm)
    assert cfg.frontend_dim == patches.shape[1] == 8
    _close(tout["logits"], jout["logits"])
    _close(tout["hidden"], jout["hidden"])
    _close(tout["kv"][0], jout["kv"][0])
    _close(tout["kv"][1], jout["kv"][1])
    assert torch.equal(tout["patches"], torch.from_numpy(patches))
    # the patches move every later position's K/V: they are in play
    plain = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    assert float((plain["kv"][0][1] - tout["kv"][0][1]).abs().max()) > 1e-2


@pytest.mark.parametrize("manager", ["recompute", "mixed"])
def test_patched_restore_rebuilds_the_prefill_kv(vlm, manager):
    """Recompute layers replay the first prefill with its stored patches:
    the restored K/V is the port prefill's bits, and within ATOL of the
    reference's prefill with the same patches."""
    cfg, jm, jparams, tm, tparams = vlm
    toks, patches, jout, tout = _patched_prefill(vlm)
    mgr = (_manager(tm, "recompute") if manager == "recompute"
           else _manager(tm, cls=MixedPlanManager))
    try:
        mgr.save_prefill("sess", toks[0], tout)
        assert mgr.store.has_blob("sess", "patches", 0)
        res = mgr.restore(tparams, "sess")
    finally:
        mgr.close()
    assert "recompute" in res.schedule.methods
    assert torch.equal(res.cache["k"], tout["kv"][0])
    assert torch.equal(res.cache["v"], tout["kv"][1])
    _close(res.cache["k"], jout["kv"][0])
    _close(res.cache["v"], jout["kv"][1])


def test_reference_restore_of_a_patched_session_drops_the_patches(vlm):
    """The reference rebuilds recompute layers from token embeddings
    only: its restored K/V of a patched session is not its prefill's."""
    cfg, jm, jparams, tm, tparams = vlm
    toks, patches, jout, _ = _patched_prefill(vlm)
    mgr = JaxManager(jm, JaxStore(jax_make_array("dram", 4),
                                  chunk_tokens=16),
                     hw=JAX_A100, schedule_override="recompute",
                     store_dtype=np.float32)
    mgr.save_prefill("sess", toks[0], jout)
    res = mgr.restore(jparams, "sess")
    err = float(jnp.abs(res.cache["k"] - jout["kv"][0]).max())
    assert err > 1e-2, err
    # layer 0's K at the patch positions: token embeddings in place of
    # the patches
    assert float(jnp.abs(res.cache["k"][0, :, :8]
                         - jout["kv"][0][0, :, :8]).max()) > 1e-2


def test_patched_session_second_round_restores_bitwise(vlm):
    """Round 0 with patches, 6 decoded tokens saved, a pause; round 1
    prefills 10 tokens over the restored history without patches (a
    patch at start > 0 is refused), decodes 4; the final restore equals
    the live cache bitwise, recompute layers included."""
    cfg, jm, jparams, tm, tparams = vlm
    toks, patches, _, out = _patched_prefill(vlm)
    mgr = _manager(tm, cls=MixedPlanManager)
    cap = 80
    try:
        mgr.save_prefill("s", toks[0], out)
        live = tm.init_cache(1, cap)
        live["k"][:, :, :N], live["v"][:, :, :N] = out["kv"]
        live["lengths"] = torch.tensor([N], dtype=torch.int32)
        n, tok = N, _greedy(out["logits"])
        for rnd in range(2):
            if rnd:
                res = mgr.restore(tparams, "s", capacity=cap)
                for name in ("k", "v"):
                    assert torch.equal(res.cache[name][:, :, :n],
                                       live[name][:, :, :n])
                new = _tokens(cfg, 10, 7)
                with pytest.raises(ValueError, match="first prefill"):
                    mgr.save_prefill("s", new[0], {
                        "patches": torch.from_numpy(patches)}, start=n)
                hk, hv = live["k"][:, :, :n], live["v"][:, :, :n]
                out = tm.prefill(tparams, {"tokens": torch.from_numpy(new)},
                                 capture_hidden=True, hist_kv=(hk, hv),
                                 hist_len=n)
                mgr.save_prefill("s", new[0], out, start=n)
                live["k"][:, :, n:n + 10], live["v"][:, :, n:n + 10] = \
                    out["kv"]
                n += 10
                live["lengths"] = torch.tensor([n], dtype=torch.int32)
                tok = _greedy(out["logits"])
            inputs = []
            for _ in range(6 if rnd == 0 else 4):
                inputs.append(int(tok[0, 0]))
                lengths = live["lengths"].clone()
                lg, live, hidden = tm.decode_step_full(tparams, live, tok)
                mgr.save_decode_hidden(["s"], hidden, lengths)
                tok = _greedy(lg)
            n += len(inputs)
            mgr.save_session_pause("s", live, n, tokens_tail=inputs)
        res = mgr.restore(tparams, "s", capacity=cap)
    finally:
        mgr.close()
    assert "recompute" in res.schedule.methods and n == N + 20
    for name in ("k", "v"):
        assert torch.equal(res.cache[name][:, :, :n], live[name][:, :, :n])


def test_patches_blob_follows_the_session(vlm):
    """A fork carries the patches and its eviction leaves its source's; a
    text-only session saved anew under an id drops a stale blob; eviction
    drops the blob."""
    cfg, _, _, tm, tparams = vlm
    toks, _, _, out = _patched_prefill(vlm)
    mgr = _manager(tm, "recompute")
    try:
        mgr.save_prefill("a", toks[0], out)
        mgr.fork_session("a", "b")
        assert mgr.store.has_blob("b", "patches", 0)
        res = mgr.restore(tparams, "b")
        assert torch.equal(res.cache["k"], out["kv"][0])
        mgr.evict("b")
        assert not mgr.store.has_blob("b", "patches", 0)
        assert mgr.store.has_blob("a", "patches", 0)
        text = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                          capture_hidden=True)
        mgr.save_prefill("a", toks[0], text)
        assert not mgr.store.has_blob("a", "patches", 0)
        res = mgr.restore(tparams, "a")
        assert torch.equal(res.cache["k"], text["kv"][0])
        mgr.save_prefill("c", toks[0], out)
        mgr.evict("c")
        assert not mgr.store.has_blob("c", "patches", 0)
    finally:
        mgr.close()


# ------------------------------------------------------------------ serve
@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", VLM])
def test_serve_cli_serves_two_rounds(name, capsys):
    serve_cli.main(["--arch", name, "--device", "cpu", "--sessions", "2",
                    "--rounds", "2", "--prompt-len", "20", "--gen", "3",
                    "--max-seq", "64", "--preempt-quantum", "2"])
    out = capsys.readouterr().out
    assert out.startswith(f"{name}: 4 layers")
    for rnd in range(2):
        for s in range(2):
            assert f"round {rnd} user{s}: 3 tokens" in out
    assert "recoverable sessions: ['user0', 'user1']" in out


def test_serve_refuses_grok_at_full_size(capsys):
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(["--arch", "grok-1-314b", "--full", "--device",
                        "cpu"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "grok-1-314b" in err and "633.0 GB in bf16" in err
    assert "80.0 GB of one card's memory" in err
