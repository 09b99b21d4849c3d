"""The enc-dec family (whisper-medium) in the port, held against the JAX
package on the same weights.

The model is built at ``reduced_for_smoke`` size (2 encoder and 4 decoder
layers, 4 heads of 16, fp32) from the reference's own ``init`` through
``from_jax_params``; frames are seeded normals x 0.1 (numpy), as the
reference's tests draw them. Tolerance: atol 1e-4 on encoder outputs,
logits, hidden states and K/V (the frameworks sum in another order);
greedy tokens equal. Inside the port: restored self K/V and cross K/V
bitwise equal to what prefill and decode held, paged decode bitwise equal
to contiguous; the restore's cost side (task graph, cross times, group
plans, makespans) equal to the reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.config.hardware import PAPER_A100 as JAX_A100
from repro.configs import get_arch as jax_get_arch
from repro.core import restoration as jax_restoration
from repro.core.capacity import restore_makespan as jax_restore_makespan
from repro.core.hcache import HCacheManager as JaxManager
from repro.models import Model as JaxModel
from repro.models import encdec as jax_encdec
from repro.models.module import split
from repro.storage import ChunkStore as JaxStore
from repro.storage import make_array as jax_make_array
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.config.hardware import PAPER_A100
from repro_torch.configs import REGISTRY, get_arch
from repro_torch.core import restoration
from repro_torch.core.capacity import restore_makespan
from repro_torch.core.hcache import HCacheManager
from repro_torch.models import Model, encdec
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers.rope import sinusoidal_positions
from repro_torch.serving.kv_cache import make_backend, paged_write_index
from repro_torch.storage import ChunkStore, make_array

ARCH = "whisper-medium"
ATOL = 1e-4


@pytest.fixture(scope="module")
def pair(rules):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = jax_reduced(jax_get_arch(ARCH))
    jm = JaxModel(cfg, rules=rules, dtype=jnp.float32, remat="none")
    jparams, _ = split(jm.init(jax.random.PRNGKey(0)))
    tcfg = reduced_for_smoke(get_arch(ARCH))
    tm = Model(tcfg, device="cpu")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    yield tcfg, jm, jparams, tm, tparams
    torch.set_num_threads(n)


def _frames(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, cfg.d_model)) * 0.1).astype(np.float32)


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n),
                                                dtype=np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def _prefills(pair, frames, toks):
    """(JAX, port) prefill outputs of one session, hidden states kept."""
    _, jm, jparams, tm, tparams = pair
    jout = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                "frames": jnp.asarray(frames)[None]},
                      capture_hidden=True)
    tout = tm.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                "frames": torch.from_numpy(frames)[None]},
                      capture_hidden=True)
    return jout, tout


# ------------------------------------------------------------ the registry
def test_registry_holds_the_reference_config():
    cfg = get_arch(ARCH)
    assert REGISTRY[ARCH] is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_get_arch(ARCH))
    assert cfg.is_encoder_decoder and not cfg.use_rope
    assert cfg.source == "arXiv:2212.04356"


def test_from_jax_params_carries_the_encdec_tree(pair):
    cfg, _, jparams, tm, tparams = pair
    assert tm.kind == "encdec"
    assert set(tparams) == {"embed", "enc_blocks", "enc_norm", "dec_blocks",
                            "final_norm"}
    assert set(tparams["dec_blocks"]) == {"ln1", "self_attn", "ln_x",
                                          "cross_attn", "ln2", "mlp"}
    flat_t = {k: v for k, v in _flat(tparams)}
    flat_j = {k: np.asarray(v) for k, v in _flat(jparams)}
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_t.items():
        assert np.array_equal(v.numpy(), flat_j[k]), k
    assert tparams["embed"]["positions"].shape == (8192, cfg.d_model)
    assert tparams["enc_blocks"]["attn"]["wk"].shape[0] == \
        cfg.encoder_layers


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("n,d,atol", [(24, 64, 1e-5), (1500, 1024, 3e-4)])
def test_sinusoidal_positions_match_jax(n, d, atol):
    """Tolerance: fp32 angles near 23 and 1500 rad are spaced 1.9e-6 and
    1.2e-4 apart, and the two packages' frequencies may differ in their
    last bit, so their angles (and sines) may differ by a few such
    steps."""
    from repro.models.layers.rope import \
        sinusoidal_positions as jax_sinusoid
    np.testing.assert_allclose(sinusoidal_positions(n, d).numpy(),
                               np.asarray(jax_sinusoid(n, d)), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("name", [ARCH, "opt-30b"])
def test_positions_past_the_learned_table_raise(name):
    """A decoder position past the 8192-row table raises (the reference's
    ``jnp.take`` would clamp it); the last row is still served."""
    model = Model(reduced_for_smoke(get_arch(name)), device="cpu")
    params = model.init(0)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    if model.kind == "encdec":
        h, frames = model.h, torch.zeros((1, 8, model.cfg.d_model))
        enc_out, _ = encdec.encode(params, frames, h)

        def run(offset):
            return encdec.decode_prefill(params, toks, enc_out, h,
                                         pos_offset=offset)
    else:
        from repro_torch.models import transformer as tfm

        def run(offset):
            c = model.cfg
            hist = torch.zeros((c.n_layers, 1, offset, c.n_kv_heads,
                                c.head_dim_))
            return tfm.lm_forward(params, toks, model.h,
                                  hist_kv=(hist, hist), hist_len=offset)
    assert torch.isfinite(run(8188)["logits"]).all()
    with pytest.raises(IndexError, match="8192-row"):
        run(8189)


# --------------------------------------------------------------- the model
def test_encode_matches_jax(pair):
    cfg, jm, jparams, tm, tparams = pair
    frames = _frames(cfg, 24, 1)[None]
    jout, jh = jax_encdec.encode(jparams, jnp.asarray(frames), jm.h,
                                 capture_hidden=True)
    tout, th = encdec.encode(tparams, torch.from_numpy(frames), tm.h,
                             capture_hidden=True)
    _close(tout, jout)
    _close(th, jh)
    assert th.shape == (cfg.encoder_layers, 1, 24, cfg.d_model)


def test_prefill_logits_hidden_self_and_cross_kv_match_jax(pair):
    cfg, jm, jparams, tm, tparams = pair
    toks = _tokens(cfg, 20, 2)
    jout, tout = _prefills(pair, _frames(cfg, 24, 1), toks)
    _close(tout["logits"], jout["logits"])
    _close(tout["hidden"], jout["hidden"])
    for i in range(2):
        _close(tout["kv"][i], jout["kv"][i])
        _close(tout["cross_kv"][i], jout["cross_kv"][i])
    assert tout["cross_kv"][0].shape == (cfg.n_layers, 1, 24, cfg.n_heads,
                                         cfg.head_dim_)
    # the paper's op and the cross projection give prefill's bits
    rk, rv = tm.restore_kv_from_hidden(tparams, tout["hidden"],
                                       positions=torch.arange(20)[None])
    assert torch.equal(rk, tout["kv"][0]) and torch.equal(rv, tout["kv"][1])
    ck, cv = encdec.cross_kv(tparams, tout["enc_out"], tm.h)
    assert torch.equal(ck, tout["cross_kv"][0])
    assert torch.equal(cv, tout["cross_kv"][1])


def _batched_caches(pair, jobs, ctx):
    """Prefill each (frames, prompt) at B=1 in both packages and pack the
    sessions into one B=len(jobs) decode cache each, with per-row
    enc_len; returns (jax cache, port cache, first tokens)."""
    cfg, jm, jparams, tm, tparams = pair
    L, H, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim_
    B = len(jobs)
    enc_max = max(len(f) for f, _ in jobs)
    jc = {k: np.zeros((L, B, n, H, hd), np.float32)
          for k, n in (("self_k", ctx), ("self_v", ctx), ("cross_k", enc_max),
                       ("cross_v", enc_max))}
    tc = tm.init_cache(B, ctx, enc_seq=enc_max)
    first = []
    for b, (frames, toks) in enumerate(jobs):
        jout, tout = _prefills(pair, frames, toks)
        S, E = toks.shape[1], len(frames)
        for name, src, t in (("self_k", "kv", 0), ("self_v", "kv", 1),
                             ("cross_k", "cross_kv", 0),
                             ("cross_v", "cross_kv", 1)):
            n = S if src == "kv" else E
            jc[name][:, b, :n] = np.asarray(jout[src][t][:, 0])
            tc[name][:, b, :n] = tout[src][t][:, 0]
        first.append(int(torch.argmax(tout["logits"][0, -1])))
        assert first[-1] == int(jnp.argmax(jout["logits"][0, -1]))
    lengths = [j[1].shape[1] for j in jobs]
    enc = [len(j[0]) for j in jobs]
    jc = {k: jnp.asarray(v) for k, v in jc.items()}
    jc["lengths"] = jnp.asarray(lengths, jnp.int32)
    jc["enc_len"] = jnp.asarray(enc, jnp.int32)
    tc["lengths"] = torch.tensor(lengths, dtype=torch.int32)
    tc["enc_len"] = torch.tensor(enc, dtype=torch.int32)
    return jc, tc, first


def _paged_cache(tm, tc, block_size=8):
    """The contiguous port cache ``tc`` laid out in a page pool, pages of
    the rows interleaved in reverse so that the table matters."""
    L, B, ctx = tc["self_k"].shape[:3]
    MB = ctx // block_size
    NB = B * MB
    cache = tm.init_paged_cache(B, NB, block_size, MB)
    table = np.arange(NB, dtype=np.int32)[::-1].reshape(MB, B).T.copy()
    for b in range(B):
        for j in range(MB):
            src = slice(j * block_size, (j + 1) * block_size)
            cache["k_pool"][:, table[b, j]] = tc["self_k"][:, b, src]
            cache["v_pool"][:, table[b, j]] = tc["self_v"][:, b, src]
    cache["block_table"] = torch.from_numpy(table)
    for k in ("cross_k", "cross_v", "enc_len", "lengths"):
        cache[k] = tc[k].clone()
    return cache, table


def test_greedy_decode_with_mixed_enc_len_matches_jax(pair):
    """Two sessions of 16 and 24 frames and 9 and 13 prompt tokens decode
    8 tokens in one batch: the port's contiguous step against the JAX
    step (logits, hidden states, self K/V, tokens), and the port's paged
    step bitwise equal to its contiguous step."""
    cfg, jm, jparams, tm, tparams = pair
    jobs = [(_frames(cfg, 16, 3), _tokens(cfg, 9, 4)),
            (_frames(cfg, 24, 5), _tokens(cfg, 13, 6))]
    jc, tc, first = _batched_caches(pair, jobs, 32)
    pc, table = _paged_cache(tm, tc)
    NB, bs = pc["k_pool"].shape[1:3]
    jtok = jnp.asarray(first, jnp.int32)[:, None]
    ttok = torch.tensor(first, dtype=torch.int32)[:, None]
    jseq, tseq = [], []
    for _ in range(8):
        jseq.append(np.asarray(jtok[:, 0]).tolist())
        tseq.append(ttok[:, 0].tolist())
        rows, slots = paged_write_index(table, pc["lengths"].numpy(), NB, bs)
        pc["write"] = (torch.from_numpy(rows), torch.from_numpy(slots))
        pl, pc, ph = tm.decode_step_paged(tparams, pc, ttok)
        jl, jc, jh = jm.decode_step_full(jparams, jc, jtok)
        tl, tc, th = tm.decode_step_full(tparams, tc, ttok)
        _close(tl, jl)
        _close(th, jh)
        _close(tc["self_k"], jc["self_k"])
        assert torch.equal(pl, tl) and torch.equal(ph, th)
        jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
    assert tseq == jseq
    assert tc["lengths"].tolist() == [17, 21]


class _Seq:
    """What ``EncDecAdapter.prefill_chunk`` reads of a resident session."""

    def __init__(self, view, frames=None):
        self.view = view
        self.request = type("R", (), {"frames": frames,
                                      "session_id": "s"})()


def test_prefill_over_restored_history_with_the_views_cross_state(pair):
    """12 new tokens over a 20-token history held in a backend slot, the
    cross state read from the view: against the JAX decoder prefill over
    the same history and cross K/V at offset 20."""
    cfg, jm, jparams, tm, tparams = pair
    frames, hist = _frames(cfg, 24, 7), _tokens(cfg, 20, 8)
    new = _tokens(cfg, 12, 9)
    jout, tout = _prefills(pair, frames, hist)
    for name in ("contiguous", "paged"):
        kv = make_backend(name, tm, 2, 64, block_size=8, enc_seq=32)
        kv.reserve(1, 40)
        view = kv.view(1)
        tm.adapter.absorb_prefill(view, tout, 20, 0)
        view.set_length(20)
        got = tm.adapter.prefill_chunk(tparams, _Seq(view), new[0], 20,
                                       capture_hidden=True)
        want = jax_encdec.decode_prefill(
            jparams, jnp.asarray(new), None, jm.h, capture_hidden=True,
            emit_kv=True, final_logits_only=True, hist_kv=jout["kv"],
            hist_len=20, cross=jout["cross_kv"], pos_offset=20)
        _close(got["logits"], want["logits"])
        _close(got["hidden"], want["hidden"])
        _close(got["kv"][0], want["kv"][0])
        ck, cv, n = view.cross_state()
        assert n == 24 and torch.equal(ck, tout["cross_kv"][0])


def test_chunked_prefill_equals_the_whole_prompt(pair):
    """A 19-token prompt in chunks of 8, 8 and 3 through a backend slot
    (the encoder runs on the first chunk only): the last logits and every
    chunk's K/V agree with one prefill of the whole prompt."""
    cfg, _, _, tm, tparams = pair
    frames, toks = _frames(cfg, 16, 10), _tokens(cfg, 19, 11)
    whole = tm.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                 "frames": torch.from_numpy(frames)[None]})
    kv = make_backend("contiguous", tm, 1, 32)
    kv.reserve(0, 19)
    view, seq = kv.view(0), _Seq(kv.view(0), frames)
    for start, n in ((0, 8), (8, 8), (16, 3)):
        out = tm.adapter.prefill_chunk(tparams, seq, toks[0, start:start + n],
                                       start, capture_hidden=False)
        tm.adapter.absorb_prefill(view, out, n, start)
        view.set_length(start + n)
    np.testing.assert_allclose(out["logits"].numpy(),
                               whole["logits"].numpy(), atol=ATOL, rtol=0)
    k, v = view.gather_hist(19)
    np.testing.assert_allclose(k.numpy(), whole["kv"][0].numpy(), atol=ATOL,
                               rtol=0)
    assert view.cross_state()[2] == 16


# ------------------------------------------------------------ restoration
def _manager(model, override, group):
    return HCacheManager(model, ChunkStore(make_array("ssd", 4),
                                           chunk_tokens=16),
                         schedule_override=override,
                         restore_group_size=group)


@pytest.mark.parametrize("override,group", [("hidden", 1), ("hidden", 8),
                                            ("kv", 8)])
def test_restored_self_and_cross_kv_are_bitwise(pair, override, group):
    """save -> restore: self K/V and cross K/V bitwise equal to the
    prefill's; the "enc" blob bitwise equal to the port's encoder output
    and within ATOL of the reference's, and both packages' manifests
    record the same enc_len."""
    cfg, jm, jparams, tm, tparams = pair
    frames, toks = _frames(cfg, 24, 12), _tokens(cfg, 20, 13)
    jout, tout = _prefills(pair, frames, toks)
    mgr = _manager(tm, override, group)
    jmgr = JaxManager(jm, JaxStore(jax_make_array("dram", 4),
                                   chunk_tokens=16), hw=JAX_A100,
                      schedule_override=override, store_dtype=np.float32)
    try:
        mgr.save_prefill("s", toks[0], tout)
        jmgr.save_prefill("s", toks[0], jout)
        res = mgr.restore(tparams, "s")
        enc = mgr.store.get_blob("s", "enc", 0)
        man = mgr.store.get_manifest("s")
    finally:
        mgr.close()
    assert np.array_equal(enc, tout["enc_out"][0].numpy())
    np.testing.assert_allclose(enc, jmgr.store.get_blob("s", "enc", 0),
                               atol=ATOL, rtol=0)
    assert man["enc_len"] == jmgr.store.get_manifest("s")["enc_len"] == 24
    assert torch.equal(res.cache["self_k"], tout["kv"][0])
    assert torch.equal(res.cache["self_v"], tout["kv"][1])
    assert torch.equal(res.cache["cross_k"], tout["cross_kv"][0])
    assert torch.equal(res.cache["cross_v"], tout["cross_kv"][1])
    assert res.cache["enc_len"].tolist() == [24]
    assert int(res.cache["lengths"][0]) == 20


def test_restore_after_decode_matches_the_never_evicted_cache(pair):
    """Prefill 20, decode 6 saving hidden states, pause, evict, restore:
    the self K/V of the decoded history is the live cache's bits, and
    greedy decoding from the restored cache gives the never-evicted
    cache's tokens (MATCH)."""
    cfg, _, _, tm, tparams = pair
    frames, toks = _frames(cfg, 20, 14), _tokens(cfg, 20, 15)
    out = tm.prefill(tparams, {"tokens": torch.from_numpy(toks),
                               "frames": torch.from_numpy(frames)[None]},
                     capture_hidden=True)
    mgr = _manager(tm, "hidden", 8)
    cap = 40
    try:
        mgr.save_prefill("s", toks[0], out)
        live = tm.init_cache(1, cap, enc_seq=20)
        live["self_k"][:, :, :20], live["self_v"][:, :, :20] = out["kv"]
        live["cross_k"][:], live["cross_v"][:] = out["cross_kv"]
        live["enc_len"][:] = 20
        live["lengths"] = torch.tensor([20], dtype=torch.int32)
        tok = torch.argmax(out["logits"][:, -1], -1)[:, None]
        inputs = []
        for _ in range(6):
            inputs.append(int(tok[0, 0]))
            lengths = live["lengths"].clone()
            lg, live, hidden = tm.decode_step_full(tparams, live, tok)
            mgr.save_decode_hidden(["s"], hidden, lengths)
            tok = torch.argmax(lg[:, -1], -1)[:, None]
        mgr.save_session_pause("s", live, 26, tokens_tail=inputs)
        res = mgr.restore(tparams, "s", capacity=cap)
    finally:
        mgr.close()
    for name in ("self_k", "self_v"):
        assert torch.equal(res.cache[name][:, :, :26], live[name][:, :, :26])
    assert torch.equal(res.cache["cross_k"], live["cross_k"])
    seqs = []
    for cache in (res.cache, {k: v.clone() for k, v in live.items()}):
        t, seq = tok, []
        for _ in range(6):
            seq.append(int(t[0, 0]))
            lg, cache = tm.decode_step(tparams, cache, t)
            t = torch.argmax(lg[:, -1], -1)[:, None]
        seqs.append(seq)
    assert seqs[0] == seqs[1], "MISMATCH"


def test_the_planner_gives_no_recompute_layer(pair):
    tm = pair[3]
    mgr = _manager(tm, None, 8)
    try:
        for n in (128, 1024, 8192):
            assert "recompute" not in mgr.plan(n).methods
        assert not mgr.degrade_to_recompute("s")
    finally:
        mgr.close()


# ------------------------------------------------------------- cost side
@pytest.mark.parametrize("methods", [("hidden",) * 4, ("kv", "hidden",
                                                       "hidden", "kv")])
def test_the_cost_side_equals_the_reference(pair, methods):
    """The restore graph with its cross pair, the cross times, the group
    plans (cross priced at the enc_len bucket) and the makespans equal the
    JAX package's, under the same hardware profile."""
    cfg, jm, _, tm, _ = pair
    for g in (1, 2, (1, 3)):
        got = restoration.compile_tasks(methods, group_size=g, cross=True)
        want = jax_restoration.compile_tasks(methods, group_size=g,
                                             cross=True)
        assert [dataclasses.astuple(t) for t in got] == \
            [dataclasses.astuple(t) for t in want]
    mgr = HCacheManager(tm, ChunkStore(make_array("dram", 4),
                                       chunk_tokens=16), hw=PAPER_A100,
                        restore_group_size="auto")
    jmgr = JaxManager(jm, JaxStore(jax_make_array("dram", 4),
                                   chunk_tokens=16), hw=JAX_A100,
                      restore_group_size="auto", store_dtype=np.float32)
    try:
        for enc_len in (0, 24, 1500, 4096):
            got = restoration.cross_restore_times(mgr, enc_len)
            want = jax_restoration.cross_restore_times(jmgr, enc_len)
            assert (got is None) == (want is None)
            if got is not None:
                assert dataclasses.astuple(got) == pytest.approx(
                    dataclasses.astuple(want), rel=1e-12)
            for n in (20, 448, 3000):
                assert restoration.choose_group_size(
                    cfg, PAPER_A100, n, methods, cross=True,
                    enc_len=enc_len) == jax_restoration.choose_group_size(
                    cfg, JAX_A100, n, methods, cross=True, enc_len=enc_len)
                assert mgr.resolve_group_size(n, methods, enc_len=enc_len) \
                    == jmgr.resolve_group_size(n, methods, enc_len=enc_len)
                assert restore_makespan(mgr, n, methods, enc_len=enc_len) \
                    == pytest.approx(jax_restore_makespan(
                        jmgr, n, methods, enc_len=enc_len), rel=1e-12)
    finally:
        mgr.close()
