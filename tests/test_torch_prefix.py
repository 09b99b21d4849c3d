"""The port's prefix sharing against the JAX package: the rolling page
hash and the prefix index (byte-identical chains, the same matches and
gauges), copy-on-write pages (a sibling keeps its bytes, index pages
spill under pressure, refcounts stay exact under random interleavings),
and the engine with sharing on: the same tokens as with sharing off, on
both backends, and the JAX engine's tokens and counters (prefix hits,
skipped tokens, copy-on-write copies) for the same request script,
through forks, divergence, eviction and restore-skip.

One JAX smoke model (llama2-7b reduced, fp32) per module; its weights are
carried into the port by ``from_jax_params``; both engines plan every
layer ``hidden`` and store fp32, so restores are lossless."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container lacks hypothesis - seeded shim
    from _hypothesis_compat import given, settings, strategies as st

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.config.hardware import PAPER_A100 as JAX_A100
from repro.configs import get_arch as jax_get_arch
from repro.core.hcache import HCacheManager as JaxManager
from repro.distributed.sharding import default_rules
from repro.launch.mesh import make_mesh
from repro.models import Model as JaxModel
from repro.models.module import split
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import prefix_index as jpi
from repro.serving.kv_cache import BlockAllocator as JaxAllocator
from repro.serving.request import Phase as JaxPhase
from repro.storage import ChunkStore as JaxStore
from repro.storage import make_array as jax_make_array
from repro_torch.config.hardware import PAPER_A100
from repro_torch.core.hcache import HCacheManager
from repro_torch.launch import serve as serve_cli
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import InferenceEngine, Phase, Request
from repro_torch.serving import prefix_index as tpi
from repro_torch.serving.kv_cache import BlockAllocator, PagedBackend


@pytest.fixture(scope="module")
def pair():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = jax_reduced(jax_get_arch("llama2-7b"))
    jm = JaxModel(cfg, rules=default_rules(mesh), model_axis=1,
                  dtype=jnp.float32, remat="none")
    jparams, _ = split(jm.init(jax.random.PRNGKey(0)))
    tm = Model(cfg, device="cpu")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    yield cfg, jm, jparams, tm, tparams
    torch.set_num_threads(n)


# ------------------------------------------------------- hashes and index
@pytest.mark.parametrize("seed,bs", [(0, 16), (1, 4), (2, 7)])
def test_hash_chain_is_byte_identical(seed, bs):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 32000, 100)
    b = a.copy()
    b[3 * bs + 1] += 1
    for toks in (a, b, a.astype(np.int32), list(a[:bs * 2])):
        assert tpi.hash_chain(toks, bs) == jpi.hash_chain(toks, bs)
    ca, cb = tpi.hash_chain(a, bs), tpi.hash_chain(b, bs)
    assert tpi.common_chain_prefix(ca, cb) == \
        jpi.common_chain_prefix(ca, cb) == 3
    # a chain extended a round at a time equals the whole chain
    head = tpi.hash_chain(a[:5 * bs], bs)
    assert head + tpi.hash_chain(a[5 * bs:], bs, prev=head[-1]) == \
        tpi.hash_chain(a[:5 * bs + (len(a) - 5 * bs) // bs * bs], bs)
    assert tpi.roll_hash(None, a[:bs]) == jpi.roll_hash(None, a[:bs])


class _Pool:
    """What ``PrefixIndex`` needs of a backend: a page size and an
    allocator."""

    def __init__(self, allocator, block_size):
        self.allocator = allocator
        self.block_size = block_size


def test_index_match_and_publish_equal_the_reference():
    """The same publishes, matches, releases and clears on both indexes
    (over the allocators of both packages) give the same blocks, match
    lengths, gauges and refcounts."""
    rng = np.random.default_rng(3)
    bs = 4
    idx = {}
    for name, mod, alloc in (("jax", jpi, JaxAllocator(24)),
                             ("port", tpi, BlockAllocator(24))):
        idx[name] = mod.PrefixIndex(_Pool(alloc, bs))
    docs = [rng.integers(0, 50, 40) for _ in range(3)]
    ops = []
    for step in range(30):
        kind = int(rng.integers(0, 4))
        doc = docs[int(rng.integers(0, 3))].copy()
        if rng.random() < 0.5:
            doc[int(rng.integers(0, 40))] = 99
        ops.append((kind, doc, int(rng.integers(1, 40)),
                    int(rng.integers(1, 4))))
    held = {"jax": [], "port": []}
    for kind, doc, n, k in ops:
        got = {}
        for name, ix in idx.items():
            a = ix.backend.allocator
            if kind == 0:                      # publish a slot's pages
                blocks = a.alloc(-(-n // bs))
                if blocks is None:
                    got[name] = None
                    continue
                got[name] = ix.publish(doc, n, blocks)
                a.free(blocks)
            elif kind == 1:                    # match, adopt
                blocks, m, _ = ix.match(doc, limit=n)
                for b in blocks:
                    a.incref(b)
                held[name].append(blocks)
                got[name] = (blocks, m)
            elif kind == 2:                    # release under pressure
                got[name] = (ix.releasable(), ix.release(k))
            else:                              # a holder lets go
                if held[name]:
                    a.free(held[name].pop(0))
                got[name] = len(held[name])
        assert got["port"] == got["jax"]
        for name in idx:
            assert idx[name].lookups == idx["jax"].lookups
            assert idx[name].hits == idx["jax"].hits
            assert idx[name].hit_tokens == idx["jax"].hit_tokens
            assert len(idx[name]) == len(idx["jax"])
    refs = [[ix.backend.allocator.refcount(b) for b in range(24)]
            for ix in idx.values()]
    assert refs[0] == refs[1]
    for name, ix in idx.items():
        for blocks in held[name]:
            ix.backend.allocator.free(blocks)
        ix.clear()
        assert ix.backend.allocator.free_count == 24


# ------------------------------------------------ copy-on-write pages
def _backend(pair, **kw):
    return PagedBackend(pair[3], **kw)


def _write_tokens(b, slot, toks, start):
    """Write each position's token id as its K/V value, so content checks
    reduce to comparing gathers with the slot's token array."""
    n = len(toks) - start
    if n <= 0:
        return
    L = b.k_pool.shape[0]
    Kv, hd = b.k_pool.shape[-2:]
    vals = torch.as_tensor(np.asarray(toks[start:], np.float32))[
        None, None, :, None, None].expand(L, 1, n, Kv, hd)
    b.view(slot).write_kv(vals, vals, start)


def _content(b, slot, n):
    k, _ = b.view(slot).gather_hist(n)
    return k[0, 0, :, 0, 0].numpy()


def test_cow_divergence_keeps_the_siblings_content(pair):
    """Two slots share a 2-page prefix; slot 1 diverges inside page 0:
    one page is copied, slot 0 still reads its bytes."""
    b = _backend(pair, max_batch=2, max_seq=64, block_size=16, num_blocks=8)
    idx = tpi.PrefixIndex(b)
    b.prefix_index = idx
    toks = np.arange(100, 140)
    assert b.reserve(0, 40)
    b.set_length(0, 40)
    _write_tokens(b, 0, toks, 0)
    idx.publish(toks, 40, b.slot_blocks[0])
    blocks, m, _ = idx.match(toks)
    assert m == 32 and len(idx) == 2
    b.adopt_shared(1, blocks)
    assert b.reserve(1, 40)
    b.set_length(1, 40)
    assert b.slot_blocks[1][:2] == b.slot_blocks[0][:2]
    _write_tokens(b, 1, toks, 32)                 # private tail, no copy
    assert b.cow_copies == 0
    fork = toks.copy()
    fork[5] = 999
    L = b.k_pool.shape[0]
    vals = torch.full((L, 1, 1) + tuple(b.k_pool.shape[-2:]), 999.0)
    b.view(1).write_kv(vals, vals, 5)
    assert b.cow_copies == 1
    assert b.slot_blocks[1][0] != b.slot_blocks[0][0]
    assert b.slot_blocks[1][1] == b.slot_blocks[0][1]
    np.testing.assert_array_equal(_content(b, 0, 40), toks)
    np.testing.assert_array_equal(_content(b, 1, 40), fork)
    # a decode step's batched write privatises each slot's frontier page
    # (page 1, held by both slots and the index) before writing it
    b.set_length(1, 20)
    b.set_length(0, 20)
    before = b.cow_copies
    b.decode(pair[4], np.zeros((2, 1), np.int64))
    assert b.cow_copies == before + 2
    shared_page = idx.match(toks)[0][1]
    assert shared_page not in b.slot_blocks[0] + b.slot_blocks[1]
    k = b.k_pool[0, shared_page, :, 0, 0].numpy()
    np.testing.assert_array_equal(k, toks[16:32])
    for slot, want in ((0, toks), (1, fork)):
        got = _content(b, slot, 40)
        np.testing.assert_array_equal(got[:20], want[:20])
        np.testing.assert_array_equal(got[21:], want[21:])
    b.free_slot(0)
    b.free_slot(1)
    assert idx.clear() == 2
    assert b.allocator.free_count == 8


def test_index_rejects_divergent_tokens(pair):
    b = _backend(pair, max_batch=2, max_seq=64, block_size=16, num_blocks=8)
    idx = tpi.PrefixIndex(b)
    toks = np.arange(32)
    b.reserve(0, 32)
    idx.publish(toks, 32, b.slot_blocks[0])
    other = toks.copy()
    other[20] = 7
    assert idx.match(other)[1] == 16
    assert idx.match(other, limit=15)[1] == 0
    b.free_slot(0)
    idx.clear()
    assert b.allocator.free_count == 8


def test_index_pages_spill_under_pool_pressure(pair):
    b = _backend(pair, max_batch=2, max_seq=128, block_size=16,
                 num_blocks=4)
    idx = tpi.PrefixIndex(b)
    b.prefix_index = idx
    toks = np.arange(32)
    b.reserve(0, 32)
    idx.publish(toks, 32, b.slot_blocks[0])
    b.free_slot(0)
    assert b.allocator.free_count == 2 and idx.releasable() == 2
    assert b.can_reserve(64)
    assert b.reserve(1, 64)
    assert len(idx) == 0
    b.free_slot(1)
    assert b.allocator.free_count == 4


def _check_invariants(b, idx, live):
    holds = [0] * b.num_blocks
    for blks in b.slot_blocks:
        for blk in blks:
            holds[blk] += 1
    for e in idx._entries.values():
        holds[e.block] += 1
    free = set(b.allocator._free)
    assert len(free) == len(b.allocator._free), "duplicate free-list entry"
    for blk in range(b.num_blocks):
        assert b.allocator.refcount(blk) == holds[blk]
        assert (blk in free) == (holds[blk] == 0)
    for slot, toks in live.items():
        np.testing.assert_array_equal(_content(b, slot, len(toks)), toks)


@settings(max_examples=8, deadline=None)
@given(ops=st.lists(st.integers(0, 4), min_size=4, max_size=20),
       seed=st.integers(0, 2**31 - 1))
def test_refcount_invariants_random_interleavings(pair, ops, seed):
    """Random admit / publish / diverge / retire / release interleavings:
    no page leaks, none is freed while held, and every slot reads exactly
    its own tokens."""
    rng = np.random.default_rng(seed)
    b = _backend(pair, max_batch=3, max_seq=64, block_size=16,
                 num_blocks=10)
    idx = tpi.PrefixIndex(b)
    b.prefix_index = idx
    shared = [rng.integers(0, 1000, 48), rng.integers(0, 1000, 48)]
    live = {}
    for op in ops:
        if op == 0:
            free = [s for s in range(3) if s not in live]
            if not free:
                continue
            slot = free[0]
            toks = np.concatenate([shared[int(rng.integers(0, 2))],
                                   rng.integers(0, 1000,
                                                int(rng.integers(0, 16)))])
            blocks, m, _ = idx.match(toks)
            if m:
                b.adopt_shared(slot, blocks)
            if not b.reserve(slot, len(toks)):
                b.free_slot(slot)
                continue
            b.set_length(slot, len(toks))
            _write_tokens(b, slot, toks, m)
            live[slot] = toks
        elif op == 1 and live:
            slot = int(rng.choice(list(live)))
            idx.publish(live[slot], len(live[slot]), b.slot_blocks[slot])
        elif op == 2 and live:
            slot = int(rng.choice(list(live)))
            pos = int(rng.integers(0, len(live[slot])))
            live[slot] = live[slot].copy()
            live[slot][pos] = int(rng.integers(1000, 2000))
            _write_tokens(b, slot, live[slot][:pos + 1], pos)
        elif op == 3 and live:
            slot = int(rng.choice(list(live)))
            b.free_slot(slot)
            del live[slot]
        elif op == 4:
            idx.release(1)
        _check_invariants(b, idx, live)
    for slot in list(live):
        b.free_slot(slot)
    idx.clear()
    assert b.allocator.free_count == b.num_blocks


# ---------------------------------------------------------------- engine
def engine(pair, port, **kw):
    cfg, jm, jparams, tm, tparams = pair
    defaults = dict(max_batch=2, max_seq=128, prefill_chunk=8)
    defaults.update(kw)
    if port:
        from repro_torch.storage import ChunkStore, make_array
        mgr = HCacheManager(tm, ChunkStore(make_array("dram", 4),
                                           chunk_tokens=16),
                            hw=PAPER_A100, schedule_override="hidden")
        return InferenceEngine(tm, tparams, mgr, **defaults)
    mgr = JaxManager(jm, JaxStore(jax_make_array("dram", 4), chunk_tokens=16),
                     hw=JAX_A100, schedule_override="hidden",
                     store_dtype=np.float32)
    return JaxEngine(jm, jparams, mgr, **defaults)


COUNTERS = ("prefix_lookups", "prefix_hits", "prefix_hit_tokens",
            "restore_skipped_tokens", "cow_copies", "restored_tokens",
            "forks", "dedup_host_bytes")


def counters(eng):
    return {k: getattr(eng.metrics, k) for k in COUNTERS}


def all_free(eng):
    """After ``close``: every page of a paged pool is back on the free
    list with refcount 0."""
    a = getattr(eng.kv, "allocator", None)
    return a is None or (a.free_count == eng.kv.num_blocks
                         and not any(a._ref))


def rag_prompts(cfg, seed=11, doc=48, n=4):
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, cfg.vocab_size, doc).astype(np.int32)
    return [np.concatenate([sys_p, rng.integers(
        0, cfg.vocab_size, 6).astype(np.int32)]) for _ in range(n)]


@pytest.mark.parametrize("backend", ["paged", "contiguous"])
def test_shared_document_tokens_equal_sharing_off_and_the_reference(
        pair, backend):
    """4 sessions over one 48-token document, 2 slots, two rounds: the
    same tokens with sharing on and off, and with sharing on the JAX
    engine's tokens and counters; under paged the later sessions skip the document's prefill
    and the second round skips restores."""
    prompts = rag_prompts(pair[0])
    results = {}
    for port, sharing in ((False, True), (True, False), (True, True)):
        eng = engine(pair, port, backend=backend,
                     prefix_sharing=sharing)
        out = []
        for rnd in range(2):
            for i, p in enumerate(prompts):
                eng.submit((Request if port else JaxRequest)(
                    f"p{i}", p if rnd == 0 else p[-3:],
                    max_new_tokens=4))
            eng.run()
            out.append({i: eng.result(f"p{i}") for i in range(4)})
        results[port, sharing] = (out, counters(eng))
        eng.close()
        if port:
            assert all_free(eng)
    assert results[True, True][0] == results[True, False][0]
    assert results[True, True] == results[False, True]
    m = results[True, True][1]
    if backend == "paged":
        assert m["prefix_hits"] >= 2
        assert m["restore_skipped_tokens"] >= 2 * 48
        assert m["dedup_host_bytes"] > 0
    assert results[True, False][1]["prefix_hits"] == 0


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_fork_diverge_evict_restore_round_trip(pair, backend):
    """fork -> diverge -> evict -> restore: the fork continues from the
    fork point, both lineages stay independent, the same tokens as the
    copying run and as the JAX engine, with the reference's counters."""
    cfg = pair[0]
    rng = np.random.default_rng(5)
    p = rng.integers(0, cfg.vocab_size, 20).astype(np.int32)
    t_fork = int(rng.integers(0, cfg.vocab_size))
    t_src = int(rng.integers(0, cfg.vocab_size))
    results = {}
    for port in (False, True):
        req, phase = (Request, Phase) if port else (JaxRequest, JaxPhase)
        for sharing in (False, True):
            eng = engine(pair, port, backend=backend,
                         prefix_sharing=sharing)
            eng.submit(req("src", p, max_new_tokens=6))
            for _ in range(200):
                s = eng.sessions.get("src")
                if (s is not None and s.phase == phase.DECODE
                        and len(s.generated) >= 3):
                    break
                eng.step()
            man = eng.fork_session("src", "fk")
            assert int(man["n_tokens"]) == eng.sessions["src"].total_len - 1
            eng.run()
            eng.submit(req("fk", np.asarray([t_fork], np.int32),
                           max_new_tokens=3))
            eng.submit(req("src", np.asarray([t_src], np.int32),
                           max_new_tokens=3))
            eng.run()
            results[port, sharing] = (eng.result("src"), eng.result("fk"),
                                      counters(eng))
            eng.close()
            if port:
                assert all_free(eng)
    assert results[True, True][:2] == results[True, False][:2] \
        == results[False, False][:2]
    assert results[True, True] == results[False, True]
    assert results[True, False] == results[False, False]
    if backend == "paged":
        m = results[True, True][2]
        assert m["restore_skipped_tokens"] > 0 and m["cow_copies"] > 0


def test_restore_skip_resumes_round_two_identically(pair):
    """A retired session's second round restores from the divergence
    token when its own published pages are still indexed."""
    cfg = pair[0]
    rng = np.random.default_rng(9)
    p1 = rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
    p2 = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
    results = {}
    for port in (False, True):
        req = Request if port else JaxRequest
        for sharing in (False, True):
            eng = engine(pair, port, backend="paged",
                         prefix_sharing=sharing)
            eng.submit(req("s", p1, max_new_tokens=4))
            eng.run()
            g1 = eng.result("s")
            eng.submit(req("s", p2, max_new_tokens=4))
            eng.run()
            results[port, sharing] = (g1, eng.result("s"), counters(eng))
            eng.close()
    assert results[True, True][:2] == results[True, False][:2]
    assert results[True, True] == results[False, True]
    m = results[True, True][2]
    assert m["restore_skipped_tokens"] >= 32 and m["restored_tokens"] < 43


def test_restores_after_a_shared_prefix_are_bitwise(pair):
    """Under sharing, every restore (restore-skip included) rebuilds the
    K/V the session held before it was paused or retired, bitwise, and a
    session the ladder would not share (int8) restores in full."""
    cfg = pair[0]
    eng = engine(pair, True, backend="paged", prefix_sharing=True,
                 preempt_quantum=2)
    snaps, checked = {}, []
    save = eng.mgr.save_session_pause

    def save_and_snapshot(session, cache, n_tokens, **kw):
        snaps[session] = (cache["k"][:, 0, :n_tokens].clone(),
                          cache["v"][:, 0, :n_tokens].clone())
        return save(session, cache, n_tokens, **kw)
    eng.mgr.save_session_pause = save_and_snapshot
    restore_step = eng._restore_step

    def checked_restore_step():
        restoring = [(s, s.executor.start_token) for s in eng.slots
                     if s is not None and s.phase == Phase.RESTORING]
        restore_step()
        for s, start in restoring:
            if s.phase == Phase.PREFILL:
                sid = s.request.session_id
                k, v = s.view.gather_hist(s.history_len)
                if eng.mgr.store.get_manifest(sid)["compress"] == "int8":
                    # restored in full from its own lossy rows
                    assert start == 0
                    err = (k[:, 0] - snaps[sid][0]).abs().max()
                    assert 0 < float(err) < 0.05
                else:
                    assert torch.equal(k[:, 0], snaps[sid][0]), sid
                    assert torch.equal(v[:, 0], snaps[sid][1]), sid
                checked.append((sid, start))
    eng._restore_step = checked_restore_step
    prompts = rag_prompts(cfg, seed=4, n=3)
    for i, p in enumerate(prompts):
        eng.submit(Request(f"q{i}", p, max_new_tokens=5))
    eng.run()
    assert eng.mgr.demote_hidden_int8("q2")
    for i in range(3):
        eng.submit(Request(f"q{i}", np.asarray([7, 8], np.int32),
                           max_new_tokens=3))
    eng.run()
    assert {sid for sid, _ in checked} == {"q0", "q1", "q2"}
    assert any(start > 0 for _, start in checked)
    assert eng.metrics.restore_skipped_tokens > 0
    assert eng.metrics.prefix_hits > 0
    eng.close()
    assert all_free(eng)


def test_serve_prefix_sharing_prints_its_hit_rate(capsys):
    serve_cli.main(["--device", "cpu", "--sessions", "3", "--rounds", "2",
                    "--prompt-len", "10", "--gen", "3", "--max-batch", "2",
                    "--max-seq", "64", "--backend", "paged",
                    "--prefix-sharing"])
    out = capsys.readouterr().out
    assert "prefix sharing: hit rate" in out
    assert "round 1 user2: 3 tokens" in out
