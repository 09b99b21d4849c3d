"""The port's front door (``repro_torch.frontend``) against the JAX
package's: tokenizer and chat template, session router (steering,
threshold, blind mode, busy/cancel, displacement, fork, rewritten
history), the engine's token callbacks, the pump (backpressure, its
thread, an engine exception relayed to every client), the OpenAI-shaped
API (chat rounds that restore, SSE, statuses, metrics) and the stdlib
HTTP binding on an ephemeral port. Where a case produces tokens, the
JAX package's front door gets the same requests over the same weights
(the reference's ``split(model.init(...))`` carried over by
``from_jax_params``): tokens equal, route kinds and ``matched_tokens``
equal. Also the port's own choices: an ``ssm``/``hybrid`` model is
served one-shot, an enc-dec model is refused, a ``--budget-kb`` front
door reclaims on the pump thread, and the pump thread records no
autograd graph.

One JAX smoke model (llama2-7b reduced, fp32) per module; both engines
plan every layer ``hidden`` and store fp32, so restores are lossless."""
import asyncio
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.config.hardware import PAPER_A100 as JAX_A100
from repro.configs import get_arch as jax_get_arch
from repro.core.hcache import HCacheManager as JaxManager
from repro.distributed.sharding import default_rules
from repro.frontend import EnginePump as JaxPump
from repro.frontend import FrontDoor as JaxFrontDoor
from repro.frontend import SessionRouter as JaxRouter
from repro.frontend import tokenizer as jtok
from repro.launch.mesh import make_mesh
from repro.models import Model as JaxModel
from repro.models.module import split
from repro.serving import InferenceEngine as JaxEngine
from repro.storage import ChunkStore as JaxStore
from repro.storage import make_array as jax_make_array
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.config.hardware import PAPER_A100
from repro_torch.configs import get_arch
from repro_torch.core.capacity import CapacityManager
from repro_torch.core.hcache import HCacheManager
from repro_torch.frontend import (ByteTokenizer, ChatTemplate, EngineFailed,
                                  EnginePump, FrontDoor, HttpFrontDoor,
                                  Overloaded, RouterBusy, SessionRouter,
                                  serve_engine, unservable)
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import InferenceEngine, Request
from repro_torch.storage import ChunkStore, make_array

TIMEOUT = 60.0


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


def fresh_engine(pair, port=True, **kw):
    cfg, jm, jparams, tm, tparams = pair
    # three chat rounds render ~150 tokens: max_seq holds them (the JAX
    # engine clamps a write past max_seq silently; the port raises)
    defaults = dict(max_batch=2, max_seq=256, prefill_chunk=8)
    defaults.update(kw)
    if port:
        mgr = HCacheManager(tm, ChunkStore(make_array("dram", 4),
                                           chunk_tokens=16),
                            hw=PAPER_A100, schedule_override="hidden")
        return InferenceEngine(tm, tparams, mgr, **defaults)
    mgr = JaxManager(jm, JaxStore(jax_make_array("dram", 4), chunk_tokens=16),
                     hw=JAX_A100, schedule_override="hidden",
                     store_dtype=np.float32)
    return JaxEngine(jm, jparams, mgr, **defaults)


def run(coro):
    """Drive an API coroutine with a hard time limit: a client that
    would wait for ever fails the test instead."""
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT))


# ------------------------------------------------------------- tokenizer
def test_tokenizer_roundtrip():
    tok = ByteTokenizer(256)
    ids = [0, 1, 17, 255, 42]
    assert list(tok.encode(tok.decode(ids))) == ids
    assert list(tok.encode("ab")) == [ord("a"), ord("b")]
    ref = jtok.ByteTokenizer(256)
    for text in ("hello wörld", tok.decode([3, 250, 7]), ""):
        assert np.array_equal(tok.encode(text), ref.encode(text))
    assert tok.decode(ids) == ref.decode(ids)


def test_chat_template_prefix_stable():
    """The rendered history is a strict token prefix of the next round's
    render, and both packages render the same tokens."""
    tok = ByteTokenizer(256)
    tpl = ChatTemplate(tok)
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hello"}]
    r1 = tpl.render(msgs)
    reply = tok.decode([5, 9, 250])
    msgs2 = msgs + [{"role": "assistant", "content": reply},
                    {"role": "user", "content": "more"}]
    r2 = tpl.render(msgs2)
    gen = tok.encode(reply)
    assert np.array_equal(r2[:len(r1)], r1)
    assert np.array_equal(r2[len(r1):len(r1) + len(gen)], gen)
    ref = jtok.ChatTemplate(jtok.ByteTokenizer(256))
    for m, head in ((msgs, True), (msgs2, True), (msgs2, False), ([], True)):
        assert np.array_equal(tpl.render(m, head), ref.render(m, head))


def test_chat_template_token_list_content():
    tpl = ChatTemplate(ByteTokenizer(256))
    a = tpl.render([{"role": "user", "content": [1, 2, 300]}])
    b = tpl.render([{"role": "user", "content": [1, 2, 300 % 256]}])
    assert np.array_equal(a, b)


# ---------------------------------------------------------------- router
def _routers(**kw):
    """The port's router and the JAX package's, with the same settings."""
    defaults = dict(n_slots=2, block_size=4, reuse_threshold=0.5,
                    max_stored=4)
    defaults.update(kw)
    return SessionRouter(None, **defaults), JaxRouter(None, **defaults)


def _same(dp, dj):
    """One routing decision, port against reference."""
    assert (dp.session_id, dp.kind, dp.matched_tokens, dp.forked_from) == \
        (dj.session_id, dj.kind, dj.matched_tokens, dj.forked_from)
    assert np.array_equal(dp.prompt, dj.prompt)
    return dp


def _route(routers, tokens, conv):
    return _same(*(r.route(np.asarray(tokens, np.int32), conv)
                   for r in routers))


def _complete(routers, decisions, generated):
    for r, d in zip(routers, decisions):
        r.complete(d, generated)


def test_router_fresh_then_exact_then_similarity():
    rs = _routers()
    p1 = np.arange(10)
    d1 = [r.route(p1.astype(np.int32), "conv-a") for r in rs]
    assert _same(*d1).kind == "fresh" and len(d1[0].prompt) == 10
    _complete(rs, d1, [90, 91, 92])         # history = p1 + [90, 91]
    hist = np.concatenate([p1, [90, 91]])
    p2 = np.concatenate([hist, [92, 7, 8]]).astype(np.int32)
    d2 = [r.route(p2, "conv-a") for r in rs]
    assert _same(*d2).kind == "exact"
    assert d2[0].matched_tokens == len(hist)
    assert list(d2[0].prompt) == [92, 7, 8]
    _complete(rs, d2, [93, 94])
    hist2 = np.concatenate([p2, [93]])
    d3 = _route(rs, np.concatenate([hist2, [94, 1]]), None)
    assert d3.kind == "restore" and d3.matched_tokens == len(hist2)
    assert d3.session_id == d1[0].session_id
    assert rs[0].stats() == rs[1].stats()
    assert rs[0].stats()["exact_hits"] == 1
    assert rs[0].stats()["similarity_hits"] == 1


def test_router_reuse_threshold_rejects_short_match():
    rs = _routers(reuse_threshold=0.9)
    d1 = [r.route(np.arange(8, dtype=np.int32), None) for r in rs]
    _complete(rs, d1, [50, 51])
    long = np.concatenate([np.arange(8), [50], np.arange(11)])
    assert _route(rs, long, None).kind == "fresh"


def test_router_blind_never_steers():
    rs = _routers(steer=False)
    p = np.arange(12, dtype=np.int32)
    d1 = [r.route(p, "conv-a") for r in rs]
    _complete(rs, d1, [1, 2])
    d2 = _route(rs, np.concatenate([p, [1, 9]]), "conv-a")
    assert d1[0].kind == d2.kind == "fresh"
    assert d2.session_id != d1[0].session_id
    assert rs[0].stats()["hit_rate"] == 0.0


def test_router_busy_conflict_and_cancel():
    r, _ = _routers()
    p = np.arange(10, dtype=np.int32)
    d1 = r.route(p, "conv-a")
    with pytest.raises(RouterBusy):
        r.route(np.concatenate([p, [5]]).astype(np.int32), "conv-a")
    r.cancel(d1)                            # failed submit releases it
    r.complete(d1, [1, 2])
    d2 = r.route(np.concatenate([p, [1, 9]]).astype(np.int32), "conv-a")
    assert d2.kind == "exact"


def test_router_displacement_to_stored_registry():
    """An overwritten slot keeps its session restorable through the
    stored registry."""
    rs = _routers(n_slots=1)
    p1 = np.arange(8)
    d1 = [r.route(p1.astype(np.int32), "conv-a") for r in rs]
    _complete(rs, d1, [70, 71])
    hist = np.concatenate([p1, [70]])
    d2 = [r.route(np.arange(100, 112, dtype=np.int32), "conv-b")
          for r in rs]
    assert _same(*d2).kind == "fresh"
    _complete(rs, d2, [1, 2])
    assert rs[0].stats()["overwrites"] >= 1
    assert d1[0].session_id in rs[0].stored
    d3 = _route(rs, np.concatenate([hist, [71, 3]]), None)
    assert d3.kind == "restore" and d3.session_id == d1[0].session_id
    assert d1[0].session_id not in rs[0].stored
    assert rs[0].stats() == rs[1].stats()


def test_router_fork_on_shared_prefix():
    class FakeEngine:
        prefix_sharing = True

        def __init__(self):
            self.forked = []

        def fork_session(self, src, new):
            self.forked.append((src, new))

    eng = FakeEngine()
    r = SessionRouter(eng, n_slots=4, block_size=4)
    p = np.arange(12, dtype=np.int32)
    d1 = r.route(p, "conv-a")
    r.complete(d1, [40, 41])
    hist = np.concatenate([p, [40]]).astype(np.int32)
    d2 = r.route(np.concatenate([hist, [41, 9]]).astype(np.int32), "conv-b")
    assert d2.kind == "fork" and d2.forked_from == d1.session_id
    assert eng.forked == [(d1.session_id, d2.session_id)]
    assert list(d2.prompt) == [41, 9]
    eng.prefix_sharing = False
    d3 = r.route(np.concatenate([hist, [41, 8]]).astype(np.int32), "conv-c")
    assert d3.kind == "fresh"


def test_router_rewritten_history_falls_back():
    rs = _routers()
    d1 = [r.route(np.arange(10, dtype=np.int32), "conv-a") for r in rs]
    _complete(rs, d1, [5, 6])
    d2 = _route(rs, np.arange(50, 64), "conv-a")
    assert d2.kind == "fresh" and d2.session_id != d1[0].session_id


# --------------------------------------------------- engine callback seam
def test_engine_token_callbacks_exactly_once(pair):
    cfg = pair[0]
    engine = fresh_engine(pair)
    tokens, finishes = [], []
    engine.on_token = lambda seq, tok: tokens.append(
        (seq.request.session_id, int(tok)))
    engine.on_finish = lambda seq, reason: finishes.append(
        (seq.request.session_id, reason))
    rng = np.random.default_rng(0)
    engine.submit(Request("a", rng.integers(0, cfg.vocab_size, 12)
                          .astype(np.int32), max_new_tokens=5))
    engine.submit(Request("b", rng.integers(0, cfg.vocab_size, 7)
                          .astype(np.int32), max_new_tokens=3))
    engine.run()
    for sid in ("a", "b"):
        assert [t for s, t in tokens if s == sid] == engine.result(sid)
    assert sorted(finishes) == [("a", "length"), ("b", "length")]
    engine.close()


def test_engine_callbacks_through_pause_resume(pair):
    """Mid-stream eviction: on_pause fires, and the resumed stream emits
    each token exactly once."""
    cfg = pair[0]
    engine = fresh_engine(pair, max_batch=1, preempt_quantum=2)
    tokens, pauses = [], []
    engine.on_token = lambda seq, tok: tokens.append(
        (seq.request.session_id, int(tok)))
    engine.on_pause = lambda seq: pauses.append(seq.request.session_id)
    rng = np.random.default_rng(1)
    for sid in ("a", "b"):
        engine.submit(Request(sid, rng.integers(0, cfg.vocab_size, 10)
                              .astype(np.int32), max_new_tokens=6))
    engine.run()
    assert engine.metrics.preemptions > 0 and pauses
    for sid in ("a", "b"):
        assert [t for s, t in tokens if s == sid] == engine.result(sid)
    engine.close()


def test_engine_callbacks_on_restored_round(pair):
    """Round 2 restores the stored history; only NEW tokens fire."""
    cfg = pair[0]
    engine = fresh_engine(pair)
    tokens = []
    engine.on_token = lambda seq, tok: tokens.append(int(tok))
    rng = np.random.default_rng(2)
    engine.submit(Request("a", rng.integers(0, cfg.vocab_size, 14)
                          .astype(np.int32), max_new_tokens=4))
    engine.run()
    assert tokens == engine.result("a")
    tokens.clear()
    engine.submit(Request("a", rng.integers(0, cfg.vocab_size, 6)
                          .astype(np.int32), max_new_tokens=3))
    engine.run()
    assert engine.metrics.restored_tokens > 0
    assert tokens == engine.result("a")
    engine.close()


def test_recoverable_sessions_and_arrival_stamping(pair):
    cfg = pair[0]
    engine = fresh_engine(pair)
    rng = np.random.default_rng(3)
    assert engine.recoverable_sessions() == []
    p = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
    r1 = Request("u1", p, max_new_tokens=3)
    engine.submit(r1)
    assert r1.arrival_time > 0.0 and r1.arrival_step >= 0
    # a caller that pre-stamped (the front door at ingress) is respected
    r2 = Request("u2", p, max_new_tokens=3, priority=2)
    r2.arrival_time, r2.arrival_step = 123.0, 7
    engine.submit(r2)
    assert (r2.arrival_time, r2.arrival_step, r2.priority) == (123.0, 7, 2)
    engine.run()
    assert sorted(engine.recoverable_sessions()) == ["u1", "u2"]
    engine.close()


def test_metrics_to_dict_json_serializable(pair):
    cfg = pair[0]
    engine = fresh_engine(pair)
    rng = np.random.default_rng(5)
    engine.submit(Request("a", rng.integers(0, cfg.vocab_size, 8)
                          .astype(np.int32), max_new_tokens=2))
    engine.run()
    blob = json.loads(json.dumps(engine.metrics.to_dict()))
    assert blob["decode_steps"] == engine.metrics.decode_steps
    assert blob["ttft_wall"]["n"] == 1
    engine.close()


# ------------------------------------------------------------------ pump
def test_pump_stream_and_backpressure(pair):
    cfg = pair[0]
    engine = fresh_engine(pair)
    pump = EnginePump(engine, max_pending=1)
    rng = np.random.default_rng(6)
    p = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    sub = pump.submit(Request("a", p, max_new_tokens=3))
    with pytest.raises(Overloaded):
        pump.submit(Request("b", p, max_new_tokens=3))
    pump.start()
    assert sub.wait(TIMEOUT)
    assert sub.finish_reason == "length" and sub.error is None
    assert sub.tokens == engine.result("a")
    assert len(sub.token_times) == 3 and sub.ttft > 0
    pump.close()
    assert pump.closed
    pump.close()                            # idempotent


def test_pump_call_runs_on_pump_thread(pair):
    engine = fresh_engine(pair)
    pump = EnginePump(engine)
    assert pump.call(lambda: threading.current_thread().name).result() \
        == threading.current_thread().name
    pump.start()
    name = pump.call(lambda: threading.current_thread().name).result(30.0)
    assert name == "engine-pump"
    # the pump thread runs the engine without autograd
    assert pump.call(torch.is_grad_enabled).result(30.0) is False
    pump.close()


def test_pump_thread_records_no_autograd(pair):
    """Grad mode is per thread: weights that require grad leave no graph
    on the engine's cache or tokens when the pump drives it."""
    cfg, *_, tparams = pair

    def grad(tree):
        if isinstance(tree, dict):
            return {k: grad(v) for k, v in tree.items()}
        if torch.is_tensor(tree) and tree.is_floating_point():
            return tree.detach().clone().requires_grad_(True)
        return tree
    engine = fresh_engine(pair)
    engine.params = grad(tparams)
    pump = EnginePump(engine).start()
    p = np.random.default_rng(7).integers(0, cfg.vocab_size, 10)
    sub = pump.submit(Request("a", p.astype(np.int32), max_new_tokens=3))
    assert sub.wait(TIMEOUT) and sub.error is None
    kv = engine.kv
    for t in list(getattr(kv, "bufs", {}).values()) + [
            getattr(kv, "k", None), getattr(kv, "v", None)]:
        if torch.is_tensor(t):
            assert not t.requires_grad and t.grad_fn is None
    pump.close()


class _Boom(RuntimeError):
    pass


def test_pump_relays_an_engine_exception(pair):
    """An exception inside ``engine.step()``: every open client finishes
    with an error (500, or an error chunk in a stream), later requests
    get 500, nothing hangs, and ``close()`` re-raises."""
    engine = fresh_engine(pair)
    calls = {"n": 0}
    decode = engine._decode_batch

    def failing_decode():
        calls["n"] += 1
        if calls["n"] == 2:
            raise _Boom("decode failed")
        decode()
    engine._decode_batch = failing_decode
    pump = EnginePump(engine).start()
    api = FrontDoor(pump, SessionRouter(engine, block_size=16))

    async def main():
        plain = api.handle("POST", "/v1/chat/completions",
                           {"messages": [{"role": "user", "content": "a"}],
                            "max_tokens": 6})
        st, agen = await api.handle(
            "POST", "/v1/chat/completions",
            {"messages": [{"role": "user", "content": "bb"}],
             "max_tokens": 6, "stream": True})
        assert st == 200
        chunks = [c async for c in agen]
        st, err = await plain
        assert st == 500 and err["error"]["type"] == "engine_error"
        assert "decode failed" in err["error"]["message"]
        assert chunks[-1] == "data: [DONE]\n\n"
        last = json.loads(chunks[-2][len("data: "):])
        assert last["error"]["type"] == "engine_error"
        st, err = await api.handle(
            "POST", "/v1/completions", {"prompt": [1, 2, 3]})
        assert st == 500 and err["error"]["type"] == "engine_error"
        st, health = await api.handle("GET", "/healthz", None)
        assert st == 500 and health["status"] == "error"

    run(main())
    assert isinstance(pump.error, _Boom)
    with pytest.raises(EngineFailed):
        pump.close()
    assert not any(t.is_alive() for t in engine.mgr.saver._threads)


# ------------------------------------------------------------------- api
def _api(pair, port=True, *, start=True, **kw):
    engine = fresh_engine(pair, port, **kw)
    Pump, Door, Router = ((EnginePump, FrontDoor, SessionRouter) if port
                          else (JaxPump, JaxFrontDoor, JaxRouter))
    pump = Pump(engine)
    if start:
        pump.start()
    return engine, pump, Door(pump, Router(engine, block_size=16))


async def _chat(api, msgs, **body):
    st, r = await api.handle("POST", "/v1/chat/completions",
                             dict(body, messages=msgs))
    assert st == 200, r
    return r


def _tokens(api, r):
    return [int(t) for t in api.tokenizer.encode(
        r["choices"][0]["message"]["content"])]


async def _chat_script(api, fork: bool):
    """Round 1 fresh, round 2 exact by conversation id, round 3 restore
    by resent transcript, (with ``fork``) a second conversation branching
    from the first's checkpoint while the first is still bound, and a
    one-shot ``/v1/completions`` over round 3's full render."""
    out = []
    msgs = [{"role": "system", "content": "sys"},
            {"role": "user", "content": "hello"}]
    r1 = await _chat(api, msgs, max_tokens=4)
    conv = r1["conversation_id"]
    msgs2 = msgs + [{"role": "assistant",
                     "content": r1["choices"][0]["message"]["content"]},
                    {"role": "user", "content": "again"}]
    r2 = await _chat(api, msgs2, max_tokens=4, conversation_id=conv)
    msgs3 = msgs2 + [{"role": "assistant",
                      "content": r2["choices"][0]["message"]["content"]},
                     {"role": "user", "content": "more"}]
    rounds = [r1, r2]
    if fork:
        rounds.append(await _chat(api, msgs3, max_tokens=4,
                                  conversation_id="conv-branch"))
    r3 = await _chat(api, msgs3, max_tokens=4)
    rounds.append(r3)
    full = api.template.render(msgs3)
    st, ref = await api.handle("POST", "/v1/completions",
                               {"prompt": [int(t) for t in full],
                                "max_tokens": 4})
    assert st == 200
    for r in rounds:
        out.append((_tokens(api, r), r["hcache"]))
    out.append((ref["choices"][0]["tokens"], ref["hcache"]))
    return out


@pytest.mark.parametrize("backend,sharing", [("contiguous", False),
                                             ("paged", True)])
def test_api_chat_rounds_match_the_reference(pair, backend, sharing):
    """Chat rounds through both packages' front doors over the same
    weights: tokens equal, route kinds and matched tokens equal; round 2
    is exact and restores, round 3 is a restore by transcript, the
    branch (paged, sharing on) is a fork, and round 3 equals a one-shot
    completion over its full render."""
    got = {}
    for port in (False, True):
        engine, pump, api = _api(pair, port, backend=backend,
                                 prefix_sharing=sharing)
        got[port] = run(_chat_script(api, fork=sharing))
        got[port, "restored"] = engine.metrics.restored_tokens
        got[port, "forks"] = engine.metrics.forks
        got[port, "stats"] = api.router.stats()
        pump.close()
    assert got[True] == got[False]
    assert got[True, "stats"] == got[False, "stats"]
    kinds = [h["route"] for _, h in got[True]]
    assert kinds == (["fresh", "exact", "fork", "restore", "fresh"]
                     if sharing else ["fresh", "exact", "restore", "fresh"])
    assert got[True][-2][0] == got[True][-1][0]      # restore == one-shot
    assert got[True, "restored"] > 0
    assert got[True, "forks"] == got[False, "forks"] == int(sharing)


def test_api_streaming_delivers_incrementally(pair):
    engine, pump, api = _api(pair)

    async def main():
        body = {"messages": [{"role": "user", "content": "stream me"}],
                "max_tokens": 6}
        st, agen = await api.handle("POST", "/v1/chat/completions",
                                    dict(body, stream=True))
        assert st == 200
        # park the pump thread: the first chunk must arrive before the
        # generation can complete
        gate = threading.Event()
        pump.call(gate.wait)
        it = agen.__aiter__()
        seen = [(time.perf_counter(), await it.__anext__())]
        assert pump.pending() > 0
        gate.set()
        async for chunk in it:
            seen.append((time.perf_counter(), chunk))
        assert seen[-1][1] == "data: [DONE]\n\n"
        bodies = [json.loads(c[len("data: "):]) for _, c in seen[:-1]]
        deltas = [b["choices"][0]["delta"].get("content") for b in bodies]
        assert sum(1 for c in deltas if c) == 6
        assert bodies[-1]["choices"][0]["finish_reason"] == "length"
        assert bodies[-1]["hcache"]["route"] == "fresh"
        # the deltas join to the answer of the same request, unstreamed
        st, twin = await api.handle("POST", "/v1/completions", {
            "prompt": [int(t) for t in api.template.render(
                body["messages"])], "max_tokens": 6})
        assert "".join(c for c in deltas if c) == api.tokenizer.decode(
            twin["choices"][0]["tokens"])

    run(main())
    pump.close()


def test_api_backpressure_and_busy_statuses(pair):
    engine, pump, api = _api(pair, start=False)
    pump.max_pending = 1

    async def main():
        st, _ = await api.handle(
            "POST", "/v1/chat/completions",
            {"messages": [{"role": "user", "content": "one"}],
             "max_tokens": 2, "stream": True, "conversation_id": "conv-x"})
        assert st == 200
        st, err = await api.handle(
            "POST", "/v1/chat/completions",
            {"messages": [{"role": "user", "content": "one two"}],
             "max_tokens": 2, "conversation_id": "conv-x"})
        assert st == 409 and err["error"]["type"] == "conversation_busy"
        st, err = await api.handle(
            "POST", "/v1/chat/completions",
            {"messages": [{"role": "user", "content": "other"}],
             "max_tokens": 2, "conversation_id": "conv-y"})
        assert st == 429 and err["error"]["type"] == "overloaded"
        assert not any(s.busy and s.conversation_id == "conv-y"
                       for s in api.router.slots)
        st, _ = await api.handle("GET", "/healthz", None)
        assert st == 200

    run(main())
    pump.close(force=True)


def test_a_shed_fork_releases_its_pages(pair):
    """A branch routed to a fork and then shed with 429 drops the fork's
    parked pages (the reference keeps them until the engine closes)."""
    engine, pump, api = _api(pair, backend="paged", prefix_sharing=True)
    released = []
    release = engine.release_fork

    def recorded(sid):
        released.append(sid)
        release(sid)
    engine.release_fork = recorded

    async def main():
        msgs = [{"role": "user", "content": "a shared start " * 3}]
        r1 = await _chat(api, msgs, max_tokens=4)
        pump.max_pending = 0
        branch = msgs + [{"role": "assistant", "content":
                          r1["choices"][0]["message"]["content"]},
                         {"role": "user", "content": "branch"}]
        st, err = await api.handle("POST", "/v1/chat/completions",
                                   {"messages": branch, "max_tokens": 4,
                                    "conversation_id": "other"})
        assert st == 429 and err["error"]["type"] == "overloaded"
        await asyncio.wrap_future(pump.call(lambda: None))

    run(main())
    assert engine.metrics.forks == 1 and released == ["fd-2"]
    pump.close()


def test_api_validation_and_metrics_endpoint(pair):
    engine, pump, api = _api(pair)

    async def main():
        assert (await api.handle("POST", "/v1/chat/completions",
                                 {"messages": []}))[0] == 400
        assert (await api.handle("POST", "/v1/completions", {}))[0] == 400
        assert (await api.handle("POST", "/v1/completions",
                                 {"prompt": ""}))[0] == 400
        assert (await api.handle("GET", "/nope", None))[0] == 404
        st, models = await api.handle("GET", "/v1/models", None)
        assert st == 200 and models["data"][0]["id"] == api.model_name
        st, m = await api.handle("GET", "/metrics", None)
        assert st == 200
        json.dumps(m)
        assert {"engine", "router", "pump"} <= set(m)

    run(main())
    pump.close()


# ----------------------------------------------------- the port's choices
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_unresumable_models_are_served_one_shot(arch):
    """An ``ssm``/``hybrid`` model never gets a route that prefills on
    top of restored state: a returning conversation routes fresh over
    its full render, and its answer is a direct engine's one-shot."""
    cfg = reduced_for_smoke(get_arch(arch))
    model = Model(cfg, device="cpu")
    params = model.init(0)

    def engine():
        mgr = HCacheManager(model, ChunkStore(make_array("dram", 4),
                                              chunk_tokens=16),
                            hw=PAPER_A100, schedule_override="hidden")
        return InferenceEngine(model, params, mgr, max_batch=2,
                               max_seq=128)
    eng = engine()
    pump = EnginePump(eng).start()
    api = FrontDoor(pump)
    assert not api.router.steer

    async def main():
        msgs = [{"role": "user", "content": "hello"}]
        r1 = await _chat(api, msgs, max_tokens=3)
        msgs2 = msgs + [{"role": "assistant",
                         "content": r1["choices"][0]["message"]["content"]},
                        {"role": "user", "content": "again"}]
        r2 = await _chat(api, msgs2, max_tokens=3,
                         conversation_id=r1["conversation_id"])
        r3 = await _chat(api, msgs2, max_tokens=3)
        return api.template.render(msgs2), r2, r3

    full, r2, r3 = run(main())
    pump.close()
    for r in (r2, r3):
        assert r["hcache"]["route"] == "fresh"
        assert r["hcache"]["matched_tokens"] == 0
        assert r["usage"]["prompt_tokens"] == len(full)
    twin = engine()
    twin.submit(Request("one-shot", full, max_new_tokens=3))
    twin.run()
    assert _tokens(api, r2) == _tokens(api, r3) == twin.result("one-shot")
    twin.close()


def test_encdec_is_refused_with_its_reason(capsys):
    from repro_torch.launch import serve as serve_cli
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(["--device", "cpu", "--arch", "whisper-medium",
                        "--serve-http", "--port", "0"])
    assert exc.value.code != 0
    assert "encoder frames" in capsys.readouterr().err
    cfg = reduced_for_smoke(get_arch("whisper-medium"))
    model = Model(cfg, device="cpu")
    assert "encoder frames" in unservable(model)
    mgr = HCacheManager(model, ChunkStore(make_array("dram", 2)),
                        hw=PAPER_A100)
    eng = InferenceEngine(model, model.init(0), mgr, max_batch=1,
                          max_seq=64)
    with pytest.raises(ValueError, match="encoder frames"):
        FrontDoor(EnginePump(eng))
    with pytest.raises(ValueError, match="encoder frames"):
        asyncio.run(serve_engine(eng, port=0))
    assert not any(t.is_alive() for t in eng.mgr.saver._threads)


def test_budget_front_door_reclaims_on_the_pump_thread(pair):
    """A ``--budget-kb`` front door: the ladder's reclaim runs on the pump
    thread (the engine's), and restores still give the unbudgeted
    tokens."""
    _, _, _, tm, tparams = pair
    got = {}
    for budget in (None, 2048):
        store = ChunkStore(make_array("dram", 4), chunk_tokens=16,
                           cold_devices=make_array("dram", 4))
        mgr = HCacheManager(tm, store, hw=PAPER_A100,
                            schedule_override="hidden")
        cap = (CapacityManager(mgr, host_budget_bytes=budget)
               if budget else None)
        eng = InferenceEngine(tm, tparams, mgr, max_batch=2, max_seq=256,
                              prefill_chunk=8, capacity=cap)
        pump = EnginePump(eng).start()
        api = FrontDoor(pump)
        threads = []
        if cap is not None:
            walk = cap.ensure_host_budget

            def recorded():
                threads.append(threading.current_thread().name)
                return walk()
            cap.ensure_host_budget = recorded

        async def main():
            out, convs = [], {}
            for rnd in range(2):
                for c in range(3):
                    # round 0 long enough that round 1's match covers
                    # the router's reuse threshold
                    ask = (f"question {c} " * 6 if rnd == 0 else "more")
                    msgs = convs.get(c, []) + [{"role": "user",
                                                "content": ask}]
                    r = await _chat(api, msgs, max_tokens=3)
                    convs[c] = msgs + [{"role": "assistant", "content":
                                        r["choices"][0]["message"]
                                        ["content"]}]
                    out.append((_tokens(api, r), r["hcache"]["route"]))
            return out

        got[budget] = run(main())
        pump.close()
        if cap is not None:
            assert cap.actions, "the budget never reclaimed"
            assert threads and set(threads) == {"engine-pump"}
            assert cap._engine_thread == pump._thread.ident
    assert got[None] == got[2048]
    assert [k for _, k in got[2048]][3:] == ["restore"] * 3


# ------------------------------------------------------------------ http
async def http_request(port, path, body=None, method="POST"):
    """One HTTP/1.1 exchange over a socket; returns (status, raw body)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    doc = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n"
                 f"Content-Type: application/json\r\n"
                 f"Content-Length: {len(doc)}\r\n\r\n".encode() + doc)
    await writer.drain()
    status = int((await reader.readline()).decode().split()[1])
    while (await reader.readline()).strip():
        pass                                # headers
    raw = (await reader.read()).decode()    # Connection: close -> EOF
    writer.close()
    await writer.wait_closed()
    return status, raw


def test_http_binding_smoke(pair):
    """Ephemeral-port server, one non-streaming and one streaming request
    over real sockets, clean shutdown: ``engine.close()`` reached and no
    leaked threads."""
    before = set(threading.enumerate())
    engine = fresh_engine(pair)
    pump = EnginePump(engine).start()
    api = FrontDoor(pump)

    async def main():
        srv = await HttpFrontDoor(api, port=0).start()
        assert srv.port != 0
        st, raw = await http_request(
            srv.port, "/v1/chat/completions",
            {"messages": [{"role": "user", "content": "hi"}],
             "max_tokens": 3})
        assert st == 200
        assert len(json.loads(raw)["choices"][0]["message"]["content"]) == 3
        st, raw = await http_request(
            srv.port, "/v1/chat/completions",
            {"messages": [{"role": "user", "content": "hi2"}],
             "max_tokens": 3, "stream": True})
        assert st == 200
        events = [e for e in raw.split("\n\n") if e.startswith("data: ")]
        assert events[-1] == "data: [DONE]"
        deltas = [json.loads(e[len("data: "):]) for e in events[:-1]]
        assert sum(1 for d in deltas
                   if d["choices"][0]["delta"].get("content")) == 3
        st, raw = await http_request(srv.port, "/healthz", method="GET")
        assert st == 200 and json.loads(raw)["status"] == "ok"
        await srv.close()

    run(main())
    pump.close()
    assert not any(t.is_alive() for t in engine.mgr.saver._threads)
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()]
    assert not leaked, leaked
