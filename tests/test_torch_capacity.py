"""The port's host-storage budget against the JAX package: the int8
hidden codec (bitwise), the ladder's stages (the same manifests and byte
counts), ``CapacityManager`` (the same actions under the same budgets,
with and without a cold tier), promotion, and the engine under a budget
(the JAX engine's tokens and ladder actions).

One JAX smoke model (llama2-7b reduced, fp32) per module; its weights are
carried into the port by ``from_jax_params``. Both managers store hidden
states as fp32 and plan every layer ``hidden``, and both stores write
each manifest padded to one size (``META_BYTES``: the port's manifest
also carries its history segments for the recompute replay), so stored
byte counts, and with them the budget's decisions, agree exactly. The port also holds its own invariants: an int8 restore
equals the plain projection of the numpy-dequantized rows bitwise, and a
recompute-degraded restore equals the K/V before the demotion bitwise."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.config.hardware import PAPER_A100 as JAX_A100
from repro.configs import get_arch as jax_get_arch
from repro.core import restoration as jrest
from repro.core.capacity import CapacityManager as JaxCapacity
from repro.core.hcache import HCacheManager as JaxManager
from repro.distributed.sharding import default_rules
from repro.launch.mesh import make_mesh
from repro.models import Model as JaxModel
from repro.models.module import split
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.storage import ChunkStore as JaxStore
from repro.storage import make_array as jax_make_array
from repro_torch.config.hardware import PAPER_A100
from repro_torch.core import restoration as trest
from repro_torch.core.capacity import CapacityManager
from repro_torch.core.hcache import HCacheManager
from repro_torch.launch import serve as serve_cli
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import InferenceEngine, Request
from repro_torch.storage import ChunkStore, make_array

N_TOKENS = 32
META_BYTES = 1024


def padded(store_cls):
    """``store_cls`` writing every manifest as META_BYTES of JSON."""
    class Padded(store_cls):
        def put_manifest(self, session, manifest):
            m = {k: v for k, v in manifest.items() if k != "pad"}
            size = len(json.dumps(dict(m, pad="")))
            assert size <= META_BYTES, size
            super().put_manifest(session,
                                 dict(m, pad="x" * (META_BYTES - size)))
    return Padded


JaxStore, ChunkStore = padded(JaxStore), padded(ChunkStore)


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


def _stores(cold):
    def make(store_cls, arr):
        return store_cls(arr("dram", 4), chunk_tokens=16,
                         cold_devices=arr("dram", 4) if cold else None)
    return make(JaxStore, jax_make_array), make(ChunkStore, make_array)


def managers(pair, cold=False, **kw):
    """A JAX manager and a port manager on fresh stores, all-hidden."""
    _, jm, _, tm, _ = pair
    jstore, tstore = _stores(cold)
    jmgr = JaxManager(jm, jstore, hw=JAX_A100, schedule_override="hidden",
                      store_dtype=np.float32, **kw)
    tmgr = HCacheManager(tm, tstore, hw=PAPER_A100,
                         schedule_override="hidden", **kw)
    return jmgr, tmgr


def save_sessions(pair, jmgr, tmgr, n=4, n_tokens=N_TOKENS, seed=0):
    """The same seeded prompts prefilled and saved on both sides; returns
    the port's prefill outputs."""
    cfg, jm, jparams, tm, tparams = pair
    rng = np.random.default_rng(seed)
    outs = {}
    for i in range(n):
        toks = rng.integers(0, cfg.vocab_size, n_tokens).astype(np.int32)
        jout = jm.prefill(jparams, {"tokens": jnp.asarray(toks)[None]},
                          capture_hidden=True)
        jmgr.save_prefill(f"s{i}", toks, jout)
        tout = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)[None]},
                          capture_hidden=True)
        tmgr.save_prefill(f"s{i}", toks, tout)
        outs[f"s{i}"] = tout
    return outs


def same_manifest(jman, tman):
    """The port's manifest is the reference's plus its replay segments."""
    assert len(json.dumps(tman)) == len(json.dumps(jman)) == META_BYTES
    assert ({k: v for k, v in tman.items() if k not in ("segments", "pad")}
            == {k: v for k, v in jman.items() if k != "pad"})


def same_bytes(jstore, tstore, sid):
    for stream in (None, "h", "hs", "tok"):
        assert tstore.bytes_for(sid, stream) == jstore.bytes_for(sid, stream)
    assert tstore.bytes_for(sid, include_cold=False) == \
        jstore.bytes_for(sid, include_cold=False)


def close(*mgrs):
    for m in mgrs:
        m.saver.close()


# ------------------------------------------------------------------ codec
@pytest.mark.parametrize("shape,seed", [((40, 64), 0), ((1, 7, 96), 1),
                                        ((4, 3, 1, 128), 2), ((17, 1), 3)])
def test_codec_is_bitwise_the_reference(shape, seed):
    """Quantize, the numpy dequantize and the torch dequantize (the one
    the card runs) give the reference's bits; a zero row keeps the floor
    scale."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30)).astype(
        np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0
    q, s = trest.quantize_hidden_int8(x)
    jq, js = jrest.quantize_hidden_int8(x)
    assert q.dtype == jq.dtype == np.int8 and s.dtype == js.dtype
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s.view(np.int32), js.view(np.int32))
    want = jrest.dequantize_hidden_int8(jq, js)
    got = trest.dequantize_hidden_int8(q, s)
    dev = trest.dequantize_hidden_int8_torch(torch.from_numpy(q),
                                             torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(dev.view(np.int32), want.view(np.int32))


def test_bf16_words_widen_exactly():
    """Stored bf16 rows (raw words) widen to the same fp32 the card's
    ``.float()`` gives, so int8 rows of a bf16 model quantize the values
    the model computed."""
    x = torch.randn(9, 40, generator=torch.Generator().manual_seed(4))
    b = x.to(torch.bfloat16)
    words = trest.to_host(b)
    assert words.dtype == np.int16
    np.testing.assert_array_equal(
        trest.host_float32(words, torch.bfloat16), b.float().numpy())


def test_decode_rows_of_int8_sessions_are_quantized_per_row(pair):
    """A decode step's int8 rows go to "h"/"hs" with the bulk codec's
    bits; the plain rows of the same step stay at full fidelity."""
    cfg, _, _, tm, _ = pair
    tmgr = HCacheManager(tm, ChunkStore(make_array("dram", 2),
                                        chunk_tokens=16),
                         hw=PAPER_A100, schedule_override="hidden")
    tmgr._session_compress["a"] = "int8"
    L, D = cfg.n_layers, cfg.d_model
    h = torch.randn(L, 3, 1, D, generator=torch.Generator().manual_seed(5))
    tmgr.save_decode_hidden(["a", None, "b"], h, np.array([0, 0, 0]))
    tmgr.saver.drain()
    for sid in ("a", "b"):
        tmgr.store.flush(sid)
    for li in range(L):
        q = tmgr.store.read_layer("a", "h", li, 1)
        s = tmgr.store.read_layer("a", "hs", li, 1)
        wq, ws = jrest.quantize_hidden_int8(h[li, 0].numpy())
        np.testing.assert_array_equal(q, wq)
        np.testing.assert_array_equal(s, ws)
        np.testing.assert_array_equal(tmgr.store.read_layer("b", "h", li, 1),
                                      h[li, 2].numpy())
    assert tmgr.store.bytes_for("b", "hs") == 0
    close(tmgr)


# ------------------------------------------------------- the ladder stages
STAGES = {"int8": ("demote_hidden_int8",),
          "int8-promote": ("demote_hidden_int8", "promote_hidden_fp16"),
          "recompute": ("degrade_to_recompute",),
          "int8-recompute": ("demote_hidden_int8", "degrade_to_recompute"),
          "int8-twice": ("demote_hidden_int8", "demote_hidden_int8")}


@pytest.mark.parametrize("stages", sorted(STAGES))
def test_stages_leave_the_references_manifests_and_bytes(pair, stages):
    jmgr, tmgr = managers(pair)
    save_sessions(pair, jmgr, tmgr, n=2)
    for name in STAGES[stages]:
        for sid in ("s0", "s1"):
            assert getattr(tmgr, name)(sid) == getattr(jmgr, name)(sid)
            same_manifest(jmgr.store.get_manifest(sid),
                          tmgr.store.get_manifest(sid))
            same_bytes(jmgr.store, tmgr.store, sid)
    assert tmgr.store.bytes_used == jmgr.store.bytes_used
    close(jmgr, tmgr)


def test_int8_codec_from_the_first_save_matches_the_reference(pair):
    """A manager built with ``compress="int8"`` stores every session in
    the codec from its first prefill: the reference's manifests and
    bytes, and a restore within the reference's 0.05."""
    cfg, _, _, tm, tparams = pair
    jmgr, tmgr = managers(pair, compress="int8")
    outs = save_sessions(pair, jmgr, tmgr, n=2)
    for sid in ("s0", "s1"):
        same_manifest(jmgr.store.get_manifest(sid),
                      tmgr.store.get_manifest(sid))
        same_bytes(jmgr.store, tmgr.store, sid)
        assert tmgr.store.bytes_for(sid, "hs") > 0
    res = tmgr.restore(tparams, "s0")
    err = (res.cache["k"][:, :, :N_TOKENS] - outs["s0"]["kv"][0]).abs()
    assert 0 < float(err.max()) < 0.05
    close(jmgr, tmgr)


def test_int8_restore_is_the_plain_projection_of_the_dequantized_rows(pair):
    """The executor's int8 path (int8 rows and scales uploaded, multiplied
    out where the projection runs) gives, bitwise, the plain projection
    of the numpy-dequantized rows; and it stays within the reference's
    0.05 of the full-fidelity K/V."""
    cfg, _, _, tm, tparams = pair
    jmgr, tmgr = managers(pair)
    outs = save_sessions(pair, jmgr, tmgr, n=1)
    assert tmgr.demote_hidden_int8("s0")
    res = tmgr.restore(tparams, "s0")
    pack = tmgr.param_pack(tparams)
    cos, sin = pack.rope_tables(N_TOKENS)
    for li in range(cfg.n_layers):
        h = trest.dequantize_hidden_int8(
            tmgr.store.read_layer("s0", "h", li, N_TOKENS),
            tmgr.store.read_layer("s0", "hs", li, N_TOKENS))
        k, v = trest.project_group(pack, torch.from_numpy(h)[None],
                                   pack.rows((li,)), cos, sin)
        assert torch.equal(res.cache["k"][li, 0, :N_TOKENS], k[0])
        assert torch.equal(res.cache["v"][li, 0, :N_TOKENS], v[0])
    err = (res.cache["k"][:, :, :N_TOKENS] - outs["s0"]["kv"][0]).abs()
    assert 0 < float(err.max()) < 0.05
    close(jmgr, tmgr)


def test_recompute_degraded_restore_is_exact(pair):
    """A session degraded to token-only restores every layer by the
    replay of its history, bitwise the K/V its prefill emitted."""
    _, _, _, tm, tparams = pair
    jmgr, tmgr = managers(pair)
    outs = save_sessions(pair, jmgr, tmgr, n=1)
    assert tmgr.degrade_to_recompute("s0")
    res = tmgr.restore(tparams, "s0")
    assert set(res.schedule.methods) == {"recompute"}
    assert torch.equal(res.cache["k"][:, :, :N_TOKENS], outs["s0"]["kv"][0])
    assert torch.equal(res.cache["v"][:, :, :N_TOKENS], outs["s0"]["kv"][1])
    close(jmgr, tmgr)


# ------------------------------------------------------ CapacityManager
def _ladder_case(pair, *, cold, fraction, pre_cold=False):
    jmgr, tmgr = managers(pair, cold=cold)
    outs = save_sessions(pair, jmgr, tmgr)
    if pre_cold:
        for m in (jmgr, tmgr):
            assert m.store.demote_session_to_cold("s0") > 0
    assert tmgr.store.bytes_used == jmgr.store.bytes_used
    budget = int(jmgr.store.bytes_used * fraction)
    jcap = JaxCapacity(jmgr, host_budget_bytes=budget)
    tcap = CapacityManager(tmgr, host_budget_bytes=budget)
    assert tcap.ensure_host_budget() == jcap.ensure_host_budget() > 0
    assert tcap.actions == jcap.actions
    assert tmgr.store.bytes_used == jmgr.store.bytes_used <= budget
    assert tmgr.store.bytes_cold == jmgr.store.bytes_cold
    for sid in tmgr.store.sessions():
        same_manifest(jmgr.store.get_manifest(sid),
                      tmgr.store.get_manifest(sid))
    return jmgr, tmgr, tcap, outs


def test_budget_with_a_cold_tier_gives_the_references_actions(pair):
    """Cold tier first; demoted sessions restore at full fidelity."""
    _, _, _, _, tparams = pair
    jmgr, tmgr, tcap, outs = _ladder_case(pair, cold=True, fraction=0.3)
    assert ("cold", "s0") in tcap.actions and tmgr.store.bytes_cold > 0
    for sid, out in outs.items():
        res = tmgr.restore(tparams, sid)
        assert torch.equal(res.cache["k"][:, :, :N_TOKENS], out["kv"][0])
    close(jmgr, tmgr)


def test_budget_without_a_cold_tier_gives_the_references_actions(pair):
    """int8, then recompute (then drop) under a deep budget; each stage's
    restores within the reference's bounds."""
    _, _, _, _, tparams = pair
    jmgr, tmgr, tcap, outs = _ladder_case(pair, cold=False, fraction=0.05)
    stages = {s for s, _ in tcap.actions}
    assert {"int8", "recompute"} <= stages
    for sid in tmgr.store.sessions():
        man = tmgr.store.get_manifest(sid)
        res = tmgr.restore(tparams, sid)
        got = res.cache["k"][:, :, :N_TOKENS]
        want = outs[sid]["kv"][0]
        if man["compress"] == "int8":
            assert float((got - want).abs().max()) < 0.05
        else:
            assert torch.equal(got, want)
    close(jmgr, tmgr)


def test_int8_after_cold_gives_the_references_bytes(pair):
    """The int8 re-encode of a cold session lands back in the cold tier
    (the hot tier never grows); its restore stays within 0.05."""
    _, _, _, _, tparams = pair
    jmgr, tmgr = managers(pair, cold=True)
    outs = save_sessions(pair, jmgr, tmgr, n=1)
    for m in (jmgr, tmgr):
        assert m.store.demote_session_to_cold("s0") > 0
        assert m.demote_hidden_int8("s0")
        assert m.store.bytes_used == 0
        assert m.store.stream_in_cold("s0", "h")
        assert m.store.stream_in_cold("s0", "hs")
    same_bytes(jmgr.store, tmgr.store, "s0")
    res = tmgr.restore(tparams, "s0")
    err = (res.cache["k"][:, :, :N_TOKENS] - outs["s0"]["kv"][0]).abs()
    assert float(err.max()) < 0.05
    close(jmgr, tmgr)


def test_cold_then_ladder_gives_the_references_actions(pair):
    _ladder_case(pair, cold=True, fraction=0.1, pre_cold=True)


def test_pressure_callback_and_promotions_match_the_reference(pair):
    """A write past the array's budget reclaims with no engine in the
    loop; promotion sweeps take the reference's steps."""
    jmgr, tmgr = managers(pair, cold=True)
    save_sessions(pair, jmgr, tmgr, n=1)
    budget = jmgr.store.bytes_used + 100
    caps = [JaxCapacity(jmgr, host_budget_bytes=budget),
            CapacityManager(tmgr, host_budget_bytes=budget)]
    assert tmgr.store.devices.budget_bytes == budget
    save_sessions(pair, jmgr, tmgr, n=2, seed=1)   # blows the budget
    assert caps[1].actions == caps[0].actions != []
    assert tmgr.store.bytes_used == jmgr.store.bytes_used <= budget
    # promotion: back to full fidelity where the budget has room
    for cap in caps:
        cap.host_budget_bytes = 10_000_000
        for sid in ("s0", "s1"):
            cap.mgr.demote_hidden_int8(sid)
    assert [c.sweep_promotions(limit=1) for c in caps] == [1, 1]
    assert [c.sweep_promotions(limit=2) for c in caps] == [1, 1]
    assert caps[1].actions == caps[0].actions
    for sid in ("s0", "s1"):
        same_manifest(jmgr.store.get_manifest(sid),
                      tmgr.store.get_manifest(sid))
    # no room: nothing moves
    for cap in caps:
        cap.mgr.demote_hidden_int8("s0")
        cap.host_budget_bytes = cap.store.bytes_used + 16
        assert cap.sweep_promotions() == 0
        assert not cap.consider_promotion("s0")
    close(jmgr, tmgr)


# ---------------------------------------------------------------- engine
def engines(pair, *, cold=False, budget=None, **kw):
    cfg, jm, jparams, tm, tparams = pair
    jmgr, tmgr = managers(pair, cold=cold)
    defaults = dict(max_batch=2, max_seq=128, prefill_chunk=8)
    defaults.update(kw)
    jeng = JaxEngine(jm, jparams, jmgr, capacity=(
        JaxCapacity(jmgr, host_budget_bytes=budget)
        if budget is not None else None), **defaults)
    teng = InferenceEngine(tm, tparams, tmgr, capacity=(
        CapacityManager(tmgr, host_budget_bytes=budget)
        if budget is not None else None), **defaults)
    return jeng, teng


def run(eng, reqs, request_cls):
    for sid, prompt, n in reqs:
        eng.submit(request_cls(sid, prompt, max_new_tokens=n))
    eng.run()
    return {sid: eng.result(sid) for sid, _, _ in reqs}


def _prompts(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(k)).astype(np.int32)
            for k in rng.integers(6, 24, size=n)]


@pytest.mark.parametrize("cold", [True, False], ids=["cold", "no-cold"])
def test_engine_under_a_budget_matches_the_reference(pair, cold):
    """Slot pressure and storage pressure at once, two rounds: the JAX
    engine's tokens and ladder actions, every request served, the hot
    tier within the budget at the end."""
    cfg = pair[0]
    budget = 26_000 if cold else 24_000
    jeng, teng = engines(pair, cold=cold, budget=budget, preempt_quantum=3)
    prompts = _prompts(cfg, 6, seed=3)
    want, got = [], []
    for rnd in range(2):
        reqs = [(f"b{i}", p[:4 + 4 * rnd], 4) for i, p in enumerate(prompts)]
        want.append(run(jeng, reqs, JaxRequest))
        got.append(run(teng, reqs, Request))
    assert got == want
    assert teng.capacity.actions == jeng.capacity.actions != []
    if not cold:
        assert "int8" in {s for s, _ in teng.capacity.actions}
    assert teng.metrics.restored_tokens == jeng.metrics.restored_tokens > 0
    assert all(len(t) == 4 for r in got for t in r.values())
    assert teng.mgr.store.bytes_used <= budget
    jeng.close()
    teng.close()


def test_engine_promotes_on_save_and_on_idle_steps(pair):
    """An int8 session is promoted on its next save when the budget has
    room (``_after_save``), and an idle one by the idle step's sweep."""
    cfg = pair[0]
    jeng, teng = engines(pair, budget=10_000_000)
    rng = np.random.default_rng(9)
    p1, p2, p3 = (rng.integers(0, cfg.vocab_size, k).astype(np.int32)
                  for k in (12, 5, 10))
    for eng, req in ((jeng, JaxRequest), (teng, Request)):
        run(eng, [("promo", p1, 3)], req)
        assert eng.mgr.demote_hidden_int8("promo")
        run(eng, [("promo", p2, 2)], req)
        run(eng, [("idle", p3, 3)], req)
        assert eng.mgr.demote_hidden_int8("idle")
        eng.step()
        assert ("promote", "idle") in eng.capacity.actions
        assert eng.mgr.store.get_manifest("idle")["compress"] == "none"
    assert teng.capacity.actions == jeng.capacity.actions
    assert ("promote", "promo") in teng.capacity.actions
    assert teng.result("promo") == jeng.result("promo")
    jeng.close()
    teng.close()


def test_stale_prefetch_executor_is_dropped_after_a_demotion(pair):
    """A warm executor that started before the ladder re-encoded its
    session is replaced at admission: the restore reads the int8 rows."""
    cfg, _, _, tm, tparams = pair
    _, teng = engines(pair)
    rng = np.random.default_rng(2)
    run(teng, [("w", rng.integers(0, cfg.vocab_size, 20).astype(np.int32),
                3)], Request)
    warm = teng.mgr.begin_restore(tparams, "w")
    teng._prefetch["w"] = warm
    assert warm.compress == "none"
    assert teng.mgr.demote_hidden_int8("w")
    seq = teng.submit(Request("w", np.asarray([5], np.int32),
                              max_new_tokens=2))
    teng._admit()
    assert seq.executor is not warm and seq.executor.compress == "int8"
    assert "w" not in teng._prefetch
    teng.run()
    assert len(teng.result("w")) == 2
    teng.close()


def test_serve_budget_kb_prints_the_ladder(capsys):
    """``--budget-kb`` builds the DRAM cold tier and the manager, and the
    ladder acts on the smoke trace."""
    serve_cli.main(["--device", "cpu", "--sessions", "3", "--rounds", "2",
                    "--prompt-len", "10", "--gen", "3", "--max-batch", "2",
                    "--max-seq", "64", "--budget-kb", "8"])
    out = capsys.readouterr().out
    assert "capacity ladder actions: [('cold'" in out
    assert "MB cold" in out and "round 1 user2: 3 tokens" in out
