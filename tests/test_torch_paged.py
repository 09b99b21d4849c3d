"""The port's paged KV backend and its serving command: the pool-pressure
scenarios of tests/test_paged.py against the JAX package's engine on the
same weights (tokens and admission counters equal), the allocator and
reservation edge cases, the drop of a decode write that has no page (the
pool's bytes are inspected), the restore-cost policies against the JAX
package's, and ``python -m repro_torch.launch.serve`` end to end."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.config.hardware import PAPER_A100 as JAX_A100
from repro.config.hardware import PAPER_H800 as JAX_H800
from repro.configs import get_arch as jax_get_arch
from repro.core import capacity as jcap
from repro.core.hcache import HCacheManager as JaxManager
from repro.distributed.sharding import default_rules
from repro.launch.mesh import make_mesh
from repro.models import Model as JaxModel
from repro.models.module import split
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.storage import ChunkStore as JaxStore
from repro.storage import make_array as jax_make_array
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.config.hardware import PAPER_A100, PAPER_H800
from repro_torch.configs import get_arch
from repro_torch.core import capacity as tcap
from repro_torch.core.hcache import HCacheManager
from repro_torch.launch import serve as serve_cli
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import (BlockAllocator, InferenceEngine,
                                 PagedBackend, Request, make_backend)
from repro_torch.storage import ChunkStore, make_array


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


def _engines(pair, **kw):
    """The JAX engine and the port's, configured alike."""
    cfg, jm, jparams, tm, tparams = pair
    jmgr = JaxManager(jm, JaxStore(jax_make_array("dram", 4),
                                   chunk_tokens=16),
                      hw=JAX_A100, schedule_override="hidden",
                      store_dtype=np.float32)
    tmgr = HCacheManager(tm, ChunkStore(make_array("dram", 4),
                                        chunk_tokens=16),
                         hw=PAPER_A100, schedule_override="hidden")
    defaults = dict(max_batch=2, max_seq=128, prefill_chunk=8)
    defaults.update(kw)
    return (JaxEngine(jm, jparams, jmgr, **defaults),
            InferenceEngine(tm, tparams, tmgr, **defaults))


def _serve_both(pair, requests, **kw):
    out = []
    for eng, req in zip(_engines(pair, **kw), (JaxRequest, Request)):
        for sid, prompt, n in requests:
            eng.submit(req(sid, prompt, max_new_tokens=n))
        eng.run()
        out.append(({sid: eng.result(sid) for sid, _, _ in requests}, eng))
        eng.close()
    return out


def _prompts(cfg, n, seed=7, lo=6, hi=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, size=n)]


# ------------------------------------------------ pool pressure vs JAX
def test_pool_exhaustion_backpressure_matches_jax(pair):
    """A 4-page pool under 4 slots and 6 two-page sessions: admission
    stalls on the allocator, pages recycle, every page comes back."""
    cfg = pair[0]
    reqs = [(f"b{i}", p, 3)
            for i, p in enumerate(_prompts(cfg, 6, seed=3, lo=16, hi=24))]
    (want, jeng), (got, teng) = _serve_both(
        pair, reqs, max_batch=4, backend="paged", cache_blocks=4)
    assert got == want
    jm, tm = jeng.metrics, teng.metrics
    assert (tm.alloc_stalls, tm.concurrent_peak) \
        == (jm.alloc_stalls, jm.concurrent_peak)
    assert tm.alloc_stalls > 0 and tm.concurrent_peak < 4
    assert teng.kv.allocator.free_count == 4
    assert all(not blks for blks in teng.kv.slot_blocks)


def test_preemption_on_pool_exhaustion_matches_jax(pair):
    """Free slots but a hogged pool: the quantum still bounds the wait."""
    cfg = pair[0]
    rng = np.random.default_rng(2)
    reqs = [("hog", rng.integers(0, cfg.vocab_size, 30).astype(np.int32), 8),
            ("small", rng.integers(0, cfg.vocab_size, 18).astype(np.int32),
             3)]
    (want, jeng), (got, teng) = _serve_both(
        pair, reqs, max_batch=4, backend="paged", cache_blocks=4,
        preempt_quantum=2)
    assert got == want
    assert (teng.metrics.alloc_stalls, teng.metrics.preemptions) \
        == (jeng.metrics.alloc_stalls, jeng.metrics.preemptions)
    assert teng.metrics.preemptions > 0
    assert teng.kv.allocator.free_count == 4


def test_restore_cost_policies_match_jax(pair):
    """Restore-cost admission and eviction over a backed-up queue pick the
    JAX engine's sessions, so the tokens and counters agree."""
    cfg = pair[0]
    reqs = [(f"r{i}", p, 4) for i, p in enumerate(_prompts(cfg, 5, seed=9))]
    results = []
    engines = _engines(pair, max_batch=2, backend="paged", preempt_quantum=2)
    for eng, cap, req in zip(engines, (jcap, tcap), (JaxRequest, Request)):
        eng.admission = cap.RestoreCostAwareAdmission(aging=1e-4)
        eng.eviction = cap.RestoreCostAwareEviction()
        for sid, prompt, n in reqs:
            eng.submit(req(sid, prompt, max_new_tokens=n))
        eng.run()
        # a second round: admission now prices stored sessions
        for sid, prompt, n in reqs:
            eng.submit(req(sid, prompt[:3], max_new_tokens=2))
        eng.run()
        results.append(({sid: eng.result(sid) for sid, _, _ in reqs},
                        eng.metrics.preemptions,
                        eng.metrics.restored_tokens))
        eng.close()
    assert results[1] == results[0]
    assert results[1][1] > 0 and results[1][2] > 0


def test_restore_makespan_matches_jax():
    """The policies' cost estimate is the JAX package's, at one and at
    several concurrent restores."""
    jcfg, tcfg = jax_get_arch("llama2-7b"), get_arch("llama2-7b")
    mesh = make_mesh((1, 1), ("data", "model"))
    jm = JaxModel(jax_reduced(jcfg), rules=default_rules(mesh),
                  dtype=jnp.float32, remat="none")
    jm.cfg = jcfg
    tm = Model(reduced_for_smoke(tcfg), device="cpu")
    tm.cfg = tcfg
    jmgr = JaxManager(jm, JaxStore(jax_make_array("ssd", 4)), hw=JAX_H800)
    tmgr = HCacheManager(tm, ChunkStore(make_array("ssd", 4)), hw=PAPER_H800)
    jmgr.cfg, tmgr.cfg = jcfg, tcfg
    for streams in (1, 3):
        jmgr.set_io_streams(streams)
        tmgr.set_io_streams(streams)
        for n, methods in ((300, ("recompute",) * 7 + ("hidden",) * 25),
                           (2000, ("hidden",) * 30 + ("kv",) * 2)):
            want = jcap.restore_makespan(jmgr, n, methods)
            assert tcap.restore_makespan(tmgr, n, methods) \
                == pytest.approx(want, rel=1e-12)
    tmgr.close()


def test_restore_from_a_start_token(pair):
    """``begin_restore(start_token=d)`` restores only [d, n): the same bits
    the full restore puts there, nothing below d. Recompute layers cannot
    skip."""
    from repro_torch.core.restoration import CacheAssembler
    cfg, _, _, tm, tparams = pair
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 40)))
    out = tm.prefill(tparams, {"tokens": toks}, capture_hidden=True)
    mgr = HCacheManager(tm, ChunkStore(make_array("dram", 2),
                                       chunk_tokens=16),
                        schedule_override="hidden", restore_group_size=3)
    mgr.save_prefill("s", toks[0].numpy(), out)
    full = mgr.restore(tparams, "s").cache
    sink = CacheAssembler(tm, 40)
    mgr.begin_restore(tparams, "s", sink, start_token=16).run()
    for name in ("k", "v"):
        assert torch.equal(sink.cache[name][:, :, 16:40],
                           full[name][:, :, 16:40])
        assert not sink.cache[name][:, :, :16].any()
    mgr.schedule_override = "recompute"
    mgr.save_prefill("r", toks[0].numpy(), out)
    with pytest.raises(ValueError, match="recompute"):
        mgr.begin_restore(tparams, "r", start_token=16)
    mgr.close()


# ------------------------------------------------- backend edge cases
def test_block_allocator_edges():
    a = BlockAllocator(4)
    got = a.alloc(3)
    assert len(got) == 3 and a.free_count == 1
    assert a.alloc(2) is None                 # exhaustion: no partial grant
    last = a.alloc(1)
    assert a.alloc(1) is None and a.free_count == 0
    a.free(got)
    assert a.alloc(3) == got                  # LIFO reuse
    a.free(last)
    with pytest.raises(RuntimeError, match="double free"):
        a.free(last)
    a.incref(got[0])
    assert a.refcount(got[0]) == 2


def test_reserve_is_all_or_nothing(pair):
    tm = pair[3]
    b = PagedBackend(tm, max_batch=2, max_seq=64, block_size=16,
                     num_blocks=3)
    assert b.reserve(0, 40)                        # 3 pages
    assert b.allocator.free_count == 0
    assert not b.can_reserve(1)
    assert not b.reserve(1, 1)                     # exhausted: no grant
    assert b.allocator.free_count == 0             # and nothing leaked
    b.free_slot(0)
    assert b.allocator.free_count == 3
    assert b.reserve(1, 1)


def test_reserve_clamps_overlong_sessions_to_table_row(pair):
    tm = pair[3]
    b = PagedBackend(tm, max_batch=2, max_seq=64, block_size=16)
    assert b.can_reserve(100_000)
    assert b.reserve(0, 100_000)
    assert len(b.slot_blocks[0]) == 4              # blocks_per_seq
    tiny = PagedBackend(tm, max_batch=2, max_seq=64, block_size=16,
                        num_blocks=2)
    assert tiny.reserve(0, 100_000)
    assert len(tiny.slot_blocks[0]) == 2


def test_decode_write_without_a_page_is_dropped(pair):
    """A slot that is exactly full and a slot with no pages write nowhere;
    a slot with room writes exactly its new token's row. Every other byte
    of the pool stays as it was."""
    _, _, _, tm, tparams = pair
    b = PagedBackend(tm, max_batch=3, max_seq=32, block_size=8,
                     num_blocks=6)
    gen = torch.Generator().manual_seed(0)
    b.k_pool.copy_(torch.randn(b.k_pool.shape, generator=gen))
    b.v_pool.copy_(torch.randn(b.v_pool.shape, generator=gen))
    assert b.reserve(0, 8) and b.reserve(2, 16)
    b.set_length(0, 8)                             # full: page 1 unmapped
    b.set_length(2, 5)                             # slot 1: no pages at all
    k0, v0 = b.k_pool.clone(), b.v_pool.clone()
    b.decode(tparams, np.array([[3], [4], [5]]))
    changed = (b.k_pool != k0).any(dim=(-1, -2)) \
        | (b.v_pool != v0).any(dim=(-1, -2))       # (L, NB, bs)
    page = int(b.table_np[2, 0])
    want = torch.zeros_like(changed)
    want[:, page, 5] = True
    assert torch.equal(changed, want)
    assert b.lengths_np.tolist() == [9, 1, 6]


def test_make_backend_and_unknown_names(pair):
    tm = pair[3]
    assert make_backend("paged", tm, 2, 32).name == "paged"
    assert make_backend("contiguous", tm, 2, 32).name == "contiguous"
    with pytest.raises(ValueError):
        make_backend("paged-tp", tm, 2, 32)


# ---------------------------------------------------------- serve.py
def test_serve_runs_end_to_end_on_the_cpu(tmp_path, capsys):
    path = tmp_path / "metrics.json"
    serve_cli.main(["--device", "cpu", "--sessions", "3", "--rounds", "2",
                    "--prompt-len", "10", "--gen", "3", "--max-batch", "2",
                    "--max-seq", "64", "--backend", "paged",
                    "--preempt-quantum", "2", "--restore-group-size", "2",
                    "--metrics-json", str(path)])
    out = capsys.readouterr().out
    assert "round 1 user2: 3 tokens" in out
    assert "cache backend paged" in out
    m = json.loads(path.read_text())
    assert m["ttft_wall"]["n"] == 6 and m["ttft_wall_restored"]["n"] >= 3
    assert m["restored_tokens"] > 0 and m["decode_steps"] > 0
    assert m["device_gauges"][0]["device"] == 0


# argv1, argv2, argv5 and argv6 pair ported flags with one still refused:
# the ported flags must not get the other through
@pytest.mark.parametrize("argv", [["--tp", "2"],
                                  ["--prefix-sharing", "--tp", "2"],
                                  ["--budget-kb", "64", "--serve-http"],
                                  ["--serve-http"],
                                  ["--tp", "4"],
                                  ["--enc-seq", "16", "--tp", "2"],
                                  ["--budget-kb", "1", "--enc-seq", "16",
                                   "--serve-http"]])
def test_serve_refuses_unported_flags(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(["--device", "cpu"] + argv)
    assert exc.value.code != 0
    assert "not ported" in capsys.readouterr().err


SERVE_SMALL = ["--device", "cpu", "--sessions", "3", "--rounds", "2",
               "--prompt-len", "10", "--gen", "3", "--max-batch", "2",
               "--max-seq", "64"]


def test_serve_hw_profile_writes_a_profile_that_loads_back(tmp_path,
                                                           capsys):
    from repro_torch.core.profiler import MeasuredProfile
    path = tmp_path / "profile.json"
    for run in range(2):             # the second run starts from the file
        serve_cli.main(SERVE_SMALL + ["--hw-profile", str(path),
                                      "--restore-group-size", "auto"])
        out = capsys.readouterr().out
        assert f"-> {path}" in out and "scheduler calibration" in out
        profile = MeasuredProfile.load(str(path))
        counts = profile.sample_counts()
        assert counts and all(n > 0 for n in counts.values())
        assert f"epoch {profile.epoch}," in out
        if run:                      # the loaded samples were kept
            assert all(counts[k] >= first[k] for k in first)
            assert sum(counts.values()) > sum(first.values())
        first = counts


def test_serve_group_plans_auto_and_fetch_give_the_tokens_of_8(
        tmp_path, capsys, monkeypatch):
    emitted = []

    class Recording(serve_cli.InferenceEngine):
        def _emit_token(self, seq, tok):
            emitted.append((seq.request.session_id, tok))
            super()._emit_token(seq, tok)

    monkeypatch.setattr(serve_cli, "InferenceEngine", Recording)
    tokens = {}
    for plan in ("8", "auto", "fetch"):
        path = tmp_path / f"m{plan}.json"
        emitted.clear()
        serve_cli.main(SERVE_SMALL + ["--restore-group-size", plan,
                                      "--preempt-quantum", "2",
                                      "--metrics-json", str(path)])
        capsys.readouterr()
        tokens[plan] = list(emitted)
        assert json.loads(path.read_text())["restored_tokens"] > 0
    assert len(tokens["8"]) == 18
    assert tokens["auto"] == tokens["8"] and tokens["fetch"] == tokens["8"]
