"""The port's serving engine: greedy tokens against the JAX package's
engine on the same weights (the scenarios of tests/test_serving.py and
the paged acceptance workload of tests/test_paged.py), and the port's own
bitwise invariants: paged equals contiguous, and every restore rebuilds
the K/V the session held before it was paused or retired, recompute
layers included, after decode steps at a batch width above one.

One JAX smoke model (llama2-7b reduced, fp32) per module; its weights are
carried into the port by ``from_jax_params``. Both managers store hidden
states as fp32, so restores are lossless on both sides. Greedy tokens
must be equal; the two frameworks' logits differ by ~1e-6 here, far below
the gaps between the top logits of these random weights."""
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
from repro.launch.mesh import make_mesh
from repro.models import Model as JaxModel
from repro.models.module import split
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.storage import ChunkStore as JaxStore
from repro.storage import make_array as jax_make_array
from repro_torch.config.hardware import PAPER_A100
from repro_torch.core.hcache import HCacheManager
from repro_torch.core.scheduler import Schedule
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import InferenceEngine, Phase, Request
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


def jax_engine(pair, **kw):
    cfg, jm, jparams, _, _ = pair
    mgr = JaxManager(jm, JaxStore(jax_make_array("dram", 4), chunk_tokens=16),
                     hw=JAX_A100, schedule_override="hidden",
                     store_dtype=np.float32)
    defaults = dict(max_batch=2, max_seq=128, prefill_chunk=8)
    defaults.update(kw)
    return JaxEngine(jm, jparams, mgr, **defaults)


def port_engine(pair, manager=HCacheManager, **kw):
    _, _, _, tm, tparams = pair
    mgr = manager(tm, ChunkStore(make_array("dram", 4), chunk_tokens=16),
                  hw=PAPER_A100, schedule_override="hidden")
    defaults = dict(max_batch=2, max_seq=128, prefill_chunk=8)
    defaults.update(kw)
    return InferenceEngine(tm, tparams, mgr, **defaults)


def serve(engine, requests, request_cls, close=True):
    """Submit ``(session, prompt, max_new)`` requests, run to the end,
    return every session's tokens."""
    for sid, prompt, n in requests:
        engine.submit(request_cls(sid, prompt, max_new_tokens=n))
    engine.run()
    out = {sid: engine.result(sid) for sid, _, _ in requests}
    if close:
        engine.close()
    return out


def _prompts(cfg, n, seed=7, lo=6, hi=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, size=n)]


# ----------------------------------------------------- parity with JAX
def test_mixed_lengths_match_jax(pair):
    cfg = pair[0]
    rng = np.random.default_rng(0)
    reqs = [("a", rng.integers(0, cfg.vocab_size, 20).astype(np.int32), 6),
            ("b", rng.integers(0, cfg.vocab_size, 5).astype(np.int32), 9)]
    want = serve(jax_engine(pair), reqs, JaxRequest)
    got = serve(port_engine(pair), reqs, Request)
    assert got == want
    assert [len(got["a"]), len(got["b"])] == [6, 9]


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_multi_round_restoration_matches_jax(pair, backend):
    """Round 2 after retire and restore (pages scattered under paged)."""
    cfg = pair[0]
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, cfg.vocab_size, 18).astype(np.int32)
    p2 = rng.integers(0, cfg.vocab_size, 7).astype(np.int32)
    results = []
    for make, req in ((jax_engine, JaxRequest), (port_engine, Request)):
        eng = make(pair, backend=backend)
        eng.submit(req("alice", p1, max_new_tokens=5))
        eng.run()
        g1 = eng.result("alice")
        eng.submit(req("alice", p2, max_new_tokens=4))
        eng.run()
        results.append((g1, eng.result("alice"),
                        eng.metrics.restored_tokens))
        eng.close()
    assert results[1] == results[0]
    assert results[1][2] > 0


def test_acceptance_workload_matches_jax_on_both_backends(pair):
    """8 sessions over 2 slots with mid-stream eviction: every session
    retires, pauses and restores; both port backends give the JAX
    engine's tokens, and paged reserves less than contiguous."""
    cfg = pair[0]
    reqs = [(f"s{i}", p, 5) for i, p in enumerate(_prompts(cfg, 8))]
    jeng = jax_engine(pair, max_batch=2, preempt_quantum=3)
    want = serve(jeng, reqs, JaxRequest)
    metrics = {}
    for backend in ("contiguous", "paged"):
        eng = port_engine(pair, max_batch=2, preempt_quantum=3,
                          backend=backend)
        assert serve(eng, reqs, Request) == want, backend
        metrics[backend] = eng.metrics
        assert eng.metrics.preemptions == jeng.metrics.preemptions > 0
        assert eng.metrics.restored_tokens == jeng.metrics.restored_tokens
    assert (metrics["paged"].reserved_tokens_peak
            < metrics["contiguous"].reserved_tokens_peak)
    assert (metrics["paged"].occupancy_mean
            > metrics["contiguous"].occupancy_mean)


# ------------------------------------------------ the port's invariants
class MixedPlanManager(HCacheManager):
    """Half the layers by recompute (a prefix), half by hidden states."""

    def plan(self, n_tokens):
        L = self.cfg.n_layers
        return Schedule(("recompute",) * (L // 2)
                        + ("hidden",) * (L - L // 2), 0.0, 0.0, 0.0, 0.0)


class CheckedEngine(InferenceEngine):
    """Snapshots each session's K/V whenever it is paused or retired, and
    checks every completed restore against the last snapshot, bitwise."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.snapshots, self.checked = {}, []
        save = self.mgr.save_session_pause

        def save_and_snapshot(session, cache, n_tokens, **kw):
            self.snapshots[session] = (cache["k"][:, 0, :n_tokens].clone(),
                                       cache["v"][:, 0, :n_tokens].clone())
            return save(session, cache, n_tokens, **kw)

        self.mgr.save_session_pause = save_and_snapshot

    def _restore_step(self):
        restoring = [s for s in self.slots
                     if s is not None and s.phase == Phase.RESTORING]
        super()._restore_step()
        for s in restoring:
            if s.phase != Phase.PREFILL:
                continue
            sid = s.request.session_id
            k, v = s.view.gather_hist(s.history_len)
            sk, sv = self.snapshots[sid]
            assert torch.equal(k[:, 0], sk) and torch.equal(v[:, 0], sv), sid
            self.checked.append(
                (sid, tuple(self.mgr.store.get_manifest(sid)["methods"])))


@pytest.fixture(scope="module")
def checked_runs(pair):
    """Both backends through pauses and restores of a mixed recompute /
    hidden plan, decoding 3 slots wide."""
    cfg, _, _, tm, tparams = pair
    reqs = [(f"u{i}", p, 6) for i, p in enumerate(_prompts(cfg, 5, seed=3))]
    runs = {}
    for backend in ("contiguous", "paged"):
        mgr = MixedPlanManager(
            tm, ChunkStore(make_array("dram", 4), chunk_tokens=16),
            hw=PAPER_A100)
        eng = CheckedEngine(tm, tparams, mgr, max_batch=3, max_seq=128,
                            prefill_chunk=8, preempt_quantum=2,
                            backend=backend)
        tokens = serve(eng, reqs, Request, close=False)
        # a second round over the restored histories
        more = [(sid, p[:4], 3) for sid, p, _ in reqs]
        tokens2 = serve(eng, more, Request)
        runs[backend] = (tokens, tokens2, eng)
    return runs


def test_paged_equals_contiguous_bitwise(checked_runs):
    """Same tokens, and the same K/V bits at every pause and retire."""
    c, p = checked_runs["contiguous"], checked_runs["paged"]
    assert p[0] == c[0] and p[1] == c[1]
    ce, pe = c[2], p[2]
    assert ce.snapshots.keys() == pe.snapshots.keys()
    for sid, (k, v) in ce.snapshots.items():
        assert torch.equal(k, pe.snapshots[sid][0])
        assert torch.equal(v, pe.snapshots[sid][1])


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_restores_rebuild_the_snapshot_bitwise(checked_runs, backend):
    """Every restore, of recompute and hidden layers alike, equals the
    K/V the session held when it was dumped, although its decode steps
    ran 3 rows wide and the recompute layers were rebuilt by replay."""
    eng = checked_runs[backend][2]
    assert eng.metrics.preemptions > 0
    assert len(eng.checked) >= 5
    assert all("recompute" in m and "hidden" in m for _, m in eng.checked)
    segs = [seg for sid in eng.snapshots
            for seg in eng.mgr.store.get_manifest(sid)["segments"]
            if seg[2] == "decode"]
    assert segs and all(seg[3] == 3 for seg in segs)


def test_engine_refuses_unported_parts(pair):
    """Tensor parallelism is ported: ``tp=2`` on a CPU model gives two
    CPU shards and, on the paged backend, the sharded pool, with prefix
    sharing too. Still refused: a width that does not divide the KV
    heads."""
    _, _, _, tm, tparams = pair
    for kw in (dict(tp=2), dict(tp=2, prefix_sharing=True)):
        mgr = HCacheManager(tm, ChunkStore(make_array("dram", 1)))
        eng = InferenceEngine(tm, tparams, mgr, backend="paged", **kw)
        assert eng.tp.spmd and eng.tp.devices == [torch.device("cpu")] * 2
        assert eng.kv.name == "paged-tp"
        assert mgr.hw.mesh_devices == 2
        eng.close()
    mgr = HCacheManager(tm, ChunkStore(make_array("dram", 1)))
    with pytest.raises(ValueError, match="n_kv_heads"):
        InferenceEngine(tm, tparams, mgr, tp=3)
    mgr.close()
