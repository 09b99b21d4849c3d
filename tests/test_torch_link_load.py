"""Per-link restore load on a multi-host (sharded) chunk store, held
against the JAX package: the manager's ``link_load`` (``set_link_load``,
part of the plan key), the planners under it (``plan``,
``resolve_group_size`` under "auto" and "fetch"), the executor's priced
task times and makespan, ``restore_makespan``, and the engine folding its
restoring executors' ``links_touched`` into a ``LinkLoad``.

The load moves plans, never bits: restored K/V and the engine's tokens on
2- and 4-shard layer-striped stores equal a one-host run's. Planning is
held to the reference exactly (the same floats); nothing here reads a
wall time."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.config.hardware import PAPER_A100 as JAX_A100
from repro.config.hardware import PAPER_H800 as JAX_H800
from repro.configs import get_arch as jax_get_arch
from repro.core import restoration as jrest
from repro.core.capacity import restore_makespan as jax_restore_makespan
from repro.core.cost_model import LinkLoad as JaxLinkLoad
from repro.core.hcache import HCacheManager as JaxManager
from repro.core.profiler import MeasuredProfile as JaxProfile
from repro.core.scheduler import Schedule as JaxSchedule
from repro.models import Model as JaxModel
from repro.models.module import split
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.storage import AsyncIOEngine as JaxAsyncIO
from repro.storage import ChunkStore as JaxStore
from repro.storage import make_shards as jax_make_shards
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.config.hardware import PAPER_A100, PAPER_H800
from repro_torch.configs import get_arch
from repro_torch.core import restoration as trest
from repro_torch.core.capacity import restore_makespan
from repro_torch.core.cost_model import LinkLoad
from repro_torch.core.hcache import HCacheManager
from repro_torch.core.profiler import MeasuredProfile
from repro_torch.core.scheduler import Schedule
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import InferenceEngine, Request
from repro_torch.storage import AsyncIOEngine, ChunkStore, make_array
from repro_torch.storage import make_shards

# a load that congests link 0, and an empty one (no restore in flight)
LOADS = {"congested": {0: 3}, "empty": {}}


def stores(n_shards, placement="layer"):
    """(port, reference) stores of ``n_shards`` hosts, 2 SSDs each."""
    return (ChunkStore(shards=make_shards(n_shards, 2, "ssd"),
                       chunk_tokens=16, placement=placement),
            JaxStore(shards=jax_make_shards(n_shards, 2, "ssd"),
                     chunk_tokens=16, placement=placement))


def seeded_profiles():
    """The same seeded samples in a port and a reference profile, some on
    per-link cells."""
    rng = np.random.default_rng(9)
    port, ref = MeasuredProfile(), JaxProfile()
    for _ in range(30):
        kind = ("io_h", "io_kv", "project", "recompute")[rng.integers(4)]
        bucket = int(2 ** rng.integers(6, 12))
        work = float(bucket * rng.uniform(1e6, 3e6))
        secs = float(rng.uniform(1e-5, 5e-5) + work * 3e-13)
        link = int(rng.integers(2)) if kind.startswith("io") \
            and rng.random() < 0.5 else None
        port.record(kind, bucket, work, secs, link=link)
        ref.record(kind, bucket, work, secs, link=link)
    return port, ref


def values(x):
    """A dataclass's field values (the two packages' classes differ)."""
    return tuple(vars(x).values())


def schedule_fields(s):
    return (tuple(s.methods), s.makespan, s.io_time, s.compute_time,
            s.bubble)


# ------------------------------------------------ planning at full size
@pytest.fixture(scope="module")
def planners(rules):
    """Full-size llama2-7b and qwen2-7b models (no weights: planning reads
    the config only)."""
    out = {}
    for name in ("llama2-7b", "qwen2-7b"):
        out[name] = (Model(get_arch(name), device="cpu"),
                     JaxModel(jax_get_arch(name), rules=rules,
                              dtype=jnp.bfloat16, remat="none"))
    return out


def managers(planners, name, n_shards, load, *, group=8, profiled=False,
             io_streams=1):
    tm, jm = planners[name]
    tstore, jstore = stores(n_shards)
    tp, jp = seeded_profiles() if profiled else (None, None)
    tmgr = HCacheManager(tm, tstore, hw=PAPER_H800,
                         restore_group_size=group, profile=tp)
    jmgr = JaxManager(jm, jstore, hw=JAX_H800, restore_group_size=group,
                      profile=jp)
    for mgr, cls in ((tmgr, LinkLoad), (jmgr, JaxLinkLoad)):
        mgr.set_io_streams(io_streams)
        if load is not None:
            mgr.set_link_load(cls(LOADS[load]))
    return tmgr, jmgr


@pytest.mark.parametrize("profiled", [False, True])
@pytest.mark.parametrize("load", sorted(LOADS))
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("name", ["llama2-7b", "qwen2-7b"])
def test_planners_match_reference_under_a_link_load(planners, name,
                                                    n_shards, load,
                                                    profiled):
    """``plan``, ``resolve_group_size`` ("auto" and "fetch") and
    ``restore_makespan`` equal the reference's under the same load."""
    for n_tokens in (1024, 2000, 6000):
        plans = {}
        for group in (8, "auto", "fetch"):
            tmgr, jmgr = managers(planners, name, n_shards, load,
                                  group=group, profiled=profiled,
                                  io_streams=2)
            tplan, jplan = tmgr.plan(n_tokens), jmgr.plan(n_tokens)
            assert isinstance(tplan, Schedule)
            assert isinstance(jplan, JaxSchedule)
            assert schedule_fields(tplan) == schedule_fields(jplan)
            methods = tplan.methods
            for mix in (methods, ("hidden",) * len(methods)):
                got = tmgr.resolve_group_size(n_tokens, mix)
                assert got == jmgr.resolve_group_size(n_tokens, mix)
                plans[group, mix == methods] = got
                assert restore_makespan(tmgr, n_tokens, mix) == \
                    jax_restore_makespan(jmgr, n_tokens, mix)
            tmgr.close()
            jmgr.saver.close()
        assert plans[8, True] == 8


def test_a_congested_link_moves_the_plans(planners):
    """The load reaches the planners: the same restore is priced higher,
    and plans differ, when link 0 carries 8 other restores."""
    hot, _ = managers(planners, "llama2-7b", 2, None)
    cold, _ = managers(planners, "llama2-7b", 2, None)
    hot.set_link_load(LinkLoad({0: 8}))
    cold.set_link_load(LinkLoad({}))
    n = 4096
    methods = ("hidden",) * 32
    assert restore_makespan(hot, n, methods) > \
        restore_makespan(cold, n, methods)
    assert hot.plan(n).makespan > cold.plan(n).makespan
    io_hot = sum(m != "recompute" for m in hot.plan(n).methods)
    assert io_hot <= sum(m != "recompute" for m in cold.plan(n).methods)


def test_price_key_changes_with_the_load(planners):
    mgr, _ = managers(planners, "qwen2-7b", 4, None, group="auto")
    methods = ("hidden",) * 28
    assert mgr.link_load is None
    keys = [mgr._price_key()]
    mgr.resolve_group_size(1024, methods)
    for streams in ({0: 2}, {0: 2, 3: 1}, {}):
        mgr.set_link_load(LinkLoad(streams))
        keys.append(mgr._price_key())
        mgr.resolve_group_size(1024, methods)
    assert len(set(keys)) == 4
    assert len(mgr._group_plans) == 4
    mgr.set_link_load(LinkLoad({0: 2}))        # a recurring fleet state
    assert mgr._price_key() == keys[1]
    mgr.resolve_group_size(1024, methods)
    assert len(mgr._group_plans) == 4
    mgr.close()


# ----------------------------------------------- executors at smoke size
S = 40


@pytest.fixture(scope="module")
def pair(rules):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = jax_reduced(jax_get_arch("llama2-7b"))
    jm = JaxModel(cfg, rules=rules, dtype=jnp.float32, remat="none")
    jparams, _ = split(jm.init(jax.random.PRNGKey(0)))
    tcfg = reduced_for_smoke(get_arch("llama2-7b"))
    tm = Model(tcfg, device="cpu")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, S),
                                             dtype=np.int32)
    jout = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                      capture_hidden=True)
    tout = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                      capture_hidden=True)
    yield cfg, jm, jparams, tm, tparams, toks, jout, tout
    torch.set_num_threads(n)


@pytest.mark.parametrize("group", [8, "auto", "fetch"])
@pytest.mark.parametrize("load", sorted(LOADS))
@pytest.mark.parametrize("n_shards", [2, 4])
def test_executor_prices_its_graph_as_the_reference(pair, n_shards, load,
                                                    group):
    """The executor's group plan, task times, links and predicted
    makespan equal the reference executor's under the same load, and so
    does ``restore_makespan``; the restored K/V is the prefill's bits and
    the one-host store's."""
    cfg, jm, jparams, tm, tparams, toks, jout, tout = pair
    tstore, jstore = stores(n_shards)
    tmgr = HCacheManager(tm, tstore, hw=PAPER_A100,
                         schedule_override="hidden",
                         restore_group_size=group)
    jmgr = JaxManager(jm, jstore, hw=JAX_A100, schedule_override="hidden",
                      store_dtype=np.float32, restore_group_size=group)
    tmgr.set_link_load(LinkLoad(LOADS[load]))
    jmgr.set_link_load(JaxLinkLoad(LOADS[load]))
    one_host = HCacheManager(tm, ChunkStore(make_array("ssd", 4),
                                            chunk_tokens=16),
                             schedule_override="hidden")
    try:
        tmgr.save_prefill("s", toks[0], tout)
        jmgr.save_prefill("s", toks[0], jout)
        one_host.save_prefill("s", toks[0], tout)
        tex = tmgr.begin_restore(tparams, "s",
                                 sink=trest.CacheAssembler(tm))
        jex = jmgr.begin_restore(jparams, "s",
                                 sink=jrest.CacheAssembler(jm))
        assert tex.group_size == jex.group_size
        assert [values(t) for t in tex.times] == \
            [values(t) for t in jex.times]
        assert tex._task_links == jex._task_links
        assert tex.predicted_makespan == jex.predicted_makespan
        assert tex.links_touched() == jex.links_touched() == \
            tuple(range(n_shards))
        assert restore_makespan(tmgr, S, tex.methods) == \
            jax_restore_makespan(jmgr, S, jex.methods) == \
            tex.predicted_makespan
        tex.run()
        jex.run()
        assert values(tex.timeline()) == values(jex.timeline())
        base = one_host.restore(tparams, "s")
        for i, name in enumerate(("k", "v")):
            assert torch.equal(tex.sink.cache[name], tout["kv"][i])
            assert torch.equal(tex.sink.cache[name], base.cache[name])
    finally:
        for mgr in (tmgr, one_host):
            mgr.close()
            mgr.store.close()
        jmgr.saver.close()
        jstore.close()


def test_links_touched_follow_the_methods(pair):
    """A layer-striped restore touches the links of its IO layers only; a
    chunk-striped one touches every link; a one-host store has link 0."""
    _, _, _, tm, tparams, toks, _, tout = pair
    cases = [(4, "layer", "hidden", (0, 1, 2, 3)),
             (4, "layer", "recompute", ()),
             (4, "chunk", "hidden", (0, 1, 2, 3)),
             (1, "layer", "hidden", (0,))]
    for n_shards, placement, override, want in cases:
        store = stores(n_shards, placement)[0]
        mgr = HCacheManager(tm, store, schedule_override=override)
        try:
            mgr.save_prefill("s", toks[0], tout)
            ex = mgr.begin_restore(tparams, "s")
            assert ex.links_touched() == want
        finally:
            mgr.close()
            store.close()


# ------------------------------------------------------------------ engine
class PlannedBySession:
    """A manager mixin whose plan depends on the session, so that
    concurrent restores touch different NIC links: sessions u0 and u2
    recompute layers 0-2 and read layer 3 only, the others read every
    layer. It records every load the engine reports."""

    def save_prefill(self, session, *args, **kw):
        self._session = session
        return super().save_prefill(session, *args, **kw)

    def plan(self, n_tokens):
        L = self.cfg.n_layers
        re = L - 1 if getattr(self, "_session", None) in ("u0", "u2") else 0
        methods = ("recompute",) * re + ("hidden",) * (L - re)
        return self._schedule_cls(methods, 0.0, 0.0, 0.0, 0.0)

    def set_link_load(self, load):
        self.loads.append(load.key())
        super().set_link_load(load)


class PortPlanned(PlannedBySession, HCacheManager):
    _schedule_cls = Schedule
    loads = None


class JaxPlanned(PlannedBySession, JaxManager):
    _schedule_cls = JaxSchedule
    loads = None


def engine_rounds(cfg):
    rng = np.random.default_rng(11)
    first = [(f"u{i}", rng.integers(0, cfg.vocab_size, n).astype(np.int32),
              5) for i, n in enumerate((30, 12, 34, 14))]
    second = [(sid, rng.integers(0, cfg.vocab_size, 4).astype(np.int32), 3)
              for sid, _, _ in first]
    return [first, second]


def run_engine(engine, rounds, request_cls):
    out = []
    for reqs in rounds:
        for sid, prompt, n in reqs:
            engine.submit(request_cls(sid, prompt, max_new_tokens=n))
        engine.run()
        out.append({sid: engine.result(sid) for sid, _, _ in reqs})
    return out


# two restore tasks per engine step: a restore spans steps, so two
# sessions restore at once
ENGINE_KW = dict(max_batch=2, max_seq=96, prefill_chunk=8,
                 preempt_quantum=2, restore_tasks_per_step=2)


@pytest.mark.parametrize("n_shards,async_io", [(2, False), (4, True)])
def test_engine_sets_the_reference_link_load(pair, n_shards, async_io):
    """4 sessions over 2 slots, restored concurrently on a layer-striped
    store: the engine reports the reference engine's per-link loads step
    for step (restores reading layer 3 only share one link with those
    reading every layer), plans are keyed by the load, and tokens and
    restored K/V equal a one-host run's."""
    cfg, jm, jparams, tm, tparams = pair[:5]
    rounds = engine_rounds(cfg)
    tstore, jstore = stores(n_shards)
    if async_io:
        tstore.attach_io_engine(AsyncIOEngine(n_shards))
        jstore.attach_io_engine(JaxAsyncIO(n_shards))
    tmgr = PortPlanned(tm, tstore, hw=PAPER_A100)
    jmgr = JaxPlanned(jm, jstore, hw=JAX_A100, store_dtype=np.float32)
    tmgr.loads, jmgr.loads = [], []
    base_mgr = PortPlanned(tm, ChunkStore(make_array("ssd", 4),
                                          chunk_tokens=16), hw=PAPER_A100)
    base_mgr.loads = []
    teng = InferenceEngine(tm, tparams, tmgr, **ENGINE_KW)
    jeng = JaxEngine(jm, jparams, jmgr, **ENGINE_KW)
    beng = InferenceEngine(tm, tparams, base_mgr, **ENGINE_KW)
    try:
        got = run_engine(teng, rounds, Request)
        run_engine(jeng, rounds, JaxRequest)
        assert run_engine(beng, rounds, Request) == got
        assert teng.metrics.preemptions == jeng.metrics.preemptions > 0
        assert tmgr.loads == jmgr.loads, (tmgr.loads, jmgr.loads)
        assert base_mgr.loads == [] and base_mgr.link_load is None
        # some step charged link 3 (shared by every restore) more than
        # the links that only the full restores read
        assert any(len(set(dict(k).values())) > 1 for k in tmgr.loads)
        # a restore being placed counts on every link
        for eng in (teng, jeng):
            eng._update_io_streams(extra=1)
        assert tmgr.link_load.key() == jmgr.link_load.key() == \
            tuple((link, 1) for link in range(n_shards))
        # the restored K/V equals the one-host store's, bitwise
        for sid, _, _ in rounds[0]:
            a = tmgr.restore(tparams, sid)
            b = base_mgr.restore(tparams, sid)
            for name in ("k", "v"):
                assert torch.equal(a.cache[name], b.cache[name]), sid
    finally:
        for eng in (teng, jeng, beng):
            eng.close()
        tstore.close()
        jstore.close()
