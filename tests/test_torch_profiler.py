"""The port's measured profile and the restoration planning built on it,
held against the JAX package on the same seeded inputs: ``MeasuredProfile``
(fits, rates, predictions, epochs, JSON both ways), the group planners
``fetch_aligned_partition`` and ``choose_group_size``, the manager's plan
cache keyed on the profile's epoch, the profiled executor's IO samples on
a simulated-SSD store, group plans that restore the same bits on both
cache backends, ``restore_makespan`` under the resolved plan, the staging
path's host pieces, and the engine's calibration gauges.

Everything is seeded with numpy; no assertion reads a wall time (compute
samples are checked for presence only)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.config.hardware import PAPER_H800 as JAX_H800
from repro.configs import get_arch as jax_get_arch
from repro.core import restoration as jrest
from repro.core.hcache import HCacheManager as JaxManager
from repro.core.profiler import MeasuredProfile as JaxProfile
from repro.models import Model as JaxModel
from repro.models.module import split
from repro.storage import ChunkStore as JaxStore
from repro.storage import make_array as jax_make_array
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.config.hardware import PAPER_A100, PAPER_H800
from repro_torch.configs import get_arch
from repro_torch.core import restoration as trest
from repro_torch.core.capacity import restore_makespan
from repro_torch.core.hcache import HCacheManager
from repro_torch.core.profiler import MeasuredProfile
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import InferenceEngine, Request
from repro_torch.serving.kv_cache import (ContiguousBackend, PagedBackend,
                                          ViewSink)
from repro_torch.storage import ChunkStore, make_array

KINDS = ("io_h", "io_kv", "project", "recompute")


def seeded_records(seed: int, n: int = 60):
    """A numpy-seeded sequence of ``record`` calls: kinds, buckets, work
    on a noisy line, per-link and per-mesh cells."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind = KINDS[rng.integers(len(KINDS))]
        bucket = int(2 ** rng.integers(4, 12))
        work = float(bucket * rng.uniform(1e5, 2e5))
        seconds = float(rng.uniform(1e-5, 1e-4) + work * rng.uniform(
            1e-12, 3e-12))
        link = int(rng.integers(3)) if rng.random() < 0.3 else None
        mesh = int(rng.choice([2, 4])) if (kind == "project"
                                           and rng.random() < 0.2) else None
        if rng.random() < 0.05:
            seconds = 0.0                     # dropped: an untimed backend
        out.append((kind, bucket, work, seconds, link, mesh))
    return out


def fill(profile, records):
    for kind, bucket, work, seconds, link, mesh in records:
        profile.record(kind, bucket, work, seconds, link=link, mesh=mesh)
    return profile


def assert_profiles_agree(a, b):
    assert a.epoch == b.epoch
    assert a.sample_counts() == b.sample_counts()
    assert sorted(a.kinds) == sorted(b.kinds)
    for kind in a.kinds:
        for bucket, cell in a.kinds[kind].items():
            other = b.kinds[kind][bucket]
            assert (cell.work, cell.seconds, cell.n) == pytest.approx(
                (other.work, other.seconds, other.n), rel=1e-12, abs=0)
    for kind in KINDS:
        for link in (None, 0, 1, 2):
            for mesh in (None, 2, 4):
                ra = a.rate(kind, link=link, mesh=mesh)
                rb = b.rate(kind, link=link, mesh=mesh)
                assert (ra is None) == (rb is None)
                if ra is not None:
                    assert ra == pytest.approx(rb, rel=1e-12, abs=0)
        for fn in ("overhead",):
            x, y = getattr(a, fn)(kind), getattr(b, fn)(kind)
            assert (x is None) == (y is None)
            if x is not None:
                assert x == pytest.approx(y, rel=1e-12, abs=1e-18)
        for work in (1e6, 3e8):
            x, y = a.predict(kind, work), b.predict(kind, work)
            assert (x is None) == (y is None)
            if x is not None:
                assert x == pytest.approx(y, rel=1e-12, abs=0)
    for mesh in (None, 2, 4):
        x, y = a.dispatch_overhead(mesh=mesh), b.dispatch_overhead(mesh=mesh)
        assert (x is None) == (y is None)
        if x is not None:
            assert x == pytest.approx(y, rel=1e-12, abs=1e-18)


# ------------------------------------------------------------ the profile
@pytest.mark.parametrize("seed", range(6))
def test_measured_profile_matches_reference(seed):
    records = seeded_records(seed)
    port, ref = MeasuredProfile(), JaxProfile()
    epochs = []
    for rec in records:
        fill(port, [rec])
        fill(ref, [rec])
        epochs.append((port.epoch, ref.epoch))
    assert all(a == b for a, b in epochs)       # the same bumps, in step
    assert epochs[-1][0] > 0
    assert_profiles_agree(port, ref)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_profile_json_loads_in_the_other_package(writer, tmp_path):
    records = seeded_records(11)
    path = str(tmp_path / "profile.json")
    if writer == "port":
        fill(MeasuredProfile(), records).save(path)
        got, want = JaxProfile.load(path), MeasuredProfile.load(path)
    else:
        fill(JaxProfile(), records).save(path)
        got, want = MeasuredProfile.load(path), JaxProfile.load(path)
    assert_profiles_agree(got, want)
    # and both equal the profile that was written
    assert_profiles_agree(got, fill(MeasuredProfile(), records))


def test_profile_drift_bumps_the_epoch_and_convergence_does_not():
    p = MeasuredProfile()
    p.record("project", 1024, 1e9, 1e-3)
    e = p.epoch
    for _ in range(5):
        p.record("project", 1024, 1e9, 1e-3)     # the same machine
    assert p.epoch == e
    p.record("project", 1024, 1e9, 3e-3)         # 3x slower: drift
    assert p.epoch > e


# ------------------------------------------------------------ group plans
N_LAYERS = 32
MIXES = {"all-hidden": ("hidden",) * N_LAYERS,
         "7re+25h": ("recompute",) * 7 + ("hidden",) * 25,
         "kv-mixed": ("recompute",) * 3 + ("hidden", "kv") * 14
         + ("hidden",)}


def profiles(kind):
    """(port, reference) profiles: none, or the same seeded samples."""
    if kind == "none":
        return None, None
    rng = np.random.default_rng(5)
    port, ref = MeasuredProfile(), JaxProfile()
    for _ in range(24):
        kind_ = ("io_h", "io_kv", "project", "recompute")[rng.integers(4)]
        bucket = int(2 ** rng.integers(6, 12))
        work = float(bucket * rng.uniform(1e6, 3e6))
        secs = float(rng.uniform(1e-5, 5e-5) + work * 3e-13)
        port.record(kind_, bucket, work, secs)
        ref.record(kind_, bucket, work, secs)
    return port, ref


@pytest.mark.parametrize("io_streams", [1, 3])
@pytest.mark.parametrize("prof", ["none", "seeded"])
@pytest.mark.parametrize("n_tokens", [64, 1024, 2000])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_group_planners_match_reference(mix, n_tokens, prof, io_streams):
    from repro.core import cost_model as jcost
    from repro_torch.core import cost_model as tcost
    methods = MIXES[mix]
    p_port, p_ref = profiles(prof)
    tcfg, jcfg = get_arch("llama2-7b"), jax_get_arch("llama2-7b")
    assert tcfg.n_layers == N_LAYERS
    got = trest.choose_group_size(tcfg, PAPER_H800, n_tokens, methods,
                                  profile=p_port, io_streams=io_streams,
                                  fetch_aligned=True)
    want = jrest.choose_group_size(jcfg, JAX_H800, n_tokens, methods,
                                   profile=p_ref, io_streams=io_streams,
                                   fetch_aligned=True)
    assert got == want
    uniform = trest.choose_group_size(tcfg, PAPER_H800, n_tokens, methods,
                                      profile=p_port, io_streams=io_streams)
    assert uniform == jrest.choose_group_size(
        jcfg, JAX_H800, n_tokens, methods, profile=p_ref,
        io_streams=io_streams)
    t_times = [tcost.method_times(c, PAPER_H800, profile=p_port,
                                  io_streams=io_streams)
               for c in tcost.layer_costs(tcfg, n_tokens)]
    j_times = [jcost.method_times(c, JAX_H800, profile=p_ref,
                                  io_streams=io_streams)
               for c in jcost.layer_costs(jcfg, n_tokens)]
    part = trest.fetch_aligned_partition(methods, t_times,
                                         dispatch_overhead=1e-5)
    assert part == jrest.fetch_aligned_partition(methods, j_times,
                                                 dispatch_overhead=1e-5)
    assert sum(part) == sum(m == "hidden" for m in methods)


# ------------------------------------------------------ smoke-size models
S = 40


@pytest.fixture(scope="module")
def pair(rules):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = jax_reduced(jax_get_arch("llama2-7b"))
    jm = JaxModel(cfg, rules=rules, dtype=jnp.float32, remat="none")
    jparams, _ = split(jm.init(jax.random.PRNGKey(0)))
    tm = Model(reduced_for_smoke(get_arch("llama2-7b")), device="cpu")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tm.cfg,
                              device="cpu")
    yield cfg, jm, jparams, tm, tparams
    torch.set_num_threads(n)


def port_manager(model, *, plan=8, profile=None, override="hidden",
                 device="ssd", hw=PAPER_H800):
    return HCacheManager(model, ChunkStore(make_array(device, 4),
                                           chunk_tokens=16),
                         hw=hw, schedule_override=override,
                         restore_group_size=plan, profile=profile)


def tokens(cfg, n=S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n),
                                                dtype=np.int32)


def port_prefill(pair, toks):
    _, _, _, tm, tparams = pair
    return tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                      capture_hidden=True)


@pytest.mark.parametrize("override,plan", [("hidden", 2), ("hidden", 8),
                                           ("kv", 1)])
def test_profiled_executor_records_reference_io_samples(pair, override,
                                                        plan):
    """Two restores of one session on a simulated-SSD array: the IO
    samples (and the observed IO durations) are the reference's exactly;
    the projection has compute samples (its first launch skipped)."""
    cfg, jm, jparams, tm, tparams = pair
    toks = tokens(cfg)
    jprof, tprof = JaxProfile(), MeasuredProfile()
    jmgr = JaxManager(jm, JaxStore(jax_make_array("ssd", 4),
                                   chunk_tokens=16),
                      hw=JAX_H800, schedule_override=override,
                      store_dtype=np.float32, restore_group_size=plan,
                      profile=jprof)
    jmgr.save_prefill("s", toks[0], jm.prefill(
        jparams, {"tokens": jnp.asarray(toks)}, capture_hidden=True))
    mgr = port_manager(tm, plan=plan, profile=tprof, override=override)
    mgr.save_prefill("s", toks[0], port_prefill(pair, toks))
    try:
        for _ in range(2):
            jex = jmgr.begin_restore(jparams, "s",
                                     sink=jrest.CacheAssembler(jm))
            jex.run()
            tex = mgr.begin_restore(tparams, "s",
                                    sink=trest.CacheAssembler(tm))
            tex.run()
            io = {i for i, t in enumerate(tex.tasks) if t.stream == "io"}
            assert {i: d for i, d in tex.observed.items() if i in io} == \
                {i: d for i, d in jex.observed.items() if i in io}
    finally:
        mgr.close()
        jmgr.saver.close()
    io_kind = "io_h" if override == "hidden" else "io_kv"
    assert tprof.samples(io_kind) > 0
    for kind in ("io_h", "io_kv"):
        assert tprof.sample_counts().get(kind) == \
            jprof.sample_counts().get(kind)
        for bucket, cell in jprof.kinds.get(kind, {}).items():
            got = tprof.kinds[kind][bucket]
            assert (got.work, got.seconds, got.n) == \
                (cell.work, cell.seconds, cell.n)
    if override == "hidden":
        assert tprof.samples("project") > 0
        assert tex.project_wall > 0
    assert set(tex.host_split) == set(trest.HOST_SPLIT)


@pytest.mark.parametrize("with_profile", [False, True])
@pytest.mark.parametrize("plan", [1, (1, 2, 1), "auto", "fetch"])
def test_group_plans_restore_the_same_bits_on_both_backends(pair, plan,
                                                            with_profile):
    """Tuple, auto and fetch plans land the prefill's K/V bitwise on the
    contiguous slot and the paged pool, with and without a profile."""
    cfg, _, _, tm, tparams = pair
    toks = tokens(cfg, seed=4)
    out = port_prefill(pair, toks)
    profile = MeasuredProfile() if with_profile else None
    mgr = port_manager(tm, plan=plan, profile=profile)
    mgr.save_prefill("s", toks[0], out)
    try:
        for backend in (ContiguousBackend(tm, 2, 64),
                        PagedBackend(tm, 2, 64, block_size=8)):
            for _ in range(2):                  # the second one calibrated
                assert backend.reserve(1, S)
                view = backend.view(1)
                ex = mgr.begin_restore(tparams, "s", sink=ViewSink(view))
                ex.run()
                k, v = view.gather_hist(S)
                assert torch.equal(k, out["kv"][0]), backend.name
                assert torch.equal(v, out["kv"][1]), backend.name
                view.free()
    finally:
        mgr.close()
    if with_profile:
        assert profile.samples("io_h") > 0 and profile.samples("project") > 0


def test_plan_cache_is_rekeyed_on_an_epoch_bump(pair):
    cfg, _, _, tm, _ = pair
    profile = MeasuredProfile()
    mgr = port_manager(tm, plan="auto", profile=profile)
    try:
        methods = ("hidden",) * cfg.n_layers
        first = mgr.resolve_group_size(S, methods)
        assert mgr.resolve_group_size(S + 3, methods) is first  # one bucket
        assert len(mgr._group_plans) == 1
        profile.record("project", 64, 1e6, 1e-3)           # epoch bump
        mgr.resolve_group_size(S, methods)
        assert len(mgr._group_plans) == 2
        epoch = profile.epoch
        profile.record("project", 64, 1e6, 1e-3)           # converged
        assert profile.epoch == epoch
        mgr.resolve_group_size(S, methods)
        assert len(mgr._group_plans) == 2
        mgr.set_io_streams(3)                              # multiplicity
        mgr.resolve_group_size(S, methods)
        assert len(mgr._group_plans) == 3
        mgr.set_profile(MeasuredProfile())                 # a new profile
        assert not mgr._group_plans and not mgr._plans
    finally:
        mgr.close()


@pytest.mark.parametrize("plan", [8, (1, 2, 1), "auto", "fetch"])
def test_restore_makespan_prices_the_executors_graph(pair, plan):
    cfg, _, _, tm, tparams = pair
    toks = tokens(cfg, seed=6)
    profile = MeasuredProfile()
    profile.record("io_h", 64, 1e6, 2e-4)
    profile.record("project", 64, 1e8, 1e-4)
    mgr = port_manager(tm, plan=plan, profile=profile, hw=PAPER_A100)
    mgr.save_prefill("s", toks[0], port_prefill(pair, toks))
    try:
        ex = mgr.begin_restore(tparams, "s")
        assert restore_makespan(mgr, S, ex.methods) == ex.predicted_makespan
        assert ex.predicted_makespan > 0
    finally:
        mgr.close()


# ----------------------------------------------------- staging, host side
@pytest.mark.parametrize("start,n", [(0, 40), (0, 16), (5, 40), (17, 33),
                                     (16, 48)])
def test_layer_read_copies_into_a_buffer_as_wait_assembles(start, n):
    store = ChunkStore(make_array("ssd", 4), chunk_tokens=16)
    data = np.random.default_rng(2).standard_normal((n, 6)).astype(
        np.float32)
    store.append_tokens("s", "h", 0, 0, data)
    store.flush("s")
    read = store.submit_layer_read("s", "h", 0, n, start_token=start)
    want = read.wait().data
    out = np.full((n - start, 6), np.nan, np.float32)
    read.copy_into(out)
    assert np.array_equal(out, want) and read.row_shape == (6,)
    shared = np.full_like(out, np.nan)
    for first in range(3):                    # three jobs share the read
        read.copy_into(shared, first, 3)
    assert np.array_equal(shared, want)
    assert read.dtype == np.float32


def test_staging_ring_hands_out_slots_in_turn_and_uploads_copies():
    ring = trest.StagingRing("cpu")
    seen, words = [], np.arange(12, dtype=np.int16).reshape(3, 4)
    for _ in range(trest.STAGING_SLOTS + 1):
        slot, buf = ring.stage((3, 4), np.int16)
        np.copyto(buf, words)
        seen.append(slot)
        x = ring.upload(slot, buf, torch.bfloat16)
        buf[...] = 0                      # the upload does not alias it
        assert x.dtype == torch.bfloat16
        assert torch.equal(x.view(torch.int16), torch.from_numpy(words))
    assert seen == list(range(trest.STAGING_SLOTS)) + [0]
    slot, big = ring.stage((64, 64), np.float32)       # a slot grows
    assert big.shape == (64, 64) and slot == 1
    slot, small = ring.stage((5, 4), np.int16)     # a slot that does not
    assert slot == 2 and small.shape == (5, 4)     # fit grows to the ring's
    assert ring._bufs[2].numel() == 64 * 64 * 4    # largest slot


def test_staging_fill_threads_write_their_own_rows_under_stress():
    """Many small fills on the worker threads, with the interpreter
    switching threads as often as it can: every row holds its own job's
    data (a lost or misplaced copy would show)."""
    import sys
    ring = trest.StagingRing("cpu")
    rng = np.random.default_rng(3)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            rows = int(rng.integers(2, 3 * trest.FILL_THREADS))
            data = rng.integers(-2 ** 15, 2 ** 15, (rows, 7, 5)).astype(
                np.int16)
            slot, buf = ring.stage(data.shape, np.int16)
            ring.fill([lambda g=g: np.copyto(buf[g], data[g])
                       for g in range(rows)])
            assert np.array_equal(buf, data)
    finally:
        sys.setswitchinterval(interval)
        ring.close()
    assert ring._pool is None


# ------------------------------------------------------------- the engine
def test_engine_calibration_gauges_are_filled(pair):
    """A calibrated engine (a MeasuredProfile, ``auto`` group plans)
    gives the uncalibrated engine's tokens and fills its gauges. Both
    finish every restore in the step it starts, so that the plan cannot
    move a pause to another step (and a token from a decode step to a
    resume prefill)."""
    cfg, _, _, tm, tparams = pair
    rng = np.random.default_rng(9)
    rounds = [[(f"s{i}", rng.integers(0, cfg.vocab_size, int(n)).astype(
        np.int32), 4) for i, n in enumerate(rng.integers(18, 30, 3))]
        for _ in range(2)]
    results = []
    for profile, plan in ((None, 8), (MeasuredProfile(), "auto")):
        mgr = port_manager(tm, plan=plan, profile=profile)
        eng = InferenceEngine(tm, tparams, mgr, max_batch=2, max_seq=128,
                              prefill_chunk=8, restore_tasks_per_step=10_000)
        try:
            for reqs in rounds:
                for sid, prompt, n in reqs:
                    eng.submit(Request(sid, prompt, max_new_tokens=n))
                eng.run()
            toks = {sid: eng.result(sid) for sid, _, _ in rounds[0]}
        finally:
            eng.close()
        results.append((toks, eng.metrics, profile))
    (plain, m0, _), (calibrated, m, profile) = results
    assert calibrated == plain
    assert m0.profiler_samples == {} and m0.restore_bubble_n == 0
    assert m.profiler_samples == profile.sample_counts()
    assert m.profiler_samples["io_h"] > 0
    assert m.profiler_samples["project"] > 0
    assert m.restore_bubble_n > 0 and m.makespan_err_n > 0
    assert len(m.makespan_predicted) == len(m.makespan_measured) > 0
    d = m.to_dict()
    assert d["profiler_samples"] == m.profiler_samples
    assert d["makespan_measured"]["n"] == len(m.makespan_measured)
