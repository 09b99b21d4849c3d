"""The port's mesh serving programs (``distributed/mesh_serving.py``,
``launch/dryrun.py``) against the JAX package's ``Model.prefill``,
``restore_kv_from_hidden`` and ``decode_step_full`` jitted under the
dry-run's shardings, at the same mesh.

The reference runs inside ``mesh_context`` over the 4 host devices
``tests/conftest.py`` forces, its weights, batch, hidden states and cache
placed by ``param_shardings``, ``prefill_batch_sharding``, the hidden
spec ("layers", "batch", "kv_seq", "d_model") and ``cache_sharding``;
the port over CPU shards, its weights converted from the reference's
``split(model.init(...))``. fp32 smoke configs; tolerance 1e-4 absolute
(``tests/test_torch_model.py``). The placed cache parts are held to the
reference's addressable shards (slices and values), a 1x1 mesh to the
plain ``Model`` calls bitwise, and the port's restore to its prefill's
K/V bitwise."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.configs import get_arch as jax_arch
from repro.distributed import sharding as jsh
from repro.launch.mesh import make_mesh as jax_mesh
from repro.models import Model as JaxModel
from repro.models.module import split
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.config.shapes import (DECODE_32K, LONG_500K, PREFILL_32K,
                                       RESTORE_32K, TRAIN_4K)
from repro_torch.configs import get_arch
from repro_torch.distributed.mesh_serving import HIDDEN_AXES, MeshServer
from repro_torch.distributed.sharding import default_rules, mesh_coords
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params

ATOL = 1e-4
SEQ = 32          # prompt tokens: 16 or 8 per context shard
CTX = 48          # cache capacity: shard boundaries at 24 (or 12, 24, 36)
STEPS = 6         # decode steps from position 32: gemma2's 16-token
N_VIS = 4         # window crosses a boundary at every step


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     ["cpu"] * (shape[0] * shape[1]))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _pair(name, shape, long_context):
    """The reference model at ``shape`` and the port's server over CPU
    shards of the same shape, on the same weights."""
    mesh = jax_mesh(shape, ("data", "model"))
    rules = jsh.default_rules(mesh, long_context=long_context)
    jm = JaxModel(jax_reduced(jax_arch(name)), rules=rules,
                  model_axis=shape[1], dtype=jnp.float32, remat="none")
    jparams = split(jm.init(jax.random.PRNGKey(0)))[0]
    np_tree = jax.tree.map(np.asarray, jparams)
    cfg = reduced_for_smoke(get_arch(name))
    tm = Model(cfg, device="cpu", model_axis=shape[1])
    tparams = from_jax_params(np_tree, cfg, device="cpu",
                              model_axis=shape[1])
    tmesh = _cpu_mesh(shape)
    srv = MeshServer(tm, tmesh, default_rules(tmesh,
                                              long_context=long_context))
    jparams = jax.device_put(jparams, jm.param_shardings(mesh))
    return mesh, rules, jm, jparams, tm, tparams, srv


def _coord(mesh, device):
    """The (data, model) coordinate of a JAX device in ``mesh``."""
    where = np.argwhere(mesh.devices == device)
    return tuple(int(i) for i in where[0])


def _hold_placement(placed, jarr, mesh, what):
    """Each addressable shard of the reference's array against the port's
    part at the same mesh coordinate: the same block, the same values."""
    coords = mesh_coords(placed.mesh)
    for shard in jarr.addressable_shards:
        coord = _coord(mesh, shard.device)
        part = placed.parts[coords.index(coord)]
        want = tuple(slice(s.start or 0, n if s.stop is None else s.stop)
                     for s, n in zip(shard.index, jarr.shape))
        assert tuple(placed.block(coord)) == want, (what, coord)
        _close(part, shard.data, f"{what} at {coord}")


def _batch(cfg, B, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ),
                                    dtype=np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, N_VIS, cfg.d_model)).astype(np.float32)
    return batch


def _run(name, shape, long_context=False):
    mesh, rules, jm, jparams, tm, tparams, srv = _pair(name, shape,
                                                       long_context)
    cfg = tm.cfg
    B = 1 if long_context else 2
    batch = _batch(cfg, B)
    jbatch = jax.device_put(
        {k: jnp.asarray(v) for k, v in batch.items()},
        {k: NamedSharding(mesh, s)
         for k, s in jm.prefill_batch_sharding().items() if k in batch})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    mp = srv.place_params(tparams)
    lm = tm.kind == "lm"
    with jsh.mesh_context(mesh), torch.no_grad():
        jout = jax.jit(lambda p, b: jm.prefill(p, b, capture_hidden=True))(
            jparams, jbatch)
        tout = srv.prefill(mp, tbatch, capture_hidden=True)
        _close(tout["logits"].gather()[..., :cfg.vocab_size],
               np.asarray(jout["logits"])[..., :cfg.vocab_size], "logits")
        _close(tout["hidden"].gather(), jout["hidden"], "hidden")
        cache_sh = {k: NamedSharding(mesh, s)
                    for k, s in jm.cache_sharding().items()}
        lengths = np.full((B,), SEQ, np.int32)
        if lm:
            _close(tout["kv"][0].gather(), jout["kv"][0], "prefill k")
            _close(tout["kv"][1].gather(), jout["kv"][1], "prefill v")
            # the paper's op from the stored hidden states
            hid_sh = NamedSharding(mesh, rules.spec(HIDDEN_AXES))
            pos = jnp.broadcast_to(jnp.arange(SEQ, dtype=jnp.int32)[None],
                                   (B, SEQ))
            jk, jv = jax.jit(lambda p, h: jm.restore_kv_from_hidden(
                p, h, positions=pos))(
                    jparams, jax.device_put(jout["hidden"], hid_sh))
            hidden = srv.place_hidden(tout["hidden"].gather(), CTX)
            tk, tv = srv.restore_kv_from_hidden(mp, hidden)
            _close(tk.gather()[:, :, :SEQ], jk, "restored k")
            _close(tv.gather()[:, :, :SEQ], jv, "restored v")
            assert torch.equal(tk.gather()[:, :, :SEQ],
                               tout["kv"][0].gather())
            assert torch.equal(tv.gather()[:, :, :SEQ],
                               tout["kv"][1].gather())
            pad = ((0, 0), (0, 0), (0, CTX - SEQ), (0, 0), (0, 0))
            jcache = {"k": np.pad(np.asarray(jk), pad),
                      "v": np.pad(np.asarray(jv), pad), "lengths": lengths}
            tcache = srv.place_cache({"k": tk, "v": tv, "lengths": lengths},
                                     CTX)
        else:
            jcache = {"conv": np.asarray(jout["states"][0]),
                      "ssm": np.asarray(jout["states"][1]),
                      "lengths": lengths}
            _close(tout["states"][0].gather(), jcache["conv"], "conv")
            _close(tout["states"][1].gather(), jcache["ssm"], "ssm")
            tcache = srv.place_cache({"conv": tout["states"][0],
                                      "ssm": tout["states"][1],
                                      "lengths": lengths})
        jcache = jax.device_put({k: jnp.asarray(v) for k, v in
                                 jcache.items()}, cache_sh)
        for k in jcache:
            _hold_placement(tcache[k], jcache[k], mesh, f"cache {k}")
        step = jax.jit(jm.decode_step_full)
        tok = np.asarray(jout["logits"]).argmax(-1).astype(np.int32)
        for i in range(STEPS):
            jlg, jcache, jhid = step(jparams, jcache, jnp.asarray(tok))
            tlg, tcache, thid = srv.decode_step(mp, tcache,
                                                torch.from_numpy(tok))
            _close(tlg.gather()[..., :cfg.vocab_size],
                   np.asarray(jlg)[..., :cfg.vocab_size],
                   f"decode logits at step {i}")
            _close(thid.gather(), jhid, f"decode hidden at step {i}")
            tok = np.asarray(jlg).argmax(-1).astype(np.int32)
        for k in jcache:
            _close(tcache[k].gather(), jcache[k], f"cache {k} after decode")


@pytest.mark.parametrize("name,shape,long_context", [
    ("llama2-7b", (2, 2), False),
    ("llama2-7b", (1, 2), False),
    ("llama2-7b", (2, 1), False),
    ("llama2-7b", (2, 2), True),
    ("qwen2-7b", (2, 2), False),
    ("gemma2-9b", (2, 2), False),
    ("gemma2-9b", (2, 2), True),
    ("granite-moe-1b-a400m", (2, 2), False),
    ("internvl2-26b", (2, 2), False),
    ("falcon-mamba-7b", (1, 2), False),
    ("falcon-mamba-7b", (2, 2), True),
])
def test_mesh_programs_match_the_reference(name, shape, long_context):
    _run(name, shape, long_context)


@pytest.mark.parametrize("name", ["llama2-7b", "gemma2-9b",
                                  "granite-moe-1b-a400m", "internvl2-26b",
                                  "falcon-mamba-7b"])
def test_one_by_one_mesh_is_the_plain_model_bitwise(name):
    cfg = reduced_for_smoke(get_arch(name))
    tm = Model(cfg, device="cpu")
    params = tm.init(0)
    srv = MeshServer(tm, _cpu_mesh((1, 1)))
    mp = srv.place_params(params)
    B = 2
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(cfg, B).items()}
    with torch.no_grad():
        got = srv.prefill(mp, tbatch, capture_hidden=True)
        want = tm.prefill(params, tbatch, capture_hidden=True)
        assert torch.equal(got["logits"].gather(), want["logits"])
        assert torch.equal(got["hidden"].gather(), want["hidden"])
        lengths = torch.full((B,), SEQ, dtype=torch.int32)
        if tm.kind == "lm":
            for g, w in zip(got["kv"], want["kv"]):
                assert torch.equal(g.gather(), w)
            pos = torch.arange(SEQ)[None].expand(B, SEQ)
            rk, rv = srv.restore_kv_from_hidden(
                mp, srv.place_hidden(want["hidden"], CTX))
            pk, pv = tm.restore_kv_from_hidden(params, want["hidden"],
                                               positions=pos)
            assert torch.equal(rk.gather()[:, :, :SEQ], pk)
            assert torch.equal(pk, want["kv"][0])
            cache = srv.place_cache({"k": rk, "v": rv, "lengths": lengths},
                                    CTX)
            plain = tm.init_cache(B, CTX)
            plain["k"][:, :, :SEQ], plain["v"][:, :, :SEQ] = pk, pv
        else:
            for g, w in zip(got["states"], want["states"]):
                assert torch.equal(g.gather(), w)
            cache = srv.place_cache({"conv": want["states"][0],
                                     "ssm": want["states"][1],
                                     "lengths": lengths})
            plain = {"conv": want["states"][0].clone(),
                     "ssm": want["states"][1].clone()}
        plain["lengths"] = lengths.clone()
        tok = want["logits"].argmax(-1)
        for _ in range(4):
            lg, cache, hid = srv.decode_step(mp, cache, tok)
            plg, plain, phid = tm.decode_step_full(params, plain, tok)
            assert torch.equal(lg.gather(), plg)
            assert torch.equal(hid.gather(), phid)
            tok = plg.argmax(-1)
        for k in plain:
            assert torch.equal(cache[k].gather(), plain[k])


def test_restore_lands_in_the_cache_layout_without_a_copy():
    """Hidden states placed at the cache's capacity restore straight into
    its parts: ``place_cache`` takes the restored K/V as it is."""
    cfg = reduced_for_smoke(get_arch("llama2-7b"))
    tm = Model(cfg, device="cpu", model_axis=2)
    srv = MeshServer(tm, _cpu_mesh((2, 2)))
    mp = srv.place_params(tm.init(0))
    hidden = torch.randn(cfg.n_layers, 2, SEQ, cfg.d_model,
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        k, v = srv.restore_kv_from_hidden(mp, srv.place_hidden(hidden, CTX))
        cache = srv.place_cache({"k": k, "v": v, "lengths": [SEQ, SEQ]},
                                CTX)
    assert cache["k"] is k and cache["v"] is v
    assert [tuple(p.shape) for p in k.parts] == \
        [(cfg.n_layers, 1, CTX // 2, cfg.n_kv_heads, cfg.head_dim_)] * 4


def _tiny(shape, seq, batch):
    return dataclasses.replace(shape, seq_len=seq, global_batch=batch)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
@pytest.mark.parametrize("name,shape", [
    ("qwen2-7b", _tiny(TRAIN_4K, 32, 2)),
    ("qwen2-7b", _tiny(PREFILL_32K, 32, 2)),
    ("qwen2-7b", _tiny(RESTORE_32K, 32, 2)),
    ("qwen2-7b", _tiny(DECODE_32K, 32, 2)),
    ("falcon-mamba-7b", _tiny(LONG_500K, 32, 1)),
])
def test_build_cell_runs_each_kind(name, shape, mesh_shape):
    mesh = _cpu_mesh(mesh_shape)
    cfg = reduced_for_smoke(get_arch(name))
    fn, args = dryrun.build_cell(mesh, cfg, shape, "base", seed=0,
                                 dtype=torch.float32, device="cpu")
    grad = shape.kind == "train"
    with torch.set_grad_enabled(grad):
        out = fn(*args)
    if shape.kind == "train":
        state, metrics = out
        assert np.isfinite(float(metrics["loss"]))
        return
    first = out[0].gather()
    assert torch.isfinite(first).all()
    if shape.kind == "decode":
        assert tuple(first.shape[:2]) == (shape.global_batch, 1)
        assert int(out[1]["lengths"].gather()[0]) == shape.seq_len


def test_build_cell_is_the_same_program_on_every_mesh():
    """A prefill cell's logits at 2x2 agree with 1x1's."""
    cfg = reduced_for_smoke(get_arch("llama2-7b"))
    shape = _tiny(PREFILL_32K, 32, 2)
    got = []
    with torch.no_grad():
        for ms in ((1, 1), (2, 2)):
            fn, args = dryrun.build_cell(_cpu_mesh(ms), cfg, shape, "base",
                                         seed=0, dtype=torch.float32,
                                         device="cpu")
            got.append(fn(*args)[0].gather())
    _close(got[1], got[0], "2x2 against 1x1")


def test_fsdp_rules_are_refused():
    cfg = reduced_for_smoke(get_arch("grok-1-314b"))
    mesh = _cpu_mesh((1, 2))
    shape = _tiny(PREFILL_32K, 32, 2)
    with pytest.raises(ValueError, match="fsdp_rules.*ROADMAP.md"):
        dryrun.build_cell(mesh, cfg, shape, "base", dtype=torch.float32,
                          device="cpu")


@pytest.mark.parametrize("variant", ["seqshard", "ffmodel", "dotsremat",
                                     "bigchunk", "triprefill",
                                     "latecombine"])
def test_serving_variants_are_refused(variant):
    cfg = reduced_for_smoke(get_arch("llama2-7b"))
    mesh = _cpu_mesh((1, 2))
    with pytest.raises(ValueError, match="ROADMAP.md"):
        dryrun.build_cell(mesh, cfg, _tiny(PREFILL_32K, 32, 2), variant,
                          dtype=torch.float32, device="cpu")


def test_seq_shard_rules_are_refused():
    cfg = reduced_for_smoke(get_arch("llama2-7b"))
    mesh = _cpu_mesh((2, 1))
    with pytest.raises(ValueError, match="seq_shard.*ROADMAP.md"):
        MeshServer(Model(cfg, device="cpu"), mesh,
                   default_rules(mesh, seq_shard=True))


FP32_REL = 1e-4   # chip_smoke.py's MESH_FP32_REL


def _rel(got, want):
    return float((got - want).norm() / want.norm())


def _twin_gap(shape, long_context):
    """The largest relative L2 between a mesh's logits and its 1x1
    twin's over a prefill, a restore into the context-split cache and
    STEPS decode steps fed the twin's tokens, in fp32."""
    cfg = reduced_for_smoke(get_arch("llama2-7b"))
    tm = Model(cfg, device="cpu", model_axis=shape[1])
    params = tm.init(0)
    B = 1 if long_context else 2
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(cfg, B).items()}
    runs = []
    for ms, lc in (((1, 1), False), (shape, long_context)):
        mesh = _cpu_mesh(ms)
        srv = MeshServer(tm, mesh, default_rules(mesh, long_context=lc))
        mp = srv.place_params(params)
        out = srv.prefill(mp, tbatch, capture_hidden=True)
        k, v = srv.restore_kv_from_hidden(
            mp, srv.place_hidden(out["hidden"].gather(), CTX))
        cache = srv.place_cache({"k": k, "v": v, "lengths": [SEQ] * B}, CTX)
        runs.append((srv, mp, cache, out["logits"].gather()))
    gaps = [_rel(runs[1][3], runs[0][3])]
    tok = runs[0][3].argmax(-1)
    for _ in range(STEPS):
        lgs = []
        for i, (srv, mp, cache, _) in enumerate(runs):
            lg, cache, _ = srv.decode_step(mp, cache, tok)
            runs[i] = (srv, mp, cache, None)
            lgs.append(lg.gather())
        gaps.append(_rel(lgs[1], lgs[0]))
        tok = lgs[0].argmax(-1)
    return max(gaps)


@pytest.mark.parametrize("mutation", [None, "slice start", "merge"])
@pytest.mark.parametrize("long_context", [False, True])
def test_fp32_twin_gap_sees_a_wrong_slice_or_merge(mutation, long_context,
                                                   monkeypatch):
    """The card's fp32 gate against the 1x1 twin: the mesh sits far
    inside it, and a slice start off by one or partials merged without
    their log-sum-exp weights land far outside it."""
    if mutation == "slice start":
        start = MeshServer._start
        monkeypatch.setattr(MeshServer, "_start",
                            lambda self, p, r: start(self, p, r) + 1)
    elif mutation == "merge":
        from repro_torch.models.layers import attention
        monkeypatch.setattr(
            attention, "merge_partials",
            lambda outs, lses, dtype=None: (
                sum(o.float() for o in outs) / len(outs)).to(
                    dtype or outs[0].dtype))
    with torch.no_grad():
        gap = _twin_gap((2, 2), long_context)
    if mutation is None:
        assert gap < FP32_REL / 10, gap
    else:
        assert gap > FP32_REL * 10, gap
