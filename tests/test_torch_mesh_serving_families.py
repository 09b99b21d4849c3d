"""The port's mesh serving programs for the hybrid (zamba2-2.7b) and
enc-dec (whisper-medium) families (``distributed/mesh_serving.py``,
``models/hybrid.py``, ``models/encdec.py``, ``layers/mamba.py::
apply_mamba2_shards``, ``launch/dryrun.py``) against the JAX package's
``Model.prefill``, ``restore_kv_from_hidden`` and ``decode_step_full``
jitted under the dry-run's shardings, at the same mesh.

As in ``tests/test_torch_mesh_serving.py`` (whose helpers this file
takes): the reference over the 4 host devices ``tests/conftest.py``
forces, the port over CPU shards on the reference's converted weights,
fp32 smoke configs, tolerance 1e-4 absolute; the placed cache parts held
to the reference's addressable shards, a 1x1 mesh to the plain ``Model``
bitwise, the restore to the prefill's K/V bitwise. Also: the cells'
shapes and specs at full size against the reference's, every serving
cell built and run, counted FLOPs against ``analyze_hlo``, a count on
``meta`` against one on the CPU, and the card's fp32 twin gate against
a wrong Mamba2 column order or a cross-slice merge out of order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro.config import shapes as jax_shapes
from repro.configs import get_arch as jax_arch
from repro.distributed import sharding as jsh
from repro.launch.mesh import make_mesh as jax_mesh
from repro.models import Model as JaxModel
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.config.shapes import (DECODE_32K, LONG_500K, PREFILL_32K,
                                       RESTORE_32K, TRAIN_4K)
from repro_torch.configs import get_arch
from repro_torch.distributed.mesh_serving import HIDDEN_AXES, MeshServer
from repro_torch.distributed.sharding import default_rules
from repro_torch.launch import dryrun
from repro_torch.models import Model
from repro_torch.models.layers import attention
from repro_torch.models.layers import mamba as mamba_lib
from repro_torch.models.model import DEC_BUF, DEC_PROMPT

from test_torch_dryrun import _count, _mesh, _reference_dryrun, \
    _reference_flops
from test_torch_mesh_serving import (CTX, SEQ, STEPS, _close,
                                     _cpu_mesh, _few_threads,  # noqa: F401
                                     _hold_placement, _pair, _rel, _tiny)

HYBRID, ENCDEC = "zamba2-2.7b", "whisper-medium"
FRAMES = 48         # encoder frames: 24 per context shard over 2
FP32_REL = 1e-4     # chip_smoke.py's MESH_FP32_REL


def _batch(cfg, B, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ),
                                    dtype=np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(cfg, B):
    return {k: torch.from_numpy(v) for k, v in _batch(cfg, B).items()}


def _hidden_key(kind):
    return "attn_hidden" if kind == "hybrid" else "hidden"


def _caches(tm, tout, k, v, B):
    """(the port's cache dict, the reference's as numpy) from the port's
    prefill outputs and the restored K/V (K/V at CTX positions)."""
    lengths = np.full((B,), SEQ, np.int32)
    pad = ((0, 0), (0, 0), (0, CTX - SEQ), (0, 0), (0, 0))
    whole = {"k": np.pad(k.gather().numpy()[:, :, :SEQ], pad),
             "v": np.pad(v.gather().numpy()[:, :, :SEQ], pad)}
    if tm.kind == "hybrid":
        conv, ssm = tout["mamba_states"]
        t = {"attn_k": k, "attn_v": v, "conv": conv, "ssm": ssm,
             "lengths": lengths}
        j = {"attn_k": whole["k"], "attn_v": whole["v"],
             "conv": conv.gather().numpy(), "ssm": ssm.gather().numpy(),
             "lengths": lengths}
        return t, j
    ck, cv = tout["cross_kv"]
    t = {"self_k": k, "self_v": v, "cross_k": ck, "cross_v": cv,
         "enc_len": FRAMES, "lengths": lengths}
    j = {"self_k": whole["k"], "self_v": whole["v"],
         "cross_k": ck.gather().numpy(), "cross_v": cv.gather().numpy(),
         "enc_len": np.int32(FRAMES), "lengths": lengths}
    return t, j


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
    hkey = _hidden_key(tm.kind)
    with jsh.mesh_context(mesh), torch.no_grad():
        jout = jax.jit(lambda p, b: jm.prefill(p, b, capture_hidden=True))(
            jparams, jbatch)
        tout = srv.prefill(mp, tbatch, capture_hidden=True)
        _close(tout["logits"].gather()[..., :cfg.vocab_size],
               np.asarray(jout["logits"])[..., :cfg.vocab_size], "logits")
        _close(tout["hidden"].gather(), jout[hkey], "hidden")
        _close(tout["kv"][0].gather(), jout["kv"][0], "prefill k")
        _close(tout["kv"][1].gather(), jout["kv"][1], "prefill v")
        second = "mamba_states" if tm.kind == "hybrid" else "cross_kv"
        for i in range(2):
            _close(tout[second][i].gather(), jout[second][i],
                   f"{second}[{i}]")
        # the paper's op from the stored hidden states
        hid_sh = NamedSharding(mesh, rules.spec(HIDDEN_AXES))
        pos = jnp.broadcast_to(jnp.arange(SEQ, dtype=jnp.int32)[None],
                               (B, SEQ))
        jk, jv = jax.jit(lambda p, h: jm.restore_kv_from_hidden(
            p, h, positions=pos))(jparams,
                                  jax.device_put(jout[hkey], hid_sh))
        tk, tv = srv.restore_kv_from_hidden(
            mp, srv.place_hidden(tout["hidden"].gather(), CTX))
        _close(tk.gather()[:, :, :SEQ], jk, "restored k")
        _close(tv.gather()[:, :, :SEQ], jv, "restored v")
        assert torch.equal(tk.gather()[:, :, :SEQ], tout["kv"][0].gather())
        assert torch.equal(tv.gather()[:, :, :SEQ], tout["kv"][1].gather())
        tcache, jcache = _caches(tm, tout, tk, tv, B)
        tcache = srv.place_cache(tcache, CTX)
        cache_sh = {k: NamedSharding(mesh, s)
                    for k, s in jm.cache_sharding().items()}
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
            _close(thid.gather(),
                   jhid[1] if tm.kind == "hybrid" else jhid,
                   f"decode hidden at step {i}")
            tok = np.asarray(jlg).argmax(-1).astype(np.int32)
        for k in jcache:
            _close(tcache[k].gather(), jcache[k], f"cache {k} after decode")


@pytest.mark.parametrize("name,shape,long_context", [
    (HYBRID, (2, 2), False),
    (HYBRID, (1, 2), False),
    (HYBRID, (2, 2), True),
    (ENCDEC, (2, 2), False),
    (ENCDEC, (1, 2), False),
    (ENCDEC, (2, 1), False),
])
def test_mesh_programs_match_the_reference(name, shape, long_context):
    _run(name, shape, long_context)


def _plain_cache(tm, want, rk, rv, B):
    """The plain model's decode cache from its prefill and a restore."""
    lengths = torch.full((B,), SEQ, dtype=torch.int32)
    if tm.kind == "hybrid":
        cache = tm.init_cache(B, CTX)
        cache["attn_k"][:, :, :SEQ], cache["attn_v"][:, :, :SEQ] = rk, rv
        cache["conv"][:], cache["ssm"][:] = want["mamba_states"]
    else:
        cache = tm.init_cache(B, CTX, enc_seq=FRAMES)
        cache["self_k"][:, :, :SEQ], cache["self_v"][:, :, :SEQ] = rk, rv
        cache["cross_k"][:], cache["cross_v"][:] = want["cross_kv"]
        cache["enc_len"] = torch.tensor(FRAMES, dtype=torch.int32)
    cache["lengths"] = lengths
    return cache


@pytest.mark.parametrize("name", [HYBRID, ENCDEC])
def test_one_by_one_mesh_is_the_plain_model_bitwise(name):
    cfg = reduced_for_smoke(get_arch(name))
    tm = Model(cfg, device="cpu")
    params = tm.init(0)
    srv = MeshServer(tm, _cpu_mesh((1, 1)))
    mp = srv.place_params(params)
    B = 2
    tbatch = _torch_batch(cfg, B)
    hkey = _hidden_key(tm.kind)
    second = "mamba_states" if tm.kind == "hybrid" else "cross_kv"
    with torch.no_grad():
        got = srv.prefill(mp, tbatch, capture_hidden=True)
        want = tm.prefill(params, tbatch, capture_hidden=True)
        assert torch.equal(got["logits"].gather(), want["logits"])
        assert torch.equal(got["hidden"].gather(), want[hkey])
        for key in ("kv", second):
            for g, w in zip(got[key], want[key]):
                assert torch.equal(g.gather(), w), key
        pos = torch.arange(SEQ)[None].expand(B, SEQ)
        rk, rv = srv.restore_kv_from_hidden(
            mp, srv.place_hidden(want[hkey], CTX))
        pk, pv = tm.restore_kv_from_hidden(params, want[hkey],
                                           positions=pos)
        assert torch.equal(rk.gather()[:, :, :SEQ], pk)
        assert torch.equal(rv.gather()[:, :, :SEQ], pv)
        assert torch.equal(pk, want["kv"][0])
        tcache, _ = _caches(tm, got, rk, rv, B)
        cache = srv.place_cache(tcache, CTX)
        plain = _plain_cache(tm, want, pk, pv, B)
        tok = want["logits"].argmax(-1)
        for _ in range(4):
            lg, cache, hid = srv.decode_step(mp, cache, tok)
            plg, plain, phid = tm.decode_step_full(params, plain, tok)
            if tm.kind == "hybrid":
                phid = phid[1]
            assert torch.equal(lg.gather(), plg)
            assert torch.equal(hid.gather(), phid)
            tok = plg.argmax(-1)
        for k in plain:
            assert torch.equal(cache[k].gather(), plain[k].expand(
                cache[k].shape)), k


@pytest.mark.parametrize("name", [HYBRID, ENCDEC])
def test_restore_lands_in_the_cache_layout(name):
    """Hidden states placed at the cache's capacity restore straight into
    its parts, which ``place_cache`` takes as they are: a hybrid stack's
    attention blocks split along the context, an enc-dec stack's self
    K/V whole along it on every shard (gathered over model); each part
    the 1x1 restore's block, bitwise."""
    cfg = reduced_for_smoke(get_arch(name))
    tm = Model(cfg, device="cpu", model_axis=2)
    params = tm.init(0)
    srv = MeshServer(tm, _cpu_mesh((2, 2)))
    twin = MeshServer(tm, _cpu_mesh((1, 1)))
    rows = tm.h.n_super if tm.kind == "hybrid" else cfg.n_layers
    hidden = torch.randn(rows, 2, SEQ, cfg.d_model,
                         generator=torch.Generator().manual_seed(3))
    names = (("attn_k", "attn_v") if tm.kind == "hybrid"
             else ("self_k", "self_v"))
    with torch.no_grad():
        k, v = srv.restore_kv_from_hidden(srv.place_params(params),
                                          srv.place_hidden(hidden, CTX))
        wk, wv = twin.restore_kv_from_hidden(twin.place_params(params),
                                             twin.place_hidden(hidden, CTX))
        cache = srv.place_cache({names[0]: k, names[1]: v,
                                 "lengths": [SEQ, SEQ]}, CTX)
    assert cache[names[0]] is k and cache[names[1]] is v
    ctx = CTX // 2 if tm.kind == "hybrid" else CTX
    assert [tuple(p.shape) for p in k.parts] == \
        [(rows, 1, ctx, cfg.n_kv_heads, cfg.head_dim_)] * 4
    for got, want in ((k, wk.gather()), (v, wv.gather())):
        for r, part in enumerate(got.parts):
            assert torch.equal(part, want[got.block(srv.coords[r])])


# ------------------------------------------------ specs at full size
def _spec(s, n):
    out = tuple(s)
    return out + (None,) * (n - len(out))


@pytest.mark.parametrize("name,long_context", [
    (HYBRID, False), (HYBRID, True), (ENCDEC, False)])
def test_cell_specs_are_the_reference_ones(name, long_context):
    """``cache_spec``/``cache_sharding``/``prefill_batch_spec``/
    ``prefill_batch_sharding`` at full size, shapes, dtypes and spec
    tuples, and the restore cell's hidden states: whisper's DEC_PROMPT
    prompt and DEC_BUF self buffer, zamba2's n_super rows."""
    jmesh = jax_mesh((2, 2), ("data", "model"))
    jm = JaxModel(jax_arch(name), rules=jsh.default_rules(
        jmesh, long_context=long_context), model_axis=2,
        dtype=jnp.bfloat16)
    tmesh = _cpu_mesh((2, 2))
    rules = default_rules(tmesh, long_context=long_context)
    tm = Model(get_arch(name), device="meta", dtype=torch.bfloat16,
               model_axis=2)
    shape = LONG_500K if long_context else DECODE_32K
    B, S = shape.global_batch, shape.seq_len
    for got, want in ((tm.cache_spec(B, S), jm.cache_spec(B, S)),
                      (tm.prefill_batch_spec(PREFILL_32K),
                       jm.prefill_batch_spec(jax_shapes.PREFILL_32K))):
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert str(got[k].dtype).split(".")[-1] == \
                str(want[k].dtype), k
    for got, want in ((tm.cache_sharding(rules), jm.cache_sharding()),
                      (tm.prefill_batch_sharding(rules),
                       jm.prefill_batch_sharding())):
        assert set(got) == set(want)
        for k in want:
            assert _spec(got[k], len(got[k])) == _spec(want[k],
                                                       len(got[k])), k
    if tm.kind == "encdec":
        assert tm.prefill_batch_spec(PREFILL_32K)["tokens"].shape[1] == \
            DEC_PROMPT
        assert tm.cache_spec(B, S)["self_k"].shape[2] == DEC_BUF
    if not long_context:      # the restore cell's stored hidden states
        jd = _reference_dryrun()
        with jsh.mesh_context(jmesh):
            _, jargs, _, _ = jd.build_cell(jmesh, jax_arch(name),
                                           jax_shapes.RESTORE_32K, "base")
        _, args = dryrun.build_cell(_mesh((2, 2), "meta"), get_arch(name),
                                    RESTORE_32K, device="meta")
        assert tuple(args[1].shape) == tuple(jargs[1].shape)


# ------------------------------------------------------ the dry-run
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
@pytest.mark.parametrize("name,shape", [
    (HYBRID, _tiny(PREFILL_32K, 32, 2)),
    (HYBRID, _tiny(RESTORE_32K, 32, 2)),
    (HYBRID, _tiny(DECODE_32K, 32, 2)),
    (HYBRID, _tiny(LONG_500K, 32, 1)),
    (ENCDEC, _tiny(PREFILL_32K, 32, 2)),
    (ENCDEC, _tiny(RESTORE_32K, 32, 2)),
    (ENCDEC, _tiny(DECODE_32K, 32, 2)),
])
def test_build_cell_runs_each_serving_kind(name, shape, mesh_shape):
    cfg = reduced_for_smoke(get_arch(name))
    fn, args = dryrun.build_cell(_cpu_mesh(mesh_shape), cfg, shape, "base",
                                 seed=0, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        out = fn(*args)
    first = out[0].gather()
    assert torch.isfinite(first).all()
    if shape.kind == "prefill":
        assert len(out) == 3
        assert tuple(first.shape[:2]) == (shape.global_batch, 1)
    if shape.kind == "decode":
        assert tuple(first.shape[:2]) == (shape.global_batch, 1)
        n = DEC_BUF if cfg.is_encoder_decoder else shape.seq_len
        assert int(out[1]["lengths"].gather()[0]) == n


def _masked_pairs(cfg, kind):
    """The (query, key) pairs a causal pass masks, at 4·hd operations
    each, over the port's prefill cell: the attention blocks over S
    tokens (hybrid), the decoder over its DEC_PROMPT-token prompt
    (enc-dec)."""
    S, B = 32, 2
    if kind == "hybrid":
        layers = cfg.n_layers // cfg.hybrid_attn_every
    else:
        layers, S = cfg.n_layers, DEC_PROMPT
    return layers * 4 * cfg.head_dim_ * cfg.n_heads * B * (
        S * S - S * (S + 1) // 2)


def _ssd_sums(cfg):
    """The two sums over the state of a Mamba2 decode step that the port
    takes as a fixed tree of adds (``norm.row_sum``) and the reference
    as products: 2·B·(G·N + H·P·G·N) operations per Mamba2 block."""
    B, N = 2, cfg.ssm_state
    inner = cfg.ssm_expand * cfg.d_model
    blocks = cfg.n_layers - cfg.n_layers // cfg.hybrid_attn_every
    return blocks * 2 * B * (N + inner * N)


@pytest.mark.parametrize("name", [HYBRID, ENCDEC])
@pytest.mark.parametrize("kind", ["restore", "prefill", "decode"])
def test_flops_agree_with_the_reference_hlo(name, kind):
    """The tolerance rule of ``tests/test_torch_dryrun.py``: the restore
    cell is the same products (within 1 %); a prefill cell's gap is
    exactly the masked pairs of the causal passes (kernel #5 counts the
    visible ones, the reference whole blocks); a hybrid decode cell's is
    exactly the Mamba2 step's two sums over the state, which the port
    adds elementwise; each within that gap plus 1 %."""
    want = _reference_flops(name, kind)
    got = _count(name, kind, (1, 1), "meta", torch.bfloat16)["flops"]
    cfg = reduced_for_smoke(get_arch(name))
    fam = Model(cfg, device="meta").kind
    gap = {"prefill": _masked_pairs(cfg, fam),
           "decode": _ssd_sums(cfg) if fam == "hybrid" else 0,
           "restore": 0}[kind]
    tol = (gap + 0.01 * want) / want
    # whisper's 128-token causal prompt masks 9.4 % of its prefill's
    # products; the gap itself is asserted exactly below
    assert tol <= 0.15
    assert abs(got - want) <= tol * want, (got, want, tol)
    assert want - got == gap


@pytest.mark.parametrize("name,kind,mesh_shape", [
    (name, kind, (2, 2)) for name in (HYBRID, ENCDEC)
    for kind in ("prefill", "restore", "decode")] + [(HYBRID, "long", (2, 2))])
def test_meta_count_equals_the_cpu_count(name, kind, mesh_shape):
    """Every key, per shard, as the lm cells'."""
    cpu = _count(name, kind, mesh_shape, "cpu")
    meta = _count(name, kind, mesh_shape, "meta")
    assert meta == cpu
    assert len(cpu["per_shard"]["flops"]) == int(np.prod(mesh_shape))
    assert cpu["flops"] > 0 and sum(cpu["total"]["launches"].values()) > 0
    if kind != "restore" or name == ENCDEC:     # the self K/V's gather
        assert cpu["collective_bytes"] > 0


# --------------------------------------------- the card's fp32 gate
def _twin_gap(name, shape):
    """The largest relative L2 between a mesh's logits and its 1x1
    twin's over a prefill, a restore into the cache and STEPS decode
    steps fed the twin's tokens, in fp32."""
    cfg = reduced_for_smoke(get_arch(name))
    tm = Model(cfg, device="cpu", model_axis=shape[1])
    params = tm.init(0)
    B = 2
    tbatch = _torch_batch(cfg, B)
    runs = []
    for ms in ((1, 1), shape):
        srv = MeshServer(tm, _cpu_mesh(ms))
        mp = srv.place_params(params)
        out = srv.prefill(mp, tbatch, capture_hidden=True)
        k, v = srv.restore_kv_from_hidden(
            mp, srv.place_hidden(out["hidden"].gather(), CTX))
        cache = srv.place_cache(_caches(tm, out, k, v, B)[0], CTX)
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


def _swapped_columns(h, M, m):
    """A wrong in_proj order: each shard's x columns where its z columns
    belong, and the reverse."""
    cols = _REAL_COLUMNS(h, M, m)
    n = h.d_inner // M
    return torch.cat([cols[n:2 * n], cols[:n], cols[2 * n:]])


_REAL_COLUMNS = mamba_lib.mamba2_shard_columns


@pytest.mark.parametrize("name,mutation", [
    (HYBRID, None), (HYBRID, "columns"), (HYBRID, "merge"),
    (ENCDEC, None), (ENCDEC, "merge")])
def test_fp32_twin_gap_sees_a_wrong_column_order_or_merge(name, mutation,
                                                          monkeypatch):
    """The card's fp32 gate against the 1x1 twin: the mesh sits far
    inside it, and a Mamba2 in_proj split in the wrong column order, or
    context slices' partials merged under each other's log-sum-exp (the
    attention blocks' K/V, whisper's cross K/V), land far outside it."""
    if mutation == "columns":
        monkeypatch.setattr(mamba_lib, "mamba2_shard_columns",
                            _swapped_columns)
    elif mutation == "merge":
        real = attention.merge_partials
        monkeypatch.setattr(
            attention, "merge_partials",
            lambda outs, lses, dtype=None: real(outs, lses[::-1], dtype))
    with torch.no_grad():
        gap = _twin_gap(name, (2, 2))
    if mutation is None:
        assert gap < FP32_REL / 10, gap
    else:
        assert gap > FP32_REL * 10, gap


def test_enc_dec_long_context_is_refused():
    cfg = reduced_for_smoke(get_arch(ENCDEC))
    mesh = _cpu_mesh((2, 2))
    with pytest.raises(ValueError, match="long_context.*ROADMAP.md"):
        MeshServer(Model(cfg, device="cpu", model_axis=2), mesh,
                   default_rules(mesh, long_context=True))


@pytest.mark.parametrize("name", [HYBRID, ENCDEC])
def test_train_cells_stay_refused(name):
    cfg = reduced_for_smoke(get_arch(name))
    with pytest.raises(ValueError, match="ROADMAP.md"):
        dryrun.build_cell(_cpu_mesh((1, 2)), cfg, _tiny(TRAIN_4K, 32, 2),
                          dtype=torch.float32, device="cpu")
