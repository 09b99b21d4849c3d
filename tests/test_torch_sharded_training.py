"""The port's sharded train step (``training/sharded.py``) against the
JAX package's ``Trainer.train_step`` jitted under the state's shardings,
at the same mesh.

The reference runs under the 4 host devices ``tests/conftest.py`` forces
(state ``device_put`` to ``rules.tree_shardings(mesh, state_axes)``,
inside ``mesh_context``); the port over CPU shards. Both start from the
reference's ``split(model.init(...))`` through ``from_jax_train_state``.
Tolerances are ``tests/test_torch_training.py``'s (fp32): losses within
a relative 1e-5, gradient norms 1e-4, each parameter leaf after three
steps within 1e-4 of its largest magnitude, except elements whose
gradient was within that tolerance of zero at some step (Adam divides by
the gradient's own size), which are held to Adam's step bound 2·lr per
step. A second run of one mesh must give the same bits, and the port's
2x2 is held against its own 1x1 with the same tolerances."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.configs import get_arch as jax_arch
from repro.distributed import sharding as jsh
from repro.launch.mesh import make_mesh as jax_mesh
from repro.models import Model as JaxModel
from repro.models.layers import moe as jmoe
from repro.models.module import split
from repro.training import AdamWConfig as JaxAdamW
from repro.training import Trainer as JaxTrainer
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.configs import get_arch
from repro_torch.distributed.collectives import (copy_to_shards,
                                                 reduce_from_shards)
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_train_state
from repro_torch.models.layers import moe as tmoe
from repro_torch.training import (AdamWConfig, CheckpointManager, DataConfig,
                                  Trainer, batch_at, side_inputs)
from repro_torch.training.sharded import ShardedTrainer
from repro_torch.training.tree import tree_leaves, tree_paths

LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-4
LEAF_REL = 1e-4
LR = 1e-3
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(shape):
    return make_mesh(shape, ("data", "model"), ["cpu"] * (shape[0] * shape[1]))


def _batch(vocab, rows=4, seq=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (rows, seq + 1))
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_run(name, shape, late):
    """The reference's three steps at ``shape`` on ``_batch``: (initial
    state as numpy, the initial state ``device_put`` to its shardings,
    per-step (loss, grad_norm), final params as numpy)."""
    mesh = jax_mesh(shape, ("data", "model"))
    rules = jsh.default_rules(mesh)
    jm = JaxModel(jax_reduced(jax_arch(name)), rules=rules,
                  model_axis=shape[1], dtype=jnp.float32, remat="full",
                  moe_late_combine=late)
    jt = JaxTrainer(jm, rules, JaxAdamW(lr=LR), loss_chunks=4)
    key = jax.random.PRNGKey(0)
    state = jax.jit(lambda r: jt.init_state(r)[0])(key)
    axes = split(jax.eval_shape(jm.init, key))[1]
    init = jax.tree.map(np.asarray, state)
    state = jax.device_put(state, rules.tree_shardings(
        mesh, jt.state_axes(axes, state, shape[0])))
    placed = state
    batch = _batch(jm.cfg.vocab_size)
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    metrics = []
    with jsh.mesh_context(mesh):
        step = jax.jit(jt.train_step)
        for _ in range(STEPS):
            state, m = step(state, jb)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return init, placed, metrics, jax.tree.map(np.asarray, state["params"])


def _port_run(name, shape, init_np, batch):
    """The port's three steps at ``shape`` from the reference's initial
    state: (per-step (loss, grad_norm), the placed states after each
    step, the elements whose gradient was near zero at some step)."""
    cfg = reduced_for_smoke(get_arch(name))
    tt = Trainer(Model(cfg, device="cpu", model_axis=shape[1]),
                 AdamWConfig(lr=LR), loss_chunks=4)
    st = ShardedTrainer(tt, _cpu_mesh(shape))
    state = st.place_state(from_jax_train_state(init_np, cfg, device="cpu",
                                                model_axis=shape[1]))
    tb = _tb(batch)
    metrics, loose = [], None
    for _ in range(STEPS):
        _, _, grads = tt.value_and_grad(st.gather_state(state)["params"], tb)
        near = {p: (g != 0) & (g.abs() < LEAF_REL * g.abs().max())
                for p, g in tree_paths(grads)}
        loose = near if loose is None else {p: loose[p] | near[p]
                                            for p in near}
        state, m = st.train_step(state, tb)
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        float(m["aux"])))
    return st, metrics, state, loose


def _hold(got_params, want_params, loose, lr=LR):
    n_loose = n_all = 0
    want = dict(tree_paths(want_params))
    for path, got in tree_paths(got_params):
        w = torch.as_tensor(np.asarray(want[path], np.float32))
        err = (got - w).abs()
        ok = ~loose[path]
        assert float(err[ok].max()) <= LEAF_REL * float(w.abs().max()), path
        assert float(err.max()) <= 2 * STEPS * lr, path
        n_loose, n_all = n_loose + int((~ok).sum()), n_all + ok.numel()
    assert n_loose <= 0.1 * n_all, (n_loose, n_all)


def _equal_trees(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert torch.equal(x, y), path


CASES = {"qwen2-7b 2x2": ("qwen2-7b", (2, 2), False),
         "granite 1x2 late combine": ("granite-moe-1b-a400m", (1, 2), True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_the_reference_at_the_same_mesh(case):
    name, shape, late = CASES[case]
    batch = _batch(reduced_for_smoke(get_arch(name)).vocab_size)
    init, _, jmetrics, jparams = _jax_run(name, shape, late)
    st, metrics, state, loose = _port_run(name, shape, init, batch)
    for (loss, gnorm, _), (jloss, jgnorm) in zip(metrics, jmetrics):
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(gnorm, jgnorm, rtol=GNORM_RTOL)
    whole = st.gather_state(state)
    cfg = reduced_for_smoke(get_arch(name))
    want = from_jax_train_state({"params": jparams, "opt": init["opt"]}, cfg,
                                device="cpu", model_axis=shape[1])["params"]
    _hold(whole["params"], want, loose)
    assert int(whole["opt"]["step"]) == STEPS
    # each device part has the shape its spec gives
    for path, leaf in tree_paths(state):
        for coord, part in zip(st.coords, leaf.parts):
            want_shape = tuple(s.stop - s.start for s in leaf.block(coord))
            assert tuple(part.shape) == want_shape, path
    # the port's own 1x1, and a second run of this mesh, bit for bit
    _, one, state1, _ = _port_run(name, (1, 1), init, batch)
    for (loss, gnorm, aux), (l1, g1, a1) in zip(metrics, one):
        np.testing.assert_allclose(loss, l1, rtol=LOSS_RTOL)
        np.testing.assert_allclose(gnorm, g1, rtol=GNORM_RTOL)
        np.testing.assert_allclose(aux, a1, rtol=LOSS_RTOL)
    _hold(whole["params"], st.gather_state(state1)["params"], loose)
    _, again, state2, _ = _port_run(name, shape, init, batch)
    assert again == metrics
    _equal_trees(st.gather_state(state2), whole)


def test_placed_parts_equal_the_reference_shards():
    """qwen2-7b smoke at 2x2: every device part of every state leaf is the
    reference's shard on the matching device (``addressable_shards``),
    bit for bit, and the parts gather back whole."""
    from repro_torch.distributed.sharding import mesh_coords
    init, placed, _, _ = _jax_run(*CASES["qwen2-7b 2x2"])
    cfg = reduced_for_smoke(get_arch("qwen2-7b"))
    st = ShardedTrainer(Trainer(Model(cfg, device="cpu", model_axis=2)),
                        _cpu_mesh((2, 2)))
    whole = from_jax_train_state(init, cfg, device="cpu", model_axis=2)
    pstate = st.place_state(whole)
    jmesh = jax_mesh((2, 2), ("data", "model"))
    coord_of = {d.id: c for c, d in np.ndenumerate(jmesh.devices)}
    r_of = {c: r for r, c in enumerate(mesh_coords(st.mesh))}
    want = dict(tree_paths(whole))
    jleaves = dict(zip(want, jax.tree.leaves(placed)))
    n = 0
    for path, leaf in tree_paths(pstate):
        for shard in jleaves[path].addressable_shards:
            part = leaf.parts[r_of[coord_of[shard.device.id]]]
            ref = torch.from_numpy(np.array(shard.data)).to(part.dtype)
            assert part.shape == ref.shape and torch.equal(part, ref), path
            n += 1
        assert torch.equal(leaf.gather(), want[path]), path
    assert n == 4 * len(jleaves)
    assert pstate["params"]["blocks"]["ln1"]["scale"].spec == (None, "data")
    assert pstate["params"]["blocks"]["attn"]["wo"].spec == \
        (None, "model", None)
    assert pstate["opt"]["m"]["embed"]["table"].spec == ("model", None)


def test_late_combine_equals_the_reference_shard_map():
    """The MoE layer alone on a 1x2 mesh: the port's shards (the router
    whole, each the expert weights' d_ff half) against the reference's
    ``_apply_moe_shard_map``: output, router softmax and the gradients of
    sum(out·w) with respect to x and every weight."""
    mesh = jax_mesh((1, 2), ("data", "model"))
    rules = jsh.default_rules(mesh)
    E, K, D, F, B, S = 4, 2, 32, 16, 2, 12
    jh = jmoe.MoEHyper(n_experts=E, top_k=K, d_model=D, d_ff=F,
                       late_combine=True)
    p = jax.tree.map(lambda b: b.value, jmoe.init_moe(jax.random.PRNGKey(3),
                                                      jh, jnp.float32),
                     is_leaf=lambda b: hasattr(b, "axes"))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    w = rng.normal(size=(B, S, D)).astype(np.float32)

    def jloss(p, x):
        out, probs = jmoe.apply_moe(p, x, jh, rules)
        return jnp.sum(out * w), (out, probs)

    with jsh.mesh_context(mesh):
        (_, (jout, jprobs)), jg = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    th = tmoe.MoEHyper(n_experts=E, top_k=K, d_model=D, d_ff=F)
    halves = {"w_up": 2, "w_gate": 2, "w_down": 1}
    tw = torch.from_numpy(w)

    def early_sum(ps, xs, h):
        """The reference's default order over the shards: the partial
        expert outputs summed before the combine (the port combines
        late only; this is the comparison)."""
        B, S, _ = xs[0].shape
        routes = [tmoe.route(p, x, h) for p, x in zip(ps, xs)]
        whole = reduce_from_shards([
            tmoe._experts(p, tmoe._dispatch(x, r[1], h), h)
            for p, x, r in zip(ps, copy_to_shards(xs), routes)])
        return ([tmoe._combine(o, r[1], r[0], B, S, h)
                 for o, r in zip(whole, routes)], [r[2] for r in routes])

    def shards(apply):
        """Each shard's own leaves (the router whole, the expert weights'
        d_ff half) and input copy; every shard's loss is a root, as each
        rank of a tensor-parallel step runs its own backward."""
        ps = [{k: (torch.from_numpy(np.array(v)).chunk(2, halves[k])[m]
                   if k in halves else torch.from_numpy(np.array(v)))
               .requires_grad_(True) for k, v in p.items()}
              for m in range(2)]
        xs = [torch.from_numpy(x).requires_grad_(True) for _ in range(2)]
        outs, probs = apply(ps, xs, th)
        torch.autograd.backward([(o * tw).sum() for o in outs])
        return ps, xs, outs, probs

    jgp, jgx = jg
    for apply in (tmoe.apply_moe_sharded, early_sum):
        ps, xs, outs, probs = shards(apply)
        for o in outs:
            np.testing.assert_allclose(o.detach().numpy(), np.asarray(jout),
                                       rtol=1e-5, atol=1e-5)
        for pr in probs:
            np.testing.assert_allclose(pr.detach().numpy(),
                                       np.asarray(jprobs), rtol=1e-6,
                                       atol=1e-7)
        for k in p:
            want = np.asarray(jgp[k])
            got = [q[k].grad.numpy() for q in ps]
            got = (np.concatenate(got, halves[k]) if k in halves else got)
            for g in (got if k not in halves else [got]):
                assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max(), k
        for t in xs:
            assert np.abs(t.grad.numpy() - np.asarray(jgx)).max() \
                <= 1e-5 * np.abs(np.asarray(jgx)).max()


@pytest.mark.parametrize("heads,kv,shape", [
    (6, 3, (1, 2)),      # a shard's heads read two K/V heads unevenly
    (8, 2, (1, 4)),      # each shard's heads read one gathered K/V head
    (4, 4, (2, 2)),      # each shard reads its own K/V slice, no gather
])
def test_head_layouts_over_the_model_axis(heads, kv, shape):
    """Every way a shard's query heads can read the K/V heads: the 1x1
    function within the tolerances above."""
    cfg = reduced_for_smoke(get_arch("qwen2-7b")).scaled(n_heads=heads,
                                                         n_kv_heads=kv)
    batch = _tb(_batch(cfg.vocab_size, seq=16))
    runs = []
    for sh in ((1, 1), shape):
        tt = Trainer(Model(cfg, device="cpu", model_axis=sh[1]),
                     AdamWConfig(lr=LR), loss_chunks=4)
        st = ShardedTrainer(tt, _cpu_mesh(sh))
        state, out = st.init_state(0), []
        for _ in range(2):
            state, m = st.train_step(state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append(out)
    for (l1, g1), (l2, g2) in zip(*runs):
        np.testing.assert_allclose(l2, l1, rtol=LOSS_RTOL)
        np.testing.assert_allclose(g2, g1, rtol=GNORM_RTOL)


def test_moe_aux_comes_from_global_means():
    """granite smoke at 2x1 on a batch whose two halves route apart: the
    step's aux equals the whole batch's (the 1x1 Trainer's), not the mean
    of the halves' auxes (f·P is not linear)."""
    cfg = reduced_for_smoke(get_arch("granite-moe-1b-a400m"))
    tt = Trainer(Model(cfg, device="cpu"), AdamWConfig(lr=LR), loss_chunks=4)
    whole = tt.init_state(0)
    rng = np.random.default_rng(9)
    toks = np.concatenate([rng.integers(0, 8, (2, 33)),
                           rng.integers(128, 256, (2, 33))])
    batch = _tb({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    _, parts, _ = tt.value_and_grad(whole["params"], batch)
    halves = [float(tt.value_and_grad(
        whole["params"], {k: v[i:i + 2] for k, v in batch.items()})[1]["aux"])
        for i in (0, 2)]
    st = ShardedTrainer(tt, _cpu_mesh((2, 1)))
    _, m = st.train_step(st.place_state(whole), batch)
    np.testing.assert_allclose(float(m["aux"]), float(parts["aux"]),
                               rtol=1e-6)
    assert abs(float(m["aux"]) - sum(halves) / 2) > 100 * 1e-6 * float(
        m["aux"])


@pytest.mark.parametrize("name", ["qwen2-7b", "granite-moe-1b-a400m"])
def test_the_plain_trainer_is_the_mesh_step_on_one_shard(name):
    """The plain ``Trainer`` and ``ShardedTrainer`` over a 1x1 mesh run
    one training forward and one loss (``transformer.
    lm_train_forward_shards``, ``train_step.chunked_ce_loss_shards``), so
    three steps give the same losses, auxes, gradient norms and state,
    bit for bit."""
    cfg = reduced_for_smoke(get_arch(name))
    tt = Trainer(Model(cfg, device="cpu"), AdamWConfig(lr=LR), loss_chunks=4)
    batch = _tb(_batch(cfg.vocab_size))
    st = ShardedTrainer(tt, _cpu_mesh((1, 1)))
    plain, placed = tt.init_state(0), st.init_state(0)
    for _ in range(STEPS):
        plain, m1 = tt.train_step(plain, batch)
        placed, m2 = st.train_step(placed, batch)
        for k in ("loss", "aux", "grad_norm"):
            assert float(m1[k]) == float(m2[k]), k
    _equal_trees(st.gather_state(placed), plain)


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "whisper-medium",
                                  "zamba2-2.7b"])
def test_data_axis_trains_the_other_families(name):
    """Over data=2 (falcon through kernel #6's plain version): the 1x1
    function, within the tolerances above; a model axis is refused."""
    cfg = reduced_for_smoke(get_arch(name))
    tt = Trainer(Model(cfg, device="cpu"), AdamWConfig(lr=LR), loss_chunks=4)
    batch = _tb(_batch(cfg.vocab_size, seq=16)) | side_inputs(
        cfg, 4, frames=16, seed=2)
    one, two = tt.init_state(0), None
    st = ShardedTrainer(tt, _cpu_mesh((2, 1)))
    two = st.place_state(one)
    for _ in range(2):
        one, m1 = tt.train_step(one, batch)
        two, m2 = st.train_step(two, batch)
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m2["grad_norm"]),
                                   float(m1["grad_norm"]), rtol=GNORM_RTOL)
    got = dict(tree_paths(st.gather_state(two)["params"]))
    for path, want in tree_paths(one["params"]):
        assert float((got[path] - want).abs().max()) <= \
            LEAF_REL * float(want.abs().max()) + 2 * 2 * LR * 0.01, path
    with pytest.raises(ValueError, match="ROADMAP.md, queue 1"):
        ShardedTrainer(tt, _cpu_mesh((1, 2)))


def test_unimplemented_rules_are_refused():
    from repro_torch.distributed import sharding as tsh
    cfg = reduced_for_smoke(get_arch("qwen2-7b"))
    tt = Trainer(Model(cfg, device="cpu", model_axis=2))
    mesh = _cpu_mesh((2, 2))
    for rules, what in ((tsh.default_rules(mesh, seq_shard=True), "seq"),
                        (tsh.fsdp_rules(mesh), "fsdp"),
                        (tsh.default_rules(mesh, long_context=True),
                         "long_context"),
                        (tsh.default_rules(mesh).with_rules(
                            d_ff=("data", "model")), "d_ff")):
        with pytest.raises(ValueError, match=what):
            ShardedTrainer(tt, mesh, rules)
    cfg6 = cfg.scaled(n_heads=6, n_kv_heads=2)
    with pytest.raises(ValueError, match="model_axis=4"):
        ShardedTrainer(Trainer(Model(cfg6, device="cpu")), _cpu_mesh((1, 4)))


# ------------------------------------------------------------ checkpoints
def test_checkpoints_restore_onto_any_mesh(tmp_path):
    """A state saved at 2x2 restores at 1x1 bit for bit, and the reverse;
    the files hold the whole state either way."""
    cfg = reduced_for_smoke(get_arch("qwen2-7b"))
    tt = Trainer(Model(cfg, device="cpu", model_axis=2), AdamWConfig(lr=LR))
    big, small = (ShardedTrainer(tt, _cpu_mesh(s)) for s in ((2, 2), (1, 1)))
    state = big.init_state(0)
    state, _ = big.train_step(state, _tb(_batch(cfg.vocab_size, seq=16)))
    CheckpointManager(str(tmp_path / "a")).save(1, state, wait=True)
    step, got = CheckpointManager(str(tmp_path / "a")).restore(
        small.init_state(1))
    assert step == 1
    _equal_trees(small.gather_state(got), big.gather_state(state))
    CheckpointManager(str(tmp_path / "b")).save(2, got, wait=True)
    _, back = CheckpointManager(str(tmp_path / "b")).restore(
        big.init_state(2))
    for (path, x), (_, y) in zip(tree_paths(back), tree_paths(state)):
        assert x.spec == y.spec and all(
            torch.equal(a, b) for a, b in zip(x.parts, y.parts)), path
    _, plain = CheckpointManager(str(tmp_path / "b")).restore(
        tt.init_state(3))
    _equal_trees(plain, big.gather_state(state))


def test_train_cli_restarts_at_2x2_bitwise(tmp_path, capsys):
    argv = ["--device", "cpu", "--mesh", "2x2", "--steps", "6", "--seq",
            "16", "--batch", "4", "--ckpt-every", "2"]
    out = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "a"),
                                 "--fail-at", "3"])
    text = capsys.readouterr().out
    assert out["report"]["restarts"] == 1 and out["report"]["final_step"] == 6
    assert "2x2 mesh over cpu, cpu, cpu, cpu" in text
    clean = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert clean["report"]["restarts"] == 0
    assert out["losses"] == clean["losses"]
    _equal_trees(out["state"], clean["state"])
    late = train_cli.main(["--device", "cpu", "--mesh", "1x2", "--arch",
                           "granite-moe-1b-a400m",
                           "--steps", "2", "--seq", "16", "--batch", "2",
                           "--ckpt-dir", str(tmp_path / "c")])
    assert late["report"]["final_step"] == 2
    assert all(v == v and abs(v) < 1e4 for v in late["losses"].values())
    assert all(t.device.type == "cpu" for t in tree_leaves(late["state"]))


def test_batch_at_splits_evenly():
    with pytest.raises(ValueError, match="does not split"):
        cfg = reduced_for_smoke(get_arch("qwen2-7b"))
        st = ShardedTrainer(Trainer(Model(cfg, device="cpu")),
                            _cpu_mesh((2, 1)))
        st.train_step(st.init_state(0),
                      batch_at(DataConfig(cfg.vocab_size, 8, 3), 0))
