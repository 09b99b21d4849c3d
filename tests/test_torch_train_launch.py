"""The port's training substrate: the twins of tests/test_training.py
(convergence, deterministic and resumable data, checkpoint round trips
with retention, supervised restarts, the supervisor giving up, ZeRO-1
axes), the serving traces and input shapes against the JAX package's
(exactly), and ``launch/train.py`` on the CPU for every family, with its
refusal."""
import dataclasses

import pytest
import torch

from repro.config.shapes import cells_for as jax_cells_for
from repro.configs import get_arch as jax_arch
from repro.training.data import leval_trace as jax_leval
from repro.training.data import sharegpt_trace as jax_sharegpt
from repro.training.optimizer import opt_axes as jax_opt_axes
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.config.shapes import ALL_SHAPES, cells_for
from repro_torch.configs import REGISTRY, get_arch
from repro_torch.distributed.fault import (FailureInjector, InjectedFailure,
                                           run_supervised)
from repro_torch.launch import train as train_cli
from repro_torch.models import Model
from repro_torch.training import (CARD_TRAIN_SHAPES, AdamWConfig,
                                  CheckpointManager, DataConfig, Trainer,
                                  batch_at, leval_trace, sharegpt_trace,
                                  side_inputs)
from repro_torch.training.optimizer import opt_axes, opt_axes_tree
from repro_torch.training.tree import tree_leaves, tree_map


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trainer():
    cfg = reduced_for_smoke(get_arch("qwen2-7b"))
    model = Model(cfg, device="cpu")
    return cfg, Trainer(model, AdamWConfig(lr=1e-3), loss_chunks=4)


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_loss_decreases(trainer):
    cfg, tr = trainer
    state = tr.init_state(0)
    batch = batch_at(DataConfig(cfg.vocab_size, 32, 4), 0)
    losses = []
    for _ in range(6):
        state, m = tr.train_step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_data_deterministic_and_resumable():
    dc = DataConfig(vocab_size=1000, seq_len=16, global_batch=2, seed=7)
    a, b, c = batch_at(dc, 41), batch_at(dc, 41), batch_at(dc, 42)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], batch_at(
        dataclasses.replace(dc, seed=8), 41)["tokens"])
    # next-token targets
    full = torch.cat([a["tokens"], a["targets"][:, -1:]], dim=1)
    assert torch.equal(full[:, 1:], a["targets"])
    assert a["tokens"].shape == (2, 16) and int(a["tokens"].max()) < 1000


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_roundtrip(tmp_path, trainer, dtype):
    cfg, tr = trainer
    state = tr.init_state(0)
    state["params"] = tree_map(lambda x: x.to(dtype), state["params"])
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (3, 7, 11):
        mgr.save(s, state, wait=s == 11)
    mgr.wait()
    assert mgr.all_steps() == [7, 11]          # retention
    assert not list(tmp_path.glob("*.tmp"))
    assert (tmp_path / "step_000000011" / "manifest.json").exists()
    assert (tmp_path / "step_000000011" / "leaf_00000.npy").exists()
    step, restored = mgr.restore(state)
    assert step == 11
    _equal_trees(restored, state)              # bf16 bit for bit
    # onto another dtype: each leaf takes the dtype of ``like``'s
    like = tree_map(lambda x: x.to(torch.float64)
                    if x.is_floating_point() else x, state)
    _, wide = mgr.restore(like, step=7)
    assert all(x.dtype == y.dtype for x, y in
               zip(tree_leaves(wide), tree_leaves(like)))


def test_checkpoint_refuses_another_tree(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"a": torch.zeros(2)}, wait=True)
    with pytest.raises(ValueError):
        mgr.restore({"b": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})


def _supervised(tmp, tr, dc, fail_at):
    state = tr.init_state(0)
    live = {"state": state}
    injector = FailureInjector(fail_at=fail_at)

    def one(step):
        injector.check(step)
        live["state"], m = tr.train_step(live["state"], batch_at(dc, step))
        return m

    report = run_supervised(
        one, ckpt=CheckpointManager(str(tmp)),
        save_state=lambda: live["state"],
        load_state=lambda s, st: live.update(state=st),
        n_steps=12, ckpt_every=3)
    return live["state"], report


def test_supervised_restart_reproduces_uninterrupted_run(tmp_path, trainer):
    """A failure injected at step 7 lands, after the restart from step 6's
    checkpoint, bit for bit on the uninterrupted run's state."""
    cfg, tr = trainer
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    clean, r0 = _supervised(tmp_path / "clean", tr, dc, ())
    faulty, r1 = _supervised(tmp_path / "faulty", tr, dc, (7,))
    assert r1.restarts == 1 and r0.restarts == 0
    assert r1.steps_run == r0.steps_run == 12 and r1.final_step == 12
    _equal_trees(faulty, clean)


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    calls = []

    def one(step):
        calls.append(step)
        raise InjectedFailure("always")

    with pytest.raises(InjectedFailure):
        run_supervised(one, ckpt=CheckpointManager(str(tmp_path)),
                       save_state=lambda: {"x": torch.zeros(())},
                       load_state=lambda s, st: None,
                       n_steps=5, max_restarts=2)
    assert len(calls) == 3


def test_opt_axes_match_jax():
    cases = [(("vocab", None), (1024, 512), 16),
             ((None, "d_ff"), (333, 512), 16),
             ((None, None), (64, 128), 16),
             ((None, None, None), (7, 9, 11), 4)]
    for axes, shape, n in cases:
        assert opt_axes(axes, shape, n) == jax_opt_axes(axes, shape, n)
    tree = opt_axes_tree({"a": ("vocab", None), "b": {"c": (None,)}},
                         {"a": torch.zeros(32, 16), "b": {"c": torch.zeros(8)}},
                         4)
    assert tree == {"a": ("vocab", "opt_fsdp"), "b": {"c": ("opt_fsdp",)}}


# ----------------------------------------------------- traces and shapes
@pytest.mark.parametrize("kwargs", [dict(n_sessions=8, rounds_per_session=3,
                                         seed=1),
                                    dict(n_sessions=5, rate=0.5,
                                         round_interval=10.0, seed=4)])
def test_sharegpt_trace_equals_jax(kwargs):
    assert [dataclasses.astuple(r) for r in sharegpt_trace(**kwargs)] == \
        [dataclasses.astuple(r) for r in jax_sharegpt(**kwargs)]


@pytest.mark.parametrize("kwargs", [dict(n_requests=20, seed=2),
                                    dict(n_requests=30, seed=3,
                                         zipf_alpha=1.1, n_contexts=12)])
def test_leval_trace_equals_jax(kwargs):
    assert [dataclasses.astuple(r) for r in leval_trace(**kwargs)] == \
        [dataclasses.astuple(r) for r in jax_leval(**kwargs)]


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_cells_for_equals_jax(name):
    got = [(dataclasses.astuple(s), why) for s, why in
           cells_for(get_arch(name))]
    want = [(dataclasses.astuple(s), why) for s, why in
            jax_cells_for(jax_arch(name))]
    assert got == want and len(got) == len(ALL_SHAPES)


# ---------------------------------------------------------- launch/train
@pytest.mark.parametrize("arch", list(CARD_TRAIN_SHAPES))
def test_side_inputs_and_card_train_shapes(arch):
    """Each card training shape cuts its config to a depth the family
    takes, and ``side_inputs`` gives an enc-dec frames and a VLM patches
    of its width: zeros without a seed (no patches then, as the JAX
    package's launcher), the same normals for the same seed."""
    layers, batch, seq = CARD_TRAIN_SHAPES[arch]
    full = get_arch(arch)
    cfg = full if layers is None else full.scaled(n_layers=layers)
    assert cfg.n_layers == (layers or full.n_layers) and batch * seq > 0
    kinds = (["frames"] if cfg.is_encoder_decoder else []) + \
        (["patches"] if cfg.family == "vlm" else [])
    small = reduced_for_smoke(full)
    a = side_inputs(small, 2, frames=6, patches=3, seed=5)
    assert sorted(a) == sorted(kinds)
    for k, t in a.items():
        assert t.shape == (2, 6 if k == "frames" else 3, small.d_model)
        assert t.dtype == torch.float32 and bool(t.any())
        assert torch.equal(t, side_inputs(small, 2, frames=6, patches=3,
                                          seed=5)[k])
    zeros = side_inputs(small, 2, frames=6)
    assert sorted(zeros) == (["frames"] if cfg.is_encoder_decoder else [])
    assert not any(bool(t.any()) for t in zeros.values())


def test_train_cli_runs_and_restarts_on_the_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--arch", "llama2-7b", "--steps", "5",
            "--seq", "16", "--batch", "2", "--ckpt-every", "2",
            "--layers", "2"]
    out = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "a"),
                                 "--fail-at", "3"])
    text = capsys.readouterr().out
    assert out["report"]["restarts"] == 1 and out["report"]["final_step"] == 5
    assert "step     4 loss" in text and "wall" in text and "gnorm" in text
    assert "llama2-7b: 2 layers" in text
    clean = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert clean["report"]["restarts"] == 0
    _equal_trees(out["state"], clean["state"])


def test_train_cli_refuses_the_cpu_without_a_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--ckpt-dir", str(tmp_path), "--steps", "1"])
    assert not list(tmp_path.iterdir())


def test_train_cli_refuses_unported_parts(tmp_path, monkeypatch):
    """A model axis over an ssm block is refused, and so is a mesh with
    more shards than visible cards (never a smaller mesh)."""
    base = ["--ckpt-dir", str(tmp_path)]
    with pytest.raises(ValueError, match="ROADMAP.md, queue 1"):
        train_cli.main(base + ["--device", "cpu", "--arch",
                               "falcon-mamba-7b", "--mesh", "1x2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ValueError, match="needs 4 cards, but 3"):
        train_cli.main(base + ["--mesh", "2x2"])
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "grok-1-314b",
                                  "internvl2-26b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "whisper-medium"])
def test_train_cli_trains_every_family_and_restarts(tmp_path, capsys, arch):
    """Each family trains through ``launch/train.py`` on the CPU (an
    enc-dec batch with zero frames), and a failure injected at step 3
    lands, after the restart, bit for bit on the uninterrupted run."""
    argv = ["--device", "cpu", "--arch", arch, "--steps", "5", "--seq",
            "16", "--batch", "2", "--ckpt-every", "2"]
    out = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "a"),
                                 "--fail-at", "3"])
    text = capsys.readouterr().out
    assert out["report"]["restarts"] == 1 and out["report"]["final_step"] == 5
    assert f"{arch}: " in text and "step     4 loss" in text
    assert all(v == v and abs(v) < 1e4 for v in out["losses"].values())
    clean = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert clean["report"]["restarts"] == 0
    _equal_trees(out["state"], clean["state"])
    if get_arch(arch).n_experts:            # the aux reached the loss
        cfg = reduced_for_smoke(get_arch(arch))
        tr = Trainer(Model(cfg, device="cpu"), AdamWConfig(lr=1e-3))
        _, parts, _ = tr.value_and_grad(
            clean["state"]["params"],
            batch_at(DataConfig(cfg.vocab_size, 16, 2), 0))
        assert float(parts["aux"]) > 0
