"""The port's sharding rules, placement and compression against the JAX
package's (``distributed/{sharding,compression}.py``).

The reference runs under the 4 host devices ``tests/conftest.py``
forces; the port places over CPU shards of an explicit mesh. Specs, head
padding and axis trees must be equal; placed parts are slices, so they
are held bitwise to the reference's ``addressable_shards`` in
``tests/test_torch_sharded_training.py``. Tolerances:
``compressed_psum`` in bf16 within two bf16 roundings (2^-7) of the
largest sum, since the two frameworks may add the four shards in another
order and precision; in int8 exactly (integer sums, one fp32 product).
The padded-heads tests train at lr 1e-2 for 4 steps, where the
reference's padded wo rows move well away from zero."""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.configs import get_arch as jax_arch
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jsh
from repro.launch.mesh import make_mesh as jax_mesh
from repro.models import Model as JaxModel
from repro.models.module import split
from repro.training import AdamWConfig as JaxAdamW
from repro.training import Trainer as JaxTrainer
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.configs import REGISTRY, get_arch
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params, from_jax_train_state
from repro_torch.models.layers.attention import live_q_columns
from repro_torch.training import AdamWConfig, Trainer
from repro_torch.training.sharded import ShardedTrainer

LOGICAL = ("batch", "seq", "kv_seq", "d_model", "heads", "kv_heads",
           "head_dim", "qkv_out", "kv_out", "o_in", "d_ff", "vocab",
           "experts", "layers", "fsdp", "opt_fsdp", "ssm_inner", "ssm_state",
           "ssm_heads", "conv_w", "dt_rank", None, "unknown")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(shape):
    return (jax_mesh(shape, ("data", "model")),
            make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape))))


RULES = {"default": lambda m: {},
         "seq_shard": lambda m: {"seq_shard": True},
         "long_context": lambda m: {"long_context": True}}


@pytest.mark.parametrize("kind", ["default", "seq_shard", "long_context",
                                  "fsdp"])
def test_specs_equal_the_reference(kind):
    jm, tm = _meshes((2, 2))
    if kind == "fsdp":
        jr, tr = jsh.fsdp_rules(jm), tsh.fsdp_rules(tm)
    else:
        jr = jsh.default_rules(jm, **RULES[kind](jm))
        tr = tsh.default_rules(tm, **RULES[kind](tm))
    assert {k: v for k, v in tr.rules.items()} == \
        {k: v for k, v in jr.rules.items()}
    for n in (1, 2, 3):
        for axes in itertools.product(LOGICAL, repeat=n):
            assert tr.spec(axes) == tuple(jr.spec(axes)), axes


def test_spec_dedup_and_with_rules():
    jm, tm = _meshes((2, 2))
    jr = jsh.default_rules(jm).with_rules(a=("data", "model"), b=("data",))
    tr = tsh.default_rules(tm).with_rules(a=("data", "model"), b=("data",))
    for axes in (("a", "b"), ("b", "a"), ("a", "a"), ("heads", "a"),
                 ("vocab", "d_ff", "batch")):
        spec = tr.spec(axes)
        assert spec == tuple(jr.spec(axes)), axes
        flat = [a for e in spec for a in tsh.entry_axes(e)]
        assert len(flat) == len(set(flat)), axes
    assert tsh.data_axes_of(tm) == jsh.data_axes_of(jm) == ("data",)
    assert tsh.mesh_axis_size(tm, "model") == jsh.mesh_axis_size(jm,
                                                                 "model")
    assert tsh.mesh_axis_size(tm, "pod") == 1


def test_pad_heads_equals_the_reference_over_the_grid():
    """The grid ``tests/test_sharding.py`` draws from, exhaustively."""
    for kv, ratio, axis in itertools.product([1, 2, 4, 8, 16, 32],
                                             range(1, 17), [1, 2, 4, 8, 16]):
        assert tsh.pad_heads(kv * ratio, kv, axis) == \
            jsh.pad_heads(kv * ratio, kv, axis)
    assert tsh.pad_heads(0, 0, 4) == (0, 0)


def _jax_axes(name, model_axis=1):
    jm = JaxModel(jax_reduced(jax_arch(name)),
                  rules=jsh.default_rules(jax_mesh((1, 1),
                                                   ("data", "model"))),
                  model_axis=model_axis, dtype=jnp.float32)
    return split(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))[1], jm


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_param_and_state_axes_equal_the_reference(name):
    jaxes, jm = _jax_axes(name)
    model = Model(reduced_for_smoke(get_arch(name)), device="cpu")
    assert model.param_axes() == jaxes
    jt = JaxTrainer(jm, jm.rules, JaxAdamW(error_feedback=True))
    jstate = jax.eval_shape(lambda r: jt.init_state(r)[0],
                            jax.random.PRNGKey(0))
    tt = Trainer(model, AdamWConfig(error_feedback=True))
    tstate = tt.init_state(0)
    for data in (1, 2, 4):
        assert tt.state_axes(model.param_axes(), tstate, data) == \
            jt.state_axes(jaxes, jstate, data), data


def test_widths_that_do_not_divide_are_refused():
    """At 1x3, kv_out = 16 does not divide by 3: the reference's
    device_put raises, and the port names the leaf."""
    devices = jax.devices()[:3]
    jmesh = jax.make_mesh((1, 3), ("data", "model"), devices=devices)
    rules = jsh.default_rules(jmesh)
    cfg = jax_reduced(jax_arch("qwen2-7b"))
    jm = JaxModel(cfg, rules=rules, model_axis=3, dtype=jnp.float32)
    jt = JaxTrainer(jm, rules, JaxAdamW())
    key = jax.random.PRNGKey(0)
    jstate = jax.jit(lambda r: jt.init_state(r)[0])(key)
    axes = split(jax.eval_shape(jm.init, key))[1]
    with pytest.raises(ValueError):
        jax.device_put(jstate, rules.tree_shardings(
            jmesh, jt.state_axes(axes, jstate, 1)))
    tcfg = reduced_for_smoke(get_arch("qwen2-7b"))
    st = ShardedTrainer(Trainer(Model(tcfg, device="cpu", model_axis=3)),
                        make_mesh((1, 3), ("data", "model"), ["cpu"] * 3))
    with pytest.raises(ValueError, match=r"^params/\S+: dimension \d+ "
                       r"\(\d+\) does not divide over mesh axes"):
        st.init_state(0)
    with pytest.raises(ValueError, match=r"^params/blocks/attn/wk: "
                       r"dimension 2 \(16\)"):
        tsh.place(torch.zeros(4, 64, 16), (None, None, "model"),
                  st.mesh, "params/blocks/attn/wk")


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("int8", [False, True])
def test_compressed_psum_equals_the_reference(int8):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(4, 96)) * rng.uniform(0.1, 50, (4, 1))).astype(
        np.float32)
    mesh = jax.make_mesh((4,), ("x",), devices=jax.devices()[:4])
    fn = shard_map(lambda a: jcomp.compressed_psum(a[0], "x", int8=int8)[None],
                   mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                   check_rep=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)), np.float32)
    got = tcomp.compressed_psum([torch.from_numpy(r) for r in x], int8=int8)
    assert len(got) == 4
    for g, w in zip(got, want):
        g = g.float().numpy()
        if int8:
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g - w).max() <= 2.0 ** -7 * np.abs(w).max()
    assert got[0].dtype == (torch.float32 if int8 else torch.bfloat16)


@pytest.mark.parametrize("seed", [64509, 0, 1, 2, 3, 7, 1234, 2 ** 31 - 1])
def test_int8_quantization_bound_with_fp32_rounding(seed):
    """The reference's |dequantize(quantize(x)) - x| <= scale/2 bound,
    with an allowance for fp32 rounding: x/scale rounds by at most
    127·2^-24 before the integer rounding (max|x|·2^-24 after the
    multiply by scale), and q·scale rounds by max|x|·2^-24 again;
    4·max|x|·2^-24 covers both. Seed 64509 is the draw whose fp32
    rounding breaks the reference test's bound without the allowance."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(64,)) * rng.uniform(0.1, 100)).astype(np.float32)
    q, s = tcomp.quantize_int8(torch.from_numpy(x))
    back = tcomp.dequantize_int8(q, s)
    err = float((back - torch.from_numpy(x)).abs().max())
    allowance = 4 * float(np.abs(x).max()) * 2.0 ** -24
    assert err <= float(s) * 0.5 + allowance
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    assert torch.equal(q, torch.from_numpy(np.asarray(jq)))
    assert float(s) == float(js)
    if seed == 64509:                   # the reference bound, no allowance
        jerr = float(jnp.abs(jcomp.dequantize_int8(jq, js) - x).max())
        assert jerr > float(js) * 0.5 + 1e-9


def test_tree_cast_bf16_matches_the_reference():
    tree = {"w": torch.ones(3), "i": torch.ones(2, dtype=torch.int32),
            "n": {"v": torch.full((2,), 1.2345678)}}
    out = tcomp.tree_cast_bf16(tree)
    ref = jcomp.tree_cast_bf16(jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                            tree))
    assert out["w"].dtype == torch.bfloat16 and out["i"].dtype == torch.int32
    assert float(out["n"]["v"][0]) == float(ref["n"]["v"][0])


# ------------------------------------------------------------ padded heads
PAD_STEPS, PAD_LR = 4, 1e-2


def _padded_cfgs():
    """qwen2-7b smoke with 6 query heads over 2 KV heads: at a model axis
    of 4 the group of 3 pads to 4 (8 heads)."""
    jcfg = jax_reduced(jax_arch("qwen2-7b")).scaled(n_heads=6, n_kv_heads=2)
    tcfg = reduced_for_smoke(get_arch("qwen2-7b")).scaled(n_heads=6,
                                                          n_kv_heads=2)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _padded_setup():
    jcfg, tcfg = _padded_cfgs()
    rules = jsh.default_rules(jax_mesh((1, 1), ("data", "model")))
    jm = JaxModel(jcfg, rules=rules, model_axis=4, dtype=jnp.float32,
                  remat="full")
    jt = JaxTrainer(jm, rules, JaxAdamW(lr=PAD_LR), loss_chunks=4)
    jstate = jax.jit(lambda r: jt.init_state(r)[0])(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, 33))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return jcfg, tcfg, jt, jstate, batch


def _live(tcfg):
    from repro_torch.models.layers.attention import AttnHyper
    h = AttnHyper(n_heads=6, n_kv_heads=2, head_dim=tcfg.head_dim_,
                  padded_heads=8)
    return live_q_columns(h).numpy()


def test_reference_padded_heads_leave_zero_under_training():
    """A reference fault the port does not copy: init zeroes the padded
    heads' wq/wo slices, but the padded query's attention output is a
    mean of V, so the padded rows of wo take a gradient and train."""
    jcfg, tcfg, jt, jstate, batch = _padded_setup()
    live = _live(tcfg)
    wo = np.asarray(jstate["params"]["blocks"]["attn"]["wo"])
    assert wo.shape[1] == 8 * tcfg.head_dim_ and not wo[:, ~live].any()
    step = jax.jit(jt.train_step)
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    for _ in range(PAD_STEPS):
        jstate, _ = step(jstate, jb)
    wo = np.asarray(jstate["params"]["blocks"]["attn"]["wo"])
    assert np.abs(wo[:, ~live]).max() > 0.01 * np.abs(wo[:, live]).max()


def test_port_padded_heads_stay_zero_and_live_gradients_match():
    jcfg, tcfg, jt, jstate, batch = _padded_setup()
    live = torch.from_numpy(_live(tcfg))
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    jg = jax.jit(jax.grad(lambda p, b: jt.loss_fn(p, b)[0]))(
        jstate["params"], jb)
    tt = Trainer(Model(tcfg, device="cpu", model_axis=4),
                 AdamWConfig(lr=PAD_LR), loss_chunks=4)
    state = from_jax_train_state(jax.tree.map(np.asarray, jstate), tcfg,
                                 device="cpu", model_axis=4)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, grads = tt.value_and_grad(state["params"], tb)
    want = from_jax_params(jax.tree.map(np.asarray, jg), tcfg, device="cpu",
                           model_axis=4)
    for name, cols in (("wq", (slice(None), slice(None), live)),
                       ("wo", (slice(None), live)),
                       ("bq", (slice(None), live))):
        g, w = grads["blocks"]["attn"][name], want["blocks"]["attn"][name]
        err = float((g[cols] - w[cols]).abs().max())
        assert err <= 1e-4 * float(w[cols].abs().max()), name
        pad = (slice(None), slice(None), ~live) if name == "wq" \
            else (slice(None), ~live)
        assert not g[pad].any(), name
    for _ in range(PAD_STEPS):
        state, _ = tt.train_step(state, tb)
    a = state["params"]["blocks"]["attn"]
    assert not a["wo"][:, ~live].any() and not a["wq"][:, :, ~live].any()
    assert not a["bq"][:, ~live].any()
    assert a["wo"][:, live].abs().max() > 0
    # and over a (1, 4) mesh, where every model shard holds two heads
    st = ShardedTrainer(tt, make_mesh((1, 4), ("data", "model"),
                                      ["cpu"] * 4))
    pstate = st.init_state(0)
    for _ in range(2):
        pstate, _ = st.train_step(pstate, tb)
    a = st.gather_state(pstate)["params"]["blocks"]["attn"]
    assert not a["wo"][:, ~live].any() and not a["wq"][:, :, ~live].any()
