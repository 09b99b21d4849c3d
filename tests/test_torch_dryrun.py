"""The port's dry-run (``repro_torch/launch/dryrun.py``): a cell counted
on ``meta`` devices equals the same cell executed on the CPU and counted,
key by key and shard by shard; counts attribute work to the shard that
did it where shards share a device; the pod mesh gives the (data x model)
mesh's bits; counted FLOPs agree with the JAX package's ``analyze_hlo``;
``run_cell``'s records and ``main --list`` follow the reference's."""
import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.config import shapes as jax_shapes
from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.config.shapes import (DECODE_32K, LONG_500K, PREFILL_32K,
                                       RESTORE_32K, SHAPES_BY_NAME, TRAIN_4K)
from repro_torch.configs import get_arch
from repro_torch.distributed.mesh_serving import MeshServer
from repro_torch.kernels import restore_kv as rkv
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import Model

KINDS = {"train": TRAIN_4K, "prefill": PREFILL_32K, "restore": RESTORE_32K,
         "decode": DECODE_32K, "long": LONG_500K}
# what a record holds beside the reference's keys, and what it lacks
PORT_ONLY = {"build_s", "count_s", "launches", "launches_total"}
REF_ONLY = {"lower_s", "compile_s", "xla_flops_once", "xla_bytes_once"}
REF_KEYS = {"cell", "arch", "shape", "mesh", "chips", "variant", "flops",
            "bytes_accessed", "bytes_all", "collectives", "collective_bytes",
            "peak_memory", "temp_bytes", "arg_bytes", "out_bytes", "lower_s",
            "compile_s", "xla_flops_once", "xla_bytes_once"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(kind, seq=32, batch=2):
    return dataclasses.replace(KINDS[kind], seq_len=seq,
                               global_batch=1 if kind == "long" else batch)


def _mesh(shape, device):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    return make_mesh(shape, axes, [device] * int(np.prod(shape)))


def _count(name, kind, mesh_shape, device, dtype=torch.float32):
    shape = _tiny(kind)
    with torch.set_grad_enabled(shape.kind == "train"):
        res = dryrun.count_cell(_mesh(mesh_shape, device),
                                reduced_for_smoke(get_arch(name)), shape,
                                device=device, dtype=dtype)
    for k in ("outputs", "build_s", "count_s"):
        res.pop(k)
    return res


CELLS = ([(name, kind, ms) for name in ("qwen2-7b", "granite-moe-1b-a400m")
          for kind in ("train", "prefill", "restore", "decode")
          for ms in ((1, 1), (1, 2), (2, 2))]
         + [("falcon-mamba-7b", kind, (1, 2))
            for kind in ("prefill", "decode", "long")])


@pytest.mark.parametrize("name,kind,mesh_shape", CELLS)
def test_meta_count_equals_the_cpu_count(name, kind, mesh_shape):
    """Every key, per shard: the kernels' formulas stand in for their
    plain versions on the CPU and for nothing at all on meta."""
    cpu = _count(name, kind, mesh_shape, "cpu")
    meta = _count(name, kind, mesh_shape, "meta")
    assert meta == cpu
    n = int(np.prod(mesh_shape))
    assert len(cpu["per_shard"]["flops"]) == n
    assert cpu["flops"] > 0 and sum(cpu["total"]["launches"].values()) > 0
    if n > 1 and kind != "restore":
        assert cpu["collective_bytes"] > 0


def test_shards_that_share_a_device_are_counted_apart():
    """A 1x2 restore on one device: each shard's one launch of kernel #1,
    at exactly its block's cost; a 2x2 prefill: four equal shards."""
    cfg = reduced_for_smoke(get_arch("qwen2-7b"))
    res = _count("qwen2-7b", "restore", (1, 2), "cpu")
    L, B, S = cfg.n_layers, 2, 32
    kv = cfg.n_kv_heads * cfg.head_dim_
    flops, nbytes = rkv.restore_cost(L, B * S // 2, cfg.d_model, kv,
                                     cfg.head_dim_, bias=cfg.qkv_bias,
                                     elem_bytes=4)
    ps = res["per_shard"]
    assert ps["launches"] == [{"restore_kv_grouped": 1}] * 2
    assert ps["flops"] == [flops] * 2
    assert all(b >= nbytes for b in ps["bytes_all"])
    pre = _count("qwen2-7b", "prefill", (2, 2), "meta")["per_shard"]
    assert len(set(pre["flops"])) == 1 and len(set(pre["bytes"])) == 1
    assert pre["launches"] == [pre["launches"][0]] * 4


def _run(mesh_shape, kind, seed=0):
    cfg = reduced_for_smoke(get_arch("qwen2-7b"))
    fn, args = dryrun.build_cell(_mesh(mesh_shape, "cpu"), cfg, _tiny(kind),
                                 seed=seed, dtype=torch.float32,
                                 device="cpu")
    with torch.set_grad_enabled(kind == "train"):
        return fn(*args)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_pod_mesh_gives_the_data_model_mesh_bits(kind):
    """(pod=2, data=1, model=2) is (data=2, model=2) with the batch over
    (pod, data) in pod-major order: the same outputs and losses, bit for
    bit."""
    a, b = _run((2, 1, 2), kind), _run((2, 2), kind)
    if kind == "train":
        for key in ("loss", "ce", "grad_norm"):
            assert torch.equal(a[1][key], b[1][key]), key
        pa, pb = a[0]["params"], b[0]["params"]
        w = (lambda t: t["blocks"]["attn"]["wq"])
        for x, y in zip(w(pa).parts, w(pb).parts):
            assert torch.equal(x, y)
        return
    assert torch.equal(a[0].gather(), b[0].gather())
    if kind == "prefill":
        assert torch.equal(a[1][0].gather(), b[1][0].gather())


def test_pod_mesh_refusals_widen_to_the_pod_axis_only():
    cfg = reduced_for_smoke(get_arch("qwen2-7b"))
    model = Model(cfg, device="cpu", model_axis=2)
    MeshServer(model, _mesh((2, 1, 2), "cpu"))
    with pytest.raises(ValueError, match="axes"):
        MeshServer(model, make_mesh((2, 2), ("model", "data"),
                                    ["cpu"] * 4))


def test_production_meshes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert {d.type for d in two.device_list()} == {"meta"}


# ------------------------------------------------ against analyze_hlo
@functools.lru_cache(maxsize=None)
def _reference_dryrun():
    """``repro.launch.dryrun``, imported after jax has its devices: at
    import it sets XLA_FLAGS for 512 host devices, which is put back."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return jd


def _reference_flops(name, kind):
    from repro.config.arch import reduced_for_smoke as jax_reduced
    from repro.configs import get_arch as jax_arch
    from repro.distributed.sharding import mesh_context
    from repro.launch.hlo_cost import analyze_hlo
    from repro.launch.mesh import make_mesh as jax_mesh
    jd = _reference_dryrun()
    shape = dataclasses.replace(
        {"train": jax_shapes.TRAIN_4K, "prefill": jax_shapes.PREFILL_32K,
         "restore": jax_shapes.RESTORE_32K,
         "decode": jax_shapes.DECODE_32K}[kind], seq_len=32, global_batch=2)
    mesh = jax_mesh((1, 1), ("data", "model"))
    with mesh_context(mesh):
        fn, args, sh, donate = jd.build_cell(
            mesh, jax_reduced(jax_arch(name)), shape, "base")
        hlo = jax.jit(fn, in_shardings=sh, donate_argnums=donate).lower(
            *args).compile().as_text()
    return analyze_hlo(hlo)["flops"]


@pytest.mark.parametrize("name", ["qwen2-7b", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("kind", ["restore", "prefill", "decode", "train"])
def test_flops_agree_with_the_reference_hlo(name, kind):
    """The restore cell is the same products (within 1 %). Elsewhere the
    port's kernel #5 counts the visible (query, key) pairs where the
    reference's attention counts whole score blocks: the gap is at most
    the masked pairs of one causal pass over every layer,
    L·4·hd·H·B·(S² − S(S+1)/2) (the reference's remat recomputes the
    attention forward as the port's does, and the backwards both take
    whole blocks). The tolerance is that gap plus 1 %: at 2 layers one
    layer counted twice or not at all moves the count by ~50 %."""
    want = _reference_flops(name, kind)
    got = _count(name, kind, (1, 1), "meta", torch.bfloat16)["flops"]
    cfg = reduced_for_smoke(get_arch(name))
    S, B = 32, 2
    masked = (cfg.n_layers * 4 * cfg.head_dim_ * cfg.n_heads * B
              * (S * S - S * (S + 1) // 2))
    gap = 0 if kind in ("restore", "decode") else masked
    tol = (gap + 0.01 * want) / want
    assert tol <= 0.10
    assert abs(got - want) <= tol * want, (got, want, tol)
    if kind == "prefill":       # exactly the masked pairs
        assert want - got == masked


# ---------------------------------------------------------- records
@pytest.fixture
def small_sweep(monkeypatch):
    """run_cell on a 2x2 (or 2x1x2) meta mesh, smoke configs, tiny
    shapes."""
    real = dryrun.get_arch
    monkeypatch.setattr(dryrun, "get_arch",
                        lambda n: reduced_for_smoke(real(n)))
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: _mesh(
                            (2, 1, 2) if multi_pod else (2, 2), "meta"))
    monkeypatch.setattr(dryrun, "SHAPES_BY_NAME", {
        n: dataclasses.replace(s, seq_len=512,
                               global_batch=1 if n == "long_500k" else 4)
        for n, s in SHAPES_BY_NAME.items()})


def test_main_all_writes_the_reference_records(small_sweep, tmp_path):
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--all", "--multipod", "--out", str(tmp_path)])
    assert exc.value.code == 1          # the refused cells
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert len(recs) == len(JAX_ASSIGNED) * len(jax_shapes.ALL_SHAPES)
    kinds = {"ok": [], "skipped": [], "error": []}
    for rec in recs.values():
        assert rec["mesh"] == "2x16x16" and rec["variant"] == "base"
        if "skipped" in rec:
            kinds["skipped"].append(rec["cell"])
        elif "error" in rec:
            assert "ROADMAP.md" in rec["error"], rec
            kinds["error"].append((rec["arch"], rec["shape"]))
        else:
            assert set(rec) == (REF_KEYS - REF_ONLY) | PORT_ONLY
            assert rec["flops"] > 0 and rec["chips"] == 4
            kinds["ok"].append(rec["cell"])
    assert len(kinds["skipped"]) == 8            # long_500k, attention
    grok = {("grok-1-314b", s.name) for s in jax_shapes.ALL_SHAPES
            if s.name != "long_500k"}
    trains = {(a, "train_4k") for a in ("falcon-mamba-7b", "zamba2-2.7b",
                                        "whisper-medium")}
    assert set(kinds["error"]) == grok | trains
    assert len(kinds["ok"]) == 26


def test_main_list_prints_the_reference_lines(capsys):
    dryrun.main(["--list"])
    want = []
    for arch, cfg in JAX_ASSIGNED.items():
        for shape in jax_shapes.ALL_SHAPES:
            skip = jax_shapes.shape_applicable(cfg, shape)
            want.append(f"{arch:24s} {shape.name:12s}"
                        + (f"  SKIP: {skip}" if skip else ""))
    assert capsys.readouterr().out.splitlines() == want
