"""The JAX package's dry-run (``repro/launch/dryrun.py``): for an (arch,
input shape, variant) cell over a (data x model) or (pod x data x model)
mesh, the cell's program and its inputs, and its counted cost.

    fn, args = build_cell(mesh, cfg, shape, "base", seed=0)
    out = fn(*args)
    rec = count_cell(mesh, cfg, shape, "base", device="meta")

``build_rules`` and ``build_model`` are the reference's. ``build_cell``
returns the program of each cell kind with inputs made from ``seed`` and
placed on the mesh:

  train    ``training/sharded.py::ShardedTrainer.train_step`` on a placed
           train state and a batch of tokens (and patches for a VLM)
  prefill  ``MeshServer.prefill`` -> the reference's ``serve_prefill``
           outputs: (logits, K/V), (logits, states), a hybrid stack's
           (logits, K/V, Mamba2 states), an enc-dec stack's (logits, self
           K/V, cross K/V) from S frames and a DEC_PROMPT-token prompt
  restore  ``MeshServer.restore_kv_from_hidden`` on hidden states placed
           as ("layers", "batch", "kv_seq", "d_model"), the paper's op:
           a hybrid stack's n_super attention blocks, an enc-dec stack's
           decoder layers
  decode   ``MeshServer.decode_step`` -> (logits, cache) on a fully
           populated cache placed by ``Model.cache_sharding``, each row's
           new token landing in its last slot (an enc-dec cache: its
           DEC_BUF-slot self cache's, over S encoder positions)

The reference lowers and compiles each cell on 512 placeholder host
devices and counts its cost from the HLO (``hlo_cost``). Here
``count_cell`` runs the program once under ``launch/exec_cost.py``'s
counter, on the card, on the CPU, or on ``meta`` devices, where no
kernel runs and no tensor holds data: the counterpart of the
placeholder devices. ``run_cell`` counts a cell on
``make_production_mesh`` (all ``meta``) and writes the reference's record
to ``experiments/dryrun/<cell>.json``; ``launch/roofline.py`` reads it.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k
    python -m repro_torch.launch.dryrun --all [--multipod] [--variant base]
        [--jobs N]
    python -m repro_torch.launch.dryrun --list

A record has the reference's keys (``lower_s``/``compile_s`` become
``build_s``/``count_s``, plus the kernel launches; ``xla_*_once`` and
``--hlo-dir`` have no counterpart). A refused cell (a program the port
does not run yet, named in ROADMAP.md) is an error record.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Union

import torch

from repro_torch.config.arch import ArchConfig
from repro_torch.config.shapes import (ALL_SHAPES, SHAPES_BY_NAME,
                                       InputShape, shape_applicable)
from repro_torch.configs import ASSIGNED, get_arch
from repro_torch.distributed.mesh_serving import (OUTPUTS, MeshParams,
                                                  MeshServer)
from repro_torch.distributed.sharding import (Placed, ShardingRules,
                                              data_axes_of, default_rules,
                                              fsdp_rules)
from repro_torch.launch import exec_cost
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.model import DEC_BUF, Model

# archs whose bf16 weights exceed one pod's model-axis shard
FSDP_ARCHS = {"grok-1-314b"}
# the reference's perf variants; the sharded MoE combines late always
# (``layers/moe.py::apply_moe_sharded``), so "latecombine" is the port's
# train step itself
VARIANTS = ("seqshard", "ffmodel", "dotsremat", "bigchunk", "triprefill",
            "latecombine")
UNPORTED = "is not ported (ROADMAP.md, queue 1)"


def build_rules(mesh: Mesh, cfg: ArchConfig, shape: InputShape,
                variant: str) -> ShardingRules:
    kw = dict(long_context=(shape.name == "long_500k"),
              seq_shard=("seqshard" in variant and shape.kind != "decode"))
    if cfg.name in FSDP_ARCHS:
        if "ffmodel" in variant:
            return default_rules(mesh, **kw).with_rules(
                fsdp=data_axes_of(mesh))
        return fsdp_rules(mesh, **kw)
    return default_rules(mesh, **kw)


def build_model(mesh: Mesh, cfg: ArchConfig, shape: InputShape,
                variant: str, *, dtype: torch.dtype = torch.bfloat16,
                device: Union[str, torch.device, None] = None) -> Model:
    """The cell's ``Model``, laid out for the mesh's model axis. A
    variant the port does not run is refused: every one in a serving
    cell, and all but ``latecombine`` in a train cell."""
    for v in VARIANTS:
        if v in variant and not (v == "latecombine"
                                 and shape.kind == "train"):
            raise ValueError(f"the {v!r} variant in a {shape.kind} cell "
                             f"{UNPORTED}")
    return Model(cfg, dtype=dtype, device=device,
                 model_axis=mesh.shape["model"])


def _meta(device) -> bool:
    return torch.device(device).type == "meta"


def _randint(gen, vocab: int, shape, device) -> torch.Tensor:
    if _meta(device):
        return torch.empty(tuple(shape), dtype=torch.int64, device=device)
    return torch.randint(0, vocab, tuple(shape), generator=gen,
                         device=device)


def _randn(gen, shape, dtype, device, scale: float = 1.0) -> torch.Tensor:
    if _meta(device):
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    x = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def _inputs(spec: dict, gen, vocab: int, dtype, device) -> dict:
    """Random tokens below ``vocab`` and N(0, 1) floats in ``dtype`` in
    the shapes of ``spec``'s meta tensors (on ``meta``: empty tensors of
    those shapes)."""
    return {k: (_randn(gen, v.shape, dtype, device) if v.is_floating_point()
                else _randint(gen, vocab, v.shape, device))
            for k, v in spec.items()}


def build_cell(mesh: Mesh, cfg: ArchConfig, shape: InputShape,
               variant: str = "base", *, seed: int = 0,
               dtype: torch.dtype = torch.bfloat16,
               device: Union[str, torch.device, None] = None):
    """(fn, args) of the cell: ``fn(*args)`` runs its program over
    ``mesh`` (whose devices must be ``device``'s kind). Weights and
    inputs come from ``seed``."""
    skip = shape_applicable(cfg, shape)
    if shape.kind == "restore" and cfg.is_attention_free:
        skip = "attention-free arch: restoration is state-blob/ssm-rescan"
    if skip:
        raise ValueError(f"{cfg.name} x {shape.name}: {skip}")
    model = build_model(mesh, cfg, shape, variant, dtype=dtype,
                        device=device)
    rules = build_rules(mesh, cfg, shape, variant)
    dev = model.device
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed + 1))
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        from repro_torch.training import AdamWConfig, Trainer
        from repro_torch.training.sharded import ShardedTrainer
        st = ShardedTrainer(Trainer(model, AdamWConfig()), mesh, rules)
        batch = _inputs(model.train_batch_spec(shape), gen, cfg.vocab_size,
                        model.dtype, dev)
        return st.train_step, (st.init_state(seed), batch)
    srv = MeshServer(model, mesh, rules)
    mp = srv.place_params(model.init(seed))
    if shape.kind == "prefill":
        batch = _inputs(model.prefill_batch_spec(shape), gen,
                        cfg.vocab_size, model.dtype, dev)
        keys = tuple(OUTPUTS[model.kind])

        def serve_prefill(mp, batch):
            out = srv.prefill(mp, batch)
            return (out["logits"],) + tuple(out[k] for k in keys)

        return serve_prefill, (mp, batch)
    if shape.kind == "restore":
        L = model.h.n_super if model.kind == "hybrid" else cfg.n_layers
        hidden = _randn(gen, (L, B, S, cfg.d_model), model.dtype, dev)
        return srv.restore_kv_from_hidden, (mp, srv.place_hidden(hidden))
    # each row's new token lands in the last slot of its (self) cache; an
    # enc-dec cache's S positions are the encoder's
    n = DEC_BUF - 1 if model.kind == "encdec" else S - 1
    cache = {}
    for name, v in model.cache_spec(B, S).items():
        if name in ("lengths", "enc_len"):
            cache[name] = torch.full(v.shape, n if name == "lengths" else S,
                                     dtype=torch.int32, device=dev)
        else:
            cache[name] = _randn(gen, v.shape, v.dtype, dev, 0.1)
    tokens = _randint(gen, cfg.vocab_size, (B, 1), dev)
    lengths = [n] * B
    enc_len = S if model.kind == "encdec" else None

    def serve_decode(mp, cache, tokens):
        lg, new_cache, _ = srv.decode_step(mp, cache, tokens,
                                           host_lengths=lengths,
                                           host_enc_len=enc_len)
        return lg, new_cache

    return serve_decode, (mp, srv.place_cache(cache), tokens)


# ------------------------------------------------------------- counting
def _per_shard(tree, n: int) -> list:
    """The tensors of ``tree`` by shard: each part of a ``Placed`` to its
    shard, each device's local tree of a ``MeshParams`` to it, any other
    tensor to shard 0."""
    out = [[] for _ in range(n)]

    def walk(x):
        if isinstance(x, Placed):
            for r, p in enumerate(x.parts):
                out[r].append(p)
        elif isinstance(x, MeshParams):
            for r, loc in enumerate(x.local):
                out[r].extend(exec_cost._tensors(loc))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            out[0].append(x)
    walk(tree)
    return out


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def count_program(fn, args, n_shards: int) -> dict:
    """Run ``fn(*args)`` (a cell's program over a mesh of ``n_shards``)
    once under the counter (``launch/exec_cost.py``), each shard holding
    its parts of ``args``. Returns the counter's result (the reference's
    ``analyze_hlo`` keys, per device the busiest shard's, with
    ``per_shard`` lists and ``total``), ``out_bytes``, ``count_s`` and the
    program's outputs under ``"outputs"``."""
    t0 = time.perf_counter()
    out, res = exec_cost.count(fn, *args, n_shards=n_shards,
                               owners=_per_shard(args, n_shards))
    count_s = time.perf_counter() - t0
    outs = [_storage_bytes(ts) for ts in _per_shard(out, n_shards)]
    res["per_shard"]["out_bytes"] = outs
    res.update(out_bytes=max(outs), count_s=count_s, outputs=out)
    return res


def count_cell(mesh: Mesh, cfg: ArchConfig, shape: InputShape,
               variant: str = "base", *, device, seed: int = 0,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """Build the cell (``build_cell``) over ``mesh`` (whose devices are
    ``device``'s kind) and count its program (``count_program``), with
    ``build_s`` beside the result."""
    t0 = time.perf_counter()
    fn, args = build_cell(mesh, cfg, shape, variant, seed=seed, dtype=dtype,
                          device=device)
    build_s = time.perf_counter() - t0
    res = count_program(fn, args, mesh.size)
    res["build_s"] = build_s
    return res


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             variant: str = "base", out_dir: str = "experiments/dryrun"
             ) -> dict:
    """Count one cell on the production mesh (``meta`` devices) and write
    its record: the reference's keys, a skip, or (raised) an error."""
    cfg = get_arch(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh_name = _mesh_name(multi_pod)
    cell_id = f"{arch}__{shape_name}__{mesh_name}__{variant}"
    skip = shape_applicable(cfg, shape)
    if shape.kind == "restore" and cfg.is_attention_free:
        skip = "attention-free arch: restoration is state-blob/ssm-rescan"
    if skip:
        rec = {"cell": cell_id, "arch": arch, "shape": shape_name,
               "mesh": mesh_name, "variant": variant, "skipped": skip}
        _write(out_dir, cell_id, rec)
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    res = count_cell(mesh, cfg, shape, variant, device="meta")
    rec = {
        "cell": cell_id, "arch": arch, "shape": shape_name,
        "mesh": mesh_name, "chips": mesh.size, "variant": variant,
        "flops": float(res["flops"]),
        "bytes_accessed": float(res["bytes"]),
        "bytes_all": float(res["bytes_all"]),
        "collectives": res["collectives"],
        "collective_bytes": int(res["collective_bytes"]),
        "peak_memory": res["peak_memory"], "temp_bytes": res["temp_bytes"],
        "arg_bytes": res["arg_bytes"], "out_bytes": res["out_bytes"],
        "build_s": res["build_s"], "count_s": res["count_s"],
        "launches": res["launches"],
        "launches_total": res["total"]["launches"],
    }
    print(f"[dryrun] {cell_id}: flops/dev={rec['flops']:.3e} "
          f"bytes/dev={rec['bytes_accessed']:.3e} "
          f"coll={rec['collective_bytes']:.3e}B "
          f"peak={(rec['peak_memory'] or 0) / 2**30:.2f}GiB "
          f"count={rec['count_s']:.1f}s")
    _write(out_dir, cell_id, rec)
    return rec


def _write(out_dir: str, cell_id: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(rec, f, indent=2)


def all_cells():
    for arch in ASSIGNED:
        for shape in ALL_SHAPES:
            yield arch, shape.name


def _cell_or_error(job):
    """``run_cell``, or its exception written as the cell's error record;
    returns the failed cell's id or None."""
    arch, shape, multi_pod, variant, out = job
    mesh_name = _mesh_name(multi_pod)
    cell_id = f"{arch}__{shape}__{mesh_name}__{variant}"
    try:
        run_cell(arch, shape, multi_pod=multi_pod, variant=variant,
                 out_dir=out)
        return None
    except Exception as e:  # record, keep going
        traceback.print_exc()
        _write(out, cell_id,
               {"cell": cell_id, "arch": arch, "shape": shape,
                "mesh": mesh_name, "variant": variant,
                "error": f"{type(e).__name__}: {e}"})
        return cell_id


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--multipod", action="store_true")
    p.add_argument("--variant", default="base")
    p.add_argument("--all", action="store_true")
    p.add_argument("--list", action="store_true")
    p.add_argument("--out", default="experiments/dryrun")
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--jobs", type=int, default=1,
                   help="cells counted at once, one process each")
    args = p.parse_args(argv)

    if args.list:
        for arch, shape in all_cells():
            cfg = get_arch(arch)
            skip = shape_applicable(cfg, SHAPES_BY_NAME[shape])
            print(f"{arch:24s} {shape:12s}"
                  + (f"  SKIP: {skip}" if skip else ""))
        return

    cells = (list(all_cells()) if args.all
             else [(args.arch, args.shape)])
    todo = []
    for arch, shape in cells:
        cell_id = f"{arch}__{shape}__{_mesh_name(args.multipod)}__" \
                  f"{args.variant}"
        path = os.path.join(args.out, cell_id + ".json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                if "error" not in json.load(f):
                    continue
        todo.append((arch, shape, args.multipod, args.variant, args.out))
    if args.jobs > 1:
        import multiprocessing
        with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
            failures = [c for c in pool.map(_cell_or_error, todo) if c]
    else:
        failures = [c for c in map(_cell_or_error, todo) if c]
    if failures:
        print(f"[dryrun] FAILURES: {failures}")
        raise SystemExit(1)
    print("[dryrun] all cells OK")


if __name__ == "__main__":
    main()
