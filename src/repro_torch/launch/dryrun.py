"""The mesh programs of the JAX package's dry-run
(``repro/launch/dryrun.py``): for an (arch, input shape, variant) cell
over a (data x model) mesh, the cell's program and its inputs.

    fn, args = build_cell(mesh, cfg, shape, "base", seed=0)
    out = fn(*args)

``build_rules`` and ``build_model`` are the reference's. ``build_cell``
returns the program of each cell kind with inputs made from ``seed`` and
placed on the mesh:

  train    ``training/sharded.py::ShardedTrainer.train_step`` on a placed
           train state and a batch of tokens (and patches for a VLM)
  prefill  ``MeshServer.prefill`` -> (logits, K/V) or (logits, states)
  restore  ``MeshServer.restore_kv_from_hidden`` on hidden states placed
           as ("layers", "batch", "kv_seq", "d_model"), the paper's op
  decode   ``MeshServer.decode_step`` -> (logits, cache) on a fully
           populated cache placed by ``Model.cache_sharding``, each row's
           new token landing in its last slot

The reference lowers and compiles each cell and counts its cost
(``run_cell``, ``hlo_cost``, ``roofline``); here the program runs. Its
counting counterpart is not ported (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.config.arch import ArchConfig
from repro_torch.config.shapes import InputShape, shape_applicable
from repro_torch.distributed.mesh_serving import MeshServer
from repro_torch.distributed.sharding import (ShardingRules, data_axes_of,
                                              default_rules, fsdp_rules)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import Model

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


def _randint(gen, vocab: int, shape, device) -> torch.Tensor:
    return torch.randint(0, vocab, tuple(shape), generator=gen,
                         device=device)


def _randn(gen, shape, dtype, device, scale: float = 1.0) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def _inputs(spec: dict, gen, vocab: int, dtype, device) -> dict:
    """Random tokens below ``vocab`` and N(0, 1) floats in ``dtype`` in
    the shapes of ``spec``'s meta tensors."""
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
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
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
        key = "kv" if model.kind == "lm" else "states"

        def serve_prefill(mp, batch):
            out = srv.prefill(mp, batch)
            return out["logits"], out[key]

        return serve_prefill, (mp, batch)
    if shape.kind == "restore":
        hidden = _randn(gen, (cfg.n_layers, B, S, cfg.d_model), model.dtype,
                        dev)
        return srv.restore_kv_from_hidden, (mp, srv.place_hidden(hidden))
    cache = {}
    for name, v in model.cache_spec(B, S).items():
        cache[name] = (torch.full(v.shape, S - 1, dtype=torch.int32,
                                  device=dev) if name == "lengths"
                       else _randn(gen, v.shape, v.dtype, dev, 0.1))
    tokens = _randint(gen, cfg.vocab_size, (B, 1), dev)

    def serve_decode(mp, cache, tokens):
        lg, new_cache, _ = srv.decode_step(mp, cache, tokens)
        return lg, new_cache

    return serve_decode, (mp, srv.place_cache(cache), tokens)
