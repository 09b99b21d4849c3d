"""Training driver with supervised restarts.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch qwen2-7b --steps 20 --ckpt-dir /tmp/ckpt --fail-at 7
    PYTHONPATH=src python -m repro_torch.launch.train --full --layers 4 \
        --seq 2048 --batch 4 --steps 8        # llama2-7b, bf16, one H100
    PYTHONPATH=src python -m repro_torch.launch.train --full \
        --arch granite-moe-1b-a400m --seq 2048 --batch 4 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --mesh 2x2 --steps 20 --fail-at 7       # 4 CPU shards

Builds a model of any family (a reduced smoke config unless ``--full``,
then cut to ``--layers`` of its layers if given: decoder layers of an
enc-dec, a multiple of the super-block for a hybrid) with random weights
from seed 0,
and trains it with AdamW, chunked cross-entropy and checkpoints under
the fault supervisor (``distributed/fault.py``), injecting failures at
``--fail-at`` steps to exercise the restart path. Batches are a function
of (seed 0, step); an enc-dec batch gets ``frames`` of zeros (batch,
seq, d_model), as the reference's launcher gives it (a VLM batch gets no
patches, as there). It runs on ``cuda`` in bf16 over an fp32 master
unless ``--device cpu`` is given (fp32 on the CPU); with no GPU present
and no ``--device`` it fails instead of falling back to the CPU. Each
step prints its loss, gradient norm and wall time.

``--mesh DxM`` trains over a (data x model) mesh through ``training/
sharded.py`` (the model laid out for a model axis of M, the state placed
by ``default_rules``; checkpoints hold the whole state, so a run restores
onto any mesh): with ``--device cpu`` over D·M CPU shards, on CUDA over
the first D·M cards, and too few cards is a ``ValueError``, never a
smaller mesh. ``main(argv, devices=[...])`` takes an explicit device
list instead (several shards may share a card). A model axis above 1 is
refused for the ssm, hybrid and enc-dec families (ROADMAP.md queue 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time

import torch

from repro_torch.config.arch import reduced_for_smoke
from repro_torch.configs import get_arch
from repro_torch.distributed.fault import FailureInjector, run_supervised
from repro_torch.distributed.tp import default_devices
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import Model, resolve_device
from repro_torch.training import (AdamWConfig, CheckpointManager, DataConfig,
                                  Trainer, batch_at, side_inputs)
from repro_torch.training.sharded import ShardedTrainer
from repro_torch.training.tree import tree_leaves

def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="qwen2-7b")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (default: repro_ckpt under "
                        "$TMPDIR)")
    p.add_argument("--ckpt-every", type=int, default=10)
    p.add_argument("--fail-at", type=int, nargs="*", default=[])
    p.add_argument("--full", action="store_true",
                   help="the architecture at its published width")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth to this many layers")
    p.add_argument("--mesh", default="1x1",
                   help="data x model, e.g. 2x2 (one process drives every "
                        "shard)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' trains in fp32 "
                        "through the kernels' plain versions)")
    return p


def build(args, device: torch.device, model_axis: int = 1):
    """(cfg, Trainer) for the parsed arguments."""
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduced_for_smoke(cfg)
    if args.layers is not None:
        cfg = cfg.scaled(n_layers=args.layers)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = Model(cfg, dtype=dtype, device=device, model_axis=model_axis)
    return cfg, Trainer(model, AdamWConfig(lr=args.lr), loss_chunks=4)


def mesh_shape(text: str):
    """"DxM" -> (D, M)."""
    try:
        shape = tuple(int(x) for x in text.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"--mesh {text!r}: expected DxM, e.g. 2x2")
    return shape


def main(argv=None, devices=None) -> dict:
    """Train as the arguments say; ``devices`` (a list of D·M devices)
    overrides the mesh's default devices."""
    args = _parser().parse_args(argv)
    shape = mesh_shape(args.mesh)
    n = shape[0] * shape[1]
    sharded = shape != (1, 1) or devices is not None
    if devices is None:
        kind = resolve_device(args.device).type
        have = torch.cuda.device_count() if kind == "cuda" else n
        if sharded and have < n:
            raise ValueError(f"--mesh {args.mesh} needs {n} cards, but "
                             f"{have} CUDA device(s) are visible; a mesh "
                             "never falls back to fewer cards")
        devices = default_devices(n, kind) if sharded \
            else [resolve_device(args.device)]
    mesh = make_mesh(shape, ("data", "model"), devices) if sharded else None
    device = torch.device(devices[0])
    cfg, trainer = build(args, device, shape[1])
    step_fn = trainer
    if sharded:
        step_fn = ShardedTrainer(trainer, mesh)
    state = step_fn.init_state(0)
    n_params = sum(math.prod(t.shape) for t in tree_leaves(state["params"]))
    where = (f"a {shape[0]}x{shape[1]} mesh over "
             f"{', '.join(str(d) for d in mesh.device_list())}" if sharded
             else str(device))
    print(f"{cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{n_params / 1e6:.1f} M parameters, {trainer.model.dtype} over "
          f"an fp32 master on {where}; seq {args.seq}, batch {args.batch}")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    ckpt_dir = args.ckpt_dir or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "repro_ckpt")
    ckpt = CheckpointManager(ckpt_dir)
    injector = FailureInjector(fail_at=tuple(args.fail_at))
    live = {"state": state}
    losses = {}

    def one_step(step: int):
        injector.check(step)
        t0 = time.perf_counter()
        batch = batch_at(dc, step, device=device) | side_inputs(
            cfg, args.batch, frames=args.seq, device=device)
        live["state"], metrics = step_fn.train_step(live["state"], batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        losses[step] = loss
        print(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
              f"wall {(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
        return metrics

    t0 = time.perf_counter()
    report = run_supervised(
        one_step, ckpt=ckpt, save_state=lambda: live["state"],
        load_state=lambda step, s: live.update(state=s),
        n_steps=args.steps, ckpt_every=args.ckpt_every)
    print(f"done: {report.steps_run} steps, {report.restarts} restarts, "
          f"{time.perf_counter() - t0:.1f}s")
    state = live["state"]
    return {"report": dataclasses.asdict(report), "losses": losses,
            "state": step_fn.gather_state(state) if sharded else state}


if __name__ == "__main__":
    main()
