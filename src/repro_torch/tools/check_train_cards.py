"""Sharded training with every shard on a card of its own.

    python3 src/repro_torch/tools/check_train_cards.py [--layers 2] \
        [--steps 3]

Needs four CUDA GPUs and the repository checkout around it. Trains
llama2-7b at full width (``--layers`` of its 32 layers, bf16 over an fp32
master, seed 0) over a 2x2 (data x model) mesh through
``training/sharded.py`` on 4 x 2048 tokens, first with every shard on
``cuda:0`` (as ``chip_smoke.py`` runs it), then with shard (d, m) on
``cuda:2d+m``; then granite-moe-1b-a400m (``--moe-layers`` of its 24
layers) over 1x2 the same two ways. Each
cross-card run must give the one-card run's losses, gradient norms and
final state bit for bit: only a run across cards catches a collective
that depends on where its shards sit, or a kernel launch outside its
shard's device. Prints each run's step ms. Fails when a gate breaks or
fewer than four cards are visible.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
BATCH, SEQ, LR = 4, 2048, 1e-4


def run(arch: str, layers: int, shape, devices, steps: int):
    """``steps`` sharded steps of ``arch`` over ``devices``: (losses,
    gradient norms, the final state whole on the CPU, step ms)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.training import (AdamWConfig, DataConfig, Trainer,
                                      batch_at)
    from repro_torch.training.sharded import ShardedTrainer
    cfg = get_arch(arch).scaled(n_layers=layers)
    model = Model(cfg, dtype=torch.bfloat16, device=devices[0],
                  model_axis=shape[1])
    st = ShardedTrainer(Trainer(model, AdamWConfig(lr=LR), loss_chunks=4),
                        make_mesh(shape, ("data", "model"), devices))
    state = st.init_state(0)
    data = batch_at(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=0), 0,
                    device=devices[0])
    losses, gnorms, walls = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = st.train_step(state, data)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        for d in dict.fromkeys(devices):
            torch.cuda.synchronize(d)
        walls.append(time.perf_counter() - t0)
    whole = st.gather_state(state, torch.device("cpu"))
    return losses, gnorms, whole, 1e3 * statistics.median(walls[1:])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--moe-layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        raise SystemExit("check_train_cards: needs 4 CUDA devices")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.training.tree import tree_paths
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    for arch, layers, shape in (
            ("llama2-7b", args.layers, (2, 2)),
            ("granite-moe-1b-a400m", args.moe_layers, (1, 2))):
        n = shape[0] * shape[1]
        one = run(arch, layers, shape, ["cuda:0"] * n, args.steps)
        many = run(arch, layers, shape, [f"cuda:{i}" for i in range(n)],
                   args.steps)
        name = f"{arch} {shape[0]}x{shape[1]}"
        print(f"{name}: losses {one[0]} on one card, {many[0]} on {n}; "
              f"gradient norms {one[1]} / {many[1]}; step {one[3]:.1f} ms "
              f"on one card, {many[3]:.1f} ms on {n}", flush=True)
        if one[0] != many[0] or one[1] != many[1]:
            raise AssertionError(f"{name}: losses or norms differ across "
                                 "cards")
        for (path, a), (_, b) in zip(tree_paths(one[2]),
                                     tree_paths(many[2])):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: {path} differs across cards")
        print(f"{name}: every state leaf bitwise the one-card run's",
              flush=True)
    print("check_train_cards: every gate held")


if __name__ == "__main__":
    main()
