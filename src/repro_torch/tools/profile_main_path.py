"""Where the time goes on the port's main path, by ``torch.profiler``.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_main_path
    python3 src/repro_torch/tools/profile_main_path.py [--src PATH] \
        [--windows all|ssm]

Needs one CUDA GPU. Builds llama2-7b at full width and depth in bf16
(random weights, seed 0), prefills and saves sessions of 1024, 1536 and
2000 tokens with the hidden-state method on every layer, then profiles
(1) one restore of each (groups of 8), with the restore's host seconds
split into store reads, host copies into staging memory, upload issue,
launches and waits for the device, (2) 8 decode steps from the restored
1024-token cache, (3) an engine-sized
prefill chunk, 128 tokens over 1900 tokens of history, and (4) 8 decode
steps of the paged backend at the engine's batch of 4 slots holding
~2000 tokens each; then it frees llama2-7b, builds falcon-mamba-7b the
same way and profiles (5) 8 decode steps of the contiguous backend at 4
slots, each holding the states of a 512-token prefill, and (6) the
prefill of a 2000-token prompt (``ssm_forward``, the lifecycle's round 0).
``--windows ssm`` runs (5) and (6) alone, ``--windows restore`` the
restores of (1) alone, ``--windows train`` (7) alone: one training step
of llama2-7b at full width and 4 of its 32 layers on 4 x 2048 tokens
(bf16 over an fp32 master, chunked loss, each block recomputed, AdamW),
as ``chip_smoke.py`` trains it, or with ``--arch`` of another family at
its training shape on the card (``training.data.CARD_TRAIN_SHAPES``:
granite-moe-1b-a400m at all 24 layers on 4 x 2048 tokens, falcon-mamba-7b
at 4 layers on 2 x 512, ...); ``--src`` profiles the
``repro_torch`` of another ``src`` directory (``git archive`` of another
commit unpacked under the gitignored ``build/``), so one chip call can
hold two trees against each other. For each window it prints the wall
time, the device time summed over kernels and copies, the device's idle
share (1 - device time / wall), and the kernels with the most device
time. Fails when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

N_TOKENS = 1024
RESTORE_TOKENS = (1024, 1536, 2000)  # the restore windows
DECODE_STEPS = 8
TOP = 8
CHUNK, HIST = 128, 1900              # an engine prefill chunk over history
SLOTS, SLOT_TOKENS = 4, (2300, 1537, 777, 2049)   # paged decode batch
SSM_PROMPT = 512                     # falcon-mamba: states of this prefill
SSM_PREFILL = 2000                   # falcon-mamba: the prefill window


def report(name: str, prof, wall_s: float, top: int = TOP) -> None:
    # device-side events only (kernels, copies): an operator's CPU event
    # repeats the device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print(f"{name}: wall {wall_s * 1e3:.1f} ms; device time not "
              "measured (the profiler saw no device activity)")
        return
    print(f"{name}: wall {wall_s * 1e3:.1f} ms, device {device_ms:.1f} ms, "
          f"idle share {1 - device_ms / (wall_s * 1e3):.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


def profiled(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, prof, wall


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None)
    ap.add_argument("--windows", choices=("all", "ssm", "restore", "train"),
                    default="all")
    ap.add_argument("--arch", default="llama2-7b",
                    help="the model of --windows train, one of "
                    "training.data.CARD_TRAIN_SHAPES")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: no CUDA device")
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
        print(f"profiling {args.src}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.windows == "train":
        profile_train(args.arch)
        return
    if args.windows != "ssm":
        profile_llama(restore_only=args.windows == "restore")
    if args.windows != "restore":
        profile_ssm()


def profile_train(arch: str) -> None:
    """One AdamW step of ``arch`` at full width and its
    ``CARD_TRAIN_SHAPES`` depth on seeded tokens (and seeded frames or
    patches), after two warm steps."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.training import (CARD_TRAIN_FRAMES, CARD_TRAIN_PATCHES,
                                      CARD_TRAIN_SHAPES, AdamWConfig,
                                      DataConfig, Trainer, batch_at,
                                      side_inputs)
    if arch not in CARD_TRAIN_SHAPES:
        raise SystemExit(f"profile_main_path: --arch {arch} has no training "
                         f"shape; one of {sorted(CARD_TRAIN_SHAPES)}")
    layers, B, S = CARD_TRAIN_SHAPES[arch]
    cfg = get_arch(arch)
    if layers is not None:
        cfg = cfg.scaled(n_layers=layers)
    trainer = Trainer(Model(cfg, dtype=torch.bfloat16), AdamWConfig(),
                      loss_chunks=4)
    live = {"state": trainer.init_state(0)}
    dev = trainer.model.device
    batch = batch_at(DataConfig(cfg.vocab_size, S, B), 0, device=dev) | \
        side_inputs(cfg, B, frames=CARD_TRAIN_FRAMES,
                    patches=CARD_TRAIN_PATCHES, seed=28, device=dev)

    def step():
        live["state"], m = trainer.train_step(live["state"], batch)
        float(m["loss"])

    for _ in range(2):                              # warm
        step()
    _, prof, wall = profiled(step)
    report(f"{arch} train step ({cfg.n_layers} layers, {B} x {S} tokens)",
           prof, wall, top=16)
    # the device time of the kernels each autograd node launched, for the
    # attention backward (plain PyTorch) and the products' backward
    nodes = [e for e in prof.key_averages() if e.device_time_total > 0
             and e.key.startswith("autograd::engine::evaluate_function")]
    for e in sorted(nodes, key=lambda e: -e.device_time_total)[:TOP]:
        print(f"  {e.device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
              f"{e.key.split(': ', 1)[-1][:80]} (inclusive)")


def profile_llama(restore_only: bool = False) -> None:
    """Windows (1)-(4) on llama2-7b, which is freed afterwards."""
    from repro_torch.configs import get_arch
    from repro_torch.core.hcache import HCacheManager
    from repro_torch.models import Model
    from repro_torch.storage import ChunkStore, make_array
    model = Model(get_arch("llama2-7b"), dtype=torch.bfloat16)
    params = model.init(0)
    rng = np.random.default_rng(0)
    mgr = HCacheManager(model, ChunkStore(make_array("ssd", 4),
                                          chunk_tokens=64),
                        schedule_override="hidden", restore_group_size=8)
    try:
        for n in RESTORE_TOKENS:
            toks = torch.from_numpy(rng.integers(
                0, model.cfg.vocab_size, n)).to(model.device)
            out = model.prefill(params, {"tokens": toks[None]},
                                capture_hidden=True)
            mgr.save_prefill(f"s{n}", toks.cpu().numpy(), out)
            if n == N_TOKENS:
                tok = torch.argmax(out["logits"][:, -1], -1).to(
                    torch.int32)[:, None]
            del out
        for n in RESTORE_TOKENS:
            cap = n + 2 * DECODE_STEPS
            mgr.restore(params, f"s{n}", capacity=cap)        # warm
            with split_probe() as split:
                res, prof, wall = profiled(lambda: mgr.restore(
                    params, f"s{n}", capacity=cap))
            report(f"restore of {n} tokens (32 hidden layers, groups of "
                   "8)", prof, wall)
            parts = getattr(res, "host_split", None) or split
            print("  host split (ms): " + ", ".join(
                f"{k} {v * 1e3:.2f}" for k, v in parts.items())
                + f", other {(wall - sum(parts.values())) * 1e3:.2f}"
                + (" (the executor's own split)"
                   if getattr(res, "host_split", None) else
                   " (timed around the parent's calls)"))
            if n == N_TOKENS:
                cache = res.cache
            del res
        if restore_only:
            return

        def decode():
            nonlocal cache, tok
            for _ in range(DECODE_STEPS):
                lg, cache = model.decode_step(params, cache, tok)
                tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]

        decode()                                    # warm
        _, prof, wall = profiled(decode)
        report(f"{DECODE_STEPS} decode steps at ~{N_TOKENS} tokens", prof,
               wall)
        del cache
        profile_engine_windows(model, params)
    finally:
        mgr.close()
        del model, params, mgr       # free llama2-7b before falcon-mamba
        gc.collect()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def split_probe():
    """Host seconds of a restore by part, timed around the calls of a tree
    whose executor keeps no split of its own (the parent's): store reads
    and waits for them, uploads (``to_device``), launches
    (``project_group``), waits for the device (``torch.cuda.synchronize``
    inside a projection group), and host copies (the rest of a group)."""
    from repro_torch.core import restoration as rest
    from repro_torch.storage import chunk_store
    split = {"read": 0.0, "copy": 0.0, "upload": 0.0, "launch": 0.0,
             "wait": 0.0}
    group = {"depth": 0, "inner": 0.0}
    patched = []

    def wrap(owner, name, part):
        fn = getattr(owner, name, None)
        if fn is None:
            return

        def timed(*args, **kw):
            if part == "wait" and not group["depth"]:
                return fn(*args, **kw)   # the restore's own start and end
            if part is None:
                group["depth"] += 1
                group["inner"] = 0.0
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                if part is None:         # a group: the rest is copying
                    group["depth"] -= 1
                    split["copy"] += dt - group["inner"]
                else:
                    split[part] += dt
                    if group["depth"]:
                        group["inner"] += dt
        patched.append((owner, name, fn))
        setattr(owner, name, timed)

    for owner, name, part in (
            (chunk_store.ChunkStore, "submit_layer_read", "read"),
            (chunk_store.LayerRead, "wait", "read"),
            (rest, "to_device", "upload"), (rest, "project_group", "launch"),
            (torch.cuda, "synchronize", "wait"),
            (rest.RestorationExecutor, "_exec_project", None)):
        wrap(owner, name, part)
    try:
        yield split
    finally:
        for owner, name, fn in reversed(patched):
            setattr(owner, name, fn)


def profile_engine_windows(model, params) -> None:
    """A prefill chunk over history and paged decode steps at batch 4."""
    from repro_torch.serving import PagedBackend
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                         HIST + CHUNK)).to(model.device)
    hist = model.prefill(params, {"tokens": toks[None, :HIST]})["kv"]

    def chunk():
        return model.prefill(params, {"tokens": toks[None, HIST:]},
                             hist_kv=hist, hist_len=HIST)

    chunk()                                         # warm
    _, prof, wall = profiled(chunk)
    report(f"prefill chunk of {CHUNK} tokens over {HIST} of history", prof,
           wall)
    del hist
    kv = PagedBackend(model, SLOTS, 2560)
    for slot, n in enumerate(SLOT_TOKENS):
        kv.reserve(slot, n + 2 * DECODE_STEPS)
        kv.set_length(slot, n)
    tokens = rng.integers(0, model.cfg.vocab_size, (SLOTS, 1))

    def paged_decode():
        for _ in range(DECODE_STEPS):
            lg, _ = kv.decode(params, tokens)
            torch.argmax(lg[:, -1], -1).cpu()

    paged_decode()                                  # warm
    _, prof, wall = profiled(paged_decode)
    report(f"{DECODE_STEPS} paged decode steps, {SLOTS} slots at "
           f"{SLOT_TOKENS} tokens", prof, wall)


def profile_ssm() -> None:
    """falcon-mamba-7b decode at the engine's batch of 4 slots, and the
    prefill of a 2000-token prompt."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.serving import ContiguousBackend
    model = Model(get_arch("falcon-mamba-7b"), dtype=torch.bfloat16)
    params = model.init(0)
    kv = ContiguousBackend(model, SLOTS, 2560)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                         SSM_PROMPT)).to(model.device)
    out = model.prefill(params, {"tokens": toks[None]})
    conv, ssm = out["states"]
    for slot in range(SLOTS):
        kv.reserve(slot, SSM_PROMPT + 2 * DECODE_STEPS)
        kv.view(slot).write_states({"conv": conv, "ssm": ssm})
        kv.set_length(slot, SSM_PROMPT)
    del out
    tokens = rng.integers(0, model.cfg.vocab_size, (SLOTS, 1))

    def decode():
        for _ in range(DECODE_STEPS):
            lg, _ = kv.decode(params, tokens)
            torch.argmax(lg[:, -1], -1).cpu()

    decode()                                        # warm
    _, prof, wall = profiled(decode)
    report(f"{DECODE_STEPS} falcon-mamba-7b decode steps, {SLOTS} slots",
           prof, wall)
    del kv
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                         SSM_PREFILL)).to(model.device)

    def prefill():
        lg = model.prefill(params, {"tokens": toks[None]})["logits"]
        torch.argmax(lg[:, -1], -1).cpu()

    prefill()                                       # warm
    _, prof, wall = profiled(prefill)
    report(f"falcon-mamba-7b prefill of {SSM_PREFILL} tokens", prof, wall)


if __name__ == "__main__":
    main()
