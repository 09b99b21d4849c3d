"""Where the time goes on the port's main path, by ``torch.profiler``.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_main_path

Needs one CUDA GPU. Builds llama2-7b at full width and depth in bf16
(random weights, seed 0), prefills and saves one 1024-token session with
the hidden-state method on every layer, then profiles (1) one restore of
it, (2) 8 decode steps from the restored cache, (3) an engine-sized
prefill chunk, 128 tokens over 1900 tokens of history, and (4) 8 decode
steps of the paged backend at the engine's batch of 4 slots holding
~2000 tokens each; then it frees llama2-7b, builds falcon-mamba-7b the
same way and profiles (5) 8 decode steps of the contiguous backend at 4
slots, each holding the states of a 512-token prefill. For each window it
prints the wall time, the device
time summed over kernels and copies, the device's idle share (1 - device
time / wall), and the kernels with the most device time. Fails when no
CUDA device is present.
"""
from __future__ import annotations

import gc
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.core.hcache import HCacheManager
from repro_torch.models import Model
from repro_torch.serving import ContiguousBackend, PagedBackend
from repro_torch.storage import ChunkStore, make_array

N_TOKENS = 1024
DECODE_STEPS = 8
TOP = 8
CHUNK, HIST = 128, 1900              # an engine prefill chunk over history
SLOTS, SLOT_TOKENS = 4, (2300, 1537, 777, 2049)   # paged decode batch
SSM_PROMPT = 512                     # falcon-mamba: states of this prefill


def report(name: str, prof, wall_s: float) -> None:
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
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:TOP]:
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
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    model = Model(get_arch("llama2-7b"), dtype=torch.bfloat16)
    params = model.init(0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, N_TOKENS)).to(model.device)
    mgr = HCacheManager(model, ChunkStore(make_array("ssd", 4),
                                          chunk_tokens=64),
                        schedule_override="hidden", restore_group_size=8)
    try:
        out = model.prefill(params, {"tokens": toks[None]},
                            capture_hidden=True)
        mgr.save_prefill("s", toks.cpu().numpy(), out)
        tok = torch.argmax(out["logits"][:, -1], -1).to(torch.int32)[:, None]
        del out
        mgr.restore(params, "s", capacity=N_TOKENS + 2 * DECODE_STEPS)
        res, prof, wall = profiled(lambda: mgr.restore(
            params, "s", capacity=N_TOKENS + 2 * DECODE_STEPS))
        report(f"restore of {N_TOKENS} tokens (32 hidden layers, groups "
               "of 8)", prof, wall)
        cache = res.cache

        def decode():
            nonlocal cache, tok
            for _ in range(DECODE_STEPS):
                lg, cache = model.decode_step(params, cache, tok)
                tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]

        decode()                                    # warm
        _, prof, wall = profiled(decode)
        report(f"{DECODE_STEPS} decode steps at ~{N_TOKENS} tokens", prof,
               wall)
        del cache, res
        profile_engine_windows(model, params)
    finally:
        mgr.close()
    del model, params, mgr           # free llama2-7b before falcon-mamba
    gc.collect()
    torch.cuda.empty_cache()
    profile_ssm_decode()


def profile_engine_windows(model, params) -> None:
    """A prefill chunk over history and paged decode steps at batch 4."""
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


def profile_ssm_decode() -> None:
    """falcon-mamba-7b decode at the engine's batch of 4 slots."""
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


if __name__ == "__main__":
    main()
