"""Time the Mamba1 state-update kernel (kernel #6, ``ssm_scan_cuda`` /
``ssm_update_cuda``) of one source tree, and the falcon-mamba-7b prefill
that runs it.

    python3 src/repro_torch/tools/bench_ssm.py [--src PATH] [--label L]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so one chip call can time two versions in
turns (``git archive`` of another commit unpacked under the gitignored
``build/``; run parent, change, change, parent). The wrappers' call
surface is the same in every version. Needs one CUDA GPU. Shapes (I =
8192, N = 16, falcon-mamba-7b's layer; bf16 x, B, C, D, fp32 state and dt;
B and C column views of an x_proj output, as the layer passes them):

- ``decode4``, ``decode1``: one token at Bt = 4 (the engine's slots) and 1
  (the lifecycle);
- ``prefill1024``, ``prefill2000``: one layer's scan over a 1024- and a
  2000-token prompt at Bt = 1.

Each time is the device ms of one call from a CUDA graph (100 calls at
S = 1, 5 at prefill sizes) replayed 5 times, the median. Beside it the
bound (bytes or operations, ``kernels/ssm_update.py::scan_cost``'s count
over the published peaks: 3.35 TB/s, 67 TFLOP/s fp32) and the share of it
reached. Then it builds falcon-mamba-7b at full width and depth in bf16
(random weights, seed 0) and times ``Model.prefill`` plus the greedy
first token at 512, 768, 1024, 1536 and 2000 tokens (host
clock around a synchronised call, median of 3 after one warm-up): the
lifecycle's TTFT at 1024 / 1536 / 2000, and summed over the engine's six
prompts (1024, 1536, 2000, 512, 768, 1024) a counterpart of its prefill
phase. Prints one line per shape and a JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

I, N, R = 8192, 16, 256
SHAPES = {"decode4": (4, 1), "decode1": (1, 1), "prefill1024": (1, 1024),
          "prefill2000": (1, 2000)}
PROMPTS = (512, 768, 1024, 1536, 2000)
ENGINE_PROMPTS = (1024, 1536, 2000, 512, 768, 1024)
PEAK_BYTES, PEAK_FP32 = 3.35e12, 67e12


def bound_ms(Bt: int, S: int, es: int = 2):
    """(ms, what bounds it): the count of ``scan_cost`` (copied here, as
    the tree under test may predate it) over the published peaks."""
    flops = Bt * S * I * (7 * N + 3)
    nbytes = (2 * Bt * I * N * 4 + I * N * 4 + es * I
              + S * Bt * (I * 4 + 2 * I * es + 2 * N * es))
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def make_case(Bt, S, gen):
    import torch
    dev = "cuda"
    h = torch.randn(Bt, I, N, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn(Bt, S, I, generator=gen, device=dev) - 4.0)
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=dev).expand(I, N).contiguous()
    x = torch.randn(Bt, S, I, generator=gen, device=dev).to(torch.bfloat16)
    proj = torch.randn(Bt, S, R + 2 * N, generator=gen,
                       device=dev).to(torch.bfloat16)
    D = torch.ones(I, device=dev).to(torch.bfloat16)
    return h, dt, x, A, proj[..., R:R + N], proj[..., R + N:], D


def time_kernel(ssu, gen, graph_ms, label):
    out = {}
    for name, (Bt, S) in SHAPES.items():
        h, dt, x, A, Bm, Cm, D = make_case(Bt, S, gen)
        ms = graph_ms(lambda: ssu.ssm_scan_cuda(h, dt, x, A, Bm, Cm, D),
                      n=100 if S == 1 else 5)
        b, by = bound_ms(Bt, S)
        out[name] = {"Bt": Bt, "S": S, "ms": ms, "bound_ms": b,
                     "bound_by": by}
        print(f"[{label}] {name} Bt={Bt} S={S} I={I} N={N} bf16: "
              f"{ms * 1e3:.2f} us per call ({ms * 1e3 / S:.3f} us per "
              f"token; graph), bound {b * 1e3:.2f} us ({by}), "
              f"{b / ms:.1%} of it", flush=True)
        del h, dt, x, Bm, Cm
    return out


def time_prefill(label):
    """falcon-mamba-7b prefill + greedy first token, ms by prompt length."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import Model

    model = Model(get_arch("falcon-mamba-7b"), dtype=torch.bfloat16)
    params = model.init(0)
    rng = np.random.default_rng(0)
    out = {}
    for n in PROMPTS:
        toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                             n)).to(model.device)[None]

        def step():
            lg = model.prefill(params, {"tokens": toks})["logits"]
            torch.argmax(lg[:, -1], -1).cpu()

        step()                                      # warm
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[n] = statistics.median(walls)
        print(f"[{label}] falcon-mamba-7b prefill of {n} tokens + greedy "
              f"token: {out[n]:.1f} ms (median of 3: "
              f"{', '.join(f'{w:.1f}' for w in walls)})", flush=True)
    engine = sum(out[n] for n in ENGINE_PROMPTS)
    print(f"[{label}] the engine's six prompt prefills "
          f"{ENGINE_PROMPTS}: {engine:.0f} ms summed", flush=True)
    return {"ttft_ms": out, "engine_prefills_ms": engine}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_ssm: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssm_update as ssu
    from repro_torch.tools.bench_restore import graph_ms
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    print(f"[{args.label}] {ssu.__file__}; kernels built in "
          f"{time.perf_counter() - t0:.1f} s; card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"label": args.label, "card": card,
              "shapes": time_kernel(ssu, gen, graph_ms, args.label),
              "prefill": time_prefill(args.label)}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
