"""Time the prefill-attention kernel (``flash_attention_cuda``) of one
source tree at the llama2-7b shapes of the main path.

    python3 src/repro_torch/tools/bench_flash.py [--src PATH] [--label L]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so one chip call can time two versions of the
kernel in turns (``git archive`` of another commit unpacked under the
gitignored ``build/``). The wrapper's call surface is the same in every
version. Needs one CUDA GPU. The shapes, as ``chip_smoke.py`` times them
(H = Kv = 32, hd = 128, bf16, causal, inputs from seed 0): self-prefills
of 1024 and 2000 tokens, 256 new tokens over 2016 of restored history, an
engine chunk of 128 over 1900, and one token over 2000 (a decode step as
the engine's recompute replay runs it). Prints one line per shape and a
JSON line: the card, then per shape the device ms of one call (a CUDA
graph of 100 calls replayed 5 times, the median) and of one eager call
(CUDA events around it, median of 20 after 2 warm-up calls, the host's
enqueue included).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SHAPES = ((0, 1024), (2016, 256), (1900, 128), (0, 2000),   # (hist, Sq)
          (2000, 1))
H = KV = 32
HD = 128


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.tools.bench_restore import graph_ms, time_ms
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    print(f"[{args.label}] {fa.__file__}; kernels built in "
          f"{time.perf_counter() - t0:.1f} s; card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"label": args.label, "card": card, "shapes": []}
    for hist, Sq in SHAPES:
        Skv = hist + Sq
        q, k, v = (torch.randn(1, n, h, HD, generator=gen, device="cuda")
                   .to(torch.bfloat16) for n, h in ((Sq, H), (Skv, KV),
                                                    (Skv, KV)))
        off = torch.tensor([hist], dtype=torch.int32, device="cuda")
        kl = torch.tensor([Skv], dtype=torch.int32, device="cuda")
        def call():
            fa.flash_attention_cuda(q, k, v, off, kl)

        ms, eager = graph_ms(call), time_ms(call, 20)
        print(f"[{args.label}] Sq={Sq} over {hist}: kernel {ms:.4f} ms "
              f"(graph), one eager call {eager:.4f} ms", flush=True)
        result["shapes"].append({"hist": hist, "Sq": Sq, "ms": ms,
                                 "eager_ms": eager})
    print(json.dumps(result))


if __name__ == "__main__":
    main()
