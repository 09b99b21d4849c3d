"""Time the decode kernels (``decode_attention_cuda``, kernel #3, and
``decode_attention_paged_cuda``, kernel #4) of one source tree.

    python3 src/repro_torch/tools/bench_decode.py [--src PATH] [--label L]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so one chip call can time two versions of the
kernels in turns (``git archive`` of another commit unpacked under the
gitignored ``build/``). The wrappers' call surface is the same in every
version. Needs one
CUDA GPU. Shapes (bf16, inputs from seed 0), each run on a contiguous
``(B, Smax, Kv, hd)`` cache (#3) and on a permuted pool of 16-token pages
holding the same rows (#4):

- ``main3``: B=3, Kv=32, G=1, hd=128, lens 1100/2017/4096 (Smax 4096);
- ``main4``: B=4, Kv=32, G=1, hd=128, lens 2300/1537/777/2049 (Smax 2560),
  the paged engine's decode step on llama2-7b;
- ``life``: B=1, Kv=32, G=1, hd=128, len 1030 (Smax 1056), the
  lifecycle's decode;
- ``gqa``: B=4, Kv=4, G=7, hd=128, lens 2000/1500/700/1900 (Smax 2048),
  qwen2-7b's grouping;
- ``hd16``, ``hd80``, ``hd256``: B=4, Kv=8, G=2, lens 2000/1500/700/1900
  (Smax 2048).

Each time is the device ms of one call from a CUDA graph of 100 calls
replayed 5 times (the median), the calls cycling over enough copies of
the inputs (up to 8) that they span twice the 50 MB L2, so K and V come
from device memory as a decode step finds them. Prints one line per shape
and a JSON line (the card, then per shape and kernel the ms).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# name: (B, Kv, G, hd, lens, Smax)
SHAPES = {
    "main3": (3, 32, 1, 128, (1100, 2017, 4096), 4096),
    "main4": (4, 32, 1, 128, (2300, 1537, 777, 2049), 2560),
    "life": (1, 32, 1, 128, (1030,), 1056),
    "gqa": (4, 4, 7, 128, (2000, 1500, 700, 1900), 2048),
    "hd16": (4, 8, 2, 16, (2000, 1500, 700, 1900), 2048),
    "hd80": (4, 8, 2, 80, (2000, 1500, 700, 1900), 2048),
    "hd256": (4, 8, 2, 256, (2000, 1500, 700, 1900), 2048),
}
BS = 16
L2_SPAN = 100e6


def make_case(B, Kv, G, hd, lens, smax, gen):
    """q, a contiguous cache and a permuted page pool with the same rows
    (sentinel table entries past each row's pages), and kv_len."""
    import torch
    dev, dt = "cuda", torch.bfloat16
    MB = -(-smax // BS)
    NB = B * MB + 3
    q = torch.randn(B * Kv, G, hd, generator=gen, device=dev).to(dt)
    k = torch.randn(B, MB * BS, Kv, hd, generator=gen, device=dev).to(dt)
    v = torch.randn(B, MB * BS, Kv, hd, generator=gen, device=dev).to(dt)
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(0))
    table = torch.full((B, MB), NB, dtype=torch.int32)
    kp = torch.zeros(NB, BS, Kv, hd, dtype=dt, device=dev)
    vp = torch.zeros_like(kp)
    for b, n in enumerate(lens):
        for j in range(-(-n // BS)):
            page = int(perm[b * MB + j])
            table[b, j] = page
            kp[page] = k[b, j * BS:(j + 1) * BS]
            vp[page] = v[b, j * BS:(j + 1) * BS]
    kv_len = torch.tensor(lens, dtype=torch.int32,
                          device=dev).repeat_interleave(Kv)
    return (q, k[:, :smax], v[:, :smax], kp, vp, table.to(dev), kv_len)


def shape_cases(name, gen):
    """Copies of one shape's inputs: enough (at most 8) that the live K
    and V of all of them span twice the L2."""
    B, Kv, G, hd, lens, smax = SHAPES[name]
    live = 2 * (2 * sum(lens) * Kv * hd + 2 * B * Kv * G * hd)
    copies = min(8, max(1, -(-int(L2_SPAN) // live)))
    return [make_case(B, Kv, G, hd, lens, smax, gen) for _ in range(copies)]


def cycled(cases, fn):
    """A call of ``fn(*case)`` on the next copy at each call."""
    at = [0]

    def call():
        fn(*cases[at[0] % len(cases)])
        at[0] += 1
    return call


def contiguous(dec):
    """Kernel #3 on a case's contiguous cache."""
    return lambda q, k, v, kp, vp, t, n: dec.decode_attention_cuda(
        q, k, v, n)


def paged(dec):
    """Kernel #4 on a case's page pool."""
    return lambda q, k, v, kp, vp, t, n: dec.decode_attention_paged_cuda(
        q, kp, vp, t, n)


def time_shapes(dec, gen, graph_ms, label):
    out = {}
    for name, (B, Kv, G, hd, lens, smax) in SHAPES.items():
        cases = shape_cases(name, gen)
        ms3 = graph_ms(cycled(cases, contiguous(dec)))
        ms4 = graph_ms(cycled(cases, paged(dec)))
        out[name] = {"decode_attention": ms3, "decode_attention_paged": ms4}
        print(f"[{label}] {name} B={B} Kv={Kv} G={G} hd={hd} lens={lens} "
              f"Smax={smax}: #3 {ms3:.4f} ms, #4 {ms4:.4f} ms (graph, "
              f"{len(cases)} copies)", flush=True)
        del cases
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_decode: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.tools.bench_restore import graph_ms
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    print(f"[{args.label}] {dec.__file__}; kernels built in "
          f"{time.perf_counter() - t0:.1f} s; card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(json.dumps({"label": args.label, "card": card,
                      "shapes": time_shapes(dec, gen, graph_ms, args.label)}))


if __name__ == "__main__":
    main()
