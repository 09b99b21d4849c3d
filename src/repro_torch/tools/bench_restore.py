"""Time the restoration kernel (``restore_kv_grouped_cuda``) of one source
tree at the six llama2-7b shapes of its three regimes, and the host cost
of one eager call of its wrapper.

    python3 src/repro_torch/tools/bench_restore.py [--src PATH] [--label L]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so one chip call can time two versions of the
kernel in turns (``git archive`` of another commit unpacked under the
gitignored ``build/``). The wrapper's call surface is the same in every
version. Needs one CUDA GPU. Weights are a random bf16 32-layer stack of
llama2-7b's Wk and Wv (seed 0); launches cycle over its layers, so the
weights are cold in L2 as decode finds them. Prints one line per shape
and a JSON line (the card, then per shape: device ms; at decode's shapes
the host µs of one eager call and of its Python alone, with the C entry
replaced by a no-op, each the median and least of 21 runs).
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

SHAPES = ((8, 1024), (8, 2048), (1, 2000), (1, 128), (1, 4), (1, 1))
D = KV = 4096
HD = 128
A = 32


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, n: int = 100, reps: int = 5) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return time_ms(graph.replay, reps) / n


def host_us(fn, n: int = 200, reps: int = 21):
    """Host time of one eager call (enqueue only), µs, as (median, least)
    over ``reps`` runs of n calls back to back, synchronised outside the
    clock."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out), min(out)


class _NoLaunch:
    """Stands in for the kernel library: every entry does nothing."""

    def __getattr__(self, name):
        return lambda *args: None


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_restore: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import _build
    from repro_torch.kernels import restore_kv as rkv
    from repro_torch.models.layers.rope import rope_table
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    print(f"[{args.label}] {rkv.__file__}; kernels built in "
          f"{time.perf_counter() - t0:.1f} s; card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    wk = (torch.randn(A, D, KV, generator=gen, device="cuda")
          * D ** -0.5).to(bf)
    wv = (torch.randn(A, D, KV, generator=gen, device="cuda")
          * D ** -0.5).to(bf)
    cos_all, sin_all = rope_table(max(S for _, S in SHAPES), HD, 10000.0,
                                  "cuda")
    rows = {G: [torch.arange(l, l + G, dtype=torch.int32, device="cuda")
                for l in range(0, A, G)] for G in (1, 8)}
    result = {"label": args.label, "card": card, "shapes": []}
    for G, S in SHAPES:
        hidden = torch.randn(G, S, D, generator=gen, device="cuda").to(bf)
        cos, sin = cos_all[:S].contiguous(), sin_all[:S].contiguous()
        cyc = itertools.cycle(rows[G])

        def call():
            rkv.restore_kv_grouped_cuda(hidden, wk, wv, None, None,
                                        next(cyc), cos, sin, head_dim=HD)

        large = G * S >= 2000
        ms = time_ms(call, 20) if large else graph_ms(call)
        row = {"G": G, "S": S, "ms": ms}
        line = f"[{args.label}] G={G} S={S}: kernel {ms:.4f} ms"
        if G == 1 and S <= 4:
            row["host_us"], row["host_us_least"] = host_us(call)
            # the wrapper's Python alone: the same call with the C entry
            # replaced by a no-op (what is left is the C entry's cost)
            build = _build.library
            _build.library = lambda: _NoLaunch()
            try:
                row["python_us"], row["python_us_least"] = host_us(call)
            finally:
                _build.library = build
            line += (f"; one eager call {row['host_us']:.2f} us of host "
                     f"time (median; least {row['host_us_least']:.2f}), "
                     f"its Python without the C entry "
                     f"{row['python_us']:.2f} (least "
                     f"{row['python_us_least']:.2f})")
        print(line, flush=True)
        result["shapes"].append(row)
        del hidden
    print(json.dumps(result))


if __name__ == "__main__":
    main()
