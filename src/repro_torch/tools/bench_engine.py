"""The llama2-7b lifecycle and serving engine, timed end to end.

    python3 src/repro_torch/tools/bench_engine.py [--src PATH] \
        [--backends contiguous,paged]

Needs one CUDA GPU and the repository checkout around it. Runs
``chip_smoke.py``'s runners for those paths (this checkout's) on the ``repro_torch`` of
``--src`` (default this checkout's ``src``; a ``git archive`` of another
commit unpacked under the gitignored ``build/`` holds two trees against
each other in one chip call): llama2-7b at full width and depth in bf16,
random weights from seed 0, through the lifecycle (3 sessions x 2 rounds,
round-1 TTFT printed per session), then the engine (6 sessions x 2
rounds over 4 slots) on each backend twice, with a synchronisation
around every phase (the phase table) and without (the engine's wall and
TTFTs when restores may overlap decode). Every check of ``chip_smoke.py``
on these paths runs too. Prints one ``SUMMARY`` line per engine run.
Fails when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--backends", default="contiguous,paged")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_engine: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import repro_torch
    print(f"tree {os.path.dirname(repro_torch.__file__)}; " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    model, params = cs.build_model()
    cs.run_main_path(model, params)
    for backend in args.backends.split(","):
        for phased in (True, False):
            run = cs.run_engine(model, params, backend, phased=phased)
            m = run["metrics"]
            mean = lambda xs: 1e3 * sum(xs) / max(len(xs), 1)  # noqa: E731
            print(f"SUMMARY {backend} {'phased' if phased else 'unphased'}:"
                  f" wall {run['wall']:.2f} s, TTFT mean "
                  f"{mean(m.ttft_wall):.0f} ms (restored "
                  f"{mean(m.ttft_wall_restored):.0f}, cold "
                  f"{mean(m.ttft_wall_cold):.0f})", flush=True)
            del run
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
