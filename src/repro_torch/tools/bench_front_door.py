"""Where the front door's time to first token goes, beside its twin's.

    python3 src/repro_torch/tools/bench_front_door.py [--backend paged]

Needs one CUDA GPU and the repository checkout around it. Serves
``chip_smoke.py``'s front-door traffic (llama2-7b at full width and
depth in bf16, random weights from seed 0; its 8 gated chat requests,
the same session ids, suffixes and forks) four ways, each twice, in the
order door, twin, pump, thread, thread, pump, twin, door:

  door    the whole front door over the socket (``run_front_door``);
  twin    the routed requests straight through the engine on the main
          thread (``run_front_door_twin``);
  pump    the same requests through ``EnginePump.submit`` alone (no
          socket, API or router), one at a time;
  thread  the twin on a plain thread of its own, under ``no_grad``.

Each run builds its engine the same way and prints each request's TTFT
(submit to first token) and the mean by route; the ``SUMMARY`` line
gives each way's per-request median over its two runs. Fails when no
CUDA device is present.
"""
from __future__ import annotations

import argparse
import gc
import os
import statistics
import subprocess
import sys
import threading

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
ORDER = ("door", "twin", "pump", "thread", "thread", "pump", "twin", "door")


def run_pump(cs, model, params, backend, routed):
    """The routed requests through ``EnginePump.submit``, one at a time:
    TTFT per request (the subscription's)."""
    from repro_torch.frontend import EnginePump
    from repro_torch.serving import Request
    eng = cs.front_door_engine(model, params, backend)
    pump = EnginePump(eng).start()
    out = []
    for sid, prompt, kind, _, src, _, _ in routed:
        if kind == "fork":
            pump.call(eng.fork_session, src, sid).result(60)
        sub = pump.submit(Request(sid, prompt,
                                  max_new_tokens=cs.DECODE_TOKENS))
        if not sub.wait(600) or sub.error is not None:
            raise RuntimeError(f"{sid}: no answer ({sub.error!r})")
        out.append(sub.ttft)
    pump.close()
    return out


def run_thread(cs, model, params, backend, routed):
    """The twin on a thread of its own, as the pump thread runs."""
    got = {}

    def body():
        with torch.no_grad():
            got["twin"] = cs.run_front_door_twin(model, params, backend,
                                                 routed)
    t = threading.Thread(target=body, name="twin-thread")
    t.start()
    t.join(600)
    return [ttft for _, ttft in got["twin"]["out"]]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="contiguous",
                    choices=("contiguous", "paged"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_front_door: no CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    model, params = cs.build_model()
    routed, ttfts = None, {way: [] for way in dict.fromkeys(ORDER)}
    for way in ORDER:
        if way == "door":
            run = cs.run_front_door(model, params, args.backend)
            routed = run["routed"]
            got = [r[5] for r in run["routed"]]
        elif way == "twin":
            got = [t for _, t in cs.run_front_door_twin(
                model, params, args.backend, routed)["out"]]
        elif way == "pump":
            got = run_pump(cs, model, params, args.backend, routed)
        else:
            got = run_thread(cs, model, params, args.backend, routed)
        ttfts[way].append(got)
        by_route = {}
        for r, t in zip(routed, got):
            by_route.setdefault(r[2], []).append(1e3 * t)
        print(f"{way} {args.backend}: TTFT ms " + ", ".join(
            f"{r[2]} {1e3 * t:.1f}" for r, t in zip(routed, got))
            + "; by route " + ", ".join(
                f"{k} {statistics.mean(v):.1f}" for k, v in by_route.items()),
            flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"SUMMARY {args.backend} (per-request median of two runs, ms): "
          + "; ".join(f"{way} " + ", ".join(
              f"{1e3 * statistics.median(ts):.1f}" for ts in zip(*runs))
              for way, runs in ttfts.items()), flush=True)


if __name__ == "__main__":
    main()
