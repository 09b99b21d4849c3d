"""Tensor-parallel serving with every shard on a card of its own.

    python3 src/repro_torch/tools/check_tp_cards.py [--widths 1,2,4] \
        [--layers 4]

Needs as many CUDA GPUs as the widest width and the repository checkout
around it. Serves llama2-7b at full width (``--layers`` of its 32 layers,
bf16, random weights from seed 0) with the engine (4 sessions x 2 rounds
over 2 slots, 256/384/192/320 then 32 tokens, 12 decode tokens, every
layer restored by the hidden method, a preemption quantum of 6) on the
paged and the contiguous backend at each width, shard s on ``cuda:s``
(``TPContext(tp)``), and holds each wider run against tp 1: the same
tokens, every restore's K/V and the final pools bitwise. Prints per run
the wall, the restores, kernel #1's and #4's launches and the per-device
gauges. ``chip_smoke.py`` runs the same path with every shard on one
card. Fails when a gate breaks or fewer cards are visible.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
PROMPTS = (256, 384, 192, 320)
ROUND1_TOKENS = 32
NEW_TOKENS = 12


def run(model, params, backend: str, tp: int) -> dict:
    """One engine run at width ``tp`` over ``cuda:0 .. cuda:tp-1``."""
    from repro_torch.core.hcache import HCacheManager
    from repro_torch.distributed.tp import TPContext, gathered
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import restore_kv as rkv
    from repro_torch.serving import InferenceEngine, Phase, Request
    from repro_torch.serving.kv_cache import PagedBackend
    from repro_torch.storage import ChunkStore, make_array

    class Recorder(InferenceEngine):
        """Keeps every completed restore's K/V."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.restored = []

        def _restore_step(self):
            restoring = [s for s in self.slots
                         if s is not None and s.phase == Phase.RESTORING]
            super()._restore_step()
            for s in restoring:
                if s.phase != Phase.RESTORING:
                    k, v = s.view.gather_hist(s.history_len)
                    self.restored.append((s.request.session_id,
                                          s.history_len, k.clone(),
                                          v.clone()))

    mgr = HCacheManager(model, ChunkStore(make_array("ssd", 4),
                                          chunk_tokens=64),
                        schedule_override="hidden")
    eng = Recorder(model, params, mgr, max_batch=2, max_seq=640,
                   prefill_chunk=128, preempt_quantum=6, backend=backend,
                   tp=TPContext(tp))
    rng = np.random.default_rng(0)
    before = (rkv.launches, dec.launches, dec.paged_launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rnd in range(2):
        for s, n in enumerate(PROMPTS):
            eng.submit(Request(f"s{s}", rng.integers(
                0, model.cfg.vocab_size, n if rnd == 0 else ROUND1_TOKENS)
                .astype(np.int32), max_new_tokens=NEW_TOKENS))
        eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pools = None
    if isinstance(eng.kv, PagedBackend):
        pools = tuple(gathered(p).to("cuda:0")
                      for p in (eng.kv.k_pool, eng.kv.v_pool))
    out = {"tokens": {s: eng.result(s) for s in eng.sessions},
           "restored": eng.restored, "pools": pools, "wall": wall,
           "launches": dict(zip(("restore_kv_grouped", "decode_attention",
                                 "decode_attention_paged"),
                                (b - a for a, b in zip(before, (
                                    rkv.launches, dec.launches,
                                    dec.paged_launches))))),
           "name": eng.kv.name, "metrics": eng.metrics}
    eng.close()
    return out


def check(name: str, got: dict, want: dict) -> None:
    if got["tokens"] != want["tokens"]:
        raise AssertionError(f"{name}: tokens differ from tp=1's")
    if [r[:2] for r in got["restored"]] != [r[:2] for r in want["restored"]]:
        raise AssertionError(f"{name}: other restores than tp=1's")
    for (sid, n, k, v), (_, _, wk, wv) in zip(got["restored"],
                                              want["restored"]):
        if not (torch.equal(k, wk) and torch.equal(v, wv)):
            raise AssertionError(f"{name}: the restore of {sid} ({n} tokens)"
                                 " differs from tp=1's")
    if want["pools"] is not None and not all(
            torch.equal(g, w) for g, w in zip(got["pools"], want["pools"])):
        raise AssertionError(f"{name}: the pool differs from tp=1's")
    print(f"{name}: tokens, {len(got['restored'])} restores and the pool "
          "bitwise those of tp=1", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="1,2,4")
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args()
    widths = [int(w) for w in args.widths.split(",")]
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < max(widths):
        raise SystemExit(f"check_tp_cards: needs {max(widths)} CUDA devices")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, cs.SRC)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    model, params = cs.build_model(layers=args.layers)
    for backend in ("paged", "contiguous"):
        ref = None
        for tp in widths:
            got = run(model, params, backend, tp)
            m = got["metrics"]
            print(f"{backend} tp={tp} ({got['name']}): wall "
                  f"{got['wall']:.2f} s, {len(got['restored'])} restores, "
                  f"{m.preemptions} preemptions, launches {got['launches']},"
                  f" gauges {m.device_gauges}", flush=True)
            if ref is None:
                ref = got
            else:
                check(f"{backend} tp={tp}", got, ref)
    print("check_tp_cards: every gate held")


if __name__ == "__main__":
    main()
