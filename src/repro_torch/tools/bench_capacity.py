"""Time the storage side of restoration on llama2-7b at full width:
all-hidden restores of 1024, 1536 and 2000 tokens from bf16 rows and
from int8 rows (``demote_hidden_int8``), the demotion itself, and the
paged backend's copy-on-write barrier.

    python3 src/repro_torch/tools/bench_capacity.py

Needs one CUDA GPU. Weights are random (seed 0), bf16. For each length
one session is prefilled and saved (every layer ``hidden``), restored
twice from its bf16 rows, demoted to int8 (timed), restored twice from
its int8 rows; the restores are synchronised walls
(``RestoreResult.wall_time``) with their host split, the second of each
pair printed, and the int8 K/V's relative L2 error against the bf16
restore's. The barrier: the host seconds of ``_ensure_private`` over four
occupied slots with no shared page (what every paged decode step adds),
and one page's copy (a shared page written), by CUDA events. Prints the
card's name and power limit, a line per measurement and a JSON line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

LENGTHS = (1024, 1536, 2000)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main() -> None:
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
    from repro_torch.configs import get_arch
    from repro_torch.core.hcache import HCacheManager
    from repro_torch.models import Model
    from repro_torch.serving.kv_cache import PagedBackend
    from repro_torch.storage import ChunkStore, make_array

    if not torch.cuda.is_available():
        raise SystemExit("bench_capacity: no CUDA device")
    print(card())
    model = Model(get_arch("llama2-7b"), dtype=torch.bfloat16)
    params = model.init(0)
    store = ChunkStore(make_array("ssd", 4), chunk_tokens=64)
    mgr = HCacheManager(model, store, schedule_override="hidden")
    gen = torch.Generator().manual_seed(0)
    out = {"card": card(), "restores": [], "barrier": {}}
    for n in LENGTHS:
        sid = f"s{n}"
        toks = torch.randint(0, model.cfg.vocab_size, (1, n), generator=gen)
        pre = model.prefill(params, {"tokens": toks.to(model.device)},
                            capture_hidden=True)
        mgr.save_prefill(sid, toks[0].numpy(), pre)
        del pre
        row = {"tokens": n}
        for codec in ("bf16", "int8"):
            if codec == "int8":
                t0 = time.perf_counter()
                assert mgr.demote_hidden_int8(sid)
                row["demote_s"] = time.perf_counter() - t0
            for _ in range(2):
                res = mgr.restore(params, sid)
            row[codec] = {"wall_ms": 1e3 * res.wall_time,
                          "project_ms": 1e3 * res.project_wall,
                          "split_ms": {k: 1e3 * v
                                       for k, v in res.host_split.items()}}
            if codec == "bf16":
                ref = res.cache["k"][:, :, :n].float()
            else:
                got = res.cache["k"][:, :, :n].float()
                row["int8_rel_l2"] = float((got - ref).norm() / ref.norm())
            del res
        out["restores"].append(row)
        print(f"all-hidden restore of {n} tokens: bf16 "
              f"{row['bf16']['wall_ms']:.1f} ms (copy "
              f"{row['bf16']['split_ms']['copy']:.1f}, read "
              f"{row['bf16']['split_ms']['read']:.1f}, upload "
              f"{row['bf16']['split_ms']['upload']:.1f}), int8 "
              f"{row['int8']['wall_ms']:.1f} ms (copy "
              f"{row['int8']['split_ms']['copy']:.1f}, read "
              f"{row['int8']['split_ms']['read']:.1f}, upload "
              f"{row['int8']['split_ms']['upload']:.1f}); demotion "
              f"{row['demote_s']:.3f} s; int8 K relative L2 to bf16 "
              f"{row['int8_rel_l2']:.5f}", flush=True)
        mgr.evict(sid)
        ref = got = None
        torch.cuda.empty_cache()
    mgr.close()

    kv = PagedBackend(model, 4, 2560, block_size=16)
    for slot in range(4):
        assert kv.reserve(slot, 2048)
        kv.set_length(slot, 1000 + 17 * slot)
    bs, reps = kv.block_size, 2000
    t0 = time.perf_counter()
    for _ in range(reps):
        for slot, blks in enumerate(kv.slot_blocks):
            if blks:
                kv._ensure_private(slot, (int(kv.lengths_np[slot]) // bs,))
    step_us = (time.perf_counter() - t0) / reps * 1e6
    page = kv.slot_blocks[0][0]
    copies = []
    for _ in range(5):
        kv.allocator.incref(kv.slot_blocks[0][0])     # a second holder
        shared = kv.slot_blocks[0][0]
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        kv._ensure_private(0, (0,))
        b.record()
        torch.cuda.synchronize()
        copies.append(a.elapsed_time(b))
        kv.allocator.free([shared])
    page_mb = 2 * kv.k_pool[:, page].numel() * kv.k_pool.element_size() / 1e6
    out["barrier"] = {"step_us": step_us, "copy_ms": sorted(copies)[2],
                      "page_mb": page_mb, "cow_copies": kv.cow_copies}
    print(f"copy-on-write barrier: {step_us:.2f} us per decode step over 4 "
          f"slots with no shared page; one page's copy ({page_mb:.1f} MB, "
          f"all layers of both pools) {sorted(copies)[2]:.4f} ms (median "
          "of 5)")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
