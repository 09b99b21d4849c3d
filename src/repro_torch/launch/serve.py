"""Serving entry point: the HCache engine over a synthetic multi-round
conversation trace.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --sessions 4 --rounds 2                     # smoke config, fp32
    PYTHONPATH=src python -m repro_torch.launch.serve --backend paged \
        --full                                      # llama2-7b, bf16, GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch \
        falcon-mamba-7b --rounds 1 --full           # ssm family, GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch \
        zamba2-2.7b --rounds 1 --full               # hybrid family, GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch \
        granite-moe-1b-a400m --full                 # MoE family, GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch whisper-medium --enc-seq 64          # enc-dec family
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --hw-profile p.json --restore-group-size auto   # calibrated
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --budget-kb 64                              # host budget ladder
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --backend paged --prefix-sharing            # shared prefixes
    PYTHONPATH=src python -m repro_torch.launch.serve --serve-http \
        --port 8080 --backend paged --prefix-sharing   # HTTP front door
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --backend paged --tp 2                      # 2 CPU shards

It runs on ``cuda`` in bf16 unless ``--device cpu`` is given (fp32 on the
CPU); with no GPU present and no ``--device`` it fails instead of falling
back to the CPU. Weights are random, from seed 0.
``--tp N`` serves tensor-parallel (DESIGN.md §16): the restoration pack
and, with ``--backend paged``, the KV pool are split by KV heads over N
shards, the first N cards (refused when fewer are visible, never run on
fewer), or N CPU shards with ``--device cpu``; a width that does not
divide the model's KV heads is refused. The tokens are those of ``--tp
1``. The weights are not sharded.
``--budget-kb`` caps the store's hot tier and adds a DRAM cold tier
under a ``CapacityManager`` (its ladder's actions are printed);
``--prefix-sharing`` turns on shared prefixes and copy-on-write pages
(the paged backend's index; host chunk sharing on either backend).
An ``ssm`` model (falcon-mamba-7b) or a ``hybrid`` one (zamba2-2.7b)
runs on the contiguous backend for one round per session: its prefill
starts from zero state, so a second round is refused. The MoE (granite-moe-1b-a400m, grok-1-314b) and VLM
(internvl2-26b) models are served text-only, as the reference serves
them; ``--full`` refuses a model whose bf16 weights exceed one card's
memory (grok-1-314b, 633 GB). An enc-dec model (whisper-medium) gets a
request's frame embeddings on round 0 (``--prompt-len`` seeded normals
x 0.1 per session, drawn after its prompt, as the JAX package's serve
draws them); later rounds restore the cross state from the store.
``--enc-seq`` sets the encoder positions of each slot's cross state.

``--serve-http`` serves the engine through the front door
(``repro_torch.frontend``: ``/v1/chat/completions``, ``/v1/completions``,
``/v1/models``, ``/healthz``, ``/metrics``) on ``--host``/``--port`` (0
picks a free port; the bound one is printed) until Ctrl-C, with
``--max-pending`` requests in flight before it answers 429; on shutdown
it writes ``--metrics-json``. An ``ssm`` or ``hybrid`` model is served
there one-shot (every request fresh over its full rendered prompt); an
enc-dec model is refused, since a chat request carries no encoder
frames.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os

import numpy as np
import torch

from repro_torch.config.arch import reduced_for_smoke
from repro_torch.config.hardware import PROFILES
from repro_torch.configs import get_arch
from repro_torch.core.capacity import (ADMISSION_POLICIES, EVICTION_POLICIES,
                                       CapacityManager,
                                       RestoreCostAwareAdmission)
from repro_torch.core.hcache import HCacheManager
from repro_torch.core.profiler import MeasuredProfile
from repro_torch.distributed.tp import context as tp_context
from repro_torch.frontend import serve_engine, unservable
from repro_torch.models.model import Model, resolve_device
from repro_torch.serving import BACKENDS, InferenceEngine, Request
from repro_torch.storage import (AsyncIOEngine, ChunkStore, make_array,
                                 make_shards)

# device memory of the card the port serves on (one H100), against which
# --full is checked when the run is not on a card
CARD_BYTES = 80e9


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="llama2-7b")
    p.add_argument("--sessions", type=int, default=3)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--prompt-len", type=int, default=24)
    p.add_argument("--gen", type=int, default=8)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=256)
    p.add_argument("--profile", default="a100", choices=sorted(PROFILES))
    p.add_argument("--ssds", type=int, default=4)
    p.add_argument("--hosts", type=int, default=1,
                   help="distributed store: number of host shards, each "
                        "with --ssds simulated SSDs behind its own NIC "
                        "link (1 = one-host store)")
    p.add_argument("--nic-bw", type=float, default=None, metavar="GBPS",
                   help="per-shard NIC bandwidth in GB/s (default: the "
                        "hardware model's NIC_BW)")
    p.add_argument("--placement", default="layer",
                   choices=("layer", "chunk"),
                   help="shard placement: layer-striped or token-chunk-"
                        "striped")
    p.add_argument("--async-io", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="attach the per-shard async IO engine (default: "
                        "on when --hosts > 1)")
    p.add_argument("--full", action="store_true",
                   help="the architecture at its published size (default: "
                        "a reduced smoke config)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels in fp32)")
    p.add_argument("--preempt-quantum", type=int, default=None,
                   help="enable mid-stream eviction after N resident steps")
    p.add_argument("--eviction", default="lru",
                   choices=sorted(EVICTION_POLICIES))
    p.add_argument("--admission", default="fifo",
                   choices=sorted(ADMISSION_POLICIES))
    p.add_argument("--admission-aging", type=float, default=0.0,
                   help="restore_cost admission: seconds of makespan "
                        "credit per queued engine step (anti-starvation)")
    p.add_argument("--backend", default="contiguous",
                   choices=sorted(BACKENDS),
                   help="KV-cache layout: contiguous slots or a "
                        "block-table page pool")
    p.add_argument("--block-size", type=int, default=16,
                   help="paged backend: tokens per physical page")
    p.add_argument("--cache-blocks", type=int, default=None,
                   help="paged backend: physical pages in the pool "
                        "(default max_batch * max_seq / block_size)")
    p.add_argument("--restore-group-size", default="8",
                   help="projection layers per restoration launch (an "
                        "integer; 1 = per layer), 'auto' for the makespan "
                        "argmin over {1, 2, 4, 8, L} and the fetch-aligned "
                        "partition per restore, or 'fetch' for the "
                        "fetch-aligned partition")
    p.add_argument("--budget-kb", type=int, default=None,
                   help="host hot-tier byte budget (KiB); enables the "
                        "capacity ladder (cold tier, int8 hidden states, "
                        "recompute-only, drop) over a DRAM cold tier")
    p.add_argument("--enc-seq", type=int, default=None,
                   help="enc-dec models: encoder positions per slot in "
                        "the paired self/cross cache (default max-seq)")
    p.add_argument("--prefix-sharing", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="cross-session prefix sharing: refcounted copy-on-"
                        "write pages and a token-hash prefix index (paged "
                        "backend), shared host chunks and session forks")
    p.add_argument("--hw-profile", default=None, metavar="PATH",
                   help="online scheduler calibration: load a "
                        "MeasuredProfile JSON from PATH if it exists (else "
                        "start empty), fold every restore's observed task "
                        "times into it, plan from it, and save it back on "
                        "exit")
    p.add_argument("--metrics-json", default=None, metavar="PATH",
                   help="dump the final EngineMetrics counters and gauges "
                        "as JSON to PATH on exit")
    p.add_argument("--priority-levels", type=int, default=1,
                   help="synthetic trace: session s gets priority "
                        "s %% N (exercises --admission priority)")
    p.add_argument("--serve-http", action="store_true",
                   help="serve the engine through the front door (an "
                        "OpenAI-compatible HTTP API and session router) "
                        "instead of the synthetic trace; Ctrl-C to stop")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="--serve-http listen port (0 = ephemeral)")
    p.add_argument("--max-pending", type=int, default=64,
                   help="--serve-http backpressure: queue-depth cap "
                        "before requests are shed with 429/overloaded")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width: split the restoration "
                        "projection and the paged KV pool by KV heads over "
                        "this many shards (the first N cards; N CPU shards "
                        "with --device cpu); refused when fewer cards are "
                        "visible")
    return p


def _group_plan(p: argparse.ArgumentParser, args):
    """The manager's projection group plan from ``--restore-group-size``."""
    if args.restore_group_size in ("auto", "fetch"):
        return args.restore_group_size
    try:
        return int(args.restore_group_size)
    except ValueError:
        p.error(f"--restore-group-size {args.restore_group_size}: give an "
                "integer, 'auto' or 'fetch'")


def _refuse_oversized(p: argparse.ArgumentParser, cfg, device) -> None:
    """Refuse a published size whose bf16 weights exceed one card's
    memory (the card's own, or an H100's 80 GB off the card): serving
    it needs its weights sharded over several cards, which ``--tp`` does
    not do (it splits the KV pool and the restoration pack)."""
    need = 2 * cfg.param_count()
    have = (torch.cuda.get_device_properties(device).total_memory
            if device.type == "cuda" else CARD_BYTES)
    if need > have:
        p.error(f"--full {cfg.name}: its {cfg.n_layers} layers hold "
                f"{cfg.param_count() / 1e9:.1f} B parameters, "
                f"{need / 1e9:.1f} GB in bf16, more than the "
                f"{have / 1e9:.1f} GB of one card's memory; --tp does "
                "not shard the weights (it splits the KV pool and the "
                "restoration pack), and sharding them over cards comes "
                "with sharded training, which is not ported yet")


def main(argv=None) -> None:
    p = _parser()
    args = p.parse_args(argv)
    group_size = _group_plan(p, args)
    device = resolve_device(args.device)
    try:
        tp = tp_context(args.tp, device)
    except ValueError as e:
        p.error(f"--tp {args.tp}: {e}")
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    cfg = get_arch(args.arch)
    if args.full:
        _refuse_oversized(p, cfg, device)
    else:
        cfg = reduced_for_smoke(cfg)
    try:
        tp.validate_heads(cfg.n_kv_heads)
    except ValueError as e:
        p.error(f"--tp {args.tp}: {e}")
    model = Model(cfg, dtype=dtype, device=device)
    if args.serve_http and unservable(model):
        p.error(f"--serve-http: {unservable(model)}")
    if (args.rounds > 1 and not args.serve_http
            and not model.adapter.supports_resume):
        p.error(f"--rounds {args.rounds}: a {model.kind!r} model serves "
                "each session one round (its prefill cannot resume on "
                "restored state); pass --rounds 1")
    params = model.init(0)
    cold = make_array("dram", args.ssds) if args.budget_kb else None
    if args.hosts > 1:
        from repro_torch.config.hardware import NIC_BW
        nic_bw = (args.nic_bw * 1e9 if args.nic_bw else NIC_BW)
        store = ChunkStore(shards=make_shards(args.hosts, args.ssds, "ssd",
                                              nic_bw=nic_bw),
                           chunk_tokens=64, cold_devices=cold,
                           placement=args.placement)
        if args.async_io is not False:
            store.attach_io_engine(AsyncIOEngine(args.hosts))
    else:
        store = ChunkStore(make_array("ssd", args.ssds), chunk_tokens=64,
                           cold_devices=cold)
        if args.async_io:
            store.attach_io_engine(AsyncIOEngine(1))
    measured = None
    if args.hw_profile:
        measured = (MeasuredProfile.load(args.hw_profile)
                    if os.path.exists(args.hw_profile)
                    else MeasuredProfile())
    mgr = HCacheManager(model, store, hw=PROFILES[args.profile],
                        restore_group_size=group_size, profile=measured)
    capacity = (CapacityManager(mgr, host_budget_bytes=args.budget_kb * 1024)
                if args.budget_kb else None)
    admission = (RestoreCostAwareAdmission(aging=args.admission_aging)
                 if args.admission == "restore_cost"
                 else ADMISSION_POLICIES[args.admission]())
    engine = InferenceEngine(model, params, mgr, max_batch=args.max_batch,
                             max_seq=args.max_seq,
                             preempt_quantum=args.preempt_quantum,
                             eviction=EVICTION_POLICIES[args.eviction](),
                             admission=admission,
                             capacity=capacity,
                             backend=args.backend,
                             block_size=args.block_size,
                             cache_blocks=args.cache_blocks,
                             enc_seq=args.enc_seq,
                             prefix_sharing=args.prefix_sharing, tp=tp)
    print(f"{cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, {dtype} on "
          f"{device}" + (f", tp={tp.tp} over "
                         f"{', '.join(str(d) for d in tp.devices)}"
                         if tp.spmd else ""))
    if args.serve_http:
        try:
            asyncio.run(serve_engine(engine, args.host, args.port,
                                     max_pending=args.max_pending))
        except KeyboardInterrupt:
            pass
        _dump_metrics(engine, args.metrics_json)
        store.close()
        print("front door closed", flush=True)
        return

    rng = np.random.default_rng(0)
    for rnd in range(args.rounds):
        for s in range(args.sessions):
            prompt = rng.integers(0, cfg.vocab_size,
                                  args.prompt_len).astype(np.int32)
            # enc-dec sessions carry encoder frames on round 0 only;
            # later rounds restore the cross state from the store
            frames = None
            if model.kind == "encdec" and rnd == 0:
                frames = rng.standard_normal(
                    (args.prompt_len, cfg.d_model)).astype(np.float32) * 0.1
            engine.submit(Request(f"user{s}", prompt,
                                  max_new_tokens=args.gen, frames=frames,
                                  priority=s % max(args.priority_levels,
                                                   1)))
        engine.run()
        for s in range(args.sessions):
            seq = engine.sessions[f"user{s}"]
            print(f"round {rnd} user{s}: {len(seq.generated)} tokens "
                  f"{[int(t) for t in seq.generated]}, restore_sim {seq.restore_sim * 1e3:.2f} ms, "
                  f"ttft_wall {seq.ttft_wall:.3f} s")
    m = engine.metrics
    print(f"\nrestored {m.restored_tokens} tokens over "
          f"{len(m.ttft_wall)} requests; decode steps {m.decode_steps}; "
          f"preemptions {m.preemptions}; "
          f"store {store.bytes_used / 1e6:.1f} MB hot "
          f"/ {store.bytes_cold / 1e6:.1f} MB cold across "
          f"{len(store.devices)} devices")
    print(f"cache backend {engine.kv.name}: peak concurrency "
          f"{m.concurrent_peak} slots, peak live/reserved tokens "
          f"{m.live_tokens_peak}/{m.reserved_tokens_peak}, mean occupancy "
          f"{m.occupancy_mean:.2f} (fragmentation "
          f"{m.fragmentation_mean:.2f}), free blocks {m.free_blocks}, "
          f"alloc stalls {m.alloc_stalls}")
    if args.prefix_sharing:
        print(f"prefix sharing: hit rate {m.prefix_hit_rate:.2f} "
              f"({m.prefix_hits}/{m.prefix_lookups} lookups, "
              f"{m.prefix_hit_tokens} tokens), skipped "
              f"{m.restore_skipped_tokens} restore/prefill tokens, "
              f"{m.cow_copies} CoW copies, pages shared/private "
              f"{m.shared_pages}/{m.private_pages}, host dedup "
              f"{m.dedup_host_bytes / 1e6:.2f} MB, forks {m.forks}")
    for r in m.device_gauges:
        print(f"device {r['device']}: free pages {r['free_pages']}, "
              f"pool occupancy {r['occupancy_pct']}%, live/reserved "
              f"{r['util_pct']}%, restore-projection utilization "
              f"{r['proj_util_pct']}%"
              + (f", pool {r['pool_bytes'] / 1e6:.2f} MB"
                 if "pool_bytes" in r else ""))
    if measured is not None:
        print(f"scheduler calibration: observed bubble "
              f"{m.restore_bubble_mean:.1%} over {m.restore_bubble_n} "
              f"restores, planned-vs-measured makespan error "
              f"{m.makespan_err_mean:.1%}, peak restore concurrency "
              f"{m.io_streams_peak} streams")
        counts = ", ".join(f"{k}={v}"
                           for k, v in measured.sample_counts().items())
        print(f"hw profile: epoch {measured.epoch}, samples "
              f"[{counts or 'none'}] -> {args.hw_profile}")
        measured.save(args.hw_profile)
    if capacity is not None and capacity.actions:
        print("capacity ladder actions:", capacity.actions)
    print("recoverable sessions:", engine.recoverable_sessions())
    _dump_metrics(engine, args.metrics_json)
    engine.close()
    store.close()                # joins the async IO workers, if attached


def _dump_metrics(engine, path) -> None:
    if not path:
        return
    with open(path, "w") as f:
        json.dump(engine.metrics.to_dict(), f, indent=2)
    print(f"metrics -> {path}")


if __name__ == "__main__":
    main()
