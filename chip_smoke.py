#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--phases NAME[,NAME]]

Needs one CUDA GPU and the repository checkout around this file. It

  1. prints the toolchain and the card, and builds the CUDA kernels from
     ``src/repro_torch/kernels/csrc`` (into ``build/kernels``);
  2. holds each kernel against its plain PyTorch version at the main
     paths' shapes and at every head size the port serves (hd 16, 64, 80,
     96, 128 and 256; windows, softcaps, fp32), checks that paged decode
     gives contiguous decode's bits at each head size and that prefill
     attention is deterministic and ignores keys past kv_len (NaN
     included), and times kernel, plain version and a PyTorch yardstick
     with CUDA events; the split-K decode kernels (#3 and #4) at every
     edge of their split plan (a row shorter than one split, one exactly
     two splits long, 4096 keys, a window starting inside a split,
     kv_len = 0 giving zeros; hd 16-256, G 1-16, bf16 and fp32), paged
     bitwise equal to contiguous there, and each row's bits the same
     alone, in a batch beside other lengths, in a larger cache with NaN
     past kv_len and through the pool (G 1 and 7); both decode kernels
     and SDPA timed by CUDA graph at ``tools/bench_decode.py``'s shapes
     (the main shapes, the lifecycle's B=1 step, qwen2-7b's G=7 grouping,
     hd 16/80/256), cycling over input copies larger than the L2;
     prefill attention at the four main-path shapes
     (self-prefills of 1024 and 2000 tokens, 256 over 2016 of history,
     128 over 1900) and at each head size; the restoration kernel at the
     six shapes of its three regimes (restore G=8 S=1024 and 2048, prefill
     G=1 S=2000 and 128, decode G=1 S=4 and 1, launches cycling over a
     32-layer stack), with the same rows launched alone at S = 1, 4, 128,
     300 and 1024 bitwise equal to the G=8 S=1024 launch (hd = 128, 96
     with bias, 80, 16 with bias, 256, and one kv head of 16); the
     Mamba1 state-update scan (one launch per layer call) bitwise equal
     to S single-token launches of itself at S = 1, 2, 31, 32, 33, 64,
     65, 1024 and 2000, Bt 1, 3 and 4, N 4, 8 and 16, bf16 and fp32, B and
     C as strided column views, within TOL of its plain version, and timed
     by CUDA graph at the decode steps (Bt 4 and 1) and a layer's
     1024- and 2000-token prefill, against the same tokens as S launches
     at S = 1, its bound and the exp unit's floor. The bf16 prefill-
     attention comparisons accept, beside TOL, the most that P's rounding
     to bf16 can move an element (``flash_p_rounding_bound``). Then
     kernels #1 and #3-#5 at the shapes qwen2-7b (G = 7, K/V 512 wide
     with bias) and gemma2-9b (hd 256, window 4096, softcap 50) give
     them, and at the shapes of granite-moe-1b-a400m (hd 64, G = 2, K/V
     512 wide), internvl2-26b (D 6144, G = 6, K/V 1024 wide) and
     grok-1-314b (softcap 30), and whisper-medium's (#1 the cross
     projection G=24 S=4096 D=KV=1024 without RoPE, #3/#4 a cross step
     over 750-4096 keys per row, #5 non-causal: the encoder at 1500 and
     4096 frames, a 448-token chunk over 1500) (``MODEL_RESTORE``,
     ``MODEL_DECODE``, ``MODEL_FLASH``, ``MODEL_FLASH_FULL``): each
     against its plain version, timed beside its bound and SDPA or
     ``torch.matmul``;
  3. serves the smoke configs (``reduced_for_smoke``: 4 layers, hd 16)
     through ``launch/serve.py`` on the card in bf16, without ``--full``:
     llama2-7b on the contiguous and the paged backend (4 sessions x 2
     rounds), again under ``--budget-kb 8`` (the ladder's actions must be
     printed) and paged with ``--prefix-sharing`` (its hit rate must be
     printed), falcon-mamba-7b and zamba2-2.7b (4 sessions, 1 round),
     and qwen2-7b,
     qwen2.5-14b, starcoder2-15b, gemma2-9b, granite-moe-1b-a400m,
     grok-1-314b and internvl2-26b (2 sessions x 2 rounds; qwen2-7b,
     gemma2-9b and granite on both backends, internvl paged) and
     whisper-medium (``--enc-seq 64``, 2 sessions x 2 rounds, both
     backends), llama2-13b (contiguous) and opt-30b (both backends: its
     learned absolute positions); then
     qwen2-7b again on a
     store of two layer-striped hosts (``--hosts 2``), which must report
     a per-link restore load and give the one-host serve's tokens; then
     ``serve.py --serve-http --port 0`` on a thread: two chat rounds over
     the socket, the second ``exact`` and restoring, a clean stop;
  4. drives the lifecycle path: llama2-7b at full width and depth in
     bf16, random weights from a seed, 3 sessions x 2 rounds of
     prefill -> save -> decode (saving hidden states) -> evict -> restore,
     checking restored K/V, greedy decoding (MATCH) and round 1's first
     token against a cache that was never evicted;
  5. restores llama2-7b sessions of 1024, 1536 and 2000 tokens (every
     layer by the hidden method) under the group plans 8, (1, 2, 4, 8,
     17), "fetch" and "auto", twice each, first under the static profile
     and then with a ``MeasuredProfile`` the restores feed, through the
     streams path (pinned staging ring, copy stream, CUDA events): every
     restored K/V bitwise equal to the K/V its prefill held; prints each
     restore's wall, projection device time and host split and the
     profile's fitted rates, and checks that ``save``/``load`` keeps them;
  6. drives the serving engine on the contiguous and then the paged KV
     backend: 6 sessions x 2 rounds over 4 slots with SplitFuse prefill
     chunks and mid-stream preemption, checking that both backends give
     the same tokens, that every restore rebuilds the K/V a session held
     before its pause bitwise (hidden and recompute layers), that every
     prefill ran the flash kernel and every decode step its decode kernel
     once per layer, and that every request agrees with a plain
     computation on the same weights (one unchunked, unbatched forward
     over the session's whole token stream): the logits that sampled each
     of its tokens, and each token as the plain logits' best up to bf16
     noise. Each backend runs twice: once with a synchronisation around
     every phase (the phase table) and once without (its wall and TTFTs
     measure how far restores overlap decode), with the same tokens; then
     the contiguous engine runs twice finishing every restore in the step
     it starts (so that the schedule does not depend on the restore
     plan), uncalibrated and calibrated (a ``MeasuredProfile``, group
     plan "auto"): the same tokens, profile samples for every method the
     calibrated restores ran, and its calibration gauges filled; then the
     contiguous engine's traffic once more under a host-storage budget
     (``CapacityManager``, 55 % of the phased run's peak hot bytes, no
     cold tier, the ladder cold -> int8 -> recompute) and a third round
     for a session the ladder put in int8: int8 actions,
     after every ``maintain`` the hot bytes within the budget unless
     only protected sessions hold them, restores of sessions never in
     the int8 codec bitwise, those of sessions once in it within 0.02
     relative L2 of their snapshots and, for int8 restores, against the
     plain version (numpy dequantize, plain projection); and the paged
     engine with prefix sharing (a shared 1024-token document, a fork,
     copy-on-write pages, restore-skip) against its twin without: the
     same tokens, hits, skipped tokens, copies and shared pages, every
     page free after ``close``, the pool pages each run held at its peak
     and the copy debt held back beside them; then tensor-parallel
     serving (``TPContext``, every shard on the one card): a short
     workload (4 sessions x 2 rounds over 2 slots, preemptions, every
     layer restored by the hidden method) on the paged engine at tp 1, 2
     and 4 (the pool split by KV heads) and on the contiguous engine at
     tp 1 and 2 (only the restoration pack split): at each tp > 1 the
     tokens and every restored session's K/V bitwise those of tp 1,
     kernel #1's launches inside the projection groups and #4's exactly
     tp times those of tp 1 and the other launches the same, with wall,
     decode per step, projection device time and per-device gauges
     printed per width; then the HTTP front door
     (``repro_torch.frontend``: pump, router, API, socket) in front of
     the engine on the contiguous backend and on the paged one with
     prefix sharing, driven through the socket by a stdlib client
     (chat rounds routed fresh, exact, restore and, paged, fork; one
     SSE stream against the same request unstreamed; a burst past
     ``max_pending`` answered 429): every gated request's tokens equal
     to the same requests driven straight through an engine built the
     same way, its logits against the plain forward, per-route TTFT
     beside the twin's, no thread left running;
  7. frees llama2-7b and serves qwen2-7b at full width and QWEN_LAYERS
     of its 28 layers in
     bf16 (random weights from a seed) through the lifecycle of step 4
     and the engine of step 6 on both backends (phased), under the same
     gates; frees it and serves gemma2-9b at full width and GEMMA_LAYERS
     of its 42 layers (local and global alternate) through
     the lifecycle with a 4608-token and a 1024-token session, so that
     the 4096-token window of its local layers cuts the history in
     prefill, restore, the recompute replay and decode; frees it and
     serves granite-moe-1b-a400m (32 experts top-8) at full width and
     GRANITE_LAYERS of its 24 layers through the lifecycle and the
     engine on both backends, each
     request held against a plain computation that follows its session's
     prefill chunks and one-token decodes (a MoE layer's capacity depends
     on the segment's length), printing the share of expert assignments
     the capacity dropped per prefill chunk; frees it and serves
     internvl2-26b at full width and VLM_LAYERS of its 48 layers
     through the lifecycle with 256 seeded
     patch embeddings at the head of each round-0 prompt (every restore,
     of recompute layers too, bitwise equal to the K/V prefill emitted)
     and the paged engine, text only (4 sessions x 2 rounds over 4
     slots); frees it and serves grok-1-314b at full width and 4 of its
     64 layers (64 would not fit one card) through a lifecycle of two
     sessions, its attention softcap through kernels #3-#5; each phase
     prints its peak allocated device memory;
  8. frees it and drives the ssm path: falcon-mamba-7b at full
     width and SSM_LAYERS of its 64 layers in bf16 (random weights from a seed) through the
     lifecycle (3 sessions: prefill -> save -> decode -> pause dump ->
     evict -> restore, the restored conv and ssm states bitwise equal to
     the live ones, greedy decoding MATCH against the never-evicted
     states) and through the engine on the contiguous backend (6
     single-round sessions over 4 slots: every request against one
     unbatched forward over its stream, every retired session's restore
     bitwise equal to the states the engine held at retire, every prefill
     and decode step one scan launch per layer);
  9. frees it and drives the hybrid path: zamba2-2.7b (HYBRID_LAYERS of
     its 54 layers: super-blocks of 5 Mamba2 blocks and an attention
     block) at full width in bf16 through the lifecycle (3 sessions of 1024,
     1536 and 2000 tokens, 16 decode tokens saved row by row, pause,
     evict, restore: the attention blocks' restored K/V bitwise equal to
     the live cache on every token, prefill and decode rows alike, the
     Mamba2 states bitwise equal, 16 more tokens MATCH against the
     never-evicted cache; session 0 all-hidden, the others planned) and
     through the engine on the contiguous backend (6 single-round
     sessions over 4 slots: every token's logits bitwise equal to a B=1
     pass over its session's own prompt and tokens, so every token is that
     pass's greedy choice; every retired session's restore bitwise equal
     to its K/V and states at retire);
 10. frees it and drives the enc-dec path: whisper-medium (ENCDEC_LAYERS
     of its 24 encoder and of its 24 decoder layers, d=1024) at full
     width in bf16 through the
     lifecycle (sessions of 1500, 3000 and 4096 frames with 448-, 256-
     and 128-token prompts: 16 decode tokens saved, pause, evict,
     restore: the self K/V bitwise equal to the live cache on every
     token, the cross K/V bitwise equal to the prefill's, 8 tokens MATCH
     against the never-evicted cache, then a 64-token round 1 over each
     cache giving the same tokens; session 0 all-hidden, the others
     planned; the enc blob's bytes printed beside the cross K/V's) and
     through the engine on both backends (6 sessions x 2 rounds over 4
     slots, ``enc_seq`` 4096, frames of 750/1500/3000/4096 positions in
     turn, prompts of 128-448 tokens, mid-stream preemption): the same
     tokens on both, every restore's self K/V bitwise equal to its
     snapshot and its cross K/V to its prefill's, every prefill running
     the flash kernel twice per decoder layer (and once per encoder
     layer on a first chunk) and every decode step the decode kernels
     twice per decoder layer (self and cross), every request against the
     encoder and one plain decoder forward over its stream;
 11. trains every family at its shape on the card (``training.data.
     CARD_TRAIN_SHAPES``), bf16 over an fp32 master, one repeated seeded
     batch: llama2-7b at full width and 4 of its 32 layers, 8 AdamW steps
     on 4 x 2048 tokens (every layer's wq/wk/wv gradient finite and
     non-zero, the loss falling; step ms, tokens/s, peak memory); then
     ``launch/train.py`` on the smoke config with a failure injected at
     step 7, bitwise equal to the uninterrupted run; then kernel #6 under
     autograd (``SSMScanFn``: a launch per 128-token chunk, a plain
     backward), its forward at falcon-mamba-7b's training shape against
     the plain scan and its gradients at a small shape against autograd
     through the plain scan, timed; then one gradient and 3 AdamW steps
     each of granite-moe-1b-a400m (24 layers; every wq/wk/wv and router
     gradient non-zero, the recompute's routing equal to the forward's,
     aux finite and positive), falcon-mamba-7b (4 layers; a_log,
     dt_proj, x_proj and conv_w gradients non-zero), zamba2-2.7b (12
     layers; Mamba2 a_log and attention wq/wk/wv gradients non-zero),
     whisper-medium (24 + 24 layers over 1500 frames; encoder q/k/v and
     cross k/v gradients non-zero) and internvl2-26b (1 layer, 256 patch
     positions; wq/wk/wv gradients non-zero, every gradient finite), each
     loss finite and falling; last, kernel #5 under autograd
     (``FlashAttentionFn``) at every shape these phases gave it (GQA,
     non-causal encoders, cross-attention over more keys than queries):
     its forward against the plain version within TOL and P's rounding
     bound and its backward (plain PyTorch) against fp32 autograd
     through a dense attention, both timed beside SDPA's;
 12. the reference's mesh serving programs (``distributed/
     mesh_serving.py``; after llama2-7b's front door and after
     falcon-mamba-7b's engine), every shard on the card, each against its
     1x1 twin, which is bitwise the plain ``Model`` (prefill's logits,
     K/V and hidden; the restore; a decode step): llama2-7b at full size
     over 2x2 under the default rules (2 sessions x MESH_SEQ tokens,
     prefill with ``capture_hidden``, every layer restored from the
     twin's hidden into the context-split cache, bitwise the twin's
     restore, and from the mesh's own hidden, bitwise its prefill's K/V;
     MESH_STEPS decode steps fed the twin's tokens) and under
     long_context (one session of MESH_LONG_SEQ over 4 context shards);
     falcon-mamba-7b (SSM_LAYERS) over 1x2 (``ssm_inner`` over model;
     2 x MESH_SSM_SEQ, MESH_STEPS steps): logits within MESH_REL relative
     L2 of the twin's, #1/#3/#5/#6 launched exactly once per layer and
     shard; the same programs in fp32 at MESH_FP32_LAYERS layers, off the
     bf16 floor, within MESH_FP32_REL; then kernel #3 on a context slice
     (``kv_start``, the lse)
     against its plain version at every slice shape the phase gave it,
     with rows ending before their slice and a window across its start;
 13. the dry-run's counts (``launch/dryrun.py``, ``launch/
     exec_cost.py``; last): llama2-7b cells in bf16 (DRYRUN_CELLS: a
     prefill of 1 x 2048 and a restore of 2 x 2048 at full depth, one
     decode step of 8 rows at 2048, a train step of 1 x 1024 at 2 layers
     on 1x1; the same at 2 layers on 2x2, every shard on the card), each
     run twice uncounted, then counted on the card and on meta devices:
     per shard the same flops, bytes, collectives and kernel launches,
     the counted launches the kernels' own, the counted peak within
     DRYRUN_PEAK_REL of the allocator's; each cell's ms beside the
     roofline's terms under ``H100_SXM``, in DRYRUN_BUDGET_S;
 14. checks that each path launched its kernels (counts reset before and
     read after each path; the restoration kernel's also by regime, the
     prefill kernel's by shape), then prints the seconds of each phase,
     the card, the kernels' JSON line and the device line last.

``--phases NAME[,NAME]`` runs only the named phases (of ``PHASES``:
kernels, smoke, llama2-7b, mesh, qwen2-7b, gemma2-9b, moe-vlm, ssm,
hybrid, encdec, train, dryrun; default all), building only the models
they use; the kernels' JSON line is printed only when the kernel checks
ran. It is for iterating on one phase: a run that checks the port runs
them all.

Any failed check raises, so the script exits non-zero and prints no
result. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Published dense peaks (NVIDIA data sheets): bf16 tensor FLOP/s, HBM B/s,
# and fp32 FLOP/s outside the tensor cores.
PEAKS = {"sxm": (989e12, 3.35e12), "pcie": (756e12, 2.0e12)}
FP32_PEAKS = {"sxm": 67e12, "pcie": 51e12}

# |kernel - plain| <= RTOL * |plain| + ATOL, compared in fp32. bf16 keeps
# 8 significant bits: the two outputs are each rounded to bf16 from fp32
# sums taken in another order, so they may differ by one bf16 ulp
# (2^-7 relative); ATOL covers values near zero. fp32 outputs differ only
# by the order of the sums.
TOL = {"bf16": (2.0 ** -7, 1e-3), "fp32": (1e-4, 1e-5)}

SEED = 0
PROMPTS = (1024, 1536, 2000)      # round 0; 2000 exercises bucket padding
# gemma2-9b's lifecycle: a prompt past its 4096-token window, a short one
GEMMA_PROMPTS = (4608, 1024)
# Depth cuts that keep the whole script near its time budget of 900 s on
# a slow host: qwen2-7b's lifecycle and engines, gemma2-9b's lifecycle
# and internvl2-26b's lifecycle and engine run at half depth since the
# tensor-parallel phase, falcon-mamba-7b's, zamba2-2.7b's and
# whisper-medium's (encoder and decoder) at about half since the sharded
# training phase; widths, head groupings, windows, super-block layouts
# and every gate are the full configs'. The lm stacks go no lower: the
# planner's layer methods follow the depth, and at 7 layers qwen2-7b's
# engine planned no recompute layer, which its gates need.
QWEN_LAYERS = 14
GEMMA_LAYERS = 22
VLM_LAYERS = 24
SSM_LAYERS = 32
HYBRID_LAYERS = 30      # 5 of zamba2-2.7b's 9 super-blocks
ENCDEC_LAYERS = 12      # encoder and decoder each
# The MoE and VLM paths, after gemma2-9b, each model freed before the
# next loads: granite-moe-1b-a400m at full width and GRANITE_LAYERS of its
# 24 layers (the depth cut keeps the whole script inside its time limit:
# its engines' MoE replay, ~90 launches per layer, is host-bound and took
# ~180 s at full depth, ~40 s at 8) through the lifecycle and the
# engine on both
# backends; internvl2-26b at full width and VLM_LAYERS layers through a
# lifecycle whose round-0 prompts start with its frontend_dim (256) patch
# embeddings (seeded normals: the ViT front end is a stub in the
# reference too), then the paged engine, text only (4 sessions x 2
# rounds over 4 slots, VLM_ENGINE_PROMPTS then VLM_ROUND1_TOKENS);
# grok-1-314b at full width and GROK_LAYERS of its 64 layers (64 would
# not fit one 80 GB card) through a lifecycle of two sessions.
MOE_ARCH, GRANITE_LAYERS = "granite-moe-1b-a400m", 8
VLM_ARCH = "internvl2-26b"
VLM_ENGINE_PROMPTS = (512, 1024, 768, 896)
VLM_ROUND1_TOKENS = 128
VLM_ENGINE_MAX_SEQ = 1280     # 1024 + 16 + 128 + 16 tokens fit, in pages
GROK_ARCH, GROK_LAYERS = "grok-1-314b", 4
GROK_PROMPTS = (1024, 1024)
ROUND1_TOKENS = 256
DECODE_TOKENS = 16
MATCH_TOKENS = 8


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def card_kind(name: str) -> str:
    return "pcie" if "PCIe" in name else "sxm"


def card_peaks(name: str):
    return PEAKS[card_kind(name)]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
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
    """Median device time of one ``fn`` call, from ``n`` calls captured in
    a CUDA graph and replayed: for a kernel of a few microseconds the
    host's launch overhead would otherwise be what an eager loop times."""
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


def bound(flops: float, nbytes: float, name: str, flops_peak=None):
    peak_flops, peak_bw = card_peaks(name)
    peak_flops = flops_peak or peak_flops
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_close(what: str, got, want, dtype_name: str,
                slack=None) -> float:
    """|got - want| <= RTOL |want| + ATOL (+ ``slack``, per element, where
    a check derives one) everywhere; returns the largest |got - want|."""
    rtol, atol = TOL[dtype_name]
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(got.isfinite().all()):
        raise AssertionError(f"{what}: bad shape or non-finite output")
    err = (got - want).abs()
    limit = rtol * want.abs() + atol
    bad = err > (limit if slack is None else limit + slack)
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside "
                             f"tolerance, max abs err {float(err.max())}")
    return float(err.max())


# ----------------------------------------------------------- kernel checks
def restore_case(G, S, D, KV, hd, A, rows, bias, dtype, gen, stacks=None):
    import torch
    from repro_torch.models.layers.rope import rope_table
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    hidden = rnd(G, S, D)
    if stacks is None:
        stacks = (rnd(A, D, KV, scale=D ** -0.5),
                  rnd(A, D, KV, scale=D ** -0.5),
                  *((rnd(A, KV), rnd(A, KV)) if bias else (None, None)))
    cos, sin = rope_table(S, hd, 10000.0, dev)
    args = (hidden, *stacks,
            torch.tensor(rows, dtype=torch.int32, device=dev),
            cos[:S].contiguous(), sin[:S].contiguous())
    return args


# (offset, length) windows of one group row launched alone, cut at the
# row's end (None: to the end): S = 1, 4 and 128 run the bytes-bound tile
# plan, the whole row the G = 1 operations plan, the others at odd offsets
INVARIANCE_WINDOWS = ((5, 1), (77, 4), (333, 128), (5, 300), (0, None))


def check_row_invariance(rkv, args, full, hd, use_rope=True):
    """The same rows launched alone, at other lengths, tile offsets, tile
    plans and group positions, give bitwise-equal K/V: what makes
    restored K/V (G = 8, S = bucket) equal prefill's (G = 1, S = chunk)
    and decode's (G = 1, S = batch)."""
    hidden, wk, wv, bk, bv, rows, cos, sin = args
    S = hidden.shape[1]
    for a, n in INVARIANCE_WINDOWS:
        b = S if n is None else min(a + n, S)
        if a >= b:
            continue
        part = rkv.restore_kv_grouped_cuda(
            hidden[1:2, a:b].contiguous(), wk, wv, bk, bv,
            rows[1:2].contiguous(), cos[a:b].contiguous(),
            sin[a:b].contiguous(), head_dim=hd, use_rope=use_rope)
        for got, want in zip(part, full):
            if not torch_equal(got, want[1:2, a:b]):
                raise AssertionError(
                    f"restore kernel output depends on the row's position "
                    f"in the launch (hd={hd}, rows {a}..{b} alone)")


def torch_equal(x, y) -> bool:
    import torch
    return bool(torch.equal(x, y))


# the six shapes of the three regimes on llama2-7b: restoration (G = 8,
# S = bucket), prefill (G = 1, S = the lifecycle's 2000-token prompt and
# the engine's 128-token chunk) and decode (G = 1, S = the batch)
RESTORE_SHAPES = ((8, 1024), (8, 2048), (1, 2000), (1, 128), (1, 4), (1, 1))


def restore_regime(G: int, S: int) -> str:
    """The caller a launch shape comes from on chip_smoke's paths: the
    executor projects groups of 8 layers, prefill and decode one layer
    at S = tokens (decode: S = the batch, at most 4 slots)."""
    return "restore" if G > 1 else "decode" if S <= 4 else "prefill"


def check_restore(card: str, gen):
    import itertools

    import torch
    from repro_torch.kernels import restore_kv as rkv
    kw = dict(head_dim=128, use_rope=True)
    D, KV, A = 4096, 4096, 32
    shapes, stacks, main = [], None, None
    for G, S in RESTORE_SHAPES:
        args = restore_case(G, S, D, KV, 128, A, list(range(8, 8 + G)),
                            False, torch.bfloat16, gen, stacks)
        stacks = args[1:5]
        k, v = rkv.restore_kv_grouped_cuda(*args, **kw)
        torch.cuda.synchronize()
        large = G * S >= 2000
        reps = 1 if large else 3
        box = {}

        def plain():
            box["out"] = rkv.restore_kv_grouped_plain(*args, **kw)

        plain_ms = time_ms(plain, reps, warmup=0)
        pk, pv = box.pop("out")
        err = max(check_close(f"restore K G={G} S={S}", k, pk, "bf16"),
                  check_close(f"restore V G={G} S={S}", v, pv, "bf16"))
        del pk, pv
        if (G, S) == RESTORE_SHAPES[0]:
            main = (args, (k, v))
        # weights cold in L2, as decode finds them: cycle the launches over
        # all 32 layers of the stack (67 MB of Wk|Wv per layer)
        hidden, wk, wv = args[:3]
        row_sets = [torch.arange(l, l + G, dtype=torch.int32, device="cuda")
                    for l in range(0, A, G)]
        cyc = itertools.cycle(row_sets)
        w_cat = torch.cat([wk, wv], -1)
        lib_cyc = itertools.cycle(range(0, A, G))

        def kern():
            rkv.restore_kv_grouped_cuda(hidden, wk, wv, None, None,
                                        next(cyc), args[6], args[7], **kw)

        def lib():
            l = next(lib_cyc)
            torch.matmul(hidden, w_cat[l:l + G])

        timer = (lambda f: time_ms(f, 20)) if large else graph_ms
        ms, lib_ms = timer(kern), timer(lib)
        del w_cat
        flops, nbytes = rkv.restore_cost(G, S, D, KV, 128)
        bound_ms, bound_by = bound(flops, nbytes, card)
        plan = rkv.tile_plan(G, S, KV, 128)
        print(f"restore_kv_grouped G={G} S={S} D={D} KV={KV} hd=128 bf16 "
              f"({restore_regime(G, S)}; plan {plan.args}, grid {plan.grid})"
              f": max_abs_err {err:.3g}; kernel {ms:.4f} ms "
              f"({'CUDA events' if large else 'CUDA graph of 100'}, layers "
              f"cycled), plain {plain_ms:.1f} ms ({reps} rep), torch.matmul "
              f"K|V yardstick {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB)")
        shapes.append({"G": G, "S": S, "regime": restore_regime(G, S),
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": lib_ms})
        if (G, S) != RESTORE_SHAPES[0]:
            del k, v
    args, full = main
    check_row_invariance(rkv, args, full, 128)
    print("restore_kv_grouped hd=128: rows launched alone at S = 1, 4, 128, "
          "300 and 1024 (odd offsets, both tile plans) bitwise equal to the "
          "G=8 S=1024 launch")
    del main, args, full, stacks
    # the other head sizes across tile plans, with bias: G = 8, S = 1024
    # runs the operations plan, the windows the bytes plan; KV = 16 is one
    # kv head of 16, whose 32-column boxes run past the tensor
    by_hd = {}
    for hd, KV_, bias in ((96, 8 * 96, True), (80, 8 * 80, False),
                          (16, 8 * 16, True), (256, 8 * 256, False),
                          (16, 16, False)):
        a = restore_case(8, 1024, 1024, KV_, hd, 8,
                         [2, 0, 3, 7, 1, 6, 5, 4], bias, torch.bfloat16, gen)
        t = graph_ms(lambda: rkv.restore_kv_grouped_cuda(*a, head_dim=hd))
        b_ms, b_by = bound(2 * 8 * 1024 * 1024 * 2 * KV_,
                           2 * (8 * 1024 * 1024 + 2 * 8 * 1024 * KV_
                                + 2 * 8 * 1024 * KV_), card)
        by_hd[f"{hd}/KV{KV_}"] = {"ms": t, "bound_ms": b_ms,
                                  "bound_by": b_by}
        print(f"restore_kv_grouped G=8 S=1024 D=1024 KV={KV_} hd={hd} bf16 "
              f"(plan {rkv.tile_plan(8, 1024, KV_, hd).args}): kernel "
              f"{t:.4f} ms (CUDA graph of 100), bound {b_ms:.4f} ms "
              f"({b_by})")
        for rope in (True, False):
            k2, v2 = rkv.restore_kv_grouped_cuda(*a, head_dim=hd,
                                                 use_rope=rope)
            torch.cuda.synchronize()
            pk2, pv2 = rkv.restore_kv_grouped_plain(*a, head_dim=hd,
                                                    use_rope=rope)
            e = max(check_close(f"restore K hd={hd} rope={rope}", k2, pk2,
                                "bf16"),
                    check_close(f"restore V hd={hd} rope={rope}", v2, pv2,
                                "bf16"))
            check_row_invariance(rkv, a, (k2, v2), hd, use_rope=rope)
            print(f"restore_kv_grouped G=8 S=1024 D=1024 KV={KV_} hd={hd} "
                  f"bias={bias} rope={rope} bf16: max_abs_err {e:.3g}; rows "
                  f"alone at S = 1, 4, 128, 300, 1024 bitwise equal")
    # extra cases: hd=96 with bias and S off the tile, fp32 at every other
    # head size
    for hd, bias, dtype, name in ((96, True, torch.bfloat16, "bf16"),
                                  (96, True, torch.float32, "fp32"),
                                  (80, False, torch.float32, "fp32"),
                                  (16, True, torch.float32, "fp32"),
                                  (256, False, torch.float32, "fp32")):
        a = restore_case(3, 300, 1024, 8 * hd, hd, 4, [2, 0, 3], bias,
                         dtype, gen)
        k2, v2 = rkv.restore_kv_grouped_cuda(a[0], *a[1:], head_dim=hd)
        torch.cuda.synchronize()
        pk2, pv2 = rkv.restore_kv_grouped_plain(*a, head_dim=hd)
        e = max(check_close(f"restore K hd={hd} {name}", k2, pk2, name),
                check_close(f"restore V hd={hd} {name}", v2, pv2, name))
        check_row_invariance(rkv, a, (k2, v2), hd)
        print(f"restore_kv_grouped G=3 S=300 D=1024 hd={hd} bias={bias} "
              f"{name}: max_abs_err {e:.3g}")
    torch.cuda.empty_cache()     # give the stacks' memory back
    m = shapes[0]
    return {"name": "restore_kv_grouped", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/restore_kv.cu",
            "replaces": "src/repro/kernels/restore_kv.py:138",
            "max_abs_err": max(x["max_abs_err"] for x in shapes),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "shapes": shapes,
            "by_head_dim": by_hd}


def decode_case(B, Kv, G, Smax, hd, lens, dtype, gen):
    import torch
    dev = "cuda"
    q = torch.randn(B * Kv, G, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Smax, Kv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Smax, Kv, hd, generator=gen, device=dev).to(dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32,
                          device=dev).repeat_interleave(Kv)
    return q, k, v, kv_len


def paged_case(lens, Kv, G, hd, bs, MB, dtype, gen):
    """A permuted page pool (NB, bs, Kv, hd) with pages of junk besides
    the rows' live pages, sentinel table entries (NB) past each row's
    pages, and the same rows as a contiguous (B, MB·bs, Kv, hd) cache."""
    import torch
    dev = "cuda"
    B = len(lens)
    pages = [-(-n // bs) for n in lens]
    NB = sum(pages) + 7
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(SEED))
    k_pool = torch.randn(NB, bs, Kv, hd, generator=gen, device=dev).to(dtype)
    v_pool = torch.randn(NB, bs, Kv, hd, generator=gen, device=dev).to(dtype)
    table = torch.full((B, MB), NB, dtype=torch.int32)
    at = 0
    for b, n in enumerate(pages):
        table[b, :n] = perm[at:at + n].to(torch.int32)
        at += n
    table = table.to(dev)
    q = torch.randn(B * Kv, G, hd, generator=gen, device=dev).to(dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32,
                          device=dev).repeat_interleave(Kv)
    idx = table.clamp(max=NB - 1).long()
    k = k_pool[idx].reshape(B, MB * bs, Kv, hd)
    v = v_pool[idx].reshape(B, MB * bs, Kv, hd)
    return q, k_pool, v_pool, table, kv_len, k, v


def decode_cost(card, B, Kv, G, hd, lens, paged=False):
    """(bound ms, bound_by, bytes) of one bf16 decode launch over B rows
    of ``lens`` live keys, from the kernel's own formula
    (``kernels/decode_attention.py::decode_cost``); for the pool one table
    entry per live 16-token page."""
    from repro_torch.kernels import decode_attention as dec
    flops, nbytes = dec.decode_cost(
        G, hd, [n for n in lens for _ in range(Kv)],
        table_entries=sum(-(-n // 16) for n in lens) if paged else 0)
    return (*bound(flops, nbytes, card), nbytes)


# (hd, G) of the split checks: every G bucket of the kernel (1, 2, 4, 8,
# 16), the smoke configs' hd 16, zamba2's 80, llama2's 128, gemma2's 256
DECODE_SPLIT_CASES = ((16, 4), (64, 16), (80, 4), (96, 2), (128, 1),
                      (128, 7), (256, 4))


def check_decode_splits():
    """Kernels #3 and #4 against the plain version at every plan edge:
    a row shorter than one split, one exactly two splits long, a row of
    4096 keys, one of 3 splits and 17 keys, and one with kv_len = 0
    (zeros); without, then with a window that starts inside a split and a
    softcap; bf16 and fp32. Paged gives contiguous's bits at each."""
    import torch
    from repro_torch.kernels import decode_attention as dec
    worst = 0.0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for hd, G in DECODE_SPLIT_CASES:
        for dtype, name in ((torch.bfloat16, "bf16"),
                            (torch.float32, "fp32")):
            S = dec.SPLIT_KEYS
            lens = [S // 2 + 3, 2 * S, 4096, 0, 3 * S + 17]
            a = paged_case(lens, 2, G, hd, 16, 4096 // 16 + 4, dtype, gen)
            q, kv_len, k, v = a[0], a[4], a[5], a[6]
            for kw in ({}, {"window": S + S // 3, "softcap": 50.0}):
                what = f"decode hd={hd} G={G} split {S} {name} {kw}"
                o3 = dec.decode_attention_cuda(q, k, v, kv_len, **kw)
                o4 = dec.decode_attention_paged_cuda(*a[:5], **kw)
                torch.cuda.synchronize()
                worst = max(worst, check_close(
                    what, o3, dec.decode_attention_plain(q, k, v, kv_len,
                                                         **kw), name))
                if not torch_equal(o4, o3):
                    raise AssertionError(f"{what}: paged decode differs "
                                         "from contiguous decode")
                if bool((o3[6:8] != 0).any()):
                    raise AssertionError(f"{what}: a kv_len = 0 row is "
                                         "not zero")
            print(f"decode_attention(_paged) hd={hd} G={G} {name}, splits "
                  f"of {S} keys, lens {lens}, and window {S + S // 3} "
                  f"softcap 50: within tolerance, paged bitwise equal to "
                  f"contiguous, zeros at kv_len 0")
    return worst


def check_decode_rows():
    """Row invariance, bitwise: each row decoded alone (B=1, a cache of
    exactly its length) gives the bits it gives in a batch beside rows of
    other lengths, in a cache with a larger Smax whose positions past
    kv_len hold NaN, and through the page pool (G 1 and 7, hd 128)."""
    import torch
    from repro_torch.kernels import decode_attention as dec
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    Kv, hd = 2, 128
    lens = [5, 256, 519, 1030, 4096]
    for G in (1, 7):
        for dtype, name in ((torch.bfloat16, "bf16"),
                            (torch.float32, "fp32")):
            q, kp, vp, table, kv_len, k, v = paged_case(
                lens, Kv, G, hd, 16, 4096 // 16 + 1, dtype, gen)
            big_k = torch.full((len(lens), 8192, Kv, hd), float("nan"),
                               dtype=dtype, device="cuda")
            big_v = big_k.clone()
            for b, n in enumerate(lens):
                big_k[b, :n], big_v[b, :n] = k[b, :n], v[b, :n]
            for kw in ({}, {"window": 300, "softcap": 30.0}):
                batch = dec.decode_attention_cuda(q, k, v, kv_len, **kw)
                big = dec.decode_attention_cuda(q, big_k, big_v, kv_len,
                                                **kw)
                paged = dec.decode_attention_paged_cuda(q, kp, vp, table,
                                                        kv_len, **kw)
                for b, n in enumerate(lens):
                    r = slice(b * Kv, (b + 1) * Kv)
                    alone = dec.decode_attention_cuda(
                        q[r], k[b:b + 1, :n], v[b:b + 1, :n], kv_len[r],
                        **kw)
                    for what, got in (("in a batch", batch[r]),
                                      ("in a larger cache", big[r]),
                                      ("through the pool", paged[r])):
                        if not torch_equal(got, alone):
                            raise AssertionError(
                                f"decode G={G} {name} {kw}: the row of "
                                f"{n} keys {what} differs from the row "
                                "alone")
            print(f"decode_attention G={G} {name} rows {lens}: alone, in a "
                  f"batch, in an 8192-slot cache with NaN past kv_len and "
                  f"through the pool, bitwise equal (with and without "
                  f"window 300 softcap 30)")


def time_decode_shapes(card):
    """Graph device times of kernels #3 and #4 and of SDPA (the contiguous
    cache, a mask past each row's length) at ``bench_decode``'s shapes,
    each cycling over copies of its inputs that span twice the L2."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.tools import bench_decode as bd
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for name, (B, Kv, G, hd, lens, smax) in bd.SHAPES.items():
        cases = bd.shape_cases(name, gen)
        ms3 = graph_ms(bd.cycled(cases, bd.contiguous(dec)))
        ms4 = graph_ms(bd.cycled(cases, bd.paged(dec)))
        ar = torch.arange(smax, device="cuda")
        sdpa_in = [(q.reshape(B, Kv * G, 1, hd), k.transpose(1, 2),
                    v.transpose(1, 2),
                    (ar[None, :] < n[::Kv, None])[:, None, None, :])
                   for q, k, v, _, _, _, n in cases]
        try:
            lib_ms = graph_ms(bd.cycled(sdpa_in, lambda q, k, v, m: (
                F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                               enable_gqa=G > 1))))
        except TypeError:            # a PyTorch without enable_gqa
            lib_ms = None
        b3, by3, nb3 = decode_cost(card, B, Kv, G, hd, lens)
        b4, by4, _ = decode_cost(card, B, Kv, G, hd, lens, paged=True)
        out[name] = {"B": B, "Kv": Kv, "G": G, "hd": hd, "lens": list(lens),
                     "Smax": smax, "ms": ms3, "paged_ms": ms4,
                     "library_ms": lib_ms, "bound_ms": b3, "bound_by": by3,
                     "paged_bound_ms": b4, "paged_bound_by": by4}
        sd = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"decode {name} B={B} Kv={Kv} G={G} hd={hd} lens={list(lens)}"
              f" Smax={smax} bf16 (CUDA graphs of 100 over {len(cases)} "
              f"copies): #3 {ms3:.4f} ms, #4 {ms4:.4f} ms (16-token pages), "
              f"SDPA {sd} ms; bound {b3:.4f} / {b4:.4f} ms ({by3}; "
              f"{nb3 / 1e6:.1f} MB), #3 at {b3 / ms3:.0%} of it")
        del cases, sdpa_in
    return out


def check_decode(card: str, gen):
    """Kernel #3: the main shape, windows and softcaps, the other head
    sizes (timed with L2-resident inputs), then the plan's edges (with
    kernel #4), row invariance, and the graph timings of both kernels over
    inputs larger than the L2 (returned for kernel #4's entry)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    B, Kv, G, Smax, hd = 3, 32, 1, 4096, 128
    lens = [1100, 2017, 4096]
    q, k, v, kv_len = decode_case(B, Kv, G, Smax, hd, lens, torch.bfloat16,
                                  gen)
    out = dec.decode_attention_cuda(q, k, v, kv_len)
    torch.cuda.synchronize()
    err = check_close("decode (main)", out,
                      dec.decode_attention_plain(q, k, v, kv_len), "bf16")
    ms = time_ms(lambda: dec.decode_attention_cuda(q, k, v, kv_len), 20)
    plain_ms = time_ms(lambda: dec.decode_attention_plain(q, k, v, kv_len),
                       20)
    qs = q.reshape(B, Kv * G, 1, hd)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(Smax, device="cuda")[None, :]
            < torch.tensor(lens, device="cuda")[:, None])[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask), 20)
    live = sum(lens) * Kv
    flops = 4 * G * hd * live
    nbytes = 2 * (2 * B * Kv * G * hd + 2 * live * hd) + 4 * B * Kv
    bound_ms, bound_by = bound(flops, nbytes, card)
    print(f"decode_attention B={B} Kv={Kv} G={G} Smax={Smax} lens={lens} "
          f"bf16: max_abs_err {err:.3g}; one eager call {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA yardstick {lib_ms:.4f} ms (eager), "
          f"bound {bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB)")
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        q2, k2, v2, l2 = decode_case(2, 4, 4, 1000, 128, [1000, 333], dtype,
                                     gen)
        kw = dict(softcap=50.0, window=256)
        o2 = dec.decode_attention_cuda(q2, k2, v2, l2, **kw)
        torch.cuda.synchronize()
        e = check_close(f"decode G=4 window softcap {name}", o2,
                        dec.decode_attention_plain(q2, k2, v2, l2, **kw),
                        name)
        print(f"decode_attention G=4 Smax=1000 window=256 softcap=50 "
              f"{name}: max_abs_err {e:.3g}")
    # the other head sizes: held against the plain version in both dtypes,
    # and timed in bf16 (4 rows of 8 kv heads with 2 query heads each)
    by_hd = {}
    for hd_ in (16, 80, 256):
        for dtype, name in ((torch.bfloat16, "bf16"),
                            (torch.float32, "fp32")):
            q2, k2, v2, l2 = decode_case(2, 4, 4, 1000, hd_, [1000, 333],
                                         dtype, gen)
            kw = dict(softcap=50.0, window=256)
            o2 = dec.decode_attention_cuda(q2, k2, v2, l2, **kw)
            torch.cuda.synchronize()
            e = check_close(f"decode hd={hd_} {name}", o2,
                            dec.decode_attention_plain(q2, k2, v2, l2, **kw),
                            name)
            print(f"decode_attention hd={hd_} G=4 window=256 softcap=50 "
                  f"{name}: max_abs_err {e:.3g}")
        lens_ = [2000, 1500, 700, 1900]
        q2, k2, v2, l2 = decode_case(4, 8, 2, 2048, hd_, lens_,
                                     torch.bfloat16, gen)
        t = graph_ms(lambda: dec.decode_attention_cuda(q2, k2, v2, l2))
        live_ = sum(lens_) * 8
        b_ms, b_by = bound(4 * 2 * hd_ * live_,
                           2 * (2 * 64 * hd_ + 2 * live_ * hd_) + 128, card)
        by_hd[hd_] = {"ms": t, "bound_ms": b_ms, "bound_by": b_by}
        print(f"decode_attention B=4 Kv=8 G=2 hd={hd_} lens={lens_} bf16: "
              f"kernel {t:.4f} ms (CUDA graph of 100, inputs L2-resident), "
              f"bound {b_ms:.4f} ms ({b_by})")
    del q, k, v
    err = max(err, check_decode_splits())
    check_decode_rows()
    shapes = time_decode_shapes(card)
    m = shapes["main3"]
    print(f"decode_attention main shape: kernel {m['ms']:.4f} ms (graph), "
          f"SDPA {m['library_ms']} ms (graph), bound {m['bound_ms']:.4f} ms "
          f"({m['bound_by']})")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:145",
            "max_abs_err": err, "ms": m["ms"], "eager_ms": ms,
            "plain_ms": plain_ms, "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "library_eager_ms": lib_ms, "by_head_dim": by_hd,
            "shapes": shapes}, shapes


def check_paged_decode(card: str, gen, shapes):
    """Kernel #4: the paged engine's step, windows and softcaps, the other
    head sizes, each bitwise equal to kernel #3 over the same logical
    cache; its graph time from ``shapes`` (``time_decode_shapes``)."""
    import torch
    from repro_torch.kernels import decode_attention as dec
    # the engine's decode step on llama2-7b: 4 slots, pages of 16 tokens
    lens, Kv, G, hd, bs, MB = [2300, 1537, 777, 2049], 32, 1, 128, 16, 160
    q, kp, vp, table, kv_len, k, v = paged_case(lens, Kv, G, hd, bs, MB,
                                                torch.bfloat16, gen)
    out = dec.decode_attention_paged_cuda(q, kp, vp, table, kv_len)
    torch.cuda.synchronize()
    err = check_close("paged decode (main)", out,
                      dec.decode_attention_paged_plain(q, kp, vp, table,
                                                       kv_len), "bf16")
    # the bitwise rule: paged decode gives contiguous decode's bits
    if not torch_equal(out, dec.decode_attention_cuda(q, k, v, kv_len)):
        raise AssertionError("paged decode differs from contiguous decode "
                             "over the same logical cache")
    ms = time_ms(lambda: dec.decode_attention_paged_cuda(q, kp, vp, table,
                                                         kv_len), 20)
    plain_ms = time_ms(lambda: dec.decode_attention_paged_plain(
        q, kp, vp, table, kv_len), 20)
    contiguous_ms = time_ms(lambda: dec.decode_attention_cuda(q, k, v,
                                                              kv_len), 20)
    B, live = len(lens), sum(lens) * Kv
    flops = 4 * G * hd * live
    nbytes = 2 * (2 * B * Kv * G * hd + 2 * live * hd) + 4 * B * Kv \
        + 4 * sum(-(-n // bs) for n in lens)
    bound_ms, bound_by = bound(flops, nbytes, card)
    print(f"decode_attention_paged B={B} Kv={Kv} G={G} hd={hd} bs={bs} "
          f"lens={lens} bf16: max_abs_err {err:.3g}, bitwise equal to "
          f"contiguous; one eager call {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, contiguous kernel on the gathered cache {contiguous_ms:.4f} "
          f"ms (eager), bound {bound_ms:.4f} ms ({bound_by}; "
          f"{nbytes / 1e6:.1f} MB)")
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        a = paged_case([1000, 333], 4, 4, 128, 16, 64, dtype, gen)
        kw = dict(softcap=50.0, window=256)
        o2 = dec.decode_attention_paged_cuda(*a[:5], **kw)
        torch.cuda.synchronize()
        e = check_close(f"paged decode G=4 window softcap {name}", o2,
                        dec.decode_attention_paged_plain(*a[:5], **kw), name)
        if not torch_equal(o2, dec.decode_attention_cuda(
                a[0], a[5], a[6], a[4], **kw)):
            raise AssertionError(f"paged decode {name} differs from "
                                 "contiguous decode")
        print(f"decode_attention_paged G=4 bs=16 window=256 softcap=50 "
              f"{name}: max_abs_err {e:.3g}, bitwise equal to contiguous")
    # the other head sizes, each bitwise equal to contiguous decode
    by_hd = {}
    for hd_ in (16, 80, 256):
        for dtype, name in ((torch.bfloat16, "bf16"),
                            (torch.float32, "fp32")):
            a = paged_case([1000, 333], 4, 4, hd_, 16, 64, dtype, gen)
            kw = dict(softcap=50.0, window=256)
            o2 = dec.decode_attention_paged_cuda(*a[:5], **kw)
            torch.cuda.synchronize()
            e = check_close(f"paged decode hd={hd_} {name}", o2,
                            dec.decode_attention_paged_plain(*a[:5], **kw),
                            name)
            if not torch_equal(o2, dec.decode_attention_cuda(
                    a[0], a[5], a[6], a[4], **kw)):
                raise AssertionError(f"paged decode hd={hd_} {name} "
                                     "differs from contiguous decode")
            print(f"decode_attention_paged hd={hd_} G=4 bs=16 window=256 "
                  f"softcap=50 {name}: max_abs_err {e:.3g}, bitwise equal "
                  f"to contiguous")
        lens_ = [2000, 1500, 700, 1900]
        a = paged_case(lens_, 8, 2, hd_, 16, 128, torch.bfloat16, gen)
        t = graph_ms(lambda: dec.decode_attention_paged_cuda(*a[:5]))
        live_ = sum(lens_) * 8
        b_ms, b_by = bound(4 * 2 * hd_ * live_,
                           2 * (2 * 64 * hd_ + 2 * live_ * hd_) + 128
                           + 4 * sum(-(-n // 16) for n in lens_), card)
        by_hd[hd_] = {"ms": t, "bound_ms": b_ms, "bound_by": b_by}
        print(f"decode_attention_paged B=4 Kv=8 G=2 hd={hd_} bs=16 "
              f"lens={lens_} bf16: kernel {t:.4f} ms (CUDA graph of 100, "
              f"inputs L2-resident), bound {b_ms:.4f} ms ({b_by})")
    m = shapes["main4"]
    print(f"decode_attention_paged main shape: kernel {m['paged_ms']:.4f} "
          f"ms (graph), kernel #3 on the same rows {m['ms']:.4f} ms (graph), "
          f"bound {m['paged_bound_ms']:.4f} ms ({m['paged_bound_by']})")
    return {"name": "decode_attention_paged", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:89",
            "max_abs_err": err, "ms": m["paged_ms"], "eager_ms": ms,
            "plain_ms": plain_ms, "bound_ms": m["paged_bound_ms"],
            "bound_by": m["paged_bound_by"], "library_ms": None,
            "yardstick": {"what": "decode_attention (kernel #3) on the "
                                  "same rows in a contiguous cache (graph)",
                          "ms": m["ms"], "eager_gathered_ms": contiguous_ms},
            "by_head_dim": by_hd}


def flash_band(offsets, kv_lens, Sq, window=None):
    """(query, key) pairs a causal prefill must visit: per query at
    position p, keys below min(p + 1, kv_len), from p - window + 1
    (``kernels/flash_attention.py::flash_pairs``)."""
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_pairs(offsets, kv_lens, Sq, window=window)


def flash_case(B, Sq, Skv, H, Kv, hd, dtype, gen):
    import torch
    dev = "cuda"
    q = torch.randn(B, Sq, H, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Skv, Kv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Skv, Kv, hd, generator=gen, device=dev).to(dtype)
    return q, k, v


# the main path's prefills (history, new tokens): the lifecycle's round-0
# self-prefills at 1024 and 2000 tokens and round 1's 256 over restored
# history, an engine chunk of 128 over history, and a one-token segment
# over history as the engine's recompute replay runs decode steps
FLASH_SHAPES = ((0, 1024), (2016, 256), (1900, 128), (0, 2000), (2000, 1))
HEAD_DIMS = (16, 64, 80, 96, 128, 256)


def sdpa_ms(F, q, k, v, hist):
    """SDPA over the same causal band, K/V heads expanded beforehand;
    device time per call from a CUDA graph of 100."""
    import torch
    Sq, Skv, H = q.shape[1], k.shape[1], q.shape[2]
    qs = q.transpose(1, 2).contiguous()
    ks, vs = (t.repeat_interleave(H // t.shape[2], 2).transpose(1, 2)
              .contiguous() for t in (k, v))
    if hist == 0 and Sq == Skv:
        return graph_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True))
    mask = (torch.arange(Skv, device="cuda")[None, :]
            <= hist + torch.arange(Sq, device="cuda")[:, None])
    return graph_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask))


def flash_cost(card, B, Sq, Skv, H, Kv, hd, hist):
    """(bound ms, bound_by, flops, bytes) of a causal prefill of Sq new
    tokens over hist of history, from the kernel's own formula
    (``kernels/flash_attention.py::flash_cost``)."""
    from repro_torch.kernels import flash_attention as fa
    flops, nbytes = fa.flash_cost(B, Sq, Skv, H, Kv, hd, offsets=[hist] * B,
                                  kv_lens=[Skv] * B)
    return (*bound(flops, nbytes, card), flops, nbytes)


def check_flash(card: str, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    H = Kv = 32
    hd = 128
    shapes = []
    for hist, Sq in FLASH_SHAPES:
        Skv = hist + Sq
        q, k, v = flash_case(1, Sq, Skv, H, Kv, hd, torch.bfloat16, gen)
        off = torch.tensor([hist], dtype=torch.int32, device="cuda")
        kl = torch.tensor([Skv], dtype=torch.int32, device="cuda")
        out = fa.flash_attention_cuda(q, k, v, off, kl)
        torch.cuda.synchronize()
        err = check_close(f"flash hist={hist} Sq={Sq}", out,
                          fa.flash_attention_plain(q, k, v, off, kl), "bf16",
                          fa.flash_p_rounding_bound(q, k, v, off, kl))
        if not torch_equal(out, fa.flash_attention_cuda(q, k, v, off, kl)):
            raise AssertionError("flash attention is not deterministic")
        ms = graph_ms(lambda: fa.flash_attention_cuda(q, k, v, off, kl))
        eager_ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, off,
                                                           kl), 20)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, off,
                                                            kl), 5)
        lib_ms = sdpa_ms(F, q, k, v, hist)
        bound_ms, bound_by, flops, nbytes = flash_cost(card, 1, Sq, Skv, H,
                                                       Kv, hd, hist)
        plan = fa.flash_plan(1, Sq, Skv, H, Kv, hd)
        print(f"flash_attention Sq={Sq} on {hist} of history H=Kv={H} "
              f"hd={hd} bf16 (plan {plan.args}, grid {plan.grid}): "
              f"max_abs_err {err:.3g}, deterministic; kernel {ms:.4f} ms "
              f"(CUDA graph of 100; one eager call {eager_ms:.4f} ms by "
              f"CUDA events), plain {plain_ms:.3f} ms, SDPA yardstick "
              f"{lib_ms:.4f} ms (graph), "
              f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} "
              f"GFLOP in the causal band, {nbytes / 1e6:.1f} MB), "
              f"{bound_ms / ms:.0%} of the bound")
        shapes.append({"hist": hist, "Sq": Sq, "Skv": Skv,
                       "max_abs_err": err, "ms": ms, "eager_ms": eager_ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms,
                       "splits": plan.splits})
    # every head size, in bf16 and fp32: GQA groups of 4 (two heads per
    # block), 3 (a block with one head of its own) and 1, per-batch
    # offsets, keys past kv_len, a window and a softcap, and non-causal
    for hd_, H_, Kv_ in [(d, 8, 2) for d in HEAD_DIMS] + [(128, 6, 2),
                                                         (80, 4, 4)]:
        for dtype, name in ((torch.bfloat16, "bf16"),
                            (torch.float32, "fp32")):
            q, k, v = flash_case(2, 200, 520, H_, Kv_, hd_, dtype, gen)
            off = torch.tensor([300, 250], dtype=torch.int32, device="cuda")
            kl = torch.tensor([500, 450], dtype=torch.int32, device="cuda")
            kw = dict(softcap=30.0, window=128)
            # bf16: P's rounding bound beside TOL; fp32 as it was
            bf16 = name == "bf16"
            o2 = fa.flash_attention_cuda(q, k, v, off, kl, **kw)
            torch.cuda.synchronize()
            e = check_close(f"flash hd={hd_} window softcap {name}", o2,
                            fa.flash_attention_plain(q, k, v, off, kl, **kw),
                            name, fa.flash_p_rounding_bound(
                                q, k, v, off, kl, **kw) if bf16 else None)
            o3 = fa.flash_attention_cuda(q, k, v, off, kl, causal=False)
            torch.cuda.synchronize()
            e = max(e, check_close(
                f"flash hd={hd_} non-causal {name}", o3,
                fa.flash_attention_plain(q, k, v, off, kl, causal=False),
                name, fa.flash_p_rounding_bound(
                    q, k, v, off, kl, causal=False) if bf16 else None))
            # keys past kv_len may hold anything, NaN included
            for t in (k, v):
                t[0, 500:], t[1, 450:] = float("nan"), float("nan")
            o4 = fa.flash_attention_cuda(q, k, v, off, kl, **kw)
            if not (torch_equal(o4, o2) and torch_equal(
                    o4, fa.flash_attention_cuda(q, k, v, off, kl, **kw))):
                raise AssertionError(f"flash hd={hd_} {name}: keys past "
                                     "kv_len changed the output, or a "
                                     "rerun did")
            print(f"flash_attention B=2 Sq=200 Skv=520 H={H_} Kv={Kv_} "
                  f"hd={hd_} offsets 300/250 kv_len 500/450 window=128 "
                  f"softcap=30, and non-causal, {name}: max_abs_err "
                  f"{e:.3g}; NaN past kv_len ignored, deterministic")
    # the kernel's time at each head size: a 1024-token causal
    # self-prefill of 16 heads over 8 kv heads (gemma2-9b's grouping)
    by_hd = {}
    for hd_ in HEAD_DIMS:
        q, k, v = flash_case(1, 1024, 1024, 16, 8, hd_, torch.bfloat16, gen)
        off = torch.zeros(1, dtype=torch.int32, device="cuda")
        kl = torch.full((1,), 1024, dtype=torch.int32, device="cuda")
        ms = graph_ms(lambda: fa.flash_attention_cuda(q, k, v, off, kl))
        lib_ms = sdpa_ms(F, q, k, v, 0)
        bound_ms, bound_by, _, _ = flash_cost(card, 1, 1024, 1024, 16, 8,
                                              hd_, 0)
        by_hd[hd_] = {"ms": ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by}
        print(f"flash_attention 1024-token self-prefill H=16 Kv=8 hd={hd_} "
              f"bf16: kernel {ms:.4f} ms, SDPA {lib_ms:.4f} ms (CUDA graphs "
              f"of 100), bound {bound_ms:.4f} ms ({bound_by})")
    m = shapes[0]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:83",
            "max_abs_err": max(x["max_abs_err"] for x in shapes),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "shapes": shapes,
            "by_head_dim": by_hd}


# ---------------------------------------- the new dense models' shapes
# kernels #1 and #3-#5 at the shapes qwen2-7b (28 heads over 4 kv heads
# of 128, K/V width 512, QKV bias) and gemma2-9b (16 heads over 8 kv
# heads of 256, a 4096-token window on its local layers, attention
# softcap 50) give them on this script's paths, bf16
MODEL_RESTORE = {    # name: (G, S, D, KV, hd, bias)
    "qwen2-7b restore": (8, 1024, 3584, 512, 128, True),
    "gemma2-9b restore": (8, 1024, 3584, 2048, 256, False),
    "internvl2-26b restore": (8, 1024, 6144, 1024, 128, False),
    "granite-moe-1b restore": (8, 1024, 1024, 512, 64, False),
    "zamba2-2.7b restore": (9, 1024, 2560, 2560, 80, False),
    # the cross projection: every decoder layer's cross K/V from one
    # 4096-frame encoder output, copied to the 24 group rows
    "whisper-medium cross projection": (24, 4096, 1024, 1024, 64, False),
}
MODEL_DECODE = {     # name: (B, Kv, G, hd, lens, Smax, window, softcap)
    "qwen2-7b engine step": (4, 4, 7, 128, (2300, 1537, 777, 2049), 2560,
                             None, None),
    "gemma2-9b local": (1, 8, 2, 256, (4880,), 4904, 4096, 50.0),
    "gemma2-9b global": (1, 8, 2, 256, (4880,), 4904, None, 50.0),
    "granite-moe-1b engine step": (4, 8, 2, 64, (2300, 1537, 777, 2049),
                                   2560, None, None),
    "internvl2-26b engine step": (4, 8, 6, 128, (1180, 655, 1040, 790),
                                  1280, None, None),
    "grok-1-314b step": (1, 8, 6, 128, (1296,), 1304, None, 30.0),
    "zamba2-2.7b engine step": (4, 32, 1, 80, (1040, 272, 784, 528), 1088,
                                None, None),
    # cross-attention at decode: each row's enc_len live, enc_seq 4096
    "whisper-medium cross step": (4, 16, 1, 64, (750, 1500, 3000, 4096),
                                  4096, None, None),
}
MODEL_FLASH = {      # name: (history, Sq, H, Kv, hd, window, softcap)
    "qwen2-7b 1024 self": (0, 1024, 28, 4, 128, None, None),
    "qwen2-7b 256 over 2016": (2016, 256, 28, 4, 128, None, None),
    "gemma2-9b 4608 self local": (0, 4608, 16, 8, 256, 4096, 50.0),
    "gemma2-9b 4608 self global": (0, 4608, 16, 8, 256, None, 50.0),
    "gemma2-9b 256 over 4624 local": (4624, 256, 16, 8, 256, 4096, 50.0),
    "granite-moe-1b 1024 self": (0, 1024, 16, 8, 64, None, None),
    "internvl2-26b 1024 self": (0, 1024, 48, 8, 128, None, None),
    "grok-1-314b 1024 self": (0, 1024, 48, 8, 128, None, 30.0),
    "zamba2-2.7b 1024 self": (0, 1024, 32, 32, 80, None, None),
}
MODEL_FLASH_FULL = {  # name: (Sq, Skv, H, Kv, hd); non-causal, no offset
    "whisper-medium encoder 1500": (1500, 1500, 16, 16, 64),
    "whisper-medium encoder 4096": (4096, 4096, 16, 16, 64),
    "whisper-medium cross prefill 448 over 1500": (448, 1500, 16, 16, 64),
}


def time_model_shapes(card):
    """Kernels #1, #3, #4 and #5 at MODEL_RESTORE, MODEL_DECODE,
    MODEL_FLASH and (#5 non-causal) MODEL_FLASH_FULL: each held against
    its plain version (paged decode
    bitwise equal to contiguous; a restored row alone bitwise equal to
    its group launch), then timed beside its bound and a PyTorch
    yardstick (SDPA applies no softcap: its time at gemma2-9b's and
    grok-1-314b's shapes leaves the softcap out). Draws from a generator of its own, so the
    earlier phases' data do not change. Returns {kernel name: rows}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import restore_kv as rkv
    from repro_torch.tools import bench_decode as bd
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = {"restore_kv_grouped": [], "decode_attention": [],
           "decode_attention_paged": [], "flash_attention": []}
    for name, (G, S, D, KV, hd, bias) in MODEL_RESTORE.items():
        args = restore_case(G, S, D, KV, hd, G, list(range(G)), bias,
                            torch.bfloat16, gen)
        # the cross projection applies no RoPE
        kw = dict(head_dim=hd, use_rope=not name.endswith("cross projection"))
        k, v = rkv.restore_kv_grouped_cuda(*args, **kw)
        torch.cuda.synchronize()
        pk, pv = rkv.restore_kv_grouped_plain(*args, **kw)
        err = max(check_close(f"{name} K", k, pk, "bf16"),
                  check_close(f"{name} V", v, pv, "bf16"))
        check_row_invariance(rkv, args, (k, v), hd, kw["use_rope"])
        del pk, pv
        w_cat = torch.cat([args[1], args[2]], -1)
        ms = time_ms(lambda: rkv.restore_kv_grouped_cuda(*args, **kw), 20)
        lib_ms = time_ms(lambda: torch.matmul(args[0], w_cat), 20)
        bound_ms, bound_by = bound(*rkv.restore_cost(
            G, S, D, KV, hd, bias=bias, rope=kw["use_rope"]), card)
        print(f"{name} G={G} S={S} D={D} KV={KV} hd={hd} bias={bias} "
              f"rope={kw['use_rope']} bf16: "
              f"max_abs_err {err:.3g}, rows alone bitwise equal; kernel "
              f"{ms:.4f} ms (CUDA events), torch.matmul K|V yardstick "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        out["restore_kv_grouped"].append({
            "shape": name, "G": G, "S": S, "D": D, "KV": KV, "hd": hd,
            "bias": bias, "max_abs_err": err, "ms": ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms})
        del args, k, v, w_cat
    for name, (B, Kv, G, hd, lens, smax, window, cap) in \
            MODEL_DECODE.items():
        kw = dict(window=window, softcap=cap)
        live_bytes = 4 * sum(lens) * Kv * hd
        cases = [bd.make_case(B, Kv, G, hd, lens, smax, gen) for _ in
                 range(min(8, max(1, -(-int(bd.L2_SPAN) // live_bytes))))]
        q, k, v, kp, vp, table, n = cases[0]
        got = dec.decode_attention_cuda(q, k, v, n, **kw)
        torch.cuda.synchronize()
        err = check_close(f"decode {name}", got,
                          dec.decode_attention_plain(q, k, v, n, **kw),
                          "bf16")
        if not torch_equal(dec.decode_attention_paged_cuda(
                q, kp, vp, table, n, **kw), got):
            raise AssertionError(f"decode {name}: paged differs from "
                                 "contiguous")
        ms3 = graph_ms(bd.cycled(cases, lambda q, k, v, kp, vp, t, n: (
            dec.decode_attention_cuda(q, k, v, n, **kw))))
        ms4 = graph_ms(bd.cycled(cases, lambda q, k, v, kp, vp, t, n: (
            dec.decode_attention_paged_cuda(q, kp, vp, t, n, **kw))))
        ar = torch.arange(smax, device="cuda")
        sdpa_in = []
        for q_, k_, v_, _, _, _, n_ in cases:
            last = n_[::Kv, None]
            keep = ar[None, :] < last
            if window:
                keep = keep & (ar[None, :] >= last - window)
            sdpa_in.append((q_.reshape(B, Kv * G, 1, hd), k_.transpose(1, 2),
                            v_.transpose(1, 2), keep[:, None, None, :]))
        lib_ms = graph_ms(bd.cycled(sdpa_in, lambda q, k, v, m: (
            F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                           enable_gqa=G > 1))))
        seen = [min(x, window) if window else x for x in lens]
        b3, by3, nbytes = decode_cost(card, B, Kv, G, hd, seen)
        b4, by4, _ = decode_cost(card, B, Kv, G, hd, seen, paged=True)
        print(f"decode {name} B={B} Kv={Kv} G={G} hd={hd} lens={list(lens)} "
              f"Smax={smax} window={window} softcap={cap} bf16: max_abs_err "
              f"{err:.3g}, paged bitwise equal; #3 {ms3:.4f} ms, #4 "
              f"{ms4:.4f} ms, SDPA {lib_ms:.4f} ms (CUDA graphs of 100 over "
              f"{len(cases)} copies), bound {b3:.4f} / {b4:.4f} ms ({by3}; "
              f"{nbytes / 1e6:.1f} MB)")
        row = {"shape": name, "B": B, "Kv": Kv, "G": G, "hd": hd,
               "lens": list(lens), "Smax": smax, "window": window,
               "softcap": cap, "max_abs_err": err, "library_ms": lib_ms}
        out["decode_attention"].append(dict(row, ms=ms3, bound_ms=b3,
                                            bound_by=by3))
        out["decode_attention_paged"].append(dict(row, ms=ms4, bound_ms=b4,
                                                  bound_by=by4))
        del cases, sdpa_in
    for name, (hist, Sq, H, Kv, hd, window, cap) in MODEL_FLASH.items():
        kw = dict(window=window, softcap=cap)
        Skv = hist + Sq
        q, k, v = flash_case(1, Sq, Skv, H, Kv, hd, torch.bfloat16, gen)
        off = torch.tensor([hist], dtype=torch.int32, device="cuda")
        kl = torch.tensor([Skv], dtype=torch.int32, device="cuda")
        got = fa.flash_attention_cuda(q, k, v, off, kl, **kw)
        torch.cuda.synchronize()
        err = check_close(f"flash {name}", got,
                          fa.flash_attention_plain(q, k, v, off, kl, **kw),
                          "bf16", fa.flash_p_rounding_bound(q, k, v, off, kl,
                                                            **kw))
        if not torch_equal(got, fa.flash_attention_cuda(q, k, v, off, kl,
                                                        **kw)):
            raise AssertionError(f"flash {name}: not deterministic")
        ms = graph_ms(lambda: fa.flash_attention_cuda(q, k, v, off, kl,
                                                      **kw), n=10)
        qs = q.transpose(1, 2).contiguous()
        ks, vs = (t.repeat_interleave(H // Kv, 2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        qi = hist + torch.arange(Sq, device="cuda")[:, None]
        kj = torch.arange(Skv, device="cuda")[None, :]
        mask = (kj <= qi) & ((kj > qi - window) if window else True)
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask), n=10)
        flops, nbytes = fa.flash_cost(1, Sq, Skv, H, Kv, hd, offsets=[hist],
                                      kv_lens=[Skv], window=window)
        bound_ms, bound_by = bound(flops, nbytes, card)
        print(f"flash {name} H={H} Kv={Kv} hd={hd} window={window} "
              f"softcap={cap} bf16: max_abs_err {err:.3g}, deterministic; "
              f"kernel {ms:.4f} ms, SDPA {lib_ms:.4f} ms (CUDA graphs of "
              f"10), bound {bound_ms:.4f} ms ({bound_by}; "
              f"{flops / 1e9:.1f} GFLOP)")
        out["flash_attention"].append({
            "shape": name, "hist": hist, "Sq": Sq, "H": H, "Kv": Kv,
            "hd": hd, "window": window, "softcap": cap, "max_abs_err": err,
            "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
        del q, k, v, qs, ks, vs, mask
    for name, (Sq, Skv, H, Kv, hd) in MODEL_FLASH_FULL.items():
        q, k, v = flash_case(1, Sq, Skv, H, Kv, hd, torch.bfloat16, gen)
        off = torch.zeros(1, dtype=torch.int32, device="cuda")
        kl = torch.tensor([Skv], dtype=torch.int32, device="cuda")
        kw = dict(causal=False)
        got = fa.flash_attention_cuda(q, k, v, off, kl, **kw)
        torch.cuda.synchronize()
        err = check_close(f"flash {name}", got,
                          fa.flash_attention_plain(q, k, v, off, kl, **kw),
                          "bf16", fa.flash_p_rounding_bound(q, k, v, off, kl,
                                                            **kw))
        if not torch_equal(got, fa.flash_attention_cuda(q, k, v, off, kl,
                                                        **kw)):
            raise AssertionError(f"flash {name}: not deterministic")
        ms = graph_ms(lambda: fa.flash_attention_cuda(q, k, v, off, kl,
                                                      **kw), n=10)
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=False), n=10)
        flops = 4 * hd * H * Sq * Skv
        nbytes = 2 * (2 * Sq * H * hd + 2 * Skv * Kv * hd) + 8
        bound_ms, bound_by = bound(flops, nbytes, card)
        print(f"flash {name} H={H} Kv={Kv} hd={hd} non-causal bf16: "
              f"max_abs_err {err:.3g}, deterministic; kernel {ms:.4f} ms, "
              f"SDPA (is_causal=False) {lib_ms:.4f} ms (CUDA graphs of 10), "
              f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.1f} "
              "GFLOP)")
        out["flash_attention"].append({
            "shape": name, "hist": 0, "Sq": Sq, "Skv": Skv, "H": H,
            "Kv": Kv, "hd": hd, "causal": False, "max_abs_err": err,
            "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
        del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()
    return out


def ssm_case(Bt, I, N, dtype, gen, S=None):
    """Inputs of the Mamba1 state update as the layer makes them: fp32 h,
    dt (softplus range) and A (-exp of the init's log(1..N)); x, B, C, D
    in the model dtype; with a token axis when S is given."""
    import torch
    dev = "cuda"
    lead = (Bt,) if S is None else (Bt, S)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    h = rnd(Bt, I, N)
    dt = torch.nn.functional.softplus(rnd(*lead, I) - 4.0)
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=dev).expand(I, N).contiguous()
    x, Bm, Cm = rnd(*lead, I), rnd(*lead, N), rnd(*lead, N)
    D = torch.ones(I, device=dev)
    return (h, dt, x.to(dtype), A, Bm.to(dtype), Cm.to(dtype), D.to(dtype))


def ssm_scan_case(Bt, I, N, S, dtype, gen, R=256):
    """A layer's scan inputs: ``ssm_case``'s with a token axis, B and C as
    column views of an x_proj output (R dt-rank columns before them)."""
    import torch
    h, dt, x, A, _, _, D = ssm_case(Bt, I, N, dtype, gen, S)
    proj = torch.randn(Bt, S, R + 2 * N, generator=gen,
                       device="cuda").to(dtype)
    return h, dt, x, A, proj[..., R:R + N], proj[..., R + N:], D


def exp_floor_ms(card_clock_mhz: float, Bt, I, N, S) -> float:
    """The exp unit's floor: one exponential per (b, s, i, n), 16 per SM
    per clock (the SFU's rate) at the card's maximum SM clock."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return Bt * S * I * N / (sms * 16 * card_clock_mhz * 1e6) * 1e3


# the scan's bitwise cases: stage boundaries (64-token slots) and a
# partial last slot, decode sizes (S <= 4: no ring) and the lifecycle's
# prompts
SSM_SCAN_S = (1, 2, 31, 32, 33, 64, 65, 1024, 2000)


def check_ssm_scan_bits():
    """The scan over S tokens bitwise equal to S single-token launches of
    the same kernel, carrying the state, at every S of SSM_SCAN_S, Bt 1, 3
    and 4, N 4, 8 and 16, bf16 and fp32, with B and C as strided column
    views (dt rank 256, and 3 at N = 8: 2-byte aligned bf16 columns); and
    within TOL of the plain version. Its own generator, so the phases
    after it see the data they saw before."""
    import torch
    from repro_torch.kernels import ssm_update as ssu
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    worst = {"bf16": 0.0, "fp32": 0.0}
    n = 0
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for N, I, R in ((16, 8192, 256), (8, 1000, 3), (4, 1000, 256)):
            for Bt in (1, 3, 4):
                for S in SSM_SCAN_S:
                    h, dt, x, A, Bm, Cm, D = ssm_scan_case(Bt, I, N, S, dtype,
                                                           gen, R)
                    hs, hk, hp = h.clone(), h.clone(), h.clone()
                    y = ssu.ssm_scan_cuda(hs, dt, x, A, Bm, Cm, D)
                    ys = [ssu.ssm_scan_cuda(hk, dt[:, t:t + 1],
                                            x[:, t:t + 1], A, Bm[:, t:t + 1],
                                            Cm[:, t:t + 1], D)
                          for t in range(S)]
                    yp = ssu.ssm_scan_plain(hp, dt, x, A, Bm, Cm, D)
                    torch.cuda.synchronize()
                    what = f"ssm scan Bt={Bt} I={I} N={N} S={S} {name}"
                    if not (torch_equal(torch.cat(ys, 1), y)
                            and torch_equal(hk, hs)):
                        raise AssertionError(f"{what}: not bitwise equal to "
                                             f"{S} single-token launches")
                    worst[name] = max(worst[name],
                                      check_close(f"{what} h", hs, hp,
                                                  "fp32"),
                                      check_close(f"{what} y", y, yp, name))
                    n += 1
    print(f"ssm_update scan: {n} cases (S {SSM_SCAN_S}, Bt 1/3/4, N 4/8/16, "
          "bf16 and fp32, B and C strided column views) bitwise equal to S "
          "single-token launches; max_abs_err against the plain version "
          f"{worst['bf16']:.3g} (bf16), {worst['fp32']:.3g} (fp32)")
    return max(worst.values())


def check_ssm_update(card: str, gen):
    import torch
    from repro_torch.kernels import ssm_update as ssu
    I, N = 8192, 16
    clock = float(sh(["nvidia-smi", "--query-gpu=clocks.max.sm",
                      "--format=csv,noheader,nounits"]).splitlines()[0])
    row = None
    # the main path's decode steps (B = 1 in the lifecycle, the engine's
    # 4 slots), then fp32 and an odd shape
    for Bt, I_, N_, dtype, name in ((4, I, N, torch.bfloat16, "bf16"),
                                    (1, I, N, torch.bfloat16, "bf16"),
                                    (4, I, N, torch.float32, "fp32"),
                                    (3, 96, 4, torch.bfloat16, "bf16"),
                                    (3, 96, 4, torch.float32, "fp32")):
        args = ssm_case(Bt, I_, N_, dtype, gen)
        h_new, y = ssu.ssm_update_cuda(*args)
        torch.cuda.synchronize()
        ph, py = ssu.ssm_update_plain(*args)
        err = max(check_close(f"ssm_update h' B={Bt} {name}", h_new, ph,
                              "fp32"),
                  check_close(f"ssm_update y B={Bt} {name}", y, py, name))
        # written over its own input, as decode runs it
        h_in = args[0].clone()
        ssu.ssm_update_cuda(h_in, *args[1:], h_out=h_in)
        if not torch_equal(h_in, h_new):
            raise AssertionError("ssm_update in place differs")
        if (I_, N_) != (I, N):
            print(f"ssm_update Bt={Bt} I={I_} N={N_} {name}: max_abs_err "
                  f"{err:.3g}, in place bitwise equal")
            continue
        out = torch.empty_like(args[0])
        ms = graph_ms(lambda: ssu.ssm_update_cuda(*args, h_out=out))
        plain_ms = graph_ms(lambda: ssu.ssm_update_plain(*args))
        eager_ms = time_ms(lambda: ssu.ssm_update_cuda(*args, h_out=out),
                           20)
        flops, nbytes = ssu.scan_cost(Bt, I, N, 1, args[2].element_size())
        bound_ms, bound_by = bound(flops, nbytes, card,
                                   FP32_PEAKS[card_kind(card)])
        print(f"ssm_update Bt={Bt} I={I} N={N} S=1 {name}: max_abs_err "
              f"{err:.3g}, in place bitwise equal; kernel {ms * 1e3:.2f} us "
              f"(CUDA graph of 100 launches; one eager call "
              f"{eager_ms * 1e3:.1f} us), plain {plain_ms * 1e3:.1f} us, "
              f"bound {bound_ms * 1e3:.3f} us ({bound_by}; "
              f"{nbytes / 1e6:.2f} MB)")
        if row is None:
            row = {"name": "ssm_update", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/ssm_update.cu",
                   "replaces": "src/repro/kernels/ssm_update.py:38",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None,
                   "library_note": "no single PyTorch call computes the "
                                   "Mamba1 state update",
                   "shapes": [{"Bt": Bt, "S": 1, "ms": ms,
                               "bound_ms": bound_ms, "bound_by": bound_by}]}
        elif dtype == torch.bfloat16:
            row["shapes"].append({"Bt": Bt, "S": 1, "ms": ms,
                                  "bound_ms": bound_ms,
                                  "bound_by": bound_by})
    row["max_abs_err"] = max(row["max_abs_err"], check_ssm_scan_bits())
    # the prefill scan of one layer at the lifecycle's prompts, against the
    # same tokens as S launches at S = 1 of this kernel (the per-token
    # launches the port made before the scan)
    for S in (1024, 2000):
        h, dt, x, A, Bm, Cm, D = ssm_scan_case(1, I, N, S, torch.bfloat16,
                                               gen)
        ms = graph_ms(lambda: ssu.ssm_scan_cuda(h, dt, x, A, Bm, Cm, D),
                      n=10)

        def per_token():
            for t in range(S):
                ssu.ssm_scan_cuda(h, dt[:, t:t + 1], x[:, t:t + 1], A,
                                  Bm[:, t:t + 1], Cm[:, t:t + 1], D)
        tokens_ms = graph_ms(per_token, n=1)
        flops, nbytes = ssu.scan_cost(1, I, N, S, 2)
        bound_ms, bound_by = bound(flops, nbytes, card,
                                   FP32_PEAKS[card_kind(card)])
        floor_ms = exp_floor_ms(clock, 1, I, N, S)
        plan = ssu.ssm_scan_plan(1, I, N, S, torch.bfloat16)
        print(f"ssm_update scan Bt=1 S={S} I={I} N={N} bf16 (plan: "
              f"{plan.tokens}-token slots x {plan.stages}, grid {plan.grid}, "
              f"{plan.threads} threads): kernel {ms:.4f} ms per layer (CUDA "
              f"graph of 10), as {S} launches at S=1 {tokens_ms:.3f} ms "
              f"(graph); bound {bound_ms:.4f} ms ({bound_by}; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), exp-unit "
              f"floor {floor_ms:.4f} ms ({1 * S * I * N / 1e6:.0f} M exps at "
              f"{clock:.0f} MHz); {bound_ms / ms:.0%} of the bound")
        row["shapes"].append({"Bt": 1, "S": S, "ms": ms,
                              "per_token_launches_ms": tokens_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "exp_floor_ms": floor_ms})
    return row


# --------------------------------------------------------------- main path
def greedy(logits):
    import torch
    return torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]


def decode(model, params, cache, tok, steps, *, save=None):
    """Greedy decode ``steps`` tokens; ``save=(mgr, session)`` streams
    each step's hidden states to the store. Returns (inputs, cache)."""
    inputs = []
    for _ in range(steps):
        inputs.append(int(tok[0, 0]))
        lengths = cache["lengths"]
        lg, cache, hidden = model.decode_step_full(params, cache, tok)
        if save is not None:
            save[0].save_decode_hidden([save[1]],
                                       model.adapter.decode_hidden(hidden),
                                       lengths.cpu())
        tok = greedy(lg)
    return inputs, cache, tok


def empty_cache(model, capacity):
    import torch
    c = model.cfg
    shape = (c.n_layers, 1, capacity, c.n_kv_heads, c.head_dim_)
    return {"k": torch.zeros(shape, dtype=model.dtype, device=model.device),
            "v": torch.zeros(shape, dtype=model.dtype, device=model.device)}


def write_kv(cache, kv, start):
    n = kv[0].shape[2]
    cache["k"][:, :, start:start + n] = kv[0]
    cache["v"][:, :, start:start + n] = kv[1]


def build_model(arch="llama2-7b", layers=None):
    """An ``lm`` model (llama2-7b unless ``arch`` names another) at full
    width and depth (``layers`` cuts the depth), bf16, random weights from
    SEED, warmed by one short prefill and decode step (library handles
    and allocator pools), so the served requests' times exclude that
    set-up."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.models.module import count_params

    cfg = get_arch(arch)
    if layers is not None:
        print(f"{arch}: depth cut from {cfg.n_layers} to {layers} layers "
              f"({2 * cfg.param_count() / 1e9:.1f} GB of bf16 weights at "
              "full depth)")
        cfg = cfg.scaled(n_layers=layers)
    model = Model(cfg, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = model.init(SEED)
    toks = torch.arange(64, device=model.device)[None]
    out = model.prefill(params, {"tokens": toks})
    cache = empty_cache(model, 65)
    write_kv(cache, out["kv"], 0)
    cache["lengths"] = torch.tensor([64], dtype=torch.int32,
                                    device=model.device)
    model.decode_step(params, cache, greedy(out["logits"]))
    n_params = count_params(params)
    experts = (f" in {cfg.n_experts} experts, top-{cfg.experts_per_token}"
               if cfg.n_experts else "")
    print(f"{arch}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads}x{cfg.head_dim_} heads over {cfg.n_kv_heads} kv "
          f"heads, d_ff={cfg.d_ff}{experts}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.2f} B params bf16 "
          f"({2 * n_params / 1e9:.1f} GB); init and warm-up "
          f"{_sync_s(t0):.1f} s on {model.device}")
    return model, params


def run_main_path(model, params, prompts=PROMPTS, patches=False):
    """A session per round-0 prompt length of ``prompts``, 2 rounds each,
    through the HCache manager: session 0 all-hidden, the others under
    the planner. ``patches``: each round-0 prompt of a VLM starts with
    ``frontend_dim`` patch embeddings (seeded normals), and every planned
    session must have recompute layers, whose replay splices them back."""
    import numpy as np
    import torch
    from repro_torch.core.hcache import HCacheManager
    from repro_torch.storage import ChunkStore, make_array

    store = ChunkStore(make_array("ssd", 4), chunk_tokens=64)
    managers = [HCacheManager(model, store, schedule_override="hidden",
                              restore_group_size=8),
                HCacheManager(model, store, restore_group_size=8)]
    rng = np.random.default_rng(SEED)
    try:
        for s, n0 in enumerate(prompts):
            mgr = managers[0 if s == 0 else 1]
            plan = mgr.plan(n0)
            print(f"{model.cfg.name} session {s}: schedule for {n0} tokens: "
                  f"{plan.summary()}; methods "
                  f"{''.join(m[0].upper() for m in plan.methods)}")
            vis = None
            if patches:
                if s and "recompute" not in plan.methods:
                    raise AssertionError(f"s{s}: the planner gave no "
                                         "recompute layer to replay patches")
                c = model.cfg
                gen = torch.Generator(device=model.device).manual_seed(
                    SEED + s)
                vis = torch.randn((1, c.frontend_dim, c.d_model),
                                  generator=gen, device=model.device).to(
                                      model.dtype)
            serve_session(model, params, mgr, f"s{s}", n0, rng, vis)
    finally:
        for m in managers:
            m.close()


def _sync_s(t0):
    import torch
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def serve_session(model, params, mgr, session, n0, rng, patches=None):
    """Two rounds of one session; raises on any disagreement with the
    never-evicted cache ``ref``. ``patches`` (1, n_vis, D) replace the
    embeddings of round 0's first n_vis tokens."""
    import torch
    dev = model.device
    n_hist = 0
    ref = None
    for rnd in range(2):
        n_new = n0 if rnd == 0 else ROUND1_TOKENS
        toks = torch.from_numpy(
            rng.integers(0, model.cfg.vocab_size, n_new)).to(dev)
        cap = n_hist + n_new + DECODE_TOKENS + MATCH_TOKENS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_ms = project_ms = 0.0
        if rnd == 0:
            live = empty_cache(model, cap)
            batch = {"tokens": toks[None]}
            if patches is not None:
                batch["patches"] = patches
            out = model.prefill(params, batch, capture_hidden=True)
        else:
            res = mgr.restore(params, session, capacity=cap)
            restore_ms = res.wall_time * 1e3
            project_ms = res.project_wall * 1e3
            live = res.cache
            out = model.prefill(
                params, {"tokens": toks[None]}, capture_hidden=True,
                hist_kv=(live["k"][:, :, :n_hist], live["v"][:, :, :n_hist]),
                hist_len=n_hist)
        tok = greedy(out["logits"])
        first = int(tok[0, 0])
        ttft_ms = _sync_s(t0) * 1e3
        mgr.save_prefill(session, toks.cpu().numpy(), out, start=n_hist)
        write_kv(live, out["kv"], n_hist)
        n_live = n_hist + n_new
        live["lengths"] = torch.tensor([n_live], dtype=torch.int32,
                                       device=dev)
        del out
        if rnd == 1:
            # the never-evicted cache, grown to this round's capacity
            grown = empty_cache(model, cap)
            grown["k"][:, :, :n_hist] = ref["k"][:, :, :n_hist]
            grown["v"][:, :, :n_hist] = ref["v"][:, :, :n_hist]
            ref_out = model.prefill(
                params, {"tokens": toks[None]},
                hist_kv=(grown["k"][:, :, :n_hist],
                         grown["v"][:, :, :n_hist]), hist_len=n_hist)
            ref_tok = greedy(ref_out["logits"])
            if int(ref_tok[0, 0]) != first:
                raise AssertionError(
                    f"{session} round 1: first token {first} over restored "
                    f"history, {int(ref_tok[0, 0])} over the never-evicted "
                    "cache")
            write_kv(grown, ref_out["kv"], n_hist)
            grown["lengths"] = live["lengths"].clone()
            ref = grown
            del ref_out
        t1 = time.perf_counter()
        inputs, live, tok = decode(model, params, live, tok, DECODE_TOKENS,
                                   save=(mgr, session))
        decode_ms = _sync_s(t1) * 1e3 / DECODE_TOKENS
        if rnd == 0:
            ref = {name: t.clone() for name, t in live.items()}
        else:
            ref_inputs, ref, _ = decode(model, params, ref, ref_tok,
                                        DECODE_TOKENS)
            if ref_inputs != inputs:
                raise AssertionError(f"{session} round 1: decode over the "
                                     "restored history diverged from the "
                                     "never-evicted cache")
        n_total = n_live + DECODE_TOKENS
        mgr.save_session_pause(session, live, n_total, tokens_tail=inputs)
        del live                            # evict the device cache
        check = mgr.restore(params, session, capacity=n_total + MATCH_TOKENS)
        diffs = {}
        for li, m in enumerate(check.schedule.methods):
            for name in ("k", "v"):
                d = float((check.cache[name][li, :, :n_total].float()
                           - ref[name][li, :, :n_total].float())
                          .abs().max())
                diffs[m] = max(diffs.get(m, 0.0), d)
        # every method restores the history bitwise: hidden and kv by
        # construction, recompute by replaying the prefill/decode segments
        for m, d in diffs.items():
            if d != 0.0:
                raise AssertionError(f"{session} round {rnd}: restored "
                                     f"{m} K/V off by {d}")
        seq_r, _, _ = decode(model, params, check.cache, tok, MATCH_TOKENS)
        seq_g, ref, _ = decode(model, params, ref, tok, MATCH_TOKENS)
        verdict = "MATCH" if seq_r == seq_g else "MISMATCH"
        vis = (f" ({patches.shape[1]} patch positions)"
               if patches is not None and rnd == 0 else "")
        print(f"{model.cfg.name} {session} round {rnd}: {n_new} new tokens"
              f"{vis} on {n_hist} of "
              f"history; first token {first}; TTFT {ttft_ms:.1f} ms "
              f"(restore {restore_ms:.1f} ms, projection {project_ms:.1f} "
              f"ms); decode {decode_ms:.2f} ms/token; check restore "
              f"{check.wall_time * 1e3:.1f} ms (projection "
              f"{check.project_wall * 1e3:.1f} ms, virtual "
              f"{check.timeline.makespan * 1e3:.2f} ms); K/V max diff by "
              f"method {diffs}; {verdict}")
        if verdict != "MATCH":
            raise AssertionError(f"{session} round {rnd}: {seq_r} != {seq_g}")
        del check
        n_hist = n_total


# ------------------------------------------------------- restore plans
RESTORE_PLANS = (8, (1, 2, 4, 8, 17), "fetch", "auto")
RESTORE_REPS = 2


def run_restore_plans(model, params):
    """Sessions of PROMPTS tokens, every layer by the hidden method, each
    restored RESTORE_REPS times under every group plan of RESTORE_PLANS,
    first under the static profile and then with a ``MeasuredProfile``
    that the restores feed: every restored K/V bitwise equal to the K/V
    its prefill held before eviction. Returns the walls, splits and the
    profile."""
    import numpy as np
    import torch
    from repro_torch.core.hcache import HCacheManager
    from repro_torch.core.profiler import MeasuredProfile
    from repro_torch.storage import ChunkStore, make_array

    store = ChunkStore(make_array("ssd", 4), chunk_tokens=64)
    saver = HCacheManager(model, store, schedule_override="hidden")
    rng = np.random.default_rng(SEED)
    held = {}
    for n in PROMPTS:
        toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, n)).to(
            model.device)
        out = model.prefill(params, {"tokens": toks[None]},
                            capture_hidden=True)
        saver.save_prefill(f"r{n}", toks.cpu().numpy(), out)
        held[n] = out["kv"]
        del out
    saver.close()
    walls = {}
    profile = MeasuredProfile()
    for calibrated in (False, True):
        mgr = HCacheManager(model, store, schedule_override="hidden",
                            profile=profile if calibrated else None)
        try:
            for plan in RESTORE_PLANS:
                mgr.restore_group_size = plan
                mgr.invalidate_plans()
                for n in PROMPTS:
                    for rep in range(RESTORE_REPS):
                        resolved = mgr.resolve_group_size(
                            n, ("hidden",) * model.cfg.n_layers)
                        res = mgr.restore(params, f"r{n}", capacity=n)
                        for i, name in enumerate(("k", "v")):
                            if not torch.equal(res.cache[name],
                                               held[n][i]):
                                raise AssertionError(
                                    f"restore of {n} tokens under plan "
                                    f"{plan} ({resolved}, calibrated "
                                    f"{calibrated}): {name} differs from "
                                    "the K/V held before eviction")
                        walls[calibrated, str(plan), n, rep] = res
                        print(f"restore plan {plan} -> {resolved}"
                              f"{' calibrated' if calibrated else ''}, {n} "
                              f"tokens, rep {rep}: wall "
                              f"{res.wall_time * 1e3:.1f} ms, projection "
                              f"device {res.project_wall * 1e3:.2f} ms "
                              "(compute-stream idle share "
                              f"{1 - res.project_wall / res.wall_time:.3f})"
                              "; host split " + ", ".join(
                                  f"{k} {v * 1e3:.1f}"
                                  for k, v in res.host_split.items())
                              + " ms; K/V bitwise equal")
                        del res
        finally:
            mgr.close()
    counts = profile.sample_counts()
    if not (counts.get("io_h") and counts.get("project")):
        raise AssertionError(f"the restores fed no io_h or project samples "
                             f"into the profile: {counts}")
    print("restore plans: the profile after "
          f"{len(RESTORE_PLANS) * len(PROMPTS) * RESTORE_REPS} calibrated "
          f"restores: epoch {profile.epoch}, samples {counts}, " + ", ".join(
              f"{k} {profile.rate(k):.4g} s/unit (overhead "
              f"{profile.overhead(k) * 1e6:.1f} us)" for k in counts))
    print("restore plans: walls (ms) by tokens, plan 8 / (1,2,4,8,17) / "
          "fetch / auto, uncalibrated, last rep: " + "; ".join(
              f"{n}: " + " / ".join(
                  f"{walls[False, str(p), n, RESTORE_REPS - 1].wall_time * 1e3:.1f}"
                  for p in RESTORE_PLANS) for n in PROMPTS))
    return profile


def check_profile_round_trip(profile):
    """``save`` and ``load`` give back the same rates and overheads."""
    from repro_torch.core.profiler import MeasuredProfile
    path = os.path.join(ROOT, "build", "hw_profile.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    profile.save(path)
    back = MeasuredProfile.load(path)
    for kind in profile.kinds:
        if (back.rate(kind), back.overhead(kind)) != (profile.rate(kind),
                                                      profile.overhead(kind)):
            raise AssertionError(f"the saved profile's {kind} fit changed "
                                 "on load")
    if back.sample_counts() != profile.sample_counts():
        raise AssertionError("the saved profile's samples changed on load")


# ------------------------------------------------------------ engine path
ENGINE_PROMPTS = (1024, 1536, 2000, 512, 768, 1024)   # round 0, per session
ENGINE_BATCH = 4
ENGINE_MAX_SEQ = 2560        # 2000 + 16 + 256 + 16 tokens fit, in pages
ENGINE_CHUNK = 128
ENGINE_QUANTUM = 4
# restore tasks per engine step that finish any restore in the step it
# starts: the engine's schedule (which step a session pauses at, and so
# which of its tokens a decode step or a resume prefill computes) then
# does not depend on the restore's group plan or methods, so a calibrated
# run must give an uncalibrated run's tokens bitwise
WHOLE_RESTORES = 10_000

# The engine against a plain computation on the same weights (one B=1
# forward over a session's whole token stream: no chunks, no batch, no
# restore, no cache; for a MoE model, whose capacity depends on the
# segment's length, B=1 over the session's own prefill chunks and
# one-token decodes): the logits that sampled each generated token
# within PLAIN_REL relative L2 error of the plain ones at its position,
# and the token within PLAIN_GAP standard deviations (of the plain logits
# there) of the plain maximum. The two round in bf16 through 32 layers
# (64 for falcon-mamba-7b) over products of other shapes, so they agree
# only to bf16 noise, and a near tie may go either
# way; a wrong position, length or batch row moves the logits by the
# order of their own spread.
PLAIN_REL = 0.05
PLAIN_GAP = 0.25

# The host-storage budget phase: the contiguous engine's traffic under a
# CapacityManager whose budget is BUDGET_FRACTION of the hot bytes the
# unbudgeted phased run's store held at its peak, on a store with no cold
# tier, so that the representation itself must shrink (int8, then
# token-only). Its ladder stops before "drop": the traffic protects every
# session at the start of round 1 (all are queued or resident), and the
# protected working set alone then exceeds the budget, so the full ladder
# would drop sessions that round 1 resubmits. The protected working set
# also keeps the store over the budget long enough that the ladder takes
# each int8 session on to token-only before it comes back, so a third
# round probes the int8 restore: the budget is tightened to just under
# the store's bytes, the ladder puts the coldest session with hidden rows
# in int8, the budget is set back, and that session gets INT8_PROBE_TOKENS
# more tokens through the engine, restoring from its int8 rows. A restore of a session that
# was ever in the int8 codec is held within INT8_REL relative L2 error of
# its snapshot, layer by layer, and an int8 restore's hidden layers
# against the plain version (numpy dequantize, the norm, the plain
# projection) on every INT8_ROW_STRIDE-th token row and the last, within
# the bf16 TOL.
BUDGET_FRACTION = 0.55
INT8_PROBE_TOKENS = 64
BUDGET_LADDER = ("cold", "int8", "recompute")
INT8_REL = 0.02
INT8_ROW_STRIDE = 16

# The prefix-sharing phase: the paged engine (16-token pages), 6 sessions
# x 2 rounds over 4 slots, every round-0 prompt one shared document of
# PREFIX_DOC tokens (a multiple of the 128-token prefill chunk and of the
# 64-token store chunk) and a question of PREFIX_QUESTION tokens of its
# own; round 1 adds ROUND1_TOKENS. Session u0 is forked to u0f once it
# decodes its third token. The same requests run with sharing off, and
# the two must give the same tokens. Every layer is planned "hidden": a
# session with recompute layers is not shared (its restore would not
# give the shared pages' bits), and llama2-7b's planner picks 7. No
# preemption: a token decoded in one run and fed again by a resume
# prefill in the other would be computed by other kernels.
PREFIX_DOC = 1024
PREFIX_QUESTION = (64, 256)
PREFIX_SESSIONS = 6

# The tensor-parallel phase: llama2-7b's engine (every layer planned
# "hidden", so that the schedule and the launches depend on nothing the
# width prices) over TP_BATCH slots, one session per TP_PROMPTS entry x 2
# rounds (round 1 TP_ROUND1_TOKENS), at each width of TP_WIDTHS on the
# paged backend and of TP_CONTIGUOUS_WIDTHS on the contiguous one, every
# shard on the card, with a preemption quantum of TP_QUANTUM steps. The
# tp 1 run of each backend keeps every restore's K/V on the card, and
# the wider runs hold each of theirs against it as it completes.
TP_PROMPTS = (512, 768, 384, 640)
TP_ROUND1_TOKENS = 64
TP_BATCH = 2
TP_QUANTUM = 8
TP_MAX_SEQ = 896             # 768 + 16 + 64 + 16 tokens fit, in pages
TP_WIDTHS = (1, 2, 4)
TP_CONTIGUOUS_WIDTHS = (1, 2)
TP_PHASE_BUDGET_S = 60.0


def engine_classes():
    """The engine and manager of the port, instrumented for this phase:
    session s0 is planned all-hidden, the rest under the PAPER_H800
    planner (recompute prefix + hidden); every pause or retire snapshots
    the session's K/V [0, n) on the card and its conv and ssm states (ssm,
    hybrid), and every completed restore is held against the last
    snapshot bitwise (an enc-dec session's cross K/V also against what
    its first prefill wrote); every prefill and decode step counts its
    kernel launches: the flash and decode kernels once per attention
    layer (lm, hybrid), the state-update scan once per layer (ssm), or
    for an enc-dec model the flash kernel twice per decoder layer (self
    and cross) plus once per encoder layer on a first chunk, and the
    decode kernels twice per decoder layer (self: #3, or #4 paged; cross:
    #3)."""
    import torch
    from repro_torch.config.arch import BlockKind
    from repro_torch.core.hcache import HCacheManager
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_update as ssu
    from repro_torch.serving import InferenceEngine, Phase
    from repro_torch.serving.kv_cache import PagedBackend

    class Manager(HCacheManager):
        all_hidden = False

        def save_prefill(self, session, tokens, prefill_out, *, start=0):
            self.schedule_override = ("hidden" if self.all_hidden
                                      or session == "s0" else None)
            try:
                return super().save_prefill(session, tokens, prefill_out,
                                            start=start)
            finally:
                self.schedule_override = None

    class Engine(InferenceEngine):
        def __init__(self, *args, phased=True, **kw):
            super().__init__(*args, **kw)
            self.phased = phased
            self.snapshots, self.checked = {}, []
            # token logits and tainted requests are keyed by id(seq): the
            # engine keeps every sequence it emitted for alive, so that a
            # later sequence cannot reuse a freed one's id
            self.last_logits, self.token_logits = None, {}
            self.emitted = {}
            self.prefills = self.decodes = 0
            # each session's prefill chunks, (start, tokens), for a plain
            # forward that follows them (MoE capacity depends on them)
            self.prefill_segs = {}
            self.walls = {"restore": 0.0, "prefill": 0.0, "decode": 0.0}
            # budget and sharing gauges: peak hot bytes and shared pages,
            # sessions ever in the int8 codec, the requests whose restores
            # read one, restore walls by codec, the int8 checks' worst
            self.bytes_peak = self.shared_peak = 0
            self.pages_peak = self.committed_peak = 0
            self.tainted, self.req_tainted = set(), set()
            self.walls_by_codec = {"none": [], "int8": [], "recompute": []}
            self.int8_worst = {"rel": 0.0, "plain": 0.0, "rows": 0,
                               "restores": 0}
            kinds = self.model.cfg.block_kinds()
            L = (sum(k == BlockKind.ATTENTION for k in kinds)
                 or len(kinds))
            save = self.mgr.save_session_pause
            prefill = self.adapter.prefill_chunk
            decode = self.kv.decode

            ssm = self.model.kind == "ssm"
            encdec = self.model.adapter.has_cross
            paged = isinstance(self.kv, PagedBackend)
            # decode launches (contiguous #3, paged #4) of one step; a
            # pool split over tensor-parallel shards launches #4 per shard
            shards = getattr(self.kv, "shards", 1)
            per_step = ((L,) if ssm else (L, L) if encdec and paged
                        else (2 * L, 0) if encdec else (0, L * shards)
                        if paged else (L, 0))
            # set by the tensor-parallel phase: every restore's K/V kept
            # (keep_restores), or held bitwise against the restores of a
            # run kept so (restore_refs, in order); restores lists each
            # restore's (session, length, K, V), K and V when kept
            self.keep_restores, self.restore_refs = False, None
            self.restores = []
            # an enc-dec session's cross K/V as its first prefill wrote
            # them, against which its restores are held
            self.cross_refs = {}

            def save_and_snapshot(session, cache, n_tokens, **kw):
                # (k, v) of the attention layers, then (conv, ssm)
                snap = tuple(cache[name][:, 0, :n_tokens].clone()
                             for name in self.model.adapter.kv_names or ())
                if "ssm" in cache:
                    snap += (cache["conv"].clone(), cache["ssm"].clone())
                self.snapshots[session] = snap
                return save(session, cache, n_tokens, **kw)

            def prefill_launches():
                return ssu.launches if ssm else fa.launches

            def decode_launches():
                return ((ssu.launches,) if ssm
                        else (dec.launches, dec.paged_launches))

            def counted_prefill(params, seq, chunk, hist, *args, **kw):
                before = prefill_launches()
                out = prefill(params, seq, chunk, hist, *args, **kw)
                self.prefill_segs.setdefault(
                    seq.request.session_id, []).append((hist, len(chunk)))
                want = L
                if encdec:
                    want = 2 * L + (0 if hist else
                                    self.model.cfg.encoder_layers)
                if encdec and not hist:
                    self.cross_refs[seq.request.session_id] = tuple(
                        t.clone() for t in out["cross_kv"])
                if prefill_launches() - before != want:
                    raise AssertionError(f"a prefill launched its kernel "
                                         f"{prefill_launches() - before} "
                                         f"times, not {want}")
                self.last_logits = out["logits"][0, -1:]
                self.prefills += 1
                return out

            def counted_decode(*args, **kw):
                before = decode_launches()
                out = decode(*args, **kw)
                got = tuple(a - b for a, b in zip(decode_launches(), before))
                if got != per_step:
                    raise AssertionError(f"a {self.kv.name} decode step "
                                         f"launched {got} (contiguous, "
                                         f"paged), not {per_step}")
                self.last_logits = out[0][:, -1]
                self.decodes += 1
                return out

            self.mgr.save_session_pause = save_and_snapshot
            self.adapter = copy.copy(self.model.adapter)
            self.adapter.prefill_chunk = counted_prefill
            self.kv.decode = counted_decode

        def _emit_token(self, seq, tok):
            # the logits that sampled tok: a prefill's (1, V) or row
            # seq.slot of a decode step's (B, V)
            row = self.last_logits[0 if len(self.last_logits) == 1
                                   else seq.slot]
            self.token_logits.setdefault(id(seq), []).append(row.float())
            self.emitted[id(seq)] = seq
            super()._emit_token(seq, tok)

        def _timed(self, what, fn, *args):
            # a phased run synchronises around every phase, which also
            # serialises restores with decode; an unphased run keeps no
            # phase times and lets them overlap
            if not self.phased:
                return fn(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            self.walls[what] += time.perf_counter() - t0

        def _prefill_step(self, seq):
            self._timed("prefill", super()._prefill_step, seq)

        def _decode_batch(self):
            self._timed("decode", super()._decode_batch)

        def step(self):
            super().step()
            self.bytes_peak = max(self.bytes_peak, self.mgr.store.bytes_used)
            self.shared_peak = max(self.shared_peak,
                                   self.metrics.shared_pages)
            if isinstance(self.kv, PagedBackend):
                # pool pages held, and held plus the copy debt the
                # backend keeps back for copy-on-write writes
                used = self.kv.num_blocks - self.kv.allocator.free_count
                self.pages_peak = max(self.pages_peak, used)
                self.committed_peak = max(self.committed_peak,
                                          used + self.kv.copy_debt())

        def _restore_step(self):
            restoring = [(s, s.executor) for s in self.slots
                         if s is not None and s.phase == Phase.RESTORING]
            self._timed("restore", super()._restore_step)
            for s, ex in restoring:
                if s.phase != Phase.PREFILL:
                    continue
                sid = s.request.session_id
                k, v = s.view.gather_hist(s.history_len)
                sk, sv = self.snapshots[sid]
                methods = list(ex.methods)
                codec = ("int8" if ex.compress == "int8" else "recompute"
                         if set(methods) == {"recompute"} else "none")
                self.walls_by_codec[codec].append(ex.wall_time)
                if sid in self.tainted:
                    # rows once stored in int8 restore lossy: every layer
                    # within INT8_REL of the snapshot, and an int8
                    # restore's hidden layers against the plain version
                    self.req_tainted.add(id(s))
                    self.int8_worst["restores"] += 1
                    for li in range(len(methods)):
                        for got, want in ((k[li, 0], sk[li]),
                                          (v[li, 0], sv[li])):
                            rel = float((got.float() - want.float()).norm()
                                        / want.float().norm())
                            self.int8_worst["rel"] = max(
                                self.int8_worst["rel"], rel)
                            if rel > INT8_REL:
                                raise AssertionError(
                                    f"{sid}: restored layer {li} lies "
                                    f"{rel:.4f} (relative L2) from its "
                                    "snapshot")
                    if codec == "int8":
                        err, n_rows = check_int8_restore(
                            self.mgr, self.params, sid, methods,
                            s.history_len, k, v)
                        self.int8_worst["plain"] = max(
                            self.int8_worst["plain"], err)
                        self.int8_worst["rows"] += n_rows
                else:
                    for li, m in enumerate(methods):
                        if not (torch.equal(k[li, 0], sk[li])
                                and torch.equal(v[li, 0], sv[li])):
                            raise AssertionError(
                                f"{self.kv.name}: restored {m} layer {li} "
                                f"of {sid} ({s.history_len} tokens) "
                                "differs from its K/V before the pause")
                if self.restore_refs is not None:
                    i = len(self.restores)
                    ref = (self.restore_refs[i]
                           if i < len(self.restore_refs) else None)
                    if ref is None or ref[:2] != (sid, s.history_len) \
                            or not (torch.equal(k, ref[2])
                                    and torch.equal(v, ref[3])):
                        raise AssertionError(
                            f"{self.kv.name}: restore {i} ({sid}, "
                            f"{s.history_len} tokens) is not the reference "
                            "run's restore, bit for bit")
                if self.keep_restores or self.restore_refs is not None:
                    self.restores.append(
                        (sid, s.history_len)
                        + ((k.clone(), v.clone()) if self.keep_restores
                           else (None, None)))
                if sid in self.cross_refs:
                    ck, cv, _ = s.view.cross_state()
                    rk, rv = self.cross_refs[sid]
                    if not (torch.equal(ck, rk) and torch.equal(cv, rv)):
                        raise AssertionError(
                            f"{self.kv.name}: the restored cross K/V of "
                            f"{sid} differ from its prefill's")
                self.checked.append((sid, s.history_len, set(methods)))

    return Manager, Engine


def check_int8_restore(mgr, params, sid, methods, n, k, v):
    """An int8 restore's hidden layers against the plain version on the
    same stored streams: the numpy dequantize, the model's norm and the
    plain projection (``restore_kv_grouped_plain``), all hidden layers in
    one call, on every INT8_ROW_STRIDE-th token row and the last (the
    kernel computes each row alone: ``check_row_invariance``). Returns
    the largest |difference| and the rows checked per layer."""
    import numpy as np
    import torch
    from repro_torch.core.restoration import dequantize_hidden_int8
    from repro_torch.kernels import restore_kv as rkv
    from repro_torch.models import transformer as tfm
    model = mgr.model
    pack = mgr.param_pack(params)
    idx = sorted(set(range(0, n, INT8_ROW_STRIDE)) | {n - 1})
    layers = [li for li, m in enumerate(methods) if m == "hidden"]
    hidden = np.stack([dequantize_hidden_int8(
        mgr.store.read_layer(sid, "h", li, n)[idx],
        mgr.store.read_layer(sid, "hs", li, n)[idx]) for li in layers])
    hidden = torch.from_numpy(hidden).to(model.device).to(model.dtype)
    rows = pack.rows(tuple(layers))
    at = torch.tensor(idx, device=model.device)
    cos, sin = pack.rope_tables(n)
    normed = tfm.norm_rows(pack.blocks, rows, hidden, model.cfg)
    a = pack.blocks["attn"]
    pk, pv = rkv.restore_kv_grouped_plain(
        normed, a["wk"], a["wv"], a.get("bk"), a.get("bv"), rows,
        cos[at].contiguous(), sin[at].contiguous(),
        head_dim=pack.attn.head_dim, use_rope=pack.attn.use_rope)
    li = torch.tensor(layers, device=model.device)
    got_k = k[li, 0][:, at].reshape(pk.shape)
    got_v = v[li, 0][:, at].reshape(pv.shape)
    err = max(check_close(f"int8 restore K of {sid}", got_k, pk, "bf16"),
              check_close(f"int8 restore V of {sid}", got_v, pv, "bf16"))
    return err, len(idx)


def plain_logits(model, params, toks, frames=None):
    """Logits at every position of one B=1 forward over ``toks``; for an
    enc-dec model the encoder over ``frames`` (numpy (S_enc, D)) first."""
    import torch
    from repro_torch.models import encdec, ssm
    from repro_torch.models import transformer as tfm
    if model.kind == "ssm":
        return ssm.ssm_forward(params, toks, model.h)["logits"]
    if model.kind == "encdec":
        f = torch.from_numpy(frames).to(model.device)[None]
        enc_out, _ = encdec.encode(params, f, model.h)
        return encdec.decode_prefill(params, toks, enc_out,
                                     model.h)["logits"]
    return tfm.lm_forward(params, toks, model.h)["logits"]


def segment_logits(model, params, toks, prefills):
    """Logits at every position of one B=1 pass over ``toks`` (1, N) that
    follows a session's own segments: each (start, n) of ``prefills`` a
    prefill over the history before it, every other position a one-token
    decode step. A MoE layer's capacity depends on the segment's length,
    so only this order drops the assignments the engine dropped."""
    import torch
    from repro_torch.models import transformer as tfm
    N = toks.shape[1]
    starts = dict(prefills)
    cache = empty_cache(model, N)
    out, p = [], 0
    while p < N:
        if p in starts:
            n = starts[p]
            if p + n > N:
                raise AssertionError(f"a prefill of {n} at {p} runs past "
                                     f"the {N}-token stream")
            hist = (cache["k"][:, :, :p], cache["v"][:, :, :p]) if p else None
            res = tfm.lm_forward(params, toks[:, p:p + n], model.h,
                                 hist_kv=hist, hist_len=p or None,
                                 emit_kv=True)
            write_kv(cache, res["kv"], p)
            out.append(res["logits"][0])
            p += n
            continue
        cache["lengths"] = torch.tensor([p], dtype=torch.int32,
                                        device=model.device)
        lg, cache = model.decode_step(params, cache, toks[:, p:p + 1])
        out.append(lg[0])
        p += 1
    return torch.cat(out)[None]


def check_against_plain(model, params, requests, plain, ungated=(),
                        histories=None, segments=None, frames=None):
    """Hold an engine run against a plain computation on the same
    weights. ``requests[(rnd, sid)] = (prompt, generated, the logits
    that sampled each generated token)``. The plain logits come from one B=1 forward over the
    session's whole token stream: the earlier rounds' prompts and
    generated tokens (a round's last token never enters the history),
    then this round's prompt and generated tokens. ``plain`` keeps, per
    request, the plain logits at the positions that sampled its tokens,
    for the next backend's run. Raises past PLAIN_REL or PLAIN_GAP;
    returns the worst relative error (of first tokens, cold and restored,
    and of decoded ones) and the worst gap. The requests of ``ungated``
    (keys) are compared but not held: their worst error and gap are
    returned as ``ungated`` and ``ungated_gap``. ``histories`` gives the
    stream a session starts from (a fork's: its source's at the fork).
    ``segments`` (a MoE model's) gives each session's prefill chunks: the
    plain computation then follows them (``segment_logits``). ``frames``
    gives an enc-dec session's frame embeddings, which the plain forward
    encodes first."""
    import torch
    history = dict(histories or {})
    worst = {"cold": 0.0, "restored": 0.0, "decode": 0.0, "gap": 0.0,
             "tokens": 0, "bitwise": 0}
    # the vocabulary's padding columns hold -1e30 in both: they would
    # swamp the spread that the error is measured against
    V = model.cfg.vocab_size
    for key in sorted(requests):                 # round 0 before round 1
        rnd, sid = key
        prompt, gen, got = requests[key]
        stream = history.get(sid, []) + [int(t) for t in prompt] + gen[:-1]
        history[sid] = stream
        if key not in plain:
            toks = torch.tensor(stream, device=model.device)[None]
            logits = (plain_logits(model, params, toks,
                                   None if frames is None else frames[sid])
                      if segments is None
                      else segment_logits(model, params, toks,
                                          segments[sid]))
            plain[key] = logits[0, len(stream) - len(gen):, :V].float()
            del logits
        ref = plain[key]                         # row i sampled gen[i]
        got = torch.stack(got)[:, :V]
        if got.shape != ref.shape or not bool(got.isfinite().all()):
            raise AssertionError(f"{sid}/{rnd}: token logits of shape "
                                 f"{tuple(got.shape)} or not finite")
        rel = ((got - ref).norm(dim=-1)
               / (ref - ref.mean(-1, keepdim=True)).norm(dim=-1))
        rows = torch.arange(len(gen), device=ref.device)
        picked = ref[rows, torch.tensor(gen, device=ref.device)]
        gap = float(((ref.amax(-1) - picked) / ref.std(-1)).max())
        if not (bool(rel.isfinite().all()) and gap == gap):
            raise AssertionError(f"{sid}/{rnd}: the comparison with the "
                                 "plain forward is not finite")
        if key in ungated:
            worst["ungated"] = max(worst.get("ungated", 0.0),
                                   float(rel.max()))
            worst["ungated_gap"] = max(worst.get("ungated_gap", 0.0), gap)
            continue
        name = "restored" if rnd else "cold"
        worst[name] = max(worst[name], float(rel[0]))
        worst["decode"] = max(worst["decode"], float(rel[1:].max()))
        worst["gap"] = max(worst["gap"], gap)
        worst["tokens"] += len(gen)
        worst["bitwise"] += int((got == ref).all(-1).sum())
        if float(rel.max()) > PLAIN_REL:
            raise AssertionError(
                f"{sid}/{rnd}: the logits of token {int(rel.argmax())} are "
                f"off the plain forward's by {float(rel.max()):.4f} "
                "(relative)")
        if gap > PLAIN_GAP:
            raise AssertionError(f"{sid}/{rnd}: a generated token lies "
                                 f"{gap:.3f} std below the plain forward's "
                                 "best")
    return worst


def hold_against_plain(name, model, params, run, plain, segments=None):
    """``check_against_plain`` on an engine run's requests (popped from
    ``run``), outside the counted path (the plain forward launches
    kernels too), printed; frees the run's cache afterwards."""
    import gc

    import torch
    t1 = time.perf_counter()
    requests = run.pop("requests")
    ungated = run.get("ungated", ())
    worst = check_against_plain(model, params, requests, plain, ungated,
                                run.get("histories"), segments,
                                run.get("frames"))
    what = ("the plain forward" if segments is None else
            "the plain forward over each session's segments")
    print(f"{name} against {what} ({len(requests)} requests, "
          f"{time.perf_counter() - t1:.1f} s): logits relative error "
          f"max {worst['cold']:.5f} at cold first tokens, "
          f"{worst['restored']:.5f} at restored first tokens, "
          f"{worst['decode']:.5f} at decoded tokens (limit {PLAIN_REL}); "
          f"generated tokens at most {worst['gap']:.4f} std below the "
          f"plain best (limit {PLAIN_GAP}); {worst['bitwise']} of "
          f"{worst['tokens']} tokens' logits bitwise equal" + (
              f"; not held, the {len(ungated)} requests that restored "
              f"int8 rows: {worst.get('ungated', 0.0):.5f}, "
              f"{worst.get('ungated_gap', 0.0):.4f} std" if ungated
              else ""))
    gc.collect()                 # free this run's cache first
    torch.cuda.empty_cache()


def budget_capacity(mgr, eng, budget):
    """The budget phase's ``CapacityManager`` (``BUDGET_LADDER``), held to
    its contract after every ``maintain``: the hot bytes within the
    budget, or every session outside the protected set (resident, queued,
    prefetching) already down to the ladder's last stage (every layer
    ``recompute``), so that only protected sessions keep it over. The
    saver is drained first, so the walk counts every row written so far.
    Also times the demotions and records the sessions ever put in the
    int8 codec."""
    from repro_torch.core.capacity import CapacityManager
    cap = CapacityManager(mgr, host_budget_bytes=budget,
                          ladder=BUDGET_LADDER)
    store = mgr.store
    cap.over = []                     # (step, bytes over the budget)
    cap.seconds = {"int8": 0.0, "recompute": 0.0, "promote": 0.0}
    maintain = cap.maintain

    def checked_maintain(engine):
        mgr.saver.drain()
        maintain(engine)
        used = store.bytes_used
        if used > budget:
            prot = cap._protected()
            free = [x for x in store.sessions() if x not in prot
                    and set(store.get_manifest(x)["methods"])
                    != {"recompute"}]
            if free:
                raise AssertionError(
                    f"budget: {used} hot bytes over {budget} after a "
                    f"maintain, with {free} outside the protected set "
                    "not yet token-only")
            cap.over.append((engine.step_count, used - budget))

    def timed(name, fn):
        def run(sid):
            t0 = time.perf_counter()
            done = fn(sid)
            cap.seconds[name] += time.perf_counter() - t0
            if done and name == "int8":
                eng.tainted.add(sid)
            return done
        return run

    cap.maintain = checked_maintain
    mgr.demote_hidden_int8 = timed("int8", mgr.demote_hidden_int8)
    mgr.degrade_to_recompute = timed("recompute", mgr.degrade_to_recompute)
    mgr.promote_hidden_fp16 = timed("promote", mgr.promote_hidden_fp16)
    return cap


def run_engine(model, params, backend: str, *, phased=True, profile=None,
               group=8, restore_tasks=8, budget=None,
               prompts=ENGINE_PROMPTS, round1=ROUND1_TOKENS,
               max_seq=ENGINE_MAX_SEQ, frames=None, enc_seq=None, tp=None,
               batch=ENGINE_BATCH, quantum=ENGINE_QUANTUM, ref=None):
    """A session per round-0 prompt of ``prompts`` (6 unless given) x 2
    rounds (round 1 ``round1`` tokens) through the continuous-batching
    engine on ``backend``; returns tokens, metrics, what was checked and,
    per request, what ``check_against_plain`` needs. ``phased`` times each
    phase between synchronisations; ``profile`` (a ``MeasuredProfile``)
    and ``group`` are the manager's calibration and group plan;
    ``restore_tasks`` the restore tasks each engine step runs; ``budget``
    the hot-tier bytes of a ``CapacityManager`` (``budget_capacity``);
    ``frames`` an enc-dec model's frame embeddings per session (numpy,
    round 0 only) and ``enc_seq`` its slots' encoder positions; ``tp`` a
    tensor-parallel width with every shard on the card (every layer then
    planned "hidden", every restore's K/V kept, or with ``ref`` (a run
    that kept them) held bitwise against that run's, and the launches of
    kernels #1 (inside projection groups and outside), #3 and #4
    returned), ``batch`` the slots, ``quantum`` the preemption
    quantum."""
    import numpy as np
    import torch
    from repro_torch.core import restoration
    from repro_torch.distributed.tp import TPContext
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import restore_kv as rkv
    from repro_torch.serving import Request
    from repro_torch.storage import ChunkStore, make_array
    Manager, Engine = engine_classes()
    store = ChunkStore(make_array("ssd", 4), chunk_tokens=64)
    mgr = Manager(model, store, restore_group_size=group,
                  **({} if profile is None else {"profile": profile}))
    mgr.all_hidden = tp is not None
    eng = Engine(model, params, mgr, max_batch=batch,
                 max_seq=max_seq, prefill_chunk=ENGINE_CHUNK,
                 preempt_quantum=quantum, backend=backend,
                 restore_tasks_per_step=restore_tasks, phased=phased,
                 enc_seq=enc_seq,
                 tp=1 if tp is None else TPContext(tp, ["cuda"] * tp))
    if tp is not None:
        eng.keep_restores = ref is None
        eng.restore_refs = None if ref is None else ref["restores"]
    # kernel #1's launches inside projection groups, the part that the
    # width multiplies
    project, grouped = restoration.project_group, [0]

    def counted_project(*args, **kw):
        before = rkv.launches
        out = project(*args, **kw)
        grouped[0] += rkv.launches - before
        return out

    restoration.project_group = counted_project
    launches0 = (rkv.launches, dec.launches, dec.paged_launches)
    cap = None
    if budget is not None:
        cap = budget_capacity(mgr, eng, budget)
        eng.capacity = cap
        cap.attach_engine(eng)
    name = (label(model) + f"engine {backend}"
            + ("" if phased else " unphased")
            + (" whole restores" if restore_tasks == WHOLE_RESTORES else "")
            + (f" calibrated ({group})" if profile is not None else "")
            + (" budget" if budget is not None else "")
            + (f" tp={tp}" if tp is not None else ""))
    rng = np.random.default_rng(SEED)
    tokens, rows, requests, keys = {}, [], {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rnd in range(2):
        seqs = []
        for s, n0 in enumerate(prompts):
            n = n0 if rnd == 0 else round1
            prompt = rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
            seqs.append(eng.submit(Request(
                f"s{s}", prompt, max_new_tokens=DECODE_TOKENS,
                frames=frames[s] if frames is not None and rnd == 0
                else None)))
        eng.run()
        for seq in seqs:
            sid = seq.request.session_id
            tokens[(rnd, sid)] = list(seq.generated)
            requests[(rnd, sid)] = (seq.request.prompt, list(seq.generated),
                                    eng.token_logits[id(seq)])
            keys[(rnd, sid)] = id(seq)
            rows.append(f"{sid}/{rnd}: ttft {seq.ttft_wall * 1e3:.0f} ms "
                        + ("(restored)" if rnd else "(cold)")
                        + f", pauses {seq.pauses}, last restore "
                        f"{seq.restore_wall * 1e3:.0f} ms")
    probe = None
    if cap is not None:
        # the int8 probe: tighten the budget to just under the store's
        # bytes, let the ladder put a session in int8, set it back, and
        # serve that session a third round
        cap.host_budget_bytes = store.bytes_used - 1
        before = len(cap.actions)
        cap.ensure_host_budget()
        cap.host_budget_bytes = budget
        probe = next((sid for st, sid in cap.actions[before:]
                      if st == "int8"), None)
        if probe is None:
            raise AssertionError("budget: the tightened budget put no "
                                 "session in int8")
        prompt = rng.integers(0, model.cfg.vocab_size,
                              INT8_PROBE_TOKENS).astype(np.int32)
        seq = eng.submit(Request(probe, prompt,
                                 max_new_tokens=DECODE_TOKENS))
        eng.run()
        tokens[(2, probe)] = list(seq.generated)
        requests[(2, probe)] = (seq.request.prompt, list(seq.generated),
                                eng.token_logits[id(seq)])
        keys[(2, probe)] = id(seq)
        rows.append(f"{probe}/2 (int8 probe): ttft "
                    f"{seq.ttft_wall * 1e3:.0f} ms (restored), last restore "
                    f"{seq.restore_wall * 1e3:.0f} ms")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    restoration.project_group = project
    launches = dict(zip(("restore_kv_grouped", "decode_attention",
                         "decode_attention_paged"),
                        (b - a for a, b in zip(launches0, (
                            rkv.launches, dec.launches,
                            dec.paged_launches)))))
    launches["restore_kv_grouped in groups"] = grouped[0]
    m = eng.metrics
    methods = set().union(*(c[2] for c in eng.checked)) if eng.checked \
        else set()
    res = {"tokens": tokens, "metrics": m, "wall": wall,
           "segments": eng.prefill_segs, "crosses": len(eng.cross_refs),
           "frames": (None if frames is None else
                      {f"s{i}": f for i, f in enumerate(frames)}),
           "checked": len(eng.checked), "methods": methods,
           "prefills": eng.prefills, "decodes": eng.decodes,
           "profile": profile, "bytes_peak": eng.bytes_peak,
           "ungated": {(rnd, sid) for (rnd, sid), key in keys.items()
                       if key in eng.req_tainted},
           "launches": launches, "restores": eng.restores,
           "decode_ms": (1e3 * eng.walls["decode"]
                         / max(m.decode_steps, 1)),
           "backend_name": eng.kv.name}
    mean = lambda xs: 1e3 * sum(xs) / max(len(xs), 1)  # noqa: E731
    walls = dict(eng.walls)
    walls["other"] = wall - sum(walls.values())
    print(f"{name}: {wall:.1f} s for {len(tokens)} requests; TTFT cold mean "
          f"{mean(m.ttft_wall_cold):.0f} ms (max "
          f"{1e3 * max(m.ttft_wall_cold, default=0):.0f}), restored mean "
          f"{mean(m.ttft_wall_restored):.0f} ms (max "
          f"{1e3 * max(m.ttft_wall_restored, default=0):.0f}); restore wall "
          f"mean {1e3 * m.restore_wall_sum / max(len(m.restore_sim_all), 1):.0f}"
          f" ms over {len(m.restore_sim_all)} "
          f"restores ({m.restored_tokens} tokens); decode "
          + (f"{1e3 * walls['decode'] / max(m.decode_steps, 1):.1f} ms per "
             "step" if phased else "untimed")
          + f" over {m.decode_steps} steps; "
          f"{eng.prefills} prefill chunks; preemptions {m.preemptions}; "
          f"peak reserved tokens {m.reserved_tokens_peak}; "
          f"{len(eng.checked)} restores checked against their snapshots "
          f"(methods {sorted(methods)}): "
          + (f"{eng.int8_worst['restores']} of sessions once int8 within "
             f"{INT8_REL} relative L2, the rest bitwise" if eng.tainted
             else "bitwise"))
    if phased:
        print(f"{name} wall by phase (synchronised): " + ", ".join(
            f"{k} {v:.2f} s ({v / wall:.0%})" for k, v in walls.items()))
    if profile is not None:
        print(f"{name} calibration: {m.makespan_err_n} restores, planned-"
              f"vs-measured makespan error mean {m.makespan_err_mean:.1%}, "
              f"bubble mean {m.restore_bubble_mean:.1%}; profiler samples "
              f"{m.profiler_samples}")
    print(f"{name} requests: " + "; ".join(rows))
    if cap is not None:
        res.update(capacity=cap, int8_worst=dict(eng.int8_worst),
                   probe=probe,
                   walls_by_codec={k: list(v) for k, v
                                   in eng.walls_by_codec.items()},
                   bytes_end=store.bytes_used)
    eng.close()
    res["requests"] = requests
    return res


def prefix_requests(vocab):
    """The prefix phase's requests: round 0 one shared document and a
    question per session, round 1 ROUND1_TOKENS more per session and for
    the fork u0f; the same arrays for both runs."""
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    doc = rng.integers(0, vocab, PREFIX_DOC).astype(np.int32)
    lo, hi = PREFIX_QUESTION
    rounds = [{f"u{s}": np.concatenate(
        [doc, rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
         .astype(np.int32)]) for s in range(PREFIX_SESSIONS)}]
    rounds.append({sid: rng.integers(0, vocab, ROUND1_TOKENS)
                   .astype(np.int32)
                   for sid in list(rounds[0]) + ["u0f"]})
    return rounds


def run_prefix_engine(model, params, sharing: bool, rounds):
    """The prefix phase's traffic through the paged engine with
    ``prefix_sharing`` on or off (phased; see PREFIX_DOC); returns tokens,
    metrics, what was checked, the sharing gauges' peaks and what
    ``check_against_plain`` needs."""
    import torch
    from repro_torch.serving import Phase, Request
    from repro_torch.storage import ChunkStore, make_array
    Manager, Engine = engine_classes()
    store = ChunkStore(make_array("ssd", 4), chunk_tokens=64)
    mgr = Manager(model, store)
    mgr.all_hidden = True
    eng = Engine(model, params, mgr, max_batch=ENGINE_BATCH,
                 max_seq=ENGINE_MAX_SEQ, prefill_chunk=ENGINE_CHUNK,
                 backend="paged", block_size=16, prefix_sharing=sharing)
    name = "engine paged prefix " + ("sharing" if sharing else "no sharing")
    tokens, requests, history, seqs = {}, {}, {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rnd, prompts in enumerate(rounds):
        for sid, prompt in prompts.items():
            seqs[rnd, sid] = eng.submit(Request(
                sid, prompt, max_new_tokens=DECODE_TOKENS))
        if rnd == 0:
            u0 = seqs[0, "u0"]
            while not (u0.phase == Phase.DECODE and len(u0.generated) >= 3):
                eng.step()
            eng.fork_session("u0", "u0f")
            # the fork's history is its source's at the fork
            eng.snapshots["u0f"] = eng.snapshots["u0"]
            n_fork = u0.total_len - 1
            history["u0f"] = [int(t) for t in
                              list(prompts["u0"]) + u0.generated][:n_fork]
        eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for (rnd, sid), seq in seqs.items():
        tokens[rnd, sid] = list(seq.generated)
        requests[rnd, sid] = (seq.request.prompt, list(seq.generated),
                              eng.token_logits[id(seq)])
    m = eng.metrics
    restored = [seq.ttft_wall for (rnd, _), seq in seqs.items() if rnd]
    # round 0: a prompt that hit the index starts as a stored session
    hits = [q.ttft_wall for (r, _), q in seqs.items() if not r and q.restored]
    misses = [q.ttft_wall for (r, _), q in seqs.items()
              if not r and not q.restored]
    mean = lambda xs: 1e3 * sum(xs) / max(len(xs), 1)  # noqa: E731
    print(f"{name}: {wall:.1f} s for {len(seqs)} requests; round-0 TTFT "
          f"mean {mean(misses):.0f} ms over {len(misses)} misses, "
          f"{mean(hits):.0f} ms over {len(hits)} prefix hits; round 1 mean "
          f"{mean(restored):.0f} ms (max "
          f"{1e3 * max(restored):.0f}); {len(m.restore_sim_all)} restores "
          f"({m.restored_tokens} tokens restored, {m.restore_skipped_tokens} "
          f"skipped); hit rate {m.prefix_hit_rate:.2f} ({m.prefix_hits}/"
          f"{m.prefix_lookups} lookups, {m.prefix_hit_tokens} tokens); "
          f"copy-on-write copies {m.cow_copies}; shared pages peak "
          f"{eng.shared_peak}; host dedup {m.dedup_host_bytes / 1e6:.1f} MB; "
          f"decode {1e3 * eng.walls['decode'] / max(m.decode_steps, 1):.1f} "
          f"ms per step over {m.decode_steps} steps; {len(eng.checked)} "
          "restores bitwise equal to their snapshots; wall by phase "
          + ", ".join(f"{k} {v:.2f} s" for k, v in eng.walls.items()))
    print(f"{name} requests: " + "; ".join(
        f"{sid}/{rnd}: ttft {q.ttft_wall * 1e3:.0f} ms"
        + (f", restore {q.restore_wall * 1e3:.0f} ms" if rnd else
           " (prefix hit)" if q.restored else "")
        for (rnd, sid), q in seqs.items()))
    eng.close()
    a = eng.kv.allocator
    if a.free_count != eng.kv.num_blocks or any(a._ref):
        raise AssertionError(f"{name}: pages still held after close "
                             f"({eng.kv.num_blocks - a.free_count})")
    return {"tokens": tokens, "metrics": m, "wall": wall,
            "checked": len(eng.checked), "shared_peak": eng.shared_peak,
            "pages_peak": eng.pages_peak,
            "committed_peak": eng.committed_peak,
            "requests": requests, "histories": history,
            "restored_ttft": restored,
            "ttft": {key: q.ttft_wall for key, q in seqs.items()},
            "hits": {key for key, q in seqs.items()
                     if not key[0] and q.restored}}


def check_prefix(on, off):
    """Sharing on gives sharing off's tokens, and shared what it is for."""
    if on["tokens"] != off["tokens"]:
        bad = [k for k in on["tokens"] if on["tokens"][k] != off["tokens"][k]]
        raise AssertionError(f"prefix sharing changed the tokens of {bad}")
    m = on["metrics"]
    if not (m.prefix_hits > 0 and m.restore_skipped_tokens > 0
            and m.cow_copies > 0 and on["shared_peak"] > 0):
        raise AssertionError(
            f"prefix sharing: hits {m.prefix_hits}, skipped "
            f"{m.restore_skipped_tokens}, copies {m.cow_copies}, shared "
            f"pages peak {on['shared_peak']}: one of them is 0")
    if off["metrics"].prefix_hits or off["metrics"].cow_copies:
        raise AssertionError("sharing off: hits or copies counted")
    if on["checked"] <= 0 or off["checked"] <= 0:
        raise AssertionError("prefix sharing: no restore was checked")
    mean = lambda xs: 1e3 * sum(xs) / max(len(xs), 1)  # noqa: E731
    hits = sorted(on["hits"])
    print(f"engine paged prefix: tokens identical with sharing on and off "
          f"for all {len(on['tokens'])} requests; wall {on['wall']:.1f} / "
          f"{off['wall']:.1f} s (on / off); round-0 TTFT of the "
          f"{len(hits)} prefix hits {mean([on['ttft'][k] for k in hits]):.0f}"
          f" ms against {mean([off['ttft'][k] for k in hits]):.0f} ms for "
          f"the same requests without sharing; round-1 TTFT mean "
          f"{mean(on['restored_ttft']):.0f} / "
          f"{mean(off['restored_ttft']):.0f} ms; pool pages at the peak "
          f"{on['pages_peak']} held, {on['committed_peak']} with the copy "
          f"debt held back (sharing), {off['pages_peak']} (no sharing)")


def run_tp_phase(model, params):
    """Tensor-parallel serving with every shard on the card: the paged
    engine at each width of TP_WIDTHS and the contiguous one at each of
    TP_CONTIGUOUS_WIDTHS (``run_engine`` with ``tp``), each wider run held
    against its backend's tp 1 run (``check_tp``). Returns
    {(backend, tp): the run's summary}."""
    import gc

    import torch
    out = {}
    for backend, widths in (("paged", TP_WIDTHS),
                            ("contiguous", TP_CONTIGUOUS_WIDTHS)):
        ref = None
        for tp in widths:
            run = run_engine(model, params, backend, prompts=TP_PROMPTS,
                             round1=TP_ROUND1_TOKENS, max_seq=TP_MAX_SEQ,
                             tp=tp, batch=TP_BATCH, quantum=TP_QUANTUM,
                             ref=ref)
            m = run["metrics"]
            out[backend, tp] = {
                "wall_s": run["wall"], "decode_ms": run["decode_ms"],
                "project_ms": 1e3 * m.restore_project_wall,
                "restores": len(run["restores"]),
                "launches": run["launches"], "gauges": m.device_gauges}
            print(f"engine {backend} tp={tp} ({run['backend_name']}): wall "
                  f"{run['wall']:.2f} s, decode {run['decode_ms']:.2f} ms "
                  f"per step over {m.decode_steps} steps, projection "
                  f"{1e3 * m.restore_project_wall:.2f} device ms over "
                  f"{len(run['restores'])} restores, launches "
                  f"{run['launches']}; per-device gauges: " + "; ".join(
                      f"device {r['device']}: free pages {r['free_pages']}, "
                      f"occupancy {r['occupancy_pct']}%, live/reserved "
                      f"{r['util_pct']}%, projection {r['proj_util_pct']}%"
                      + (f", pool {r['pool_bytes'] / 1e6:.1f} MB"
                         if "pool_bytes" in r else "")
                      for r in m.device_gauges))
            if ref is None:
                ref = run
                if m.preemptions <= 0 or not run["restores"]:
                    raise AssertionError(f"{backend} tp=1: no preemption or "
                                         "no restore")
            else:
                check_tp(backend, tp, run, ref)
            del run
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    return out


def check_tp(backend, tp, run, ref):
    """A run at width ``tp`` against its backend's tp 1 run: the same
    tokens, the same restores (session, length; ``run_engine`` held each
    one's K/V bitwise against tp 1's as it completed), kernel
    #1's launches inside projection groups and the paged decode kernel's
    ``tp`` times those of tp 1 (every shard launched), the rest of #1's
    and the contiguous decode kernel's the same, and one gauge row per
    shard of a split pool."""
    name = f"engine {backend} tp={tp}"
    check_same_tokens(name, run, ref, "tp=1")
    got, want = run["restores"], ref["restores"]
    if [(s, n) for s, n, _, _ in got] != [(s, n) for s, n, _, _ in want]:
        raise AssertionError(f"{name}: restored other sessions or lengths "
                             "than tp=1")
    a, b = run["launches"], ref["launches"]
    grouped = "restore_kv_grouped in groups"
    scaled = {grouped: tp, "decode_attention_paged": tp}
    for k, n in b.items():
        want_n = n * scaled.get(k, 1)
        if k == "restore_kv_grouped":
            want_n = n + (tp - 1) * b[grouped]
        if a[k] != want_n:
            raise AssertionError(f"{name}: {a[k]} {k} launches, not "
                                 f"{want_n} (tp=1: {n})")
    if b[grouped] <= 0 or (backend == "paged"
                           and b["decode_attention_paged"] <= 0):
        raise AssertionError(f"{name}: tp=1 launched no sharded kernel")
    rows = len(run["metrics"].device_gauges)
    if rows != (tp if backend == "paged" else 1):
        raise AssertionError(f"{name}: {rows} gauge rows")
    print(f"{name}: tokens of all {len(run['tokens'])} requests and the K/V "
          f"of all {len(got)} restores bitwise those of tp=1; kernel #1 in "
          f"projection groups {a[grouped]} = {tp} x {b[grouped]}, paged "
          f"decode {a['decode_attention_paged']} = {tp} x "
          f"{b['decode_attention_paged']}")


# The front-door phase: llama2-7b (full size, bf16) behind the HTTP front
# door (EnginePump -> SessionRouter -> FrontDoor -> HttpFrontDoor on an
# ephemeral port), driven through the socket by a stdlib client, once on
# the contiguous backend and once on the paged backend with prefix
# sharing (every layer planned hidden, as in the prefix phase). The
# conversations' messages are token-id lists through the chat template:
# conversation A (a FD_SYSTEM-token system prompt and a FD_USER[0]-token
# question) round 0 fresh, round 1 exact by its conversation id, then a
# branch resending A's transcript under another conversation id while A
# is still bound (a fork with sharing on, else fresh), then A's round 2
# by transcript alone (restore); conversation B (FD_B tokens) round 0
# fresh, round 1 restore; one SSE-streamed request and its twin
# unstreamed; every gated request waits for its answer before the next
# is sent. Then FD_BURST concurrent short requests against a pump with
# FD_MAX_PENDING: some must get 429. Every gated request's tokens must
# equal those of the same requests (session ids, suffixes, forks, in
# order) driven straight through an engine built the same way, and its
# logits must pass ``check_against_plain``.
FD_SYSTEM = 384
FD_USER = (256, 128, 96, 64)
FD_B = (512, 128, 64)
FD_SSE = 300
FD_MAX_PENDING = 4
FD_BURST = 8
# device memory the front door may hold past its twin (the pump thread
# runs without autograd: a recorded graph would hold GBs)
FD_MEMORY_SLACK = 256 << 20


def front_door_engine(model, params, backend):
    """The front-door phase's engine (and its twin's): the instrumented
    engine of ``engine_classes`` on ``backend``; paged with prefix
    sharing and every layer hidden. Records every submitted sequence."""
    from repro_torch.storage import ChunkStore, make_array
    Manager, Engine = engine_classes()
    mgr = Manager(model, ChunkStore(make_array("ssd", 4), chunk_tokens=64))
    mgr.all_hidden = backend == "paged"
    eng = Engine(model, params, mgr, max_batch=ENGINE_BATCH,
                 max_seq=ENGINE_MAX_SEQ, prefill_chunk=ENGINE_CHUNK,
                 backend=backend, block_size=16,
                 prefix_sharing=backend == "paged")
    eng.seqs = []
    submit, fork = eng.submit, eng.fork_session

    def recorded(request):
        seq = submit(request)
        eng.seqs.append(seq)
        return seq

    def forked(src, new_id):
        man = fork(src, new_id)
        # the fork's history is its source's at the fork
        eng.snapshots[new_id] = eng.snapshots[src]
        return man
    eng.submit, eng.fork_session = recorded, forked
    return eng


def http_call(port, path, body=None, method="POST"):
    """One request to the front door over a socket: (status, body text)."""
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    c.request(method, path, None if body is None else json.dumps(body),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    raw = r.read().decode("utf-8")
    c.close()
    return r.status, raw


def chat_call(port, messages, **body):
    """A non-streamed chat round that must answer 200: the answer."""
    st, raw = http_call(port, "/v1/chat/completions",
                        dict(body, messages=messages))
    if st != 200:
        raise AssertionError(f"front door: chat answered {st}: {raw[:300]}")
    return json.loads(raw)


def sse_events(raw):
    events = [e[len("data: "):] for e in raw.split("\n\n")
              if e.startswith("data: ")]
    if not events or events[-1] != "[DONE]":
        raise AssertionError("front door: the stream did not end with "
                             "[DONE]")
    return [json.loads(e) for e in events[:-1]]


def run_front_door(model, params, backend):
    """The front-door phase's traffic on ``backend`` (see FD_SYSTEM);
    returns what its checks need: the routed requests in order, the
    engine's requests for ``check_against_plain``, the forks' histories,
    the subscriptions' TTFTs, the router's stats and metrics."""
    import asyncio
    import concurrent.futures
    import threading

    import numpy as np
    import torch
    from repro_torch.frontend import (EnginePump, FrontDoor, HttpFrontDoor,
                                      SessionRouter)
    before = set(threading.enumerate())
    eng = front_door_engine(model, params, backend)
    # the saver's drains (the pump drains when the engine goes idle, as
    # the twin's run() does after each request): count and seconds
    drains = []
    drain = eng.mgr.saver.drain

    def timed_drain():
        t = time.perf_counter()
        drain()
        drains.append(time.perf_counter() - t)
    eng.mgr.saver.drain = timed_drain
    pump = EnginePump(eng, max_pending=FD_MAX_PENDING)
    subs = []
    submit = pump.submit

    def recorded(request, loop=None):
        sub = submit(request, loop)
        subs.append(sub)
        return sub
    pump.submit = recorded
    router = SessionRouter(eng, block_size=16)
    api = FrontDoor(pump, router, model_name=model.cfg.name,
                    default_max_tokens=DECODE_TOKENS)
    pump.start()
    loop = asyncio.new_event_loop()
    serving = threading.Thread(target=loop.run_forever, name="front-door",
                               daemon=True)
    serving.start()
    srv = HttpFrontDoor(api, port=0)
    asyncio.run_coroutine_threadsafe(srv.start(), loop).result(60)
    port = srv.port
    rng = np.random.default_rng(SEED + 2)
    V = model.cfg.vocab_size

    def ids(n):
        return [int(t) for t in rng.integers(0, V, n)]

    def turn(msgs, answer, n):
        return msgs + [{"role": "assistant",
                        "content": answer["choices"][0]["message"]
                        ["content"]},
                       {"role": "user", "content": ids(n)}]
    memory = []

    def chat(msgs, **body):
        a = chat_call(port, msgs, max_tokens=DECODE_TOKENS, **body)
        torch.cuda.synchronize()
        memory.append(torch.cuda.memory_allocated())
        return a
    t0 = time.perf_counter()
    a_msgs = [{"role": "system", "content": ids(FD_SYSTEM)},
              {"role": "user", "content": ids(FD_USER[0])}]
    a0 = chat(a_msgs)
    a_msgs = turn(a_msgs, a0, FD_USER[1])
    a1 = chat(a_msgs, conversation_id=a0["conversation_id"])
    chat(turn(a_msgs, a1, FD_USER[2]), conversation_id="branch")
    chat(turn(a_msgs, a1, FD_USER[3]))
    b_msgs = [{"role": "system", "content": ids(FD_B[0])},
              {"role": "user", "content": ids(FD_B[1])}]
    b0 = chat(b_msgs)
    chat(turn(b_msgs, b0, FD_B[2]))
    sse_msgs = [{"role": "user", "content": ids(FD_SSE)}]
    st, raw = http_call(port, "/v1/chat/completions",
                        {"messages": sse_msgs, "max_tokens": DECODE_TOKENS,
                         "stream": True})
    torch.cuda.synchronize()
    memory.append(torch.cuda.memory_allocated())
    if st != 200:
        raise AssertionError(f"front door: the stream answered {st}")
    chunks = sse_events(raw)
    streamed = "".join(c["choices"][0]["delta"].get("content") or ""
                       for c in chunks)
    twin = chat(sse_msgs)
    if streamed != twin["choices"][0]["message"]["content"]:
        raise AssertionError("front door: the streamed deltas differ from "
                             "the unstreamed answer of the same request")
    if chunks[-1].get("hcache", {}).get("route") != "fresh":
        raise AssertionError("front door: the stream's last chunk has no "
                             "hcache block")
    gated_s = time.perf_counter() - t0
    n_gated = len(subs)
    st, raw = http_call(port, "/metrics", method="GET")
    metrics = json.loads(raw)
    # the burst: concurrent short requests past max_pending
    bodies = [{"messages": [{"role": "user", "content": ids(64)}],
               "max_tokens": 4} for _ in range(FD_BURST)]
    with concurrent.futures.ThreadPoolExecutor(FD_BURST) as ex:
        burst = list(ex.map(lambda b: http_call(
            port, "/v1/chat/completions", b), bodies))
    statuses = sorted(st for st, _ in burst)
    if 429 not in statuses or 200 not in statuses:
        raise AssertionError(f"front door: a burst of {FD_BURST} against "
                             f"max_pending {FD_MAX_PENDING} answered "
                             f"{statuses}")
    asyncio.run_coroutine_threadsafe(srv.close(), loop).result(60)
    loop.call_soon_threadsafe(loop.stop)
    serving.join(60)
    loop.close()
    pump.close()
    leaked = [t.name for t in threading.enumerate()
              if t not in before and t.is_alive()]
    if leaked:
        raise AssertionError(f"front door: threads left running {leaked}")
    a = getattr(eng.kv, "allocator", None)
    if a is not None and (a.free_count != eng.kv.num_blocks or any(a._ref)):
        raise AssertionError("front door: pages still held after close")
    routed = [(sub.meta["decision"], sub) for sub in subs[:n_gated]]
    requests, histories, streams, rounds = {}, {}, {}, {}
    for (d, sub), seq in zip(routed, eng.seqs):
        sid = d.session_id
        if d.forked_from is not None:
            histories[sid] = list(streams[d.forked_from])
            streams[sid] = list(streams[d.forked_from])
        rnd = rounds[sid] = rounds.get(sid, -1) + 1
        gen = list(seq.generated)
        if gen != sub.tokens:
            raise AssertionError(f"front door: {sid}/{rnd} emitted "
                                 f"{sub.tokens}, the engine holds {gen}")
        requests[rnd, sid] = (seq.request.prompt, gen,
                              eng.token_logits[id(seq)])
        streams[sid] = (streams.get(sid, []) + [int(t) for t in
                                                seq.request.prompt]
                        + gen[:-1])
    return {"routed": [(d.session_id, np.asarray(d.prompt), d.kind,
                        d.matched_tokens, d.forked_from, sub.ttft,
                        list(sub.tokens)) for d, sub in routed],
            "requests": requests, "histories": histories,
            "stats": router.stats(), "metrics": metrics["engine"],
            "restored": eng.metrics.restored_tokens, "memory": memory,
            "burst": statuses, "gated_s": gated_s, "drains": drains,
            "checked": len(eng.checked)}


def run_front_door_twin(model, params, backend, routed):
    """The front-door phase's routed requests straight through an engine
    built the same way: the same session ids, suffixes and forks, one
    request at a time; tokens, TTFTs and device memory per request."""
    import torch
    from repro_torch.serving import Request
    eng = front_door_engine(model, params, backend)
    out, memory = [], []
    for sid, prompt, kind, _, src, _, _ in routed:
        if kind == "fork":
            eng.fork_session(src, sid)
        seq = eng.submit(Request(sid, prompt, max_new_tokens=DECODE_TOKENS))
        eng.run()
        torch.cuda.synchronize()
        memory.append(torch.cuda.memory_allocated())
        out.append((list(seq.generated), seq.ttft_wall))
    eng.close()
    return {"out": out, "memory": memory,
            "restored": eng.metrics.restored_tokens}


def check_front_door(backend, run, twin):
    """The front door gave its twin's tokens on every gated request, the
    routes the traffic asks for, restored tokens, and no device memory
    the twin did not hold; prints per-route TTFT beside the twin's."""
    kinds = [r[2] for r in run["routed"]]
    want = ["fresh", "exact", "fork" if backend == "paged" else "fresh",
            "restore", "fresh", "restore", "fresh", "fresh"]
    if kinds != want:
        raise AssertionError(f"front door {backend}: routes {kinds}, not "
                             f"{want}")
    for r, (tokens, _) in zip(run["routed"], twin["out"]):
        if r[6] != tokens:
            raise AssertionError(f"front door {backend}: {r[0]} ({r[2]}) "
                                 f"gave {r[6]}, its direct-engine twin "
                                 f"{tokens}")
    if backend == "contiguous" and run["restored"] <= 0:
        raise AssertionError("front door: no token was restored")
    grow = (run["memory"][-1] - run["memory"][0]) - (
        twin["memory"][-1] - twin["memory"][0])
    if grow > FD_MEMORY_SLACK:
        raise AssertionError(f"front door {backend}: device memory grew "
                             f"{grow / 2**20:.0f} MiB more than its twin's "
                             "over the rounds")
    by_route = {}
    for r, (_, ttft) in zip(run["routed"], twin["out"]):
        by_route.setdefault(r[2], []).append((r[5], ttft))
    mean = lambda xs: 1e3 * sum(xs) / max(len(xs), 1)  # noqa: E731
    print(f"front door {backend}: {len(kinds)} gated requests in "
          f"{run['gated_s']:.1f} s, tokens equal to the direct-engine twin; "
          "TTFT by route (front door / twin): " + "; ".join(
              f"{k} {mean([a for a, _ in v]):.1f} / "
              f"{mean([b for _, b in v]):.1f} ms over {len(v)}"
              for k, v in by_route.items())
          + f"; restored tokens {run['restored']} (twin "
          f"{twin['restored']}); matched tokens "
          f"{[r[3] for r in run['routed']]}; burst statuses {run['burst']}; "
          f"router {run['stats']}; device memory after each round "
          f"{[round(m / 2**30, 2) for m in run['memory']]} GB (twin "
          f"{[round(m / 2**30, 2) for m in twin['memory']]}); "
          f"{run['checked']} restores bitwise equal to their snapshots")
    print(f"front door {backend} requests (route: TTFT front door / twin "
          "ms): " + ", ".join(
              f"{r[2]} {1e3 * r[5]:.1f} / {1e3 * t:.1f}"
              for r, (_, t) in zip(run["routed"], twin["out"]))
          + f"; saver drains {len(run['drains'])}, "
          f"{sum(run['drains']):.2f} s in all, longest "
          f"{1e3 * max(run['drains'], default=0):.1f} ms")


def serve_http_cli(serve):
    """``serve.py --serve-http --port 0`` (smoke config) on a thread of
    this process, with its stdout kept: two chat rounds over the socket,
    the second ``exact`` and restoring, then a clean stop (the front
    door's stop event, as Ctrl-C cancels it) with no thread left
    running."""
    import asyncio
    import contextlib
    import threading
    before = set(threading.enumerate())
    base = serve.serve_engine
    state = {}

    async def stoppable(*args, **kw):
        state["loop"] = asyncio.get_running_loop()
        state["stop"] = kw["stop"] = asyncio.Event()
        return await base(*args, **kw)
    serve.serve_engine = stoppable
    tee = _Tee(sys.stdout)
    errors = []

    def main():
        try:
            serve.main(["--serve-http", "--port", "0", "--max-seq", "256"])
        except BaseException as e:        # noqa: BLE001 - re-raised below
            errors.append(e)
    thread = threading.Thread(target=main, name="serve-http", daemon=True)
    with contextlib.redirect_stdout(tee):
        try:
            thread.start()
            port, t0 = None, time.perf_counter()
            while port is None and time.perf_counter() - t0 < 300:
                if errors:
                    raise errors[0]
                line = next((x for x in "".join(tee.parts).splitlines()
                             if "front door listening on http://" in x),
                            None)
                if line:
                    port = int(line.split("http://")[1].split()[0]
                               .rsplit(":", 1)[1])
                time.sleep(0.05)
            if port is None:
                raise AssertionError("serve --serve-http never listened")
            msgs = [{"role": "user", "content": "hello from the card"}]
            r1 = chat_call(port, msgs, max_tokens=8)
            msgs += [{"role": "assistant",
                      "content": r1["choices"][0]["message"]["content"]},
                     {"role": "user", "content": "and a second round"}]
            r2 = chat_call(port, msgs, max_tokens=8,
                           conversation_id=r1["conversation_id"])
            st, raw = http_call(port, "/metrics", method="GET")
            restored = json.loads(raw)["engine"]["restored_tokens"]
        finally:
            if "loop" in state:
                state["loop"].call_soon_threadsafe(state["stop"].set)
            if thread.is_alive():
                thread.join(120)
            serve.serve_engine = base
    if errors:
        raise errors[0]
    if thread.is_alive() or "front door closed" not in "".join(tee.parts):
        raise AssertionError("serve --serve-http did not stop cleanly")
    leaked = [t.name for t in threading.enumerate()
              if t not in before and t.is_alive()]
    if leaked:
        raise AssertionError(f"serve --serve-http left threads {leaked}")
    h1, h2 = r1["hcache"], r2["hcache"]
    if not (h1["route"] == "fresh" and h2["route"] == "exact"
            and h2["session_id"] == h1["session_id"] and restored > 0):
        raise AssertionError(f"serve --serve-http: routes {h1}, {h2}, "
                             f"restored {restored}")
    print(f"serve --serve-http: round 0 {h1}, round 1 {h2}, restored "
          f"{restored} tokens, stopped with no thread left")


def check_budget(run, budget, peak):
    """The budget run's ladder: int8 actions, no drop, restores of int8
    sessions checked, every request served. Prints first, then gates."""
    cap = run["capacity"]
    walls = {k: (len(v), 1e3 * sum(v) / max(len(v), 1))
             for k, v in run["walls_by_codec"].items()}
    w = run["int8_worst"]
    print(f"engine contiguous budget: budget {budget} B "
          f"({BUDGET_FRACTION:.0%} of the unbudgeted peak {peak} B), ladder "
          f"{BUDGET_LADDER}; actions {cap.actions}; hot bytes at the end "
          f"{run['bytes_end']} (unbudgeted {peak}); int8 probe "
          f"{run['probe']}; over the budget after "
          f"{len(cap.over)} maintains, by at most "
          f"{max([o for _, o in cap.over], default=0)} B, held by protected "
          f"sessions only; demotion seconds " + ", ".join(
              f"{k} {v:.3f}" for k, v in cap.seconds.items())
          + "; restores (count, mean wall ms) by codec " + ", ".join(
              f"{k} {n} / {ms:.1f}" for k, (n, ms) in walls.items())
          + f"; rows once int8: worst relative L2 to the snapshot "
          f"{w['rel']:.5f} (limit {INT8_REL}); the {walls['int8'][0]} int8 "
          f"restores against the plain version on {w['rows']} token rows "
          f"per hidden layer in all, max abs err {w['plain']:.4g}")
    stages = [st for st, _ in cap.actions]
    if "int8" not in stages or "drop" in stages:
        raise AssertionError(f"budget ladder: actions {cap.actions}")
    if not walls["int8"][0] or not w["rows"]:
        raise AssertionError("budget: no int8 restore was checked")
    if any(len(t) != DECODE_TOKENS for t in run["tokens"].values()):
        raise AssertionError("budget: a request ended short")


def label(model) -> str:
    """The prefix of a path's printed lines: none for llama2-7b (the main
    path's model), the model's name for the others."""
    name = model.cfg.name
    return "" if name == "llama2-7b" else f"{name} "


def check_engine(con, pag, prefix="", methods=("hidden", "recompute")):
    """Both backends' runs agree and exercised what the phase is for:
    preemption, restores, and restores of layers under each of
    ``methods`` checked."""
    if con["tokens"] != pag["tokens"]:
        bad = [k for k in con["tokens"] if con["tokens"][k] != pag["tokens"][k]]
        raise AssertionError(f"paged and contiguous tokens differ for {bad}")
    for name, r in (("contiguous", con), ("paged", pag)):
        m = r["metrics"]
        if m.preemptions <= 0 or m.restored_tokens <= 0:
            raise AssertionError(f"{name}: no preemption or no restore")
        if r["checked"] <= 0 or not set(methods) <= r["methods"]:
            raise AssertionError(f"{name}: restores of {methods} layers "
                                 "were not all checked")
    if not (pag["metrics"].reserved_tokens_peak
            < con["metrics"].reserved_tokens_peak):
        raise AssertionError("paged reserved no less than contiguous")
    print(f"{prefix}engine: tokens identical on both backends for all 12 "
          "requests")


def check_same_tokens(name, run, ref, ref_name="phased"):
    """A run of the engine gives the reference run's tokens."""
    if run["tokens"] != ref["tokens"]:
        bad = [k for k in ref["tokens"] if run["tokens"][k] != ref["tokens"][k]]
        raise AssertionError(f"{name}: tokens differ from the {ref_name} "
                             f"run's for {bad}")
    if run["checked"] <= 0:
        raise AssertionError(f"{name}: no restore was checked")
    print(f"{name}: tokens identical to the {ref_name} run's for all "
          f"{len(ref['tokens'])} requests")


def check_calibration(run):
    """The calibrated run fed its profile for every method its restores
    ran, and the profile survives ``save``/``load``."""
    profile = run["profile"]
    counts = profile.sample_counts()
    need = {"io_h", "project"} | ({"recompute"} if "recompute"
                                  in run["methods"] else set()) | (
        {"io_kv"} if "kv" in run["methods"] else set())
    missing = sorted(k for k in need if not counts.get(k))
    if missing:
        raise AssertionError(f"calibrated engine: no {missing} samples in "
                             f"the profile ({counts})")
    m = run["metrics"]
    if m.profiler_samples != counts or not m.makespan_err_n:
        raise AssertionError("calibrated engine: the calibration gauges "
                             "were not filled")
    check_profile_round_trip(profile)
    print("engine contiguous calibrated: profile epoch "
          f"{profile.epoch}, samples {counts}; rates " + ", ".join(
              f"{k} {profile.rate(k):.4g} s/unit (overhead "
              f"{profile.overhead(k) * 1e6:.1f} us)" for k in counts)
          + "; save/load gives the same fits")


# --------------------------------------------------------------- ssm path
SSM_ARCH = "falcon-mamba-7b"


def build_ssm_model():
    """falcon-mamba-7b at full width and SSM_LAYERS of its 64 layers,
    bf16, random weights from SEED, warmed by one short prefill and
    decode step."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.models.module import count_params

    cfg = get_arch(SSM_ARCH).scaled(n_layers=SSM_LAYERS)
    model = Model(cfg, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = model.init(SEED)
    out = model.prefill(params, {"tokens": torch.arange(
        64, device=model.device)[None]})
    cache = {"conv": out["states"][0], "ssm": out["states"][1],
             "lengths": torch.tensor([64], dtype=torch.int32,
                                     device=model.device)}
    model.decode_step(params, cache, greedy(out["logits"]))
    m = model.h.mamba
    n_params = count_params(params)
    print(f"{SSM_ARCH}: {cfg.n_layers} layers, d={cfg.d_model}, inner "
          f"{m.d_inner}, state {m.d_state}, dt_rank {m.dt_rank}, vocab "
          f"{cfg.vocab_size}, {n_params / 1e9:.2f} B params bf16 (a_log "
          f"fp32); init and warm-up {_sync_s(t0):.1f} s on {model.device}")
    return model, params


def run_ssm_lifecycle(model, params):
    """3 sessions through the HCache manager: prefill -> save -> decode
    (saving hidden states) -> pause dump -> evict -> restore; the restored
    states bitwise equal to the live ones, then greedy decoding from them
    against the never-evicted states (MATCH)."""
    import numpy as np
    import torch
    from repro_torch.core.hcache import HCacheManager
    from repro_torch.storage import ChunkStore, make_array

    mgr = HCacheManager(model, ChunkStore(make_array("ssd", 4),
                                          chunk_tokens=64))
    rng = np.random.default_rng(SEED)
    dev = model.device
    try:
        for s, n0 in enumerate(PROMPTS):
            session = f"m{s}"
            toks = torch.from_numpy(
                rng.integers(0, model.cfg.vocab_size, n0)).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.prefill(params, {"tokens": toks[None]})
            tok = greedy(out["logits"])
            ttft_ms = _sync_s(t0) * 1e3
            mgr.save_prefill(session, toks.cpu().numpy(), out)
            live = {"conv": out["states"][0], "ssm": out["states"][1],
                    "lengths": torch.tensor([n0], dtype=torch.int32,
                                            device=dev)}
            del out
            t1 = time.perf_counter()
            inputs, live, tok = decode(model, params, live, tok,
                                       DECODE_TOKENS, save=(mgr, session))
            decode_ms = _sync_s(t1) * 1e3 / DECODE_TOKENS
            n_total = n0 + DECODE_TOKENS
            mgr.save_session_pause(session, live, n_total,
                                   tokens_tail=inputs)
            ref = {name: t.clone() for name, t in live.items()}
            del live                            # evict the device state
            res = mgr.restore(params, session)
            for name in ("conv", "ssm"):
                if not torch_equal(res.cache[name], ref[name]):
                    raise AssertionError(f"{session}: restored {name} state "
                                         "differs from the live one")
            seq_r, _, _ = decode(model, params, res.cache, tok,
                                 DECODE_TOKENS)
            seq_g, _, _ = decode(model, params, ref, tok, DECODE_TOKENS)
            verdict = "MATCH" if seq_r == seq_g else "MISMATCH"
            print(f"{SSM_ARCH} {session}: {n0} prompt tokens; TTFT (prefill)"
                  f" {ttft_ms:.1f} ms; decode {decode_ms:.2f} ms/token; "
                  f"restore {res.wall_time * 1e3:.1f} ms (methods "
                  f"{sorted(set(res.schedule.methods))}, virtual "
                  f"{res.timeline.makespan * 1e3:.3f} ms); conv and ssm "
                  f"states bitwise equal; {verdict}")
            if verdict != "MATCH":
                raise AssertionError(f"{session}: {seq_r} != {seq_g}")
    finally:
        mgr.close()


def run_ssm_engine(model, params):
    """6 single-round sessions over 4 slots of the contiguous backend; then
    every retired session's restore against the states the engine held at
    retire, bitwise. Returns what ``check_against_plain`` needs."""
    import numpy as np
    import torch
    from repro_torch.core.hcache import HCacheManager
    from repro_torch.serving import Request
    from repro_torch.storage import ChunkStore, make_array
    _, Engine = engine_classes()
    mgr = HCacheManager(model, ChunkStore(make_array("ssd", 4),
                                          chunk_tokens=64))
    eng = Engine(model, params, mgr, max_batch=ENGINE_BATCH,
                 max_seq=ENGINE_MAX_SEQ, backend="contiguous")
    rng = np.random.default_rng(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs = [eng.submit(Request(f"s{s}", rng.integers(
        0, model.cfg.vocab_size, n).astype(np.int32),
        max_new_tokens=DECODE_TOKENS))
        for s, n in enumerate(ENGINE_PROMPTS)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = eng.metrics
    walls = dict(eng.walls)
    walls["other"] = wall - sum(walls.values())
    for seq in seqs:
        sid = seq.request.session_id
        res = mgr.restore(params, sid)
        held = eng.snapshots[sid]
        if not (torch_equal(res.cache["conv"], held[0])
                and torch_equal(res.cache["ssm"], held[1])):
            raise AssertionError(f"{SSM_ARCH} engine: the restore of {sid} "
                                 "differs from its states at retire")
    mean = lambda xs: 1e3 * sum(xs) / max(len(xs), 1)  # noqa: E731
    print(f"{SSM_ARCH} engine contiguous: {wall:.1f} s for 6 requests; TTFT "
          f"mean {mean(m.ttft_wall):.0f} ms (max "
          f"{1e3 * max(m.ttft_wall, default=0):.0f}); {eng.prefills} "
          f"prefills (whole prompts); decode "
          f"{1e3 * walls['decode'] / max(m.decode_steps, 1):.1f} ms per step "
          f"over {m.decode_steps} steps; peak concurrency "
          f"{m.concurrent_peak}; 6 restores bitwise equal to the states at "
          f"retire")
    print(f"{SSM_ARCH} engine wall by phase (synchronised): " + ", ".join(
        f"{k} {v:.2f} s ({v / wall:.0%})" for k, v in walls.items()))
    if m.concurrent_peak != ENGINE_BATCH or m.decode_steps <= 0:
        raise AssertionError(f"{SSM_ARCH} engine: the batch never filled")
    requests = {(0, s.request.session_id): (
        s.request.prompt, list(s.generated), eng.token_logits[id(s)])
        for s in seqs}
    eng.close()
    return requests


# ------------------------------------------------------------ hybrid path
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_ENGINE_PROMPTS = (1024, 256, 768, 512, 896, 640)
HYBRID_ENGINE_MAX_SEQ = 1088     # 1024 + 16 tokens fit


def build_hybrid_model():
    """zamba2-2.7b at full width and HYBRID_LAYERS of its 54 layers,
    bf16, random weights from SEED, warmed by one short prefill and
    decode step."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.models.module import count_params

    cfg = get_arch(HYBRID_ARCH).scaled(n_layers=HYBRID_LAYERS)
    model = Model(cfg, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = model.init(SEED)
    out = model.prefill(params, {"tokens": torch.arange(
        64, device=model.device)[None]})
    model.decode_step(params, hybrid_cache(model, out, 65),
                      greedy(out["logits"]))
    h, m = model.h, model.h.mamba
    n_params = count_params(params)
    print(f"{HYBRID_ARCH}: {cfg.n_layers} layers ({h.n_super} super-blocks "
          f"of {h.k - 1} Mamba2 blocks and an attention block), "
          f"d={cfg.d_model}, {cfg.n_heads}x{cfg.head_dim_} heads over "
          f"{cfg.n_kv_heads} kv heads, d_ff={cfg.d_ff}, Mamba2 {m.n_heads} "
          f"heads of {m.head_dim}, state {m.d_state}, conv channels "
          f"{m.conv_channels}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} "
          f"B params bf16 ({2 * n_params / 1e9:.2f} GB; dt_bias, a_log and "
          f"d_skip fp32); init and warm-up {_sync_s(t0):.1f} s on "
          f"{model.device}")
    return model, params


def hybrid_cache(model, out, capacity):
    """A B=1 decode cache of ``capacity`` positions holding a hybrid
    prefill's attention K/V and Mamba2 states."""
    import torch
    cache = model.init_cache(1, capacity)
    n = out["kv"][0].shape[2]
    cache["attn_k"][:, :, :n] = out["kv"][0]
    cache["attn_v"][:, :, :n] = out["kv"][1]
    cache["conv"].copy_(out["mamba_states"][0])
    cache["ssm"].copy_(out["mamba_states"][1])
    cache["lengths"] = torch.tensor([n], dtype=torch.int32,
                                    device=model.device)
    return cache


def run_hybrid_lifecycle(model, params):
    """A session per prompt of PROMPTS through the HCache manager: prefill
    -> save -> DECODE_TOKENS decode steps, each step's attention hidden
    states saved -> pause dump -> evict -> restore. The restored attention
    K/V equal the live cache bitwise on every token (prefill and decode
    rows), the Mamba2 states bitwise; DECODE_TOKENS more tokens from the
    restored cache against the never-evicted one (MATCH). Session 0 is
    all-hidden, the others planned."""
    import collections

    import numpy as np
    import torch
    from repro_torch.core.hcache import HCacheManager
    from repro_torch.storage import ChunkStore, make_array

    store = ChunkStore(make_array("ssd", 4), chunk_tokens=64)
    managers = [HCacheManager(model, store, schedule_override="hidden",
                              restore_group_size=8),
                HCacheManager(model, store, restore_group_size=8)]
    kinds = model.cfg.block_kinds()
    rng = np.random.default_rng(SEED)
    dev = model.device
    try:
        for s, n0 in enumerate(PROMPTS):
            session, mgr = f"z{s}", managers[0 if s == 0 else 1]
            plan = mgr.plan(n0)
            by_kind = collections.Counter(
                f"{kinds[li].value} {m}" for li, m in enumerate(plan.methods))
            print(f"{HYBRID_ARCH} {session}: schedule for {n0} tokens: "
                  f"{plan.summary()}; methods by block kind "
                  f"{dict(sorted(by_kind.items()))}; the Mamba2 blocks' "
                  f"states restore as {model.adapter.n_state_blobs} blob")
            toks = torch.from_numpy(
                rng.integers(0, model.cfg.vocab_size, n0)).to(dev)
            cap = n0 + 2 * DECODE_TOKENS
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.prefill(params, {"tokens": toks[None]},
                                capture_hidden=True)
            tok = greedy(out["logits"])
            ttft_ms = _sync_s(t0) * 1e3
            mgr.save_prefill(session, toks.cpu().numpy(), out)
            live = hybrid_cache(model, out, cap)
            del out
            t1 = time.perf_counter()
            inputs, live, tok = decode(model, params, live, tok,
                                       DECODE_TOKENS, save=(mgr, session))
            decode_ms = _sync_s(t1) * 1e3 / DECODE_TOKENS
            n_total = n0 + DECODE_TOKENS
            mgr.save_session_pause(session, live, n_total,
                                   tokens_tail=inputs)
            ref = {name: t.clone() for name, t in live.items()}
            del live                            # evict the device state
            res = mgr.restore(params, session, capacity=cap)
            for name in ("attn_k", "attn_v"):
                if not torch_equal(res.cache[name][:, :, :n_total],
                                   ref[name][:, :, :n_total]):
                    raise AssertionError(
                        f"{session}: restored {name} differs from the live "
                        f"cache on [0, {n_total})")
            for name in ("conv", "ssm"):
                if not torch_equal(res.cache[name], ref[name]):
                    raise AssertionError(f"{session}: restored {name} state "
                                         "differs from the live one")
            seq_r, _, _ = decode(model, params, res.cache, tok,
                                 DECODE_TOKENS)
            seq_g, _, _ = decode(model, params, ref, tok, DECODE_TOKENS)
            verdict = "MATCH" if seq_r == seq_g else "MISMATCH"
            n_attn = len(model.adapter.decode_layers(model.h.n_super))
            h_mb = n_attn * n_total * model.cfg.d_model * 2 / 1e6
            blob_mb = (ref["conv"].numel() * 2 + ref["ssm"].numel() * 4) / 1e6
            print(f"{HYBRID_ARCH} {session}: {n0} prompt tokens; TTFT "
                  f"(prefill) {ttft_ms:.1f} ms; decode {decode_ms:.2f} "
                  f"ms/token; restore of {n_total} tokens "
                  f"{res.wall_time * 1e3:.1f} ms (projection "
                  f"{res.project_wall * 1e3:.2f} ms; host " + ", ".join(
                      f"{k} {v * 1e3:.1f}" for k, v in res.host_split.items())
                  + f" ms; virtual {res.timeline.makespan * 1e3:.3f} ms; "
                  f"uploads {h_mb:.1f} MB of hidden states for {n_attn} "
                  f"attention layers and a {blob_mb:.1f} MB state blob); "
                  f"attn_k/attn_v bitwise equal on all {n_total} tokens, "
                  f"conv and ssm bitwise equal; {verdict}")
            if verdict != "MATCH":
                raise AssertionError(f"{session}: {seq_r} != {seq_g}")
            del res, ref
    finally:
        for m in managers:
            m.close()


def run_hybrid_engine(model, params):
    """6 single-round sessions over 4 slots of the contiguous backend
    (session s0 all-hidden, the rest planned); then every retired
    session's restore against the K/V and states the engine held at
    retire, bitwise. Returns {session: (prompt, generated, the logits
    that sampled each token)}."""
    import numpy as np
    import torch
    from repro_torch.serving import Request
    from repro_torch.storage import ChunkStore, make_array
    Manager, Engine = engine_classes()
    mgr = Manager(model, ChunkStore(make_array("ssd", 4), chunk_tokens=64),
                  restore_group_size=8)
    eng = Engine(model, params, mgr, max_batch=ENGINE_BATCH,
                 max_seq=HYBRID_ENGINE_MAX_SEQ, backend="contiguous")
    rng = np.random.default_rng(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs = [eng.submit(Request(f"s{s}", rng.integers(
        0, model.cfg.vocab_size, n).astype(np.int32),
        max_new_tokens=DECODE_TOKENS))
        for s, n in enumerate(HYBRID_ENGINE_PROMPTS)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = eng.metrics
    walls = dict(eng.walls)
    walls["other"] = wall - sum(walls.values())
    for seq in seqs:
        sid = seq.request.session_id
        res = mgr.restore(params, sid)
        k, v, conv, ssm = eng.snapshots[sid]
        n = k.shape[1]
        if not (res.n_tokens == n
                and torch_equal(res.cache["attn_k"][:, 0, :n], k)
                and torch_equal(res.cache["attn_v"][:, 0, :n], v)
                and torch_equal(res.cache["conv"], conv)
                and torch_equal(res.cache["ssm"], ssm)):
            raise AssertionError(f"{HYBRID_ARCH} engine: the restore of "
                                 f"{sid} differs from its state at retire")
    mean = lambda xs: 1e3 * sum(xs) / max(len(xs), 1)  # noqa: E731
    print(f"{HYBRID_ARCH} engine contiguous: {wall:.1f} s for "
          f"{len(seqs)} requests; TTFT mean {mean(m.ttft_wall):.0f} ms (max "
          f"{1e3 * max(m.ttft_wall, default=0):.0f}); {eng.prefills} "
          f"prefills (whole prompts); decode "
          f"{1e3 * walls['decode'] / max(m.decode_steps, 1):.1f} ms per step "
          f"over {m.decode_steps} steps; peak concurrency "
          f"{m.concurrent_peak}; {len(seqs)} restores bitwise equal to the "
          "K/V and states at retire")
    print(f"{HYBRID_ARCH} engine wall by phase (synchronised): " + ", ".join(
        f"{k} {v:.2f} s ({v / wall:.0%})" for k, v in walls.items()))
    if m.concurrent_peak != ENGINE_BATCH or m.decode_steps <= 0:
        raise AssertionError(f"{HYBRID_ARCH} engine: the batch never filled")
    requests = {s.request.session_id: (
        s.request.prompt, list(s.generated), eng.token_logits[id(s)])
        for s in seqs}
    eng.close()
    return requests


def check_hybrid_engine(model, params, requests):
    """Each engine request against a B=1 pass over its own prompt (one
    prefill) and its generated tokens (one-token decode steps): the
    logits that sampled each token bitwise equal to the pass's, so every
    token is the pass's greedy choice. Each row's arithmetic does not
    depend on the batch it runs in (the SSD's decode sums run in a fixed
    order; the products, kernels and norms are per row). Outside the
    counted path. Returns the counts of tokens checked."""
    import torch
    V = model.cfg.vocab_size
    n = 0
    for sid in sorted(requests):
        prompt, gen, got = requests[sid]
        toks = torch.from_numpy(prompt.astype("int64")).to(model.device)
        out = model.prefill(params, {"tokens": toks[None]})
        cache = hybrid_cache(model, out, len(prompt) + len(gen))
        rows = [out["logits"][0, -1]]
        for t in gen[:-1]:
            lg, cache = model.decode_step(params, cache, torch.tensor(
                [[t]], device=model.device))
            rows.append(lg[0, -1])
        ref = torch.stack(rows)[:, :V].float()
        got = torch.stack(got)[:, :V]
        same = (got == ref).all(-1)
        if not bool(same.all()):
            i = int((~same).nonzero()[0, 0])
            rel = float((got[i] - ref[i]).norm()
                        / (ref[i] - ref[i].mean()).norm())
            raise AssertionError(
                f"{HYBRID_ARCH} engine {sid}: the logits of token {i} differ "
                f"from the B=1 pass's (relative L2 {rel:.3g})")
        if ref.argmax(-1).tolist() != list(gen):
            raise AssertionError(f"{HYBRID_ARCH} engine {sid}: tokens differ "
                                 "from the B=1 pass's greedy choices")
        n += len(gen)
        del cache, out
    return n


# ------------------------------------------------------------ enc-dec path
ENCDEC_ARCH = "whisper-medium"
# (encoder frames, decoder prompt tokens) of the lifecycle's sessions:
# whisper's 30 s window, twice it, and the cell's longest context
ENCDEC_SESSIONS = ((1500, 448), (3000, 256), (4096, 128))
ENCDEC_ROUND1 = 64
ENCDEC_ENC_SEQ = 4096
# the engine's sessions: encoder lengths cycle over 750/1500/3000/4096,
# so that every decode batch mixes enc_len; decoder prompts of 128-448
ENCDEC_ENGINE_FRAMES = (750, 1500, 3000, 4096, 750, 1500)
ENCDEC_ENGINE_PROMPTS = (448, 128, 256, 384, 192, 320)
ENCDEC_ENGINE_MAX_SEQ = 576      # 448 + 16 + 64 + 16 tokens fit, in pages


def encdec_frames(model, n: int, seed: int):
    """(n, D) frame embeddings on the host: seeded normals x 0.1, fp32."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, model.cfg.d_model)) * 0.1).astype(
        np.float32)


def encdec_cache(model, out, capacity):
    """A B=1 decode cache of ``capacity`` decoder positions holding an
    enc-dec prefill's self K/V and its cross K/V (enc_seq = its encoder
    length)."""
    import torch
    ck, cv = out["cross_kv"]
    cache = model.init_cache(1, capacity, enc_seq=ck.shape[2])
    n = out["kv"][0].shape[2]
    cache["self_k"][:, :, :n] = out["kv"][0]
    cache["self_v"][:, :, :n] = out["kv"][1]
    cache["cross_k"].copy_(ck)
    cache["cross_v"].copy_(cv)
    cache["enc_len"][:] = ck.shape[2]
    cache["lengths"] = torch.tensor([n], dtype=torch.int32,
                                    device=model.device)
    return cache


def build_encdec_model():
    """whisper-medium at full width and ENCDEC_LAYERS of its 24 encoder
    and 24 decoder layers, bf16, random weights from SEED, warmed by one
    short prefill (64 frames, 16 tokens) and decode step."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.models.module import count_params

    cfg = get_arch(ENCDEC_ARCH).scaled(n_layers=ENCDEC_LAYERS,
                                       encoder_layers=ENCDEC_LAYERS)
    model = Model(cfg, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = model.init(SEED)
    frames = torch.from_numpy(encdec_frames(model, 64, SEED)).to(
        model.device)
    out = model.prefill(params, {"tokens": torch.arange(
        16, device=model.device)[None], "frames": frames[None]})
    model.decode_step(params, encdec_cache(model, out, 17),
                      greedy(out["logits"]))
    n_params = count_params(params)
    print(f"{ENCDEC_ARCH}: {cfg.encoder_layers} encoder and {cfg.n_layers} "
          f"decoder layers, d={cfg.d_model}, {cfg.n_heads}x{cfg.head_dim_} "
          f"heads, d_ff={cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e6:.1f} M params bf16 ({2 * n_params / 1e9:.2f} "
          f"GB, the learned position table of 8192 rows included); init "
          f"and warm-up {_sync_s(t0):.1f} s on {model.device}")
    return model, params


def run_encdec_lifecycle(model, params):
    """A session per (frames, prompt) of ENCDEC_SESSIONS through the HCache
    manager: prefill -> save (decoder hidden states, the encoder output
    as the "enc" blob) -> DECODE_TOKENS decode steps, each step's hidden
    states saved -> pause dump -> evict -> restore. The restored self K/V
    equal the live cache bitwise on every token, the restored cross K/V
    the prefill's bitwise; MATCH_TOKENS more tokens from the restored
    cache against the never-evicted one (MATCH); then round 1,
    ENCDEC_ROUND1 new tokens prefilled over each cache's history and cross
    state and DECODE_TOKENS decoded, the same tokens from both. Session 0
    is all-hidden, the others planned."""
    import numpy as np
    import torch
    from repro_torch.core.hcache import HCacheManager
    from repro_torch.models import encdec
    from repro_torch.storage import ChunkStore, make_array

    store = ChunkStore(make_array("ssd", 4), chunk_tokens=64)
    managers = [HCacheManager(model, store, schedule_override="hidden",
                              restore_group_size=8),
                HCacheManager(model, store, restore_group_size=8)]
    rng = np.random.default_rng(SEED)
    dev, c = model.device, model.cfg

    def round1(cache, n_hist, toks):
        return encdec.decode_prefill(
            params, toks[None], None, model.h, capture_hidden=True,
            emit_kv=True, final_logits_only=True,
            hist_kv=(cache["self_k"][:, :, :n_hist],
                     cache["self_v"][:, :, :n_hist]),
            hist_len=n_hist, cross=(cache["cross_k"], cache["cross_v"]),
            pos_offset=n_hist)

    try:
        for s, (n_enc, n0) in enumerate(ENCDEC_SESSIONS):
            session, mgr = f"w{s}", managers[0 if s == 0 else 1]
            plan = mgr.plan(n0)
            toks = torch.from_numpy(rng.integers(0, c.vocab_size, n0)).to(dev)
            frames = torch.from_numpy(
                encdec_frames(model, n_enc, SEED + 1 + s)).to(dev)
            n_total = n0 + DECODE_TOKENS
            cap = n_total + ENCDEC_ROUND1 + DECODE_TOKENS + MATCH_TOKENS
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.prefill(params, {"tokens": toks[None],
                                         "frames": frames[None]},
                                capture_hidden=True)
            tok = greedy(out["logits"])
            ttft_ms = _sync_s(t0) * 1e3
            mgr.save_prefill(session, toks.cpu().numpy(), out)
            live = encdec_cache(model, out, cap)
            cross_ref = tuple(t.clone() for t in out["cross_kv"])
            del out
            t1 = time.perf_counter()
            inputs, live, tok = decode(model, params, live, tok,
                                       DECODE_TOKENS, save=(mgr, session))
            decode_ms = _sync_s(t1) * 1e3 / DECODE_TOKENS
            mgr.save_session_pause(session, live, n_total,
                                   tokens_tail=inputs)
            ref = {name: t.clone() for name, t in live.items()}
            del live                            # evict the device state
            res = mgr.restore(params, session, capacity=cap)
            for name in ("self_k", "self_v"):
                if not torch_equal(res.cache[name][:, :, :n_total],
                                   ref[name][:, :, :n_total]):
                    raise AssertionError(
                        f"{session}: restored {name} differs from the live "
                        f"cache on [0, {n_total})")
            if not (torch_equal(res.cache["cross_k"], cross_ref[0])
                    and torch_equal(res.cache["cross_v"], cross_ref[1])
                    and res.cache["enc_len"].tolist() == [n_enc]):
                raise AssertionError(f"{session}: restored cross K/V differ "
                                     "from the prefill's")
            seq_r, _, _ = decode(model, params, {k: t.clone() for k, t in
                                                 res.cache.items()},
                                 tok, MATCH_TOKENS)
            seq_g, _, _ = decode(model, params, {k: t.clone() for k, t in
                                                 ref.items()},
                                 tok, MATCH_TOKENS)
            verdict = "MATCH" if seq_r == seq_g else "MISMATCH"
            if verdict != "MATCH":
                raise AssertionError(f"{session}: {seq_r} != {seq_g}")
            # round 1 over the restored and the never-evicted cache
            new = torch.from_numpy(
                rng.integers(0, c.vocab_size, ENCDEC_ROUND1)).to(dev)
            toks1 = []
            for cache in (res.cache, ref):
                out = round1(cache, n_total, new)
                if cache is res.cache:
                    mgr.save_prefill(session, new.cpu().numpy(), out,
                                     start=n_total)
                n_live = n_total + ENCDEC_ROUND1
                cache["self_k"][:, :, n_total:n_live] = out["kv"][0]
                cache["self_v"][:, :, n_total:n_live] = out["kv"][1]
                cache["lengths"] = torch.tensor([n_live], dtype=torch.int32,
                                                device=dev)
                got, _, _ = decode(model, params, cache, greedy(
                    out["logits"]), DECODE_TOKENS)
                toks1.append(got)
                del out
            if toks1[0] != toks1[1]:
                raise AssertionError(f"{session} round 1: {toks1[0]} over "
                                     f"the restored cache, {toks1[1]} over "
                                     "the never-evicted one")
            enc_mb = store.get_blob(session, "enc", 0).nbytes / 1e6
            cross_mb = (2 * cross_ref[0].numel()
                        * cross_ref[0].element_size() / 1e6)
            methods = "".join(m[0].upper() for m in plan.methods)
            print(f"{ENCDEC_ARCH} {session}: {n_enc} frames, {n0} prompt "
                  f"tokens (methods {methods}); TTFT (encoder and decoder "
                  f"prefill) {ttft_ms:.1f} ms; decode {decode_ms:.2f} "
                  f"ms/token; restore of {n_total} tokens "
                  f"{res.wall_time * 1e3:.1f} ms (projection "
                  f"{res.project_wall * 1e3:.2f} ms; host " + ", ".join(
                      f"{k} {v * 1e3:.1f}" for k, v in res.host_split.items())
                  + f" ms; virtual {res.timeline.makespan * 1e3:.3f} ms); "
                  f"enc blob {enc_mb:.2f} MB beside {cross_mb:.1f} MB of "
                  f"cross K/V ({cross_mb / enc_mb:.0f}x); self K/V bitwise "
                  f"on all {n_total} tokens, cross K/V bitwise; {verdict}; "
                  f"round 1 ({ENCDEC_ROUND1} new tokens) gives the "
                  f"never-evicted cache's {DECODE_TOKENS} tokens")
            del res, ref, cross_ref
    finally:
        for m in managers:
            m.close()


def run_encdec_engine(model, params, backend):
    """6 sessions x 2 rounds over 4 slots (``run_engine``) with frames of
    ENCDEC_ENGINE_FRAMES on round 0 and ENCDEC_ENC_SEQ encoder positions
    per slot."""
    frames = [encdec_frames(model, n, SEED + 10 + i)
              for i, n in enumerate(ENCDEC_ENGINE_FRAMES)]
    run = run_engine(model, params, backend, prompts=ENCDEC_ENGINE_PROMPTS,
                     round1=ENCDEC_ROUND1, max_seq=ENCDEC_ENGINE_MAX_SEQ,
                     frames=frames, enc_seq=ENCDEC_ENC_SEQ)
    if run["crosses"] != len(frames):
        raise AssertionError(f"{ENCDEC_ARCH} engine {backend}: "
                             f"{run['crosses']} first prefills recorded "
                             f"their cross K/V, not {len(frames)}")
    return run


# the smoke configs (reduced_for_smoke: 4 layers, hd 16) through
# launch/serve.py's path on the card, bf16, without --full:
# (name, arguments, kernels that must run)
SMOKE_SERVES = (
    ("serve llama2-7b smoke contiguous", ["--sessions", "4", "--rounds", "2"],
     ("restore_kv_grouped", "decode_attention", "flash_attention")),
    ("serve llama2-7b smoke paged", ["--sessions", "4", "--rounds", "2",
                                     "--backend", "paged"],
     ("restore_kv_grouped", "decode_attention_paged", "flash_attention")),
    ("serve llama2-7b smoke contiguous --budget-kb",
     ["--sessions", "4", "--rounds", "2", "--budget-kb", "8"],
     ("restore_kv_grouped", "decode_attention", "flash_attention")),
    ("serve llama2-7b smoke paged --prefix-sharing",
     ["--sessions", "4", "--rounds", "2", "--backend", "paged",
      "--prefix-sharing"],
     ("restore_kv_grouped", "decode_attention_paged", "flash_attention")),
    ("serve falcon-mamba-7b smoke", ["--arch", "falcon-mamba-7b",
                                     "--rounds", "1"], ("ssm_update",)),
    ("serve zamba2-2.7b smoke", ["--arch", "zamba2-2.7b", "--rounds", "1"],
     ("restore_kv_grouped", "decode_attention", "flash_attention")),
) + tuple(
    (f"serve {arch} smoke {backend}", ["--arch", arch, "--sessions", "2",
                                       "--rounds", "2", "--backend",
                                       backend],
     ("restore_kv_grouped", "flash_attention", "decode_attention"
      if backend == "contiguous" else "decode_attention_paged"))
    for arch, backends in (("qwen2-7b", ("contiguous", "paged")),
                           ("qwen2.5-14b", ("contiguous",)),
                           ("starcoder2-15b", ("contiguous",)),
                           ("gemma2-9b", ("contiguous", "paged")),
                           ("granite-moe-1b-a400m", ("contiguous", "paged")),
                           ("grok-1-314b", ("contiguous",)),
                           ("internvl2-26b", ("paged",)),
                           ("llama2-13b", ("contiguous",)),
                           ("opt-30b", ("contiguous", "paged")))
    for backend in backends) + tuple(
    (f"serve whisper-medium smoke {backend}",
     ["--arch", "whisper-medium", "--enc-seq", "64", "--sessions", "2",
      "--rounds", "2", "--backend", backend],
     ("restore_kv_grouped", "flash_attention", "decode_attention")
     + (("decode_attention_paged",) if backend == "paged" else ()))
    for backend in ("contiguous", "paged"))
# what a serve must print: its ladder's actions (the 8 KiB budget is
# below the smoke trace's first session, so the cold tier fills) or its
# prefix-sharing line
SERVE_PRINTS = {"serve llama2-7b smoke contiguous --budget-kb":
                "capacity ladder actions: [('cold'",
                "serve llama2-7b smoke paged --prefix-sharing":
                "prefix sharing: hit rate"}
# qwen2-7b's contiguous smoke serve again on a store of two hosts, layer-
# striped: the engine must report a per-link load and give the one-host
# serve's tokens
HOSTS_SERVE = ("serve qwen2-7b smoke contiguous",
               "serve qwen2-7b smoke contiguous --hosts 2",
               ["--hosts", "2", "--placement", "layer"])


class _Tee:
    """A stdout that also keeps what was written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def recorded_serve(serve, argv):
    """``serve.main(argv)`` with its engine's emitted tokens, the
    per-link loads its manager holds after each report, and its printed
    lines recorded."""
    import contextlib
    tokens, loads = [], []
    base = serve.InferenceEngine

    class Recording(base):
        def _emit_token(self, seq, tok):
            tokens.append((seq.request.session_id, int(tok)))
            super()._emit_token(seq, tok)

        def _update_io_streams(self, extra=0):
            super()._update_io_streams(extra)
            loads.append(self.mgr.link_load)

    serve.InferenceEngine = Recording
    tee = _Tee(sys.stdout)
    try:
        with contextlib.redirect_stdout(tee):
            serve.main(argv)
    finally:
        serve.InferenceEngine = base
    return {"tokens": tokens, "loads": loads, "out": "".join(tee.parts)}


def check_hosts_serve(one, two):
    """The two-host serve reported a ``LinkLoad`` at every update, some
    with a restore in flight, the one-host serve none; same tokens."""
    from repro_torch.core.cost_model import LinkLoad
    if not two["loads"] or not all(isinstance(x, LinkLoad)
                                   for x in two["loads"]):
        raise AssertionError("--hosts 2: the engine did not set the "
                             "manager's link load")
    if not any(x.key() for x in two["loads"]):
        raise AssertionError("--hosts 2: no load with a restore in flight")
    if any(x is not None for x in one["loads"]):
        raise AssertionError("one host: a link load was set")
    if two["tokens"] != one["tokens"]:
        raise AssertionError("--hosts 2: tokens differ from the one-host "
                             "serve's")
    print(f"{HOSTS_SERVE[1]}: link loads reported at "
          f"{len(two['loads'])} updates (busiest "
          f"{max(two['loads'], key=lambda x: sum(x.streams.values()))}); "
          f"{len(two['tokens'])} tokens identical to the one-host serve's")


def with_drop_shares(fn):
    """Run ``fn`` recording, for every prefill of an ``lm`` model (the
    lifecycle's and the engine's chunks; not the recompute replay), the
    share of its expert assignments that the MoE capacity dropped, over
    all layers (from each layer's routing, ``moe.route``). Returns (fn's
    result, the shares by chunk length)."""
    import torch
    from repro_torch.models import adapter as ad
    from repro_torch.models.layers import moe
    chunks, log = [], None
    route, prefill = moe.route, ad.LMAdapter.prefill

    def recorded_route(p, x, h):
        weight, slot, probs = route(p, x, h)
        if log is not None:
            dropped = h.n_experts * moe.capacity(x.shape[1], h)
            log.append((slot.numel(), (slot == dropped).sum()))
        return weight, slot, probs

    def recorded_prefill(self, params, batch, **kw):
        nonlocal log
        log = []
        try:
            out = prefill(self, params, batch, **kw)
        finally:
            entries, log = log, None
        chunks.append((batch["tokens"].shape[1], sum(n for n, _ in entries),
                       torch.stack([d for _, d in entries]).sum()))
        return out

    moe.route, ad.LMAdapter.prefill = recorded_route, recorded_prefill
    try:
        out = fn()
    finally:
        moe.route, ad.LMAdapter.prefill = route, prefill
    by_len = {}
    for S, n, d in chunks:
        by_len.setdefault(S, []).append(int(d) / n)
    return out, by_len


def print_drop_shares(name, by_len):
    shares = [x for xs in by_len.values() for x in xs]
    print(f"{name}: expert assignments dropped by the capacity, over "
          f"{len(shares)} prefill chunks: mean {statistics.mean(shares):.4f},"
          f" max {max(shares):.4f}; by chunk length (tokens: chunks, mean, "
          "max): " + ", ".join(
              f"{S}: {len(xs)}, {statistics.mean(xs):.4f}, {max(xs):.4f}"
              for S, xs in sorted(by_len.items())))


def serve_moe_vlm(drive):
    """The MoE and VLM paths, each model freed before the next loads
    (``drive`` runs a path with its launch counts): granite-moe-1b-a400m
    at full width and GRANITE_LAYERS layers through the lifecycle and the
    engine on both backends, the engine's requests against a plain
    computation that follows each session's prefill chunks, with the share
    of expert assignments dropped per prefill chunk; internvl2-26b at full
    width and VLM_LAYERS layers through a lifecycle whose round-0 prompts start with
    patch embeddings, restored bitwise on recompute layers too (the replay
    splices the stored patches back), then the paged engine, text only;
    grok-1-314b at full width and GROK_LAYERS of its 64 layers through a
    lifecycle (the attention softcap through kernels #3-#5, 8 experts
    top-2)."""
    import gc

    import torch
    lm_needs = ("restore_kv_grouped", "decode_attention", "flash_attention")
    paged_needs = ("restore_kv_grouped", "decode_attention_paged",
                   "flash_attention")
    model, params = build_model(MOE_ARCH, layers=GRANITE_LAYERS)
    _, shares = with_drop_shares(lambda: drive(
        f"{MOE_ARCH} lifecycle", lambda: run_main_path(model, params),
        lm_needs))
    print_drop_shares(f"{MOE_ARCH} lifecycle", shares)
    runs = {}
    for backend, decode_kernel in (("contiguous", "decode_attention"),
                                   ("paged", "decode_attention_paged")):
        runs[backend], shares = with_drop_shares(lambda b=backend: drive(
            f"{MOE_ARCH} engine {b}", lambda: run_engine(model, params, b),
            ("restore_kv_grouped", decode_kernel, "flash_attention")))
        print_drop_shares(f"{MOE_ARCH} engine {backend}", shares)
        hold_against_plain(f"{MOE_ARCH} engine {backend}", model, params,
                           runs[backend], {},
                           segments=runs[backend]["segments"])
    check_engine(runs["contiguous"], runs["paged"], f"{MOE_ARCH} ")
    del model, params, runs                            # free granite
    gc.collect()
    torch.cuda.empty_cache()
    model, params = build_model(VLM_ARCH, layers=VLM_LAYERS)
    drive(f"{VLM_ARCH} lifecycle",
          lambda: run_main_path(model, params, patches=True), lm_needs)
    run = drive(f"{VLM_ARCH} engine paged", lambda: run_engine(
        model, params, "paged", prompts=VLM_ENGINE_PROMPTS,
        round1=VLM_ROUND1_TOKENS, max_seq=VLM_ENGINE_MAX_SEQ), paged_needs)
    if run["checked"] <= 0 or "recompute" not in run["methods"]:
        raise AssertionError(f"{VLM_ARCH} engine: no restore with "
                             "recompute layers was checked")
    hold_against_plain(f"{VLM_ARCH} engine paged", model, params, run, {})
    del model, params, run                             # free internvl2-26b
    gc.collect()
    torch.cuda.empty_cache()
    model, params = build_model(GROK_ARCH, layers=GROK_LAYERS)
    _, shares = with_drop_shares(lambda: drive(
        f"{GROK_ARCH} lifecycle ({GROK_LAYERS} layers)",
        lambda: run_main_path(model, params, GROK_PROMPTS), lm_needs))
    print_drop_shares(f"{GROK_ARCH} lifecycle", shares)
    del model, params                                  # free grok-1-314b
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------- training
# Every family trained at its shape on the card (``training.data.
# CARD_TRAIN_SHAPES``: full width, bf16 compute over an fp32 master, each
# block recomputed in backward), one gradient and then AdamW steps on one
# repeated seeded batch. llama2-7b first, at 4 of its 32 layers (at full
# depth its fp32 master, m, v and gradient and the bf16 copy, ~18 bytes per
# parameter, are ~120 GB): TRAIN_STEPS steps at rate TRAIN_LR. Then a
# supervised restart of its smoke config through ``launch/train.py``:
# RESTART_STEPS steps, a checkpoint every RESTART_EVERY, a failure
# injected at RESTART_FAIL_AT, against the same run uninterrupted. Then
# the other families, FAMILY_STEPS steps each at FAMILY_LR.
TRAIN_ARCH = "llama2-7b"
TRAIN_STEPS, TRAIN_LR = 8, 1e-3
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL_AT = 12, 3, 7
FAMILY_STEPS = 3
# AdamW's rate for the other families: at 1e-3, whisper-medium's third
# step overshot its first loss (its tied table at unit scale makes the
# logits large, and every weight moves by the rate at each step)
FAMILY_LR = 1e-4
# kernel #5's backward (plain PyTorch, fp32 products of the bf16 inputs,
# rounded to bf16 once) against fp32 autograd through a dense attention:
# TOL["bf16"], one bf16 rounding of each output beside the sums' order
FLASH_BWD_TOL = "bf16"


def recorded_flash_shapes(fn, shapes: dict, phase: str):
    """``fn()`` with every ``FlashAttentionFn`` call (``ops.
    flash_attention_autograd``, the training path's route to kernel #5)
    counted into ``shapes`` by (B, Sq, Skv, H, Kv, hd, causal, softcap,
    window): each entry's ``launches``, the ``phases`` that made them, and
    ``other_lens``, a device flag set where a call's query offsets were not
    all 0 or its key lengths not all Skv (read once, after the phases)."""
    import torch
    from repro_torch.kernels import ops
    autograd = ops.flash_attention_autograd

    def spy(q, k, v, q_offset, kv_len, *, causal=True, softcap=None,
            window=None, host_lens=None):
        key = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
               causal, softcap, window)
        e = shapes.setdefault(key, {"launches": 0, "phases": [],
                                    "other_lens": torch.zeros(
                                        (), dtype=torch.bool,
                                        device=q.device)})
        e["launches"] += 1
        if phase not in e["phases"]:
            e["phases"].append(phase)
        e["other_lens"] |= (q_offset != 0).any() | (kv_len != k.shape[1]).any()
        return autograd(q, k, v, q_offset, kv_len, causal=causal,
                        softcap=softcap, window=window, host_lens=host_lens)

    ops.flash_attention_autograd = spy
    try:
        return fn()
    finally:
        ops.flash_attention_autograd = autograd


def attention_mask(Sq, Skv, causal, window):
    """(Sq, Skv) bool, True where query i (at position i) sees key j."""
    import torch
    qp = torch.arange(Sq, device="cuda")[:, None]
    kp = torch.arange(Skv, device="cuda")[None, :]
    ok = torch.ones(Sq, Skv, dtype=torch.bool, device="cuda")
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    return ok


def dense_attention(q, k, v, mask, softcap):
    """Softmax attention in fp32 over ``mask`` (Sq, Skv), K/V heads shared
    by H/Kv query heads each (GQA), logits softcapped where ``softcap`` is
    set, one batch row at a time: the autograd reference for kernel #5's
    backward (every query row sees a key)."""
    import torch
    g, hd = q.shape[2] // k.shape[2], q.shape[3]
    outs = []
    for b in range(q.shape[0]):
        kb, vb = (t[b].repeat_interleave(g, 1) for t in (k, v))
        s = torch.einsum("qhd,khd->hqk", q[b], kb) * hd ** -0.5
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(torch.einsum("hqk,khd->qhd", p, vb))
    return torch.stack(outs)


def check_flash_train(card: str, key, seed: int):
    """Kernel #5 under autograd (``FlashAttentionFn``) at one shape of the
    training path, ``key`` = (B, Sq, Skv, H, Kv, hd, causal, softcap,
    window) as ``recorded_flash_shapes`` keys it, bf16, query offsets 0
    and every key live: its forward (the kernel) against the plain version
    within TOL and P's rounding bound; its backward against fp32 autograd
    through ``dense_attention`` within FLASH_BWD_TOL; times of the forward
    (kernel, plain, SDPA) and of the backward (plain, SDPA's) with their
    bounds. SDPA runs with K/V heads expanded, and not at all under a
    softcap, which it does not take. Inputs from a generator of its own,
    seeded with ``seed``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, H, Kv, hd, causal, softcap, window = key
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = flash_case(B, Sq, Skv, H, Kv, hd, torch.bfloat16, gen)
    dout = torch.randn(q.shape, generator=gen,
                       device="cuda").to(torch.bfloat16)
    off = torch.zeros(B, dtype=torch.int32, device="cuda")
    kl = torch.full((B,), Skv, dtype=torch.int32, device="cuda")
    mask_kw = {"causal": causal, "softcap": softcap, "window": window}
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.FlashAttentionFn.apply(*leaves, off, kl, causal, softcap,
                                    window)
    out.backward(dout)
    torch.cuda.synchronize()
    name = (f"flash train B={B} Sq={Sq} Skv={Skv} H={H} Kv={Kv} hd={hd} "
            + ("causal" if causal else "non-causal"))
    err = check_close(f"{name} forward", out.detach(),
                      fa.flash_attention_plain(q, k, v, off, kl, **mask_kw),
                      "bf16", fa.flash_p_rounding_bound(q, k, v, off, kl,
                                                        **mask_kw))
    mask = attention_mask(Sq, Skv, causal, window)
    ref = [t.float().requires_grad_(True) for t in (q, k, v)]
    dense_attention(*ref, mask, softcap).backward(dout.float())
    bwd_err = max(check_close(f"{name} d{n}", t.grad, r.grad,
                              FLASH_BWD_TOL)
                  for n, t, r in zip("qkv", leaves, ref))
    del ref, leaves, out
    ms = graph_ms(lambda: fa.flash_attention_cuda(q, k, v, off, kl,
                                                  **mask_kw), n=20)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, off, kl,
                                                        **mask_kw), 3)
    bwd_ms = time_ms(lambda: fa.flash_attention_backward_plain(
        q, k, v, dout, off, kl, **mask_kw), 3)
    lib_ms = lib_bwd_ms = None
    if softcap is None:
        qs = q.transpose(1, 2).contiguous().requires_grad_(True)
        ks, vs = (t.repeat_interleave(H // Kv, 2).transpose(1, 2)
                  .contiguous().requires_grad_(True) for t in (k, v))
        full = bool(mask.all())
        plain_causal = causal and window is None and Sq == Skv
        sdpa_kw = ({"is_causal": True} if plain_causal else
                   {} if full else {"attn_mask": mask})
        with torch.no_grad():
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, **sdpa_kw))
        o = F.scaled_dot_product_attention(qs, ks, vs, **sdpa_kw)
        do = dout.transpose(1, 2)
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
            o, (qs, ks, vs), do, retain_graph=True), 5)
        del qs, ks, vs, o
    # forward: q read and out written once, K and V read once, 4 hd
    # operations per visible (query, key) pair; backward: q, k, v and dout
    # read, dq, dk and dv written, 10 hd operations per visible pair (the
    # scores recomputed, dP, dV, dQ and dK), at the bf16 tensor rate a
    # kernel would run
    pairs = B * int(mask.sum())
    flops = 4 * hd * H * pairs
    nbytes = 2 * B * (2 * Sq * H * hd + 2 * Skv * Kv * hd) + 8 * B
    bound_ms, bound_by = bound(flops, nbytes, card)
    bwd_bytes = 2 * B * (3 * Sq * H * hd + 4 * Skv * Kv * hd) + 8 * B
    bwd_bound_ms, bwd_by = bound(2.5 * flops, bwd_bytes, card)
    lib = (f"SDPA {lib_ms:.4f} ms (graph)" if lib_ms is not None
           else "no SDPA (softcap)")
    lib_bwd = (f"SDPA's backward {lib_bwd_ms:.3f} ms"
               if lib_bwd_ms is not None else "no SDPA backward")
    print(f"flash_attention training shape B={B} Sq={Sq} Skv={Skv} H={H} "
          f"Kv={Kv} hd={hd} {'causal' if causal else 'non-causal'}"
          + (f" softcap {softcap}" if softcap is not None else "")
          + (f" window {window}" if window is not None else "")
          + f" bf16: forward (FlashAttentionFn, the kernel) max_abs_err "
          f"{err:.3g}; kernel {ms:.4f} ms (CUDA graph of 20), plain "
          f"{plain_ms:.2f} ms, {lib}, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{flops / 1e9:.1f} GFLOP over the visible pairs, "
          f"{nbytes / 1e6:.1f} MB), {bound_ms / ms:.0%} of the bound; "
          f"backward (plain PyTorch, fp32 products) max_abs_err "
          f"{bwd_err:.3g} against fp32 autograd ({FLASH_BWD_TOL} TOL), "
          f"{bwd_ms:.2f} ms, {lib_bwd}, bound {bwd_bound_ms:.4f} ms "
          f"({bwd_by}, bf16 rate)")
    return {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "Kv": Kv, "hd": hd,
            "causal": causal, "softcap": softcap, "window": window,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "backward_max_abs_err": bwd_err, "backward_plain_ms": bwd_ms,
            "backward_library_ms": lib_bwd_ms,
            "backward_bound_ms": bwd_bound_ms, "backward_bound_by": bwd_by}


def check_flash_train_shapes(card: str, shapes: dict):
    """``check_flash_train`` at every shape the training phases gave
    kernel #5 (``recorded_flash_shapes``), each with its launches and the
    phases that made them; fails if a call had a query offset or a key
    length the check does not cover."""
    rows = []
    for i, (key, e) in enumerate(shapes.items()):
        if bool(e["other_lens"]):
            raise AssertionError(f"flash train {key}: a call with query "
                                 "offsets or key lengths other than 0 and "
                                 "Skv")
        row = check_flash_train(card, key, SEED + 15 + i)
        row.update(launches=e["launches"], phases=e["phases"])
        rows.append(row)
    return rows


def run_train(arch: str, lr: float, steps: int):
    """One gradient and ``steps`` AdamW steps (rate ``lr``) of ``arch`` at
    full width and its ``CARD_TRAIN_SHAPES`` depth on one repeated seeded
    batch (an enc-dec with CARD_TRAIN_FRAMES frames of seeded normals x
    0.1, a VLM with CARD_TRAIN_PATCHES patch positions of seeded normals x
    0.02): the first gradient's ``family_gates``; a MoE stack's routing in
    backward's recompute equal to the forward's, layer by layer, and its
    aux finite and positive at every step; the loss finite at every step
    and lower after the last. Prints step ms (median of steps 2-``steps``),
    tokens/s, peak allocated memory and the gated norms."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.models.module import count_params
    from repro_torch.training import (CARD_TRAIN_FRAMES, CARD_TRAIN_PATCHES,
                                      CARD_TRAIN_SHAPES, AdamWConfig,
                                      DataConfig, Trainer, batch_at,
                                      side_inputs)
    layers, batch, seq = CARD_TRAIN_SHAPES[arch]
    full = get_arch(arch)
    cfg = full if layers is None else full.scaled(n_layers=layers)
    model = Model(cfg, dtype=torch.bfloat16)
    trainer = Trainer(model, AdamWConfig(lr=lr), loss_chunks=4)
    t0 = time.perf_counter()
    state = trainer.init_state(SEED)
    n_params = count_params(state["params"])
    data = batch_at(DataConfig(cfg.vocab_size, seq, batch, seed=SEED), 0,
                    device=model.device) | side_inputs(
        cfg, batch, frames=CARD_TRAIN_FRAMES, patches=CARD_TRAIN_PATCHES,
        seed=SEED + 28, device=model.device)
    extra = "".join(f", {t.shape[1]} {k}" for k, t in data.items()
                    if k in ("frames", "patches"))
    print(f"train {arch}: {cfg.n_layers} of {full.n_layers} layers"
          + (f" (+{cfg.encoder_layers} encoder)" if cfg.encoder_layers
             else "") + f", d={cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.3f} B params, bf16 over an fp32 master; batch "
          f"{batch} x {seq} tokens{extra}; init {_sync_s(t0):.1f} s")
    (_, parts, grads), slots = recorded_routes(
        lambda: trainer.value_and_grad(state["params"], data))
    norms = family_gates(cfg, grads)
    del grads
    if cfg.n_experts:
        L = cfg.n_layers
        if len(slots) != 2 * L or not all(
                torch.equal(slots[li], slots[2 * L - 1 - li])
                for li in range(L)):
            raise AssertionError(f"train {arch}: the recompute's routing "
                                 "differs from the forward's")
        print(f"train {arch}: the routing (slots) of all {L} layers in "
              "backward's recompute equal to the forward's")
    del slots
    torch.cuda.reset_peak_memory_stats()
    losses, walls, auxes = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, data)
        losses.append(float(m["loss"]))
        walls.append(_sync_s(t0))
        auxes.append(float(m["aux"]))
        if not (losses[-1] == losses[-1] and abs(losses[-1]) < 1e4):
            raise AssertionError(f"train {arch}: loss {losses[-1]}")
        if cfg.n_experts and not 0 < auxes[-1] < 1e4:
            raise AssertionError(f"train {arch}: aux {auxes[-1]}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train {arch}: the loss did not fall: "
                             f"{losses}")
    step_ms = statistics.median(walls[1:]) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = batch * seq
    print(f"train {arch}: every gradient finite; norms by layer "
          + ("; ".join(f"{k} " + ", ".join(f"{x:.3g}" for x in v)
                       for k, v in norms.items()) or "not gated"))
    print(f"train {arch}: losses " + ", ".join(f"{x:.4f}" for x in losses)
          + ("; aux " + ", ".join(f"{x:.4f}" for x in auxes)
             if cfg.n_experts else ""))
    print(f"train {arch}: step {step_ms:.1f} ms (median of steps 2-"
          f"{steps}; first {walls[0] * 1e3:.1f} ms), "
          f"{tokens / step_ms * 1e3:.0f} tokens/s, peak allocated "
          f"{peak:.1f} GB over the steps")
    return {"arch": arch, "layers": cfg.n_layers, "params": n_params,
            "losses": losses, "aux": auxes, "step_ms": step_ms,
            "first_ms": walls[0] * 1e3,
            "tokens_per_s": tokens / step_ms * 1e3, "peak_gb": peak}


def run_train_restart():
    """``launch/train.py`` on the smoke config, on the card: RESTART_STEPS
    steps with a failure injected at RESTART_FAIL_AT and a restart from
    the last checkpoint, against the same run uninterrupted; the two
    final states must be equal bit for bit. Deterministic algorithms are
    on for the phase: the backward of the token-embedding gather
    (``index_put_`` with accumulation) and of the loss's ``torch.gather``
    (``scatter_add_``) use atomics on the card otherwise."""
    import tempfile
    import warnings

    import torch
    from repro_torch.launch import train
    from repro_torch.training.tree import tree_leaves
    argv = ["--arch", TRAIN_ARCH, "--steps", str(RESTART_STEPS),
            "--ckpt-every", str(RESTART_EVERY)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            faulty = train.main(argv + ["--ckpt-dir", f"{tmp}/faulty",
                                        "--fail-at", str(RESTART_FAIL_AT)])
            clean = train.main(argv + ["--ckpt-dir", f"{tmp}/clean"])
    finally:
        torch.use_deterministic_algorithms(False)
    alerts = sorted({str(w.message).split("\n")[0][:120] for w in caught
                     if "deterministic" in str(w.message)})
    if faulty["report"]["restarts"] != 1 or clean["report"]["restarts"]:
        raise AssertionError(f"train restart: reports {faulty['report']}, "
                             f"{clean['report']}")
    pairs = list(zip(tree_leaves(faulty["state"]),
                     tree_leaves(clean["state"])))
    if not all(torch_equal(a, b) for a, b in pairs):
        raise AssertionError("train restart: the restarted run's state "
                             "differs from the uninterrupted run's")
    print(f"train restart: {RESTART_STEPS} steps of the smoke config, "
          f"failure at {RESTART_FAIL_AT}, restored from step "
          f"{RESTART_FAIL_AT - 1 - (RESTART_FAIL_AT - 1) % RESTART_EVERY}: "
          f"all {len(pairs)} state leaves bitwise equal to the "
          f"uninterrupted run's; determinism alerts: {alerts or 'none'}")
    return {"leaves": len(pairs), "alerts": alerts}


# kernel #6 under autograd: the forward at falcon's training shape, the
# gradients at a small one whose last 128-token chunk is partial
SSM_TRAIN_SHAPE = (2, 512, 8192, 16)      # Bt, S, I, N
SSM_GRAD_SHAPE = (1, 300, 1024, 16)


def ssm_train_case(Bt, S, I, N, gen):
    """``SSMScanFn``'s inputs as the Mamba1 layer makes them: fp32 h0 (the
    layer's zeros replaced by normals, so that A reaches y), dt and A;
    bf16 x, B and C (column views of a projection), D."""
    import torch
    h, dt, x, A, Bm, Cm, D = ssm_scan_case(Bt, I, N, S, torch.bfloat16, gen)
    return [h, dt, x, A, Bm, Cm, D]


def plain_scan_autograd(h, dt, x, A, B, C, d_skip):
    """The functional plain scan (``ssm_update_plain`` step by step, no
    state written), the autograd reference for ``SSMScanFn``; y in x's
    dtype."""
    import torch
    from repro_torch.kernels import ssm_update as ssu
    ys = []
    for t in range(x.shape[1]):
        h, y = ssu.ssm_update_plain(h, dt[:, t], x[:, t], A, B[:, t],
                                    C[:, t], d_skip)
        ys.append(y)
    return torch.stack(ys, 1), h


def check_ssm_train(card: str):
    """Kernel #6 under autograd (``SSMScanFn``): its forward (one kernel
    launch per 128-token chunk) at SSM_TRAIN_SHAPE against the plain scan
    (y within TOL["bf16"], the final state within TOL["fp32"]); its
    gradients at SSM_GRAD_SHAPE against autograd through the functional
    plain scan, within TOL["bf16"] (first, so that the timed backward
    finds every kernel it launches loaded); forward and backward times
    at the training shape beside the forward's bound (bytes) and the
    plain scan. Inputs from a generator of its own."""
    import torch
    from repro_torch.kernels import ssm_update as ssu
    gen = torch.Generator(device="cuda").manual_seed(SEED + 28)
    Bt, S, I, N = SSM_TRAIN_SHAPE
    args = ssm_train_case(Bt, S, I, N, gen)
    before = ssu.launches
    y, h = ssu.SSMScanFn.apply(*args)
    torch.cuda.synchronize()
    per_call = ssu.launches - before
    hp = args[0].clone()
    yp = ssu.ssm_scan_plain(hp, *args[1:])
    err = max(check_close("ssm train forward y", y, yp, "bf16"),
              check_close("ssm train forward state", h, hp, "fp32"))
    ms = time_ms(lambda: ssu.SSMScanFn.apply(*args), 5)
    plain_ms = time_ms(lambda: ssu.ssm_scan_plain(args[0].clone(),
                                                  *args[1:]), 1, 1)
    flops, nbytes = ssu.scan_cost(Bt, I, N, S, 2)
    nbytes += -(-S // ssu.CHUNK) * Bt * I * N * 4     # the saved starts
    bound_ms, bound_by = bound(flops, nbytes, card,
                               FP32_PEAKS[card_kind(card)])
    # the gradients at a small shape against the functional plain scan
    gBt, gS, gI, gN = SSM_GRAD_SHAPE
    small = ssm_train_case(gBt, gS, gI, gN, gen)
    mine = [t.detach().clone().requires_grad_(True) for t in small]
    # D in fp32 for the reference: its gradient sums over every token,
    # which autograd would otherwise accumulate in bf16 step by step
    ref = [t.detach().clone().requires_grad_(True) for t in small[:6]]
    ref.append(small[6].detach().float().requires_grad_(True))
    ys, hs = ssu.SSMScanFn.apply(*mine)
    yr, hr = plain_scan_autograd(*ref)
    dys = torch.randn(ys.shape, generator=gen, device="cuda").to(ys.dtype)
    dhs = torch.randn(hs.shape, generator=gen, device="cuda")
    torch.autograd.backward((ys, hs), (dys, dhs))
    torch.autograd.backward((yr, hr), (dys, dhs))
    grad_err = max(check_close(f"ssm train d{n}", a.grad, b.grad, "bf16")
                   for n, a, b in zip(("h0", "dt", "x", "A", "B", "C", "D"),
                                      mine, ref))
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    out = ssu.SSMScanFn.apply(*leaves)
    dy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
    dh = torch.randn(h.shape, generator=gen, device="cuda")
    t0 = time.perf_counter()
    torch.autograd.backward(out, (dy, dh))
    bwd_ms = _sync_s(t0) * 1e3
    print(f"ssm_update training shape Bt={Bt} S={S} I={I} N={N} bf16 "
          f"(SSMScanFn, {per_call} launches of {ssu.CHUNK}-token chunks): "
          f"forward max_abs_err {err:.3g} against the plain scan, "
          f"{ms:.3f} ms (plain {plain_ms:.1f} ms), bound {bound_ms:.4f} ms "
          f"({bound_by}; {nbytes / 1e6:.1f} MB with the chunk-start "
          f"states), {bound_ms / ms:.0%} of the bound; backward (plain "
          f"PyTorch, each chunk recomputed) {bwd_ms:.1f} ms; gradients at "
          f"Bt={gBt} S={gS} I={gI} N={gN} max_abs_err {grad_err:.3g} "
          "against autograd through the functional plain scan (TOL bf16)")
    return {"Bt": Bt, "S": S, "I": I, "N": N, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "launches_per_call": per_call,
            "backward_plain_ms": bwd_ms, "backward_max_abs_err": grad_err,
            "grad_shape": list(SSM_GRAD_SHAPE)}


def family_gates(cfg, grads):
    """The first gradient's gates for ``cfg``'s family (each listed
    gradient finite and non-zero in every layer, or every leaf finite);
    returns the per-layer norms it gated on, by name."""
    import torch
    from repro_torch.training.tree import tree_paths

    def layers(name, stack, n):
        out = []
        for li in range(n):
            g = stack[li].float()
            if not bool(g.isfinite().all()) or not bool(g.any()):
                raise AssertionError(f"train {cfg.name}: layer {li} {name} "
                                     "gradient is not finite and non-zero")
            out.append(float(g.norm()))
        return {name: out}

    norms = {}
    if "attn" in grads.get("blocks", {}):     # an lm stack's attention
        for w in ("wq", "wk", "wv"):
            norms |= layers(w, grads["blocks"]["attn"][w], cfg.n_layers)
    if cfg.n_experts:
        norms |= layers("router", grads["blocks"]["moe"]["router"],
                        cfg.n_layers)
    if cfg.family == "ssm":
        m = grads["blocks"]["m"]
        for k in ("a_log", "dt_proj", "x_proj", "conv_w"):
            norms |= layers(k, m[k], cfg.n_layers)
    if cfg.family == "hybrid":
        a_log = grads["mamba"]["m"]["a_log"]
        norms |= layers("mamba2 a_log", a_log.flatten(0, 1),
                        a_log.shape[0] * a_log.shape[1])
        for w in ("wq", "wk", "wv"):
            norms |= layers(f"attn {w}", grads["attn"]["attn"][w],
                            a_log.shape[0])
    if cfg.is_encoder_decoder:
        for w in ("wq", "wk", "wv"):
            norms |= layers(f"encoder {w}", grads["enc_blocks"]["attn"][w],
                            cfg.encoder_layers)
        for w in ("wk", "wv"):
            norms |= layers(f"cross {w}",
                            grads["dec_blocks"]["cross_attn"][w],
                            cfg.n_layers)
    for path, g in tree_paths(grads):
        if not bool(g.isfinite().all()):
            raise AssertionError(f"train {cfg.name}: gradient {path} is "
                                 "not finite")
    return norms


def recorded_routes(fn):
    """``fn()`` recording each MoE layer's slots (``moe.route``); returns
    (fn's result, the slots in call order)."""
    from repro_torch.models.layers import moe
    route, slots = moe.route, []

    def spy(p, x, h):
        out = route(p, x, h)
        slots.append(out[1].clone())
        return out

    moe.route = spy
    try:
        return fn(), slots
    finally:
        moe.route = route


# Sharded training over a (data x model) mesh (``training/sharded.py``)
# with every shard on the card: llama2-7b at full width and
# SHARDED_LAYERS of its layers over a 2x2 mesh (4 x 2048 tokens a step,
# 2 x 2048 per data shard; the fp32 master and moments are replicated
# over data, so its state is twice the 1x1 state, which is why the depth
# is cut to 2), then granite-moe-1b-a400m at GRANITE_LAYERS over 1x2
# (the MoE layer combines on each shard, then sums once); each against
# its 1x1 twin, the plain ``Trainer`` on the same seeded weights and
# batch. The mesh changes only the order and precision of sums (each
# row-parallel product's partial sums are rounded to bf16 before they
# are added, one more bf16 rounding, 2^-8 relative, than the twin's
# single product), and the losses and gradient norm are means over
# millions of such elements, so each step's loss must stay within
# SHARDED_RTOL of the twin's and the step-0 gradient norm within
# SHARDED_GNORM_RTOL (a root of a sum of squares that a few large
# leaves, the router's among them, dominate). The card's readings
# behind them (NVIDIA H100 80GB HBM3, 700 W): step-0 gaps 4.4e-6
# (loss) and 2.2e-5 (norm) for llama2-7b, 2.7e-5 and 3.3e-4 for granite;
# later losses within 1.9e-5 (llama2-7b) and 8.2e-5 (granite) relative
# of the twin's. Every step is gated: a
# fault in the update (a ZeRO slice written back to the wrong data
# shard, a clip scale or an AdamW part on the wrong device) leaves the
# step-0 loss and norm as they were.
SHARDED_ARCH, SHARDED_LAYERS, SHARDED_MESH = "llama2-7b", 2, (2, 2)
SHARDED_BATCH, SHARDED_SEQ = 4, 2048
# AdamW's rate: at 1e-3 the 2-layer model fits the repeated batch in one
# step (loss 10.88 -> 0.13) and then overshoots
SHARDED_STEPS, SHARDED_LR = 4, 1e-4
SHARDED_MOE_MESH, SHARDED_MOE_STEPS = (1, 2), 3
SHARDED_RTOL, SHARDED_GNORM_RTOL = 1e-3, 2e-3
SHARDED_PHASE_BUDGET_S = 60.0


def sharded_steps(step, state, data, steps):
    """``steps`` calls of ``step(state, data)``: (final state, losses,
    gradient norms, auxes, walls in s)."""
    losses, gnorms, auxes, walls = [], [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, data)
        walls.append(_sync_s(t0))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        auxes.append(float(m["aux"]))
    return state, losses, gnorms, auxes, walls


def run_sharded_train(card, arch, layers, shape, steps, lr, repeat=False):
    """``arch`` at full width and ``layers`` layers: its 1x1 twin (the
    plain ``Trainer``), then ``training/sharded.py`` over a ``shape``
    mesh of ``["cuda"] * D·M`` from the same seeded weights and batch
    (twice with ``repeat``), under deterministic algorithms (the
    embedding's and the loss's gathers accumulate with atomics
    otherwise). Gates: every step's loss within SHARDED_RTOL of the
    twin's and the step-0 gradient norm within SHARDED_GNORM_RTOL; every
    loss finite; kernel #5's launches
    D·M times the twin's; each device part of each state leaf the shape
    its spec gives; with ``repeat`` every later loss below the one
    before and the second run bitwise equal to the first (losses,
    gradient norms, every part of every state leaf); for a MoE stack the
    recompute's routing equal to the forward's and the aux finite and
    positive. Prints step ms, tokens/s, peak memory and state bytes per
    shard beside ``card`` (its name and power limit)."""
    import gc
    import warnings

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.training import AdamWConfig, DataConfig, Trainer, \
        batch_at
    from repro_torch.training.sharded import ShardedTrainer
    from repro_torch.training.tree import tree_paths
    cfg = get_arch(arch)
    full_layers = cfg.n_layers
    if layers is not None:
        cfg = cfg.scaled(n_layers=layers)
    D, M = shape
    name = f"train {arch} {D}x{M}"
    data = batch_at(DataConfig(cfg.vocab_size, SHARDED_SEQ, SHARDED_BATCH,
                               seed=SEED), 0, device="cuda")
    tokens = SHARDED_BATCH * SHARDED_SEQ
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            twin = Trainer(Model(cfg, dtype=torch.bfloat16),
                           AdamWConfig(lr=lr), loss_chunks=4)
            state = twin.init_state(SEED)
            n0 = fa.launches
            torch.cuda.reset_peak_memory_stats()
            state, t_loss, t_gn, _, t_walls = sharded_steps(
                twin.train_step, state, data, steps)
            twin_launches = fa.launches - n0
            twin_peak = torch.cuda.max_memory_allocated() / 1e9
            del state, twin
            gc.collect()
            torch.cuda.empty_cache()
            trainer = Trainer(Model(cfg, dtype=torch.bfloat16, model_axis=M),
                              AdamWConfig(lr=lr), loss_chunks=4)
            st = ShardedTrainer(trainer, make_mesh(
                shape, ("data", "model"), ["cuda"] * (D * M)))
            runs = []
            for _ in range(2 if repeat else 1):
                pstate = st.init_state(SEED)
                torch.cuda.reset_peak_memory_stats()
                n0 = fa.launches
                (pstate, losses, gnorms, auxes, walls), slots = \
                    recorded_routes(lambda: sharded_steps(
                        st.train_step, pstate, data, steps))
                runs.append({"state": pstate, "losses": losses,
                             "gnorms": gnorms, "auxes": auxes,
                             "walls": walls, "launches": fa.launches - n0,
                             "peak": torch.cuda.max_memory_allocated() / 1e9,
                             "slots": slots})
                del pstate
    finally:
        torch.use_deterministic_algorithms(False)
    alerts = sorted({str(w.message).split("\n")[0][:120] for w in caught
                     if "deterministic" in str(w.message)})
    run = runs[0]
    losses, gnorms = run["losses"], run["gnorms"]
    per_shard = st.state_bytes(run["state"])
    step_ms = statistics.median(run["walls"][1:]) * 1e3
    twin_ms = statistics.median(t_walls[1:]) * 1e3
    print(f"{name}: {cfg.n_layers} of {full_layers} layers at full width, "
          f"bf16 over an fp32 master, {D}x{M} mesh with every shard on "
          f"cuda, batch {SHARDED_BATCH} x {SHARDED_SEQ} tokens "
          f"({SHARDED_BATCH // D} rows per data shard)")
    print(f"{name}: losses " + ", ".join(f"{x:.5f}" for x in losses)
          + "; the twin's " + ", ".join(f"{x:.5f}" for x in t_loss)
          + "; gaps " + ", ".join(f"{a - b:+.2e}" for a, b in
                                  zip(losses, t_loss))
          + "; relative gaps " + ", ".join(
              f"{abs(a - b) / abs(b):.2e}" for a, b in zip(losses, t_loss))
          + f"; gradient norms {gnorms[0]:.5f} / twin {t_gn[0]:.5f} at "
          f"step 0 (rtol {SHARDED_RTOL:.4g} on every loss, "
          f"{SHARDED_GNORM_RTOL:.4g} on this norm)"
          + ("; aux " + ", ".join(f"{x:.4f}" for x in run["auxes"])
             if cfg.n_experts else ""))
    print(f"{name} on {card}: step {step_ms:.1f} ms (twin {twin_ms:.1f} "
          f"ms; medians of steps 2-{steps}), "
          f"{tokens / step_ms * 1e3:.0f} tokens/s "
          f"(twin {tokens / twin_ms * 1e3:.0f}), peak allocated "
          f"{run['peak']:.1f} GB (twin {twin_peak:.1f} GB); state bytes "
          "per shard " + ", ".join(f"{b / 1e9:.3f} GB" for b in per_shard)
          + f"; flash_attention launches {run['launches']} (twin "
          f"{twin_launches})"
          + f"; determinism alerts: {alerts or 'none'}")
    for what, got, want, rtol in (
            [(f"step-{i} loss", a, b, SHARDED_RTOL)
             for i, (a, b) in enumerate(zip(losses, t_loss))]
            + [("step-0 gradient norm", gnorms[0], t_gn[0],
                SHARDED_GNORM_RTOL)]):
        if not abs(got - want) <= rtol * abs(want):
            raise AssertionError(f"{name}: {what} {got} against the 1x1 "
                                 f"twin's {want} (rtol {rtol})")
    if not all(x == x and abs(x) < 1e4 for x in losses + gnorms):
        raise AssertionError(f"{name}: losses {losses}, norms {gnorms}")
    if run["launches"] != D * M * twin_launches or twin_launches <= 0:
        raise AssertionError(f"{name}: {run['launches']} flash_attention "
                             f"launches, not {D * M} x {twin_launches}")
    for path, leaf in tree_paths(run["state"]):
        for coord, part in zip(st.coords, leaf.parts):
            want = tuple(sl.stop - sl.start for sl in leaf.block(coord))
            if tuple(part.shape) != want:
                raise AssertionError(f"{name}: {path} part at {coord} has "
                                     f"shape {tuple(part.shape)}, not {want}")
    if repeat:
        if not all(b < a for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"{name}: the loss did not fall: {losses}")
        again = runs[1]
        same = (again["losses"] == losses and again["gnorms"] == gnorms
                and all(torch_equal(a, b) for (_, x), (_, y) in zip(
                    tree_paths(run["state"]), tree_paths(again["state"]))
                    for a, b in zip(x.parts, y.parts)))
        if not same:
            raise AssertionError(f"{name}: a second run differs from the "
                                 "first")
    if cfg.n_experts:
        L, S = cfg.n_layers, run["slots"]
        per_step = 2 * L * M             # forward, then backward's recompute
        for i in range(steps):
            fwd = S[i * per_step:i * per_step + L * M]
            bwd = S[i * per_step + L * M:(i + 1) * per_step]
            for li in range(L):
                for m in range(M):
                    if not torch_equal(fwd[li * M + m],
                                       bwd[(L - 1 - li) * M + m]):
                        raise AssertionError(f"{name}: step {i} layer {li} "
                                             f"shard {m}: the recompute's "
                                             "routing differs")
        if not all(0 < a < 1e4 for a in run["auxes"]):
            raise AssertionError(f"{name}: aux {run['auxes']}")
    print(f"{name}: gates held" + ("; a second run bitwise equal to "
                                   "the first" if repeat else "")
          + (f"; the recompute's routing equal to the forward's in all "
             f"{cfg.n_layers} layers x {M} shards x {steps} steps"
             if cfg.n_experts else ""))
    out = {"arch": arch, "layers": cfg.n_layers, "mesh": f"{D}x{M}",
           "losses": losses, "twin_losses": t_loss, "grad_norms": gnorms,
           "twin_grad_norms": t_gn, "step_ms": step_ms, "twin_ms": twin_ms,
           "tokens_per_s": tokens / step_ms * 1e3, "peak_gb": run["peak"],
           "state_bytes_per_shard": per_shard, "launches": run["launches"],
           "twin_launches": twin_launches}
    del runs, run, st, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_sharded_phase(card):
    """llama2-7b over SHARDED_MESH, then granite-moe-1b-a400m over
    SHARDED_MOE_MESH (``run_sharded_train``)."""
    return [run_sharded_train(card, SHARDED_ARCH, SHARDED_LAYERS,
                              SHARDED_MESH, SHARDED_STEPS, SHARDED_LR,
                              repeat=True),
            run_sharded_train(card, MOE_ARCH, GRANITE_LAYERS,
                              SHARDED_MOE_MESH, SHARDED_MOE_STEPS,
                              FAMILY_LR)]


# ------------------------------------------------------ mesh serving
# The reference's mesh serving programs (``launch/dryrun.py``'s
# serve_prefill, restore_op, serve_decode) over a (data x model) mesh
# with every shard on the one card, each against its 1x1 twin, which is
# held bitwise to the plain ``Model`` calls.
MESH_SHAPE = (2, 2)
MESH_SEQ = 4096             # tokens per session, 2 sessions (default rules)
MESH_LONG_SEQ = 8192        # one session under long_context
MESH_SSM_SHAPE = (1, 2)
MESH_SSM_SEQ = 512          # falcon-mamba-7b, 2 sessions
MESH_STEPS = 16
MESH_PAD = 128              # cache capacity past the prompt
# The mesh's logits against its 1x1 twin's: the two round in bf16 over
# products of other shapes (half-width query, FFN and vocabulary
# products, the row-parallel sums over model, the merged context
# slices), so they agree to bf16 noise, which 32 layers of random
# weights carry to ~0.02 relative L2, as they carry the engine's
# against the plain forward (PLAIN_REL's comment; PERF.md); the twin's
# last prefill position against the plain model's decode step of that
# token over a prefill of the others, another bf16 evaluation of the
# same function, is printed beside it. A wrong slice, position or merge
# moves the logits by the order of their own spread.
MESH_REL = PLAIN_REL
# The same programs in fp32 at full width and MESH_FP32_LAYERS layers,
# off the bf16 floor: the mesh and its twin differ only in the order of
# fp32 sums (row-parallel products over model, the merged context
# slices), a few 1e-6 relative, so a wrong slice, position or merge,
# which moves the logits by far more, shows against MESH_FP32_REL.
MESH_FP32_LAYERS = 2
MESH_FP32_SEQ = 1024        # 2 sessions (default rules)
MESH_FP32_LONG_SEQ = 2048   # one session under long_context
MESH_FP32_SSM_SEQ = 256     # falcon-mamba-7b, 2 sessions
MESH_FP32_STEPS = 8
MESH_FP32_REL = 1e-4
MESH_PHASE_BUDGET_S = 90.0


def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def whole(placed):
    """A ``Placed`` result whole: its one part on a 1x1 mesh (no copy)."""
    return placed.parts[0] if len(placed.parts) == 1 else placed.gather()


def mesh_server(model, shape, long_context=False):
    from repro_torch.distributed.mesh_serving import MeshServer
    from repro_torch.distributed.sharding import default_rules
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, ("data", "model"),
                     ["cuda:0"] * (shape[0] * shape[1]))
    return MeshServer(model, mesh, default_rules(mesh,
                                                 long_context=long_context))


def mesh_launches():
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import restore_kv as rkv
    from repro_torch.kernels import ssm_update as ssu
    return {"#1": rkv.launches, "#3": dec.launches, "#5": fa.launches,
            "#6": ssu.launches}


def uncounted(fn):
    """``fn()`` with the kernels' launch counters left as they were: a
    launch made only to time a kernel is not one of the path's."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import restore_kv as rkv
    from repro_torch.kernels import ssm_update as ssu
    mods = (rkv, dec, fa, ssu)
    saved = [m.launches for m in mods]
    try:
        return fn()
    finally:
        for m, n in zip(mods, saved):
            m.launches = n


def launches_since(before, want: dict, what: str) -> dict:
    """The launches of each kernel since ``before``, which must equal
    ``want``'s (kernels not named there must not have launched)."""
    now = mesh_launches()
    got = {k: now[k] - before[k] for k in now}
    if {k: v for k, v in got.items() if v} != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    return got


def recorded_slices(fn, shapes: dict):
    """``fn()`` with every launch of kernel #3 on a context slice
    (``kv_start`` given) recorded by shape into ``shapes``."""
    from repro_torch.kernels import decode_attention as dec
    launch = dec.decode_attention_cuda

    def wrapped(q, k, v, kv_len, **kw):
        if kw.get("kv_start") is not None:
            key = (*q.shape, k.shape[1], k.shape[2], str(q.dtype),
                   kw.get("window"))
            if key not in shapes:
                shapes[key] = {"launches": 0, "kv_len": kv_len.tolist(),
                               "kv_start": kw["kv_start"].tolist()}
            shapes[key]["launches"] += 1
        return launch(q, k, v, kv_len, **kw)

    dec.decode_attention_cuda = wrapped
    try:
        return fn()
    finally:
        dec.decode_attention_cuda = launch


def run_mesh_lm(card, model, params, shape, long_context, B, S,
                limit=MESH_REL, steps=MESH_STEPS):
    """llama2-7b's prefill (``capture_hidden``), restore of every layer
    and MESH_STEPS decode steps over ``shape`` under the default or the
    long_context rules, against the 1x1 twin: the twin bitwise the plain
    ``Model`` (prefill's logits, K/V and hidden; the restore; a decode
    step's logits, hidden and written K/V), the twin's restore bitwise its
    prefill's K/V, the mesh's restore of the twin's hidden bitwise the
    twin's restore, the mesh's restore of its own hidden bitwise its
    prefill's K/V, prefill and every decode step's logits (both runs fed
    the twin's greedy tokens) within ``limit`` relative L2 of the twin's,
    and each kernel's launches exactly its per-shard count times the
    shards (a long_context decode step runs its model shards once, on
    data shard 0, over all context shards)."""
    import torch
    from repro_torch.models import transformer as tfm
    twin = mesh_server(model, (1, 1))
    srv = mesh_server(model, shape, long_context)
    D, M, C = srv.D, srv.M, srv.C
    shards = D * M
    stepping = M if long_context else shards     # model shards per step
    L = model.cfg.n_layers
    cap = S + MESH_PAD
    name = (f"{model.cfg.name} {shape[0]}x{shape[1]}"
            + (" long_context" if long_context else "")
            + (" fp32" if model.dtype == torch.float32 else ""))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    toks = torch.randint(0, model.cfg.vocab_size, (B, S), generator=gen,
                         device="cuda")
    row = {"mesh": name, "B": B, "S": S, "context_shards": C}
    with torch.no_grad():
        tp = twin.place_params(params)
        tout = twin.prefill(tp, {"tokens": toks}, capture_hidden=True)
        plain = model.prefill(params, {"tokens": toks}, capture_hidden=True)
        for what, got, want in (
                ("logits", tout["logits"], plain["logits"]),
                ("k", tout["kv"][0], plain["kv"][0]),
                ("v", tout["kv"][1], plain["kv"][1]),
                ("hidden", tout["hidden"], plain["hidden"])):
            if not torch.equal(whole(got), want):
                raise AssertionError(f"{name}: the 1x1 prefill's {what} "
                                     "differs from Model.prefill")
        del plain
        first = model.prefill(params, {"tokens": toks[:, :S - 1]})
        pc = model.init_cache(B, S)
        pc["k"][:, :, :S - 1], pc["v"][:, :, :S - 1] = first["kv"]
        pc["lengths"][:] = S - 1
        del first
        row["floor_rel"] = rel_l2(model.decode_step(
            params, pc, toks[:, S - 1:])[0], whole(tout["logits"]))
        del pc
        hidden = whole(tout["hidden"])
        tk, tv = twin.restore_kv_from_hidden(
            tp, twin.place_hidden(hidden, cap))
        if not (torch.equal(whole(tk)[:, :, :S], whole(tout["kv"][0]))
                and torch.equal(whole(tv)[:, :, :S],
                                whole(tout["kv"][1]))):
            raise AssertionError(f"{name}: the 1x1 restore differs from "
                                 "its prefill's K/V")
        pos = torch.arange(S, device="cuda")[None].expand(B, S)
        pk, pv = model.restore_kv_from_hidden(params, hidden, positions=pos)
        if not (torch.equal(pk, whole(tk)[:, :, :S])
                and torch.equal(pv, whole(tv)[:, :, :S])):
            raise AssertionError(f"{name}: the 1x1 restore differs from "
                                 "Model.restore_kv_from_hidden")
        del pk, pv
        mp = srv.place_params(params)
        torch.cuda.synchronize()
        before, t0 = mesh_launches(), time.perf_counter()
        mout = srv.prefill(mp, {"tokens": toks}, capture_hidden=True)
        row["prefill_ms"] = _sync_s(t0) * 1e3
        row["prefill_launches"] = launches_since(
            before, {"#1": L * shards, "#5": L * shards}, f"{name} prefill")
        row["prefill_rel"] = rel_l2(mout["logits"].gather(),
                                    whole(tout["logits"]))
        # the mesh's own hidden restores its prefill's K/V
        mk, mv = srv.restore_kv_from_hidden(mp, mout["hidden"])
        for got, want in ((mk, mout["kv"][0]), (mv, mout["kv"][1])):
            if not all(torch.equal(a, b) for a, b in zip(got.parts,
                                                         want.parts)):
                raise AssertionError(f"{name}: the mesh's restore differs "
                                     "from its prefill's K/V")
        del mk, mv, mout
        # the twin's hidden at the cache's capacity: the decode cache
        mh = srv.place_hidden(hidden, cap)
        torch.cuda.synchronize()
        before, t0 = mesh_launches(), time.perf_counter()
        rk, rv = srv.restore_kv_from_hidden(mp, mh)
        row["restore_ms"] = _sync_s(t0) * 1e3
        row["restore_launches"] = launches_since(
            before, {"#1": shards}, f"{name} restore")
        for got, want in ((rk, whole(tk)), (rv, whole(tv))):
            for r, part in enumerate(got.parts):
                if not torch.equal(part, want[got.block(srv.coords[r])]):
                    raise AssertionError(f"{name}: shard {srv.coords[r]}'s "
                                         "restored K/V differs from the "
                                         "1x1 restore")
        sl = mh.block(srv.coords[0])
        b, s = sl[1].stop - sl[1].start, sl[2].stop - sl[2].start
        spos = torch.arange(sl[2].start, sl[2].stop,
                            device="cuda")[None].expand(b, s)
        row["projection_ms_per_shard"] = uncounted(lambda: time_ms(
            lambda: tfm.lm_restore_kv(mp.local[0], mh.parts[0], model.h,
                                      positions=spos), 3, warmup=1))
        row["shard_block"] = f"(L={L}, B={b}, S={s})"
        del mh
        lengths = [S] * B
        tcache = twin.place_cache({"k": tk, "v": tv, "lengths": lengths},
                                  cap)
        mcache = srv.place_cache({"k": rk, "v": rv, "lengths": lengths},
                                 cap)
        if mcache["k"] is not rk:
            raise AssertionError(f"{name}: the restored K/V was copied into "
                                 "the cache's layout")
        # one step of the plain Model on a copy of the twin's cache
        tok = greedy(whole(tout["logits"]))
        pc = {"k": whole(tk).clone(), "v": whole(tv).clone(),
              "lengths": torch.full((B,), S, dtype=torch.int32,
                                    device="cuda")}
        plg, pc, phid = model.decode_step_full(params, pc, tok)
        tlg, tcache, thid = twin.decode_step(tp, tcache, tok)
        if not (torch.equal(whole(tlg), plg) and torch.equal(whole(thid), phid)
                and torch.equal(whole(tcache["k"])[:, :, S], pc["k"][:, :, S])
                and torch.equal(whole(tcache["v"])[:, :, S],
                                pc["v"][:, :, S])):
            raise AssertionError(f"{name}: the 1x1 decode step differs from "
                                 "Model.decode_step_full")
        del pc, plg, phid
        rels, mesh_ms, twin_ms = [], [], []
        step_tok = tok
        for i in range(steps):
            if i:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tlg, tcache, _ = twin.decode_step(tp, tcache, step_tok)
                twin_ms.append(_sync_s(t0) * 1e3)
            before, t0 = mesh_launches(), time.perf_counter()
            mlg, mcache, _ = srv.decode_step(mp, mcache, step_tok)
            mesh_ms.append(_sync_s(t0) * 1e3)
            if i == 0:
                row["decode_launches"] = launches_since(
                    before, {"#1": L * stepping, "#3": L * shards},
                    f"{name} decode")
            rels.append(rel_l2(mlg.gather(), whole(tlg)))
            step_tok = greedy(whole(tlg))
        row["decode_rel_max"] = max(rels)
        row["decode_ms"] = statistics.median(mesh_ms)
        row["decode_ms_1x1"] = statistics.median(twin_ms)
    bad = [g for g in rels + [row["prefill_rel"]] if not g <= limit]
    if bad:
        raise AssertionError(f"{name}: logits {bad} relative L2 from the "
                             f"1x1 twin's (limit {limit})")
    row["limit"] = limit
    print(f"mesh serving {name} ({card}): B={B} x S={S}, {C} context "
          f"shards; prefill {row['prefill_ms']:.1f} ms (logits rel "
          f"{row['prefill_rel']:.3g}; the twin against a decode step of "
          f"its last token {row['floor_rel']:.3g}), restore "
          f"{row['restore_ms']:.1f} ms of which one shard's {row['shard_block']} projection "
          f"{row['projection_ms_per_shard']:.3f} ms (CUDA events), decode "
          f"{row['decode_ms']:.1f} ms/step against {row['decode_ms_1x1']:.1f}"
          f" at 1x1 (max logits rel {row['decode_rel_max']:.3g}, limit "
          f"{limit}); launches per shard: prefill #1 "
          f"{row['prefill_launches']['#1'] // shards} #5 "
          f"{row['prefill_launches']['#5'] // shards}, restore #1 "
          f"{row['restore_launches']['#1'] // shards}, decode "
          f"step #1 {row['decode_launches']['#1'] // stepping} (on "
          f"{stepping} model shards) #3 "
          f"{row['decode_launches']['#3'] // shards}; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; restored K/V "
          "bitwise the 1x1 restore's, the 1x1 prefill, restore and decode "
          "bitwise the plain Model's")
    return row


def run_mesh_ssm(card, model, params, shape, B, S, limit=MESH_REL,
                 steps=MESH_STEPS):
    """falcon-mamba-7b's prefill and MESH_STEPS decode steps over
    ``shape`` (``ssm_inner`` over model) against its 1x1 twin, which is
    bitwise the plain ``Model`` (prefill's logits, states and hidden, a
    decode step's logits, hidden and states); every step's logits within
    ``limit`` relative L2 of the twin's; kernel #6 once per layer and
    shard in each program."""
    import torch
    twin = mesh_server(model, (1, 1))
    srv = mesh_server(model, shape)
    shards = srv.D * srv.M
    L = model.cfg.n_layers
    name = (f"{model.cfg.name} {shape[0]}x{shape[1]}"
            + (" fp32" if model.dtype == torch.float32 else ""))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 37)
    toks = torch.randint(0, model.cfg.vocab_size, (B, S), generator=gen,
                         device="cuda")
    row = {"mesh": name, "B": B, "S": S}
    with torch.no_grad():
        tp = twin.place_params(params)
        tout = twin.prefill(tp, {"tokens": toks}, capture_hidden=True)
        plain = model.prefill(params, {"tokens": toks}, capture_hidden=True)
        for what, got, want in (
                ("logits", tout["logits"], plain["logits"]),
                ("conv", tout["states"][0], plain["states"][0]),
                ("ssm", tout["states"][1], plain["states"][1]),
                ("hidden", tout["hidden"], plain["hidden"])):
            if not torch.equal(whole(got), want):
                raise AssertionError(f"{name}: the 1x1 prefill's {what} "
                                     "differs from Model.prefill")
        del plain
        mp = srv.place_params(params)
        torch.cuda.synchronize()
        before, t0 = mesh_launches(), time.perf_counter()
        mout = srv.prefill(mp, {"tokens": toks})
        row["prefill_ms"] = _sync_s(t0) * 1e3
        row["prefill_launches"] = launches_since(
            before, {"#6": L * shards}, f"{name} prefill")
        row["prefill_rel"] = rel_l2(mout["logits"].gather(),
                                    whole(tout["logits"]))
        row["state_rel"] = rel_l2(mout["states"][1].gather(),
                                  whole(tout["states"][1]))
        lengths = [S] * B
        tcache = twin.place_cache({"conv": tout["states"][0],
                                   "ssm": tout["states"][1],
                                   "lengths": lengths})
        mcache = srv.place_cache({"conv": mout["states"][0],
                                  "ssm": mout["states"][1],
                                  "lengths": lengths})
        tok = greedy(whole(tout["logits"]))
        pc = {"conv": whole(tcache["conv"]).clone(),
              "ssm": whole(tcache["ssm"]).clone(),
              "lengths": torch.full((B,), S, dtype=torch.int32,
                                    device="cuda")}
        plg, pc, phid = model.decode_step_full(params, pc, tok)
        tlg, tcache, thid = twin.decode_step(tp, tcache, tok)
        if not (torch.equal(whole(tlg), plg) and torch.equal(whole(thid), phid)
                and torch.equal(whole(tcache["ssm"]), pc["ssm"])
                and torch.equal(whole(tcache["conv"]), pc["conv"])):
            raise AssertionError(f"{name}: the 1x1 decode step differs from "
                                 "Model.decode_step_full")
        del pc
        rels, mesh_ms, twin_ms = [], [], []
        step_tok = tok
        for i in range(steps):
            if i:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tlg, tcache, _ = twin.decode_step(tp, tcache, step_tok)
                twin_ms.append(_sync_s(t0) * 1e3)
            before, t0 = mesh_launches(), time.perf_counter()
            mlg, mcache, _ = srv.decode_step(mp, mcache, step_tok)
            mesh_ms.append(_sync_s(t0) * 1e3)
            if i == 0:
                row["decode_launches"] = launches_since(
                    before, {"#6": L * shards}, f"{name} decode")
            rels.append(rel_l2(mlg.gather(), whole(tlg)))
            step_tok = greedy(whole(tlg))
        row["decode_rel_max"] = max(rels)
        row["decode_ms"] = statistics.median(mesh_ms)
        row["decode_ms_1x1"] = statistics.median(twin_ms)
    bad = [g for g in rels + [row["prefill_rel"]] if not g <= limit]
    if bad:
        raise AssertionError(f"{name}: logits {bad} relative L2 from the "
                             f"1x1 twin's (limit {limit})")
    row["limit"] = limit
    print(f"mesh serving {name} ({card}): B={B} x S={S}; prefill "
          f"{row['prefill_ms']:.1f} ms (logits rel {row['prefill_rel']:.3g}"
          f", ssm state rel {row['state_rel']:.3g}), decode "
          f"{row['decode_ms']:.1f} ms/step against {row['decode_ms_1x1']:.1f}"
          f" at 1x1 (max logits rel {row['decode_rel_max']:.3g}, limit "
          f"{limit}); launches per shard: prefill #6 "
          f"{row['prefill_launches']['#6'] // shards}, decode step #6 "
          f"{row['decode_launches']['#6'] // shards}; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; the 1x1 "
          "prefill and decode bitwise the plain Model's")
    return row


# The hybrid (zamba2-2.7b) and enc-dec (whisper-medium) stacks on the
# same programs, on the weights their phases loaded: zamba2 over
# MESH_SHAPE under the default rules (2 sessions of MESH_HYBRID_SEQ) and
# long_context (one of MESH_HYBRID_LONG_SEQ over 4 context shards),
# whisper over MESH_SHAPE (2 sessions of MESH_ENCDEC_FRAMES frames and
# the dry-run's DEC_PROMPT-token prompt), then both in fp32 at
# MESH_FP32_HYBRID_LAYERS and MESH_FP32_ENCDEC_LAYERS (encoder and
# decoder each) under MESH_FP32_REL.
MESH_HYBRID_SEQ = 2048
MESH_HYBRID_LONG_SEQ = 4096
MESH_ENCDEC_FRAMES = 1500
MESH_FP32_HYBRID_LAYERS = 6          # one super-block
MESH_FP32_ENCDEC_LAYERS = 2
MESH_FP32_HYBRID_SEQ = 512
MESH_FP32_HYBRID_LONG_SEQ = 1024
MESH_FP32_ENCDEC_FRAMES = 1500


def mesh_batch(model, B, S, seed, frames=0):
    """Random tokens (B, S) (and ``frames`` encoder frames (B, frames,
    D) for an enc-dec model) on the card, from ``seed``."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"tokens": torch.randint(0, model.cfg.vocab_size, (B, S),
                                     generator=gen, device="cuda")}
    if frames:
        batch["frames"] = torch.stack([torch.from_numpy(encdec_frames(
            model, frames, seed + b)) for b in range(B)]).to("cuda")
    return batch


def run_mesh_stack(card, model, params, shape, long_context, batch,
                   limit=MESH_REL, steps=MESH_STEPS):
    """A hybrid or enc-dec stack's prefill (``capture_hidden``), restore
    and ``steps`` decode steps over ``shape``, against the 1x1 twin, as
    ``run_mesh_lm`` holds llama2-7b: the twin bitwise the plain ``Model``
    (prefill's logits, K/V, Mamba2 states or cross K/V and hidden; the
    restore; a decode step's logits, hidden and every cache leaf), the
    twin's restore bitwise its prefill's K/V, the mesh's restore of the
    twin's hidden bitwise the twin's restore, the mesh's restore of its
    own hidden bitwise its prefill's K/V, prefill and every step's logits
    within ``limit`` of the twin's, and each kernel's launches per layer
    and shard as the programs' docstrings state them: zamba2 per
    attention block and shard #1 and #5 once in prefill, #1 once per
    stepping model shard and #3 once per context shard at decode;
    whisper per shard #1 once per encoder and decoder layer and once for
    the cross K/V and #5 once per encoder layer and twice per decoder
    layer in prefill, #1 once and #3 twice per decoder layer at decode;
    the restore one #1 per shard."""
    import torch
    kind, c = model.kind, model.cfg
    hyb = kind == "hybrid"
    twin = mesh_server(model, (1, 1))
    srv = mesh_server(model, shape, long_context)
    D, M, C = srv.D, srv.M, srv.C
    shards = D * M
    stepping = M if long_context else shards     # model shards per step
    B, S = batch["tokens"].shape
    F = batch["frames"].shape[1] if not hyb else 0
    cap = S + MESH_PAD
    L = model.h.n_super if hyb else c.n_layers
    second = "mamba_states" if hyb else "cross_kv"
    hkey = "attn_hidden" if hyb else "hidden"
    kvn = ("attn_k", "attn_v") if hyb else ("self_k", "self_v")
    if hyb:
        want_prefill = {"#1": L * shards, "#5": L * shards}
        want_step = {"#1": L * stepping, "#3": L * shards}
    else:
        Le = c.encoder_layers
        want_prefill = {"#1": (Le + 1 + L) * shards,
                        "#5": (Le + 2 * L) * shards}
        want_step = {"#1": L * shards, "#3": 2 * L * shards}
    name = (f"{c.name} {shape[0]}x{shape[1]}"
            + (" long_context" if long_context else "")
            + (" fp32" if model.dtype == torch.float32 else ""))
    row = {"mesh": name, "B": B, "S": S, "context_shards": C}
    if F:
        row["frames"] = F

    def logits_rel(got, want):
        # over the true vocabulary: the padded columns' -1e30 would make
        # the norms infinite (whisper's 51865 words pad to 51968)
        return rel_l2(got[..., :c.vocab_size], want[..., :c.vocab_size])

    def states(out):
        if hyb:
            return {"conv": out["mamba_states"][0],
                    "ssm": out["mamba_states"][1]}
        return {"cross_k": out["cross_kv"][0], "cross_v": out["cross_kv"][1],
                "enc_len": F}

    with torch.no_grad():
        tp = twin.place_params(params)
        tout = twin.prefill(tp, batch, capture_hidden=True)
        plain = model.prefill(params, batch, capture_hidden=True)
        pairs = [("logits", tout["logits"], plain["logits"]),
                 ("hidden", tout["hidden"], plain[hkey])]
        for i in range(2):
            pairs += [(f"kv[{i}]", tout["kv"][i], plain["kv"][i]),
                      (f"{second}[{i}]", tout[second][i], plain[second][i])]
        for what, got, want in pairs:
            if not torch.equal(whole(got), want):
                raise AssertionError(f"{name}: the 1x1 prefill's {what} "
                                     "differs from Model.prefill")
        del plain, pairs
        hidden = whole(tout["hidden"])
        tk, tv = twin.restore_kv_from_hidden(
            tp, twin.place_hidden(hidden, cap))
        pos = torch.arange(S, device="cuda")[None].expand(B, S)
        pk, pv = model.restore_kv_from_hidden(params, hidden, positions=pos)
        for got, pre, plain_kv in ((tk, tout["kv"][0], pk),
                                   (tv, tout["kv"][1], pv)):
            if not torch.equal(whole(got)[:, :, :S], whole(pre)):
                raise AssertionError(f"{name}: the 1x1 restore differs from "
                                     "its prefill's K/V")
            if not torch.equal(plain_kv, whole(got)[:, :, :S]):
                raise AssertionError(f"{name}: the 1x1 restore differs from "
                                     "Model.restore_kv_from_hidden")
        del pk, pv
        mp = srv.place_params(params)
        torch.cuda.synchronize()
        before, t0 = mesh_launches(), time.perf_counter()
        mout = srv.prefill(mp, batch, capture_hidden=True)
        row["prefill_ms"] = _sync_s(t0) * 1e3
        row["prefill_launches"] = launches_since(before, want_prefill,
                                                 f"{name} prefill")
        row["prefill_rel"] = logits_rel(mout["logits"].gather(),
                                        whole(tout["logits"]))
        row["state_rel"] = rel_l2(mout[second][1].gather(),
                                  whole(tout[second][1]))
        # the mesh's own hidden restores its prefill's K/V
        mk, mv = srv.restore_kv_from_hidden(mp, mout["hidden"])
        for got, want in ((mk, mout["kv"][0]), (mv, mout["kv"][1])):
            if not all(torch.equal(a, b) for a, b in zip(got.parts,
                                                         want.parts)):
                raise AssertionError(f"{name}: the mesh's restore differs "
                                     "from its prefill's K/V")
        del mk, mv
        # the twin's hidden at the cache's capacity: the decode cache
        mh = srv.place_hidden(hidden, cap)
        torch.cuda.synchronize()
        before, t0 = mesh_launches(), time.perf_counter()
        rk, rv = srv.restore_kv_from_hidden(mp, mh)
        row["restore_ms"] = _sync_s(t0) * 1e3
        row["restore_launches"] = launches_since(
            before, {"#1": shards}, f"{name} restore")
        for got, want in ((rk, whole(tk)), (rv, whole(tv))):
            for r, part in enumerate(got.parts):
                if not torch.equal(part, want[got.block(srv.coords[r])]):
                    raise AssertionError(f"{name}: shard {srv.coords[r]}'s "
                                         "restored K/V differs from the "
                                         "1x1 restore")
        del mh
        lengths = [S] * B
        tcache = twin.place_cache({kvn[0]: tk, kvn[1]: tv, **states(tout),
                                   "lengths": lengths}, cap)
        mcache = srv.place_cache({kvn[0]: rk, kvn[1]: rv, **states(mout),
                                  "lengths": lengths}, cap)
        if mcache[kvn[0]] is not rk:
            raise AssertionError(f"{name}: the restored K/V was copied into "
                                 "the cache's layout")
        del mout
        # one step of the plain Model on a copy of the twin's cache
        tok = greedy(whole(tout["logits"]))
        pc = {n: whole(x).clone() for n, x in tcache.items()
              if n not in ("lengths", "enc_len")}
        pc["lengths"] = torch.full((B,), S, dtype=torch.int32, device="cuda")
        if not hyb:
            pc["enc_len"] = torch.tensor(F, dtype=torch.int32, device="cuda")
        plg, pc, phid = model.decode_step_full(params, pc, tok)
        tlg, tcache, thid = twin.decode_step(tp, tcache, tok)
        same = [n for n in pc if n not in ("lengths", "enc_len")
                and not torch.equal(whole(tcache[n]), pc[n])]
        if not (torch.equal(whole(tlg), plg) and torch.equal(
                whole(thid), phid[1] if hyb else phid)) or same:
            raise AssertionError(f"{name}: the 1x1 decode step differs from "
                                 f"Model.decode_step_full {same}")
        del pc, plg, phid
        rels, mesh_ms, twin_ms = [], [], []
        step_tok = tok
        for i in range(steps):
            if i:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tlg, tcache, _ = twin.decode_step(tp, tcache, step_tok)
                twin_ms.append(_sync_s(t0) * 1e3)
            before, t0 = mesh_launches(), time.perf_counter()
            mlg, mcache, _ = srv.decode_step(mp, mcache, step_tok)
            mesh_ms.append(_sync_s(t0) * 1e3)
            if i == 0:
                row["decode_launches"] = launches_since(before, want_step,
                                                        f"{name} decode")
            rels.append(logits_rel(mlg.gather(), whole(tlg)))
            step_tok = greedy(whole(tlg))
        row["decode_rel_max"] = max(rels)
        row["decode_ms"] = statistics.median(mesh_ms)
        row["decode_ms_1x1"] = statistics.median(twin_ms)
    bad = [g for g in rels + [row["prefill_rel"]] if not g <= limit]
    if bad:
        raise AssertionError(f"{name}: logits {bad} relative L2 from the "
                             f"1x1 twin's (limit {limit})")
    row["limit"] = limit
    per = {k: {n: v // (shards if k != "decode" or n != "#1" else stepping)
               for n, v in row[f"{k}_launches"].items() if v}
           for k in ("prefill", "restore", "decode")}
    print(f"mesh serving {name} ({card}): B={B} x S={S}"
          + (f" over {F} frames" if F else "") + f", {C} context shards; "
          f"prefill {row['prefill_ms']:.1f} ms (logits rel "
          f"{row['prefill_rel']:.3g}, {second}[1] rel "
          f"{row['state_rel']:.3g}), restore {row['restore_ms']:.1f} ms, "
          f"decode {row['decode_ms']:.1f} ms/step against "
          f"{row['decode_ms_1x1']:.1f} at 1x1 (max logits rel "
          f"{row['decode_rel_max']:.3g}, limit {limit}); launches per shard "
          f"{per}; peak allocated {torch.cuda.max_memory_allocated() / 1e9:.1f}"
          " GB; the 1x1 prefill, restore and decode bitwise the plain "
          "Model's, the restores bitwise the 1x1 restore and the prefill")
    return row


def run_mesh_families(card, model, params):
    """The mesh runs of a phase's loaded hybrid or enc-dec model:
    (their rows, the slice shapes they gave kernel #3)."""
    import gc

    import torch
    from repro_torch.models.model import DEC_PROMPT
    shapes, rows = {}, []
    if model.kind == "hybrid":
        runs = ((False, mesh_batch(model, 2, MESH_HYBRID_SEQ, SEED + 43)),
                (True, mesh_batch(model, 1, MESH_HYBRID_LONG_SEQ,
                                  SEED + 47)))
    else:
        runs = ((False, mesh_batch(model, 2, DEC_PROMPT, SEED + 53,
                                   MESH_ENCDEC_FRAMES)),)
    for long_context, batch in runs:
        rows.append(recorded_slices(
            lambda: run_mesh_stack(card, model, params, MESH_SHAPE,
                                   long_context, batch), shapes))
        gc.collect()
        torch.cuda.empty_cache()
    return rows, shapes


def run_mesh_families_fp32(card, kind):
    """The same programs in fp32 at full width: zamba2 at
    MESH_FP32_HYBRID_LAYERS under the default rules and long_context, or
    whisper at MESH_FP32_ENCDEC_LAYERS, under MESH_FP32_REL: (rows, the
    slice shapes)."""
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.models.model import DEC_PROMPT
    shapes, rows = {}, []
    if kind == "hybrid":
        cfg = get_arch(HYBRID_ARCH).scaled(n_layers=MESH_FP32_HYBRID_LAYERS)
    else:
        cfg = get_arch(ENCDEC_ARCH).scaled(
            n_layers=MESH_FP32_ENCDEC_LAYERS,
            encoder_layers=MESH_FP32_ENCDEC_LAYERS)
    model = Model(cfg, dtype=torch.float32)
    params = model.init(SEED)
    if kind == "hybrid":
        runs = ((False, mesh_batch(model, 2, MESH_FP32_HYBRID_SEQ,
                                   SEED + 59)),
                (True, mesh_batch(model, 1, MESH_FP32_HYBRID_LONG_SEQ,
                                  SEED + 61)))
    else:
        runs = ((False, mesh_batch(model, 2, DEC_PROMPT, SEED + 67,
                                   MESH_FP32_ENCDEC_FRAMES)),)
    for long_context, batch in runs:
        rows.append(recorded_slices(
            lambda: run_mesh_stack(card, model, params, MESH_SHAPE,
                                   long_context, batch, limit=MESH_FP32_REL,
                                   steps=MESH_FP32_STEPS), shapes))
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return rows, shapes


def check_mesh_decode(card, shapes: dict):
    """Kernel #3 on a context slice (``kv_start``, ``return_lse``) against
    its plain version at every slice shape the mesh phase gave it: the
    phase's own lengths and slice starts; every row ending before its
    slice (no live key: zeros, lse -inf); and a window that crosses the
    slice's first position. Output within TOL (the inputs' dtype's), lse
    within fp32's;
    the kernel timed by CUDA graph beside the plain version and the bound
    (the slice's live K and V read once)."""
    import torch
    from repro_torch.kernels import decode_attention as dec
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    rows = []
    for key, rec in sorted(shapes.items(), key=lambda kv: str(kv[0])):
        BKv, G, hd, Sc, Kv, dtype_name, window = key
        dtype = getattr(torch, dtype_name.split(".")[-1])
        tol = "fp32" if dtype == torch.float32 else "bf16"
        B = BKv // Kv
        q = torch.randn(BKv, G, hd, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, Sc, Kv, hd, generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn(B, Sc, Kv, hd, generator=gen,
                        device="cuda").to(dtype)
        start = torch.tensor(rec["kv_start"], dtype=torch.int32,
                             device="cuda")
        lens = torch.tensor(rec["kv_len"], dtype=torch.int32, device="cuda")
        cases = (("phase", lens, window),
                 ("empty", start.clone(), window),
                 ("window across the slice start", start + 64, 200))
        errs, lse_errs = [], []
        for what, n, w in cases:
            kw = dict(window=w, kv_start=start, return_lse=True)
            out, lse = dec.decode_attention_cuda(q, k, v, n, **kw)
            pout, plse = dec.decode_attention_plain(q, k, v, n, **kw)
            label = (f"decode_attention on a slice {what} (BKv={BKv}, G={G},"
                     f" hd={hd}, slice {Sc}, starts {rec['kv_start'][:1]})")
            errs.append(check_close(label, out, pout, tol))
            fin = torch.isfinite(plse)
            if not torch.equal(torch.isfinite(lse), fin) or not bool(
                    (lse[~fin] == plse[~fin]).all()):
                raise AssertionError(f"{label}: lse -inf where the plain "
                                     "version's is not, or the reverse")
            lse_errs.append(check_close(label + " lse", lse[fin], plse[fin],
                                        "fp32") if bool(fin.any()) else 0.0)
            if what == "empty" and not (bool((out == 0).all())
                                        and not bool(fin.any())):
                raise AssertionError(f"{label}: not zeros with lse -inf")
        kw = dict(window=window, kv_start=start, return_lse=True)
        ms = graph_ms(lambda: dec.decode_attention_cuda(q, k, v, lens, **kw))
        plain_ms = time_ms(lambda: dec.decode_attention_plain(q, k, v, lens,
                                                              **kw), 3)
        live = [max(min(int(n) - int(s), Sc), 0)
                for n, s in zip(rec["kv_len"], rec["kv_start"])]
        nbytes = 2 * (2 * BKv * G * hd + 2 * sum(live) * hd) + 4 * BKv * \
            (2 + G)
        bound_ms, bound_by = bound(4 * G * hd * sum(live), nbytes, card)
        rows.append({"BKv": BKv, "G": G, "hd": hd, "slice": Sc,
                     "window": window, "launches": rec["launches"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err": max(errs),
                     "lse_max_abs_err": max(lse_errs)})
    print("decode_attention on context slices (kv_start, lse) against its "
          f"plain version ({card}): " + "; ".join(
              f"BKv={r['BKv']} G={r['G']} hd={r['hd']} slice {r['slice']}: "
              f"{r['launches']} launches, {r['ms']:.4f} ms (bound "
              f"{r['bound_ms']:.4f}, plain {r['plain_ms']:.2f}), max abs err "
              f"{r['max_abs_err']:.4f}, lse {r['lse_max_abs_err']:.2e}"
              for r in rows))
    return rows


def run_mesh_phase(card, model, params):
    """llama2-7b over MESH_SHAPE under the default rules (2 sessions of
    MESH_SEQ) and under long_context (one of MESH_LONG_SEQ), then the fp32
    runs (``run_mesh_fp32``): (their rows, the slice shapes they gave
    kernel #3, for ``check_mesh_decode``)."""
    import gc

    import torch
    shapes = {}
    rows = []
    for long_context, B, S in ((False, 2, MESH_SEQ),
                               (True, 1, MESH_LONG_SEQ)):
        rows.append(recorded_slices(
            lambda: run_mesh_lm(card, model, params, MESH_SHAPE,
                                long_context, B, S), shapes))
        gc.collect()
        torch.cuda.empty_cache()
    rows += recorded_slices(lambda: run_mesh_fp32(card), shapes)
    return rows, shapes


def run_mesh_fp32(card):
    """The mesh programs in fp32 at full width and MESH_FP32_LAYERS
    layers, under every gate of the bf16 runs and MESH_FP32_REL:
    llama2-7b over MESH_SHAPE under the default rules and long_context,
    falcon-mamba-7b over MESH_SSM_SHAPE."""
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    rows = []
    for arch in ("llama2-7b", SSM_ARCH):
        model = Model(get_arch(arch).scaled(n_layers=MESH_FP32_LAYERS),
                      dtype=torch.float32)
        params = model.init(SEED)
        if model.kind == "lm":
            for long_context, B, S in ((False, 2, MESH_FP32_SEQ),
                                       (True, 1, MESH_FP32_LONG_SEQ)):
                rows.append(run_mesh_lm(card, model, params, MESH_SHAPE,
                                        long_context, B, S,
                                        limit=MESH_FP32_REL,
                                        steps=MESH_FP32_STEPS))
        else:
            rows.append(run_mesh_ssm(card, model, params, MESH_SSM_SHAPE, 2,
                                     MESH_FP32_SSM_SEQ, limit=MESH_FP32_REL,
                                     steps=MESH_FP32_STEPS))
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def flash_shape_classes(counter):
    """Launches by (new tokens, self-prefill or over history)."""
    out = {}
    for (B, Sq, Skv), n in sorted(counter.items()):
        key = f"B={B} Sq={Sq} " + ("self" if Sq == Skv else "over history")
        out[key] = out.get(key, 0) + n
    return out


def run_llama_phases(drive, phase_s, model, params):
    """llama2-7b at full size: the lifecycle, the restore plans, the engine
    on both backends (phased, unphased, calibrated), the budget, prefix
    sharing, tensor-parallel serving and the front door, each held against
    its gates."""
    import gc

    import torch
    from repro_torch.core.profiler import MeasuredProfile
    drive("lifecycle", lambda: run_main_path(model, params),
          ("restore_kv_grouped", "decode_attention", "flash_attention"))
    profile = drive("restore plans", lambda: run_restore_plans(model, params),
                    ("restore_kv_grouped",))
    check_profile_round_trip(profile)
    gc.collect()
    torch.cuda.empty_cache()
    runs, plain = {}, {}

    lm_needs = ("restore_kv_grouped", "decode_attention", "flash_attention")

    def against_plain(name, run, plain):
        hold_against_plain(name, model, params, run, plain)

    for backend, decode_kernel in (("contiguous", "decode_attention"),
                                   ("paged", "decode_attention_paged")):
        needs = ("restore_kv_grouped", decode_kernel, "flash_attention")
        runs[backend] = drive(
            f"engine {backend}", lambda b=backend: run_engine(model, params, b),
            needs)
        against_plain(f"engine {backend}", runs[backend], plain)
        # the overlap's measure: no synchronisation around the phases
        free = drive(f"engine {backend} unphased", lambda b=backend:
                     run_engine(model, params, b, phased=False), needs)
        check_same_tokens(f"engine {backend} unphased", free, runs[backend])
        against_plain(f"engine {backend} unphased", free, plain)
        del free
    check_engine(runs["contiguous"], runs["paged"])
    # calibration: the same engine with a MeasuredProfile and "auto" group
    # plans against an uncalibrated twin, both finishing every restore in
    # the step it starts, so that the schedule is the same
    needs = ("restore_kv_grouped", "decode_attention", "flash_attention")
    twin = drive("engine contiguous whole restores",
                 lambda: run_engine(model, params, "contiguous",
                                    restore_tasks=WHOLE_RESTORES), needs)
    calibrated = drive(
        "engine contiguous whole restores calibrated",
        lambda: run_engine(model, params, "contiguous",
                           profile=MeasuredProfile(), group="auto",
                           restore_tasks=WHOLE_RESTORES), needs)
    check_same_tokens("engine contiguous calibrated", calibrated, twin,
                      "uncalibrated")
    check_calibration(calibrated)
    plain = {}                       # these streams may differ from above
    against_plain("engine contiguous whole restores", twin, plain)
    against_plain("engine contiguous calibrated", calibrated, plain)
    # the host-storage budget: the same traffic under BUDGET_FRACTION of
    # the phased contiguous run's peak hot bytes, no cold tier
    peak = runs["contiguous"]["bytes_peak"]
    budget = int(BUDGET_FRACTION * peak)
    budgeted = drive("engine contiguous budget",
                     lambda: run_engine(model, params, "contiguous",
                                        budget=budget), lm_needs)
    check_budget(budgeted, budget, peak)
    against_plain("engine contiguous budget", budgeted, {})
    # prefix sharing: one shared document, a fork, copy-on-write pages,
    # against the same requests with sharing off
    rounds = prefix_requests(model.cfg.vocab_size)
    paged_needs = ("restore_kv_grouped", "decode_attention_paged",
                   "flash_attention")
    shared = drive("engine paged prefix sharing",
                   lambda: run_prefix_engine(model, params, True, rounds),
                   paged_needs)
    unshared = drive("engine paged prefix no sharing",
                     lambda: run_prefix_engine(model, params, False, rounds),
                     paged_needs)
    check_prefix(shared, unshared)
    against_plain("engine paged prefix sharing", shared, {})
    del budgeted, shared, unshared
    gc.collect()
    torch.cuda.empty_cache()
    # tensor-parallel serving, every shard on the card: the paged engine
    # at tp 1, 2, 4 and the contiguous one at tp 1, 2, each held against
    # tp 1
    drive("engine paged tp", lambda: run_tp_phase(model, params),
          ("restore_kv_grouped", "decode_attention",
           "decode_attention_paged", "flash_attention"))
    if phase_s["engine paged tp"] > TP_PHASE_BUDGET_S:
        print(f"engine paged tp: {phase_s['engine paged tp']:.1f} s, over "
              f"its budget of {TP_PHASE_BUDGET_S:.0f} s")
    # the HTTP front door on both backends, each against its twin
    for backend, decode_kernel in (("contiguous", "decode_attention"),
                                   ("paged", "decode_attention_paged")):
        needs = ("restore_kv_grouped", decode_kernel, "flash_attention")
        door = drive(f"front door {backend}",
                     lambda b=backend: run_front_door(model, params, b),
                     needs)
        direct = drive(f"front door {backend} twin",
                       lambda b=backend, r=door["routed"]:
                       run_front_door_twin(model, params, b, r), needs)
        check_front_door(backend, door, direct)
        against_plain(f"front door {backend}", door, {})
        del door, direct


def run_training_phases(card, drive, phase_s, counts, kernels):
    """Training on the card: llama2-7b at full width, a supervised restart
    through launch/train.py, kernel #6 under autograd, the other families,
    sharded training, then kernel #5 under autograd at every shape these
    phases gave it (into ``kernels`` when the kernel checks ran)."""
    import gc

    import torch
    # training: llama2-7b at full width, a supervised restart through
    # launch/train.py, kernel #6 under autograd, then the other families;
    # kernel #5 under autograd at every shape these phases gave it
    from repro_torch.training import CARD_TRAIN_SHAPES
    train_flash = {}
    before = dict(counts)
    train = drive(f"train {TRAIN_ARCH}", lambda: recorded_flash_shapes(
        lambda: run_train(TRAIN_ARCH, TRAIN_LR, TRAIN_STEPS), train_flash,
        TRAIN_ARCH), ("flash_attention",))
    drive("train restart", lambda: recorded_flash_shapes(
        run_train_restart, train_flash, "restart"), ("flash_attention",))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ssm_train = check_ssm_train(card)
    phase_s["train ssm kernel check"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    families = {}
    for arch in CARD_TRAIN_SHAPES:
        if arch == TRAIN_ARCH:
            continue
        families[arch] = drive(
            f"train {arch}", lambda a=arch: recorded_flash_shapes(
                lambda: run_train(a, FAMILY_LR, FAMILY_STEPS), train_flash,
                a),
            ("ssm_update",) if arch == SSM_ARCH else ("flash_attention",))
        gc.collect()
        torch.cuda.empty_cache()
    # sharded training, every shard on the card, each mesh against its
    # 1x1 twin
    drive("train sharded", lambda: recorded_flash_shapes(
        lambda: run_sharded_phase(card), train_flash, "sharded"),
        ("flash_attention",))
    if phase_s["train sharded"] > SHARDED_PHASE_BUDGET_S:
        print(f"train sharded: {phase_s['train sharded']:.1f} s, over its "
              f"budget of {SHARDED_PHASE_BUDGET_S:.0f} s")
    gc.collect()
    torch.cuda.empty_cache()
    flash_launches = (counts.get("flash_attention", 0)
                      - before.get("flash_attention", 0))
    recorded = sum(e["launches"] for e in train_flash.values())
    if recorded != flash_launches:
        raise AssertionError(f"training: {flash_launches} flash_attention "
                             f"launches, {recorded} through FlashAttentionFn")
    t0 = time.perf_counter()
    train_shapes = check_flash_train_shapes(card, train_flash)
    phase_s["train flash kernel checks"] = time.perf_counter() - t0
    ssm_train["launches"] = (counts.get("ssm_update", 0)
                             - before.get("ssm_update", 0))
    if kernels:
        kernels[3]["train_shapes"] = train_shapes
        kernels[4]["train_shape"] = ssm_train
    print(f"flash_attention launches added by training: {flash_launches}, "
          "by shape and phase: " + "; ".join(
              f"B={r['B']} Sq={r['Sq']} Skv={r['Skv']} H={r['H']} "
              f"Kv={r['Kv']} hd={r['hd']} "
              f"{'causal' if r['causal'] else 'non-causal'}: "
              f"{r['launches']} ({', '.join(r['phases'])})"
              for r in train_shapes)
          + f"; ssm_update launches added by training: "
          f"{ssm_train['launches']} ({SSM_ARCH}); train {TRAIN_ARCH} step "
          f"{train['step_ms']:.1f} ms, {train['tokens_per_s']:.0f} "
          "tokens/s; " + "; ".join(
              f"{a} {r['step_ms']:.1f} ms, {r['tokens_per_s']:.0f} "
              f"tokens/s, peak {r['peak_gb']:.1f} GB"
              for a, r in families.items()))


# the dry-run phase: llama2-7b cells counted on the card and on meta
# devices (kind, sequence, batch, layers (None: all 32), mesh); the 2x2
# prefill and train take 2 rows, so the batch splits over its data axis
DRYRUN_ARCH = "llama2-7b"
DRYRUN_CELLS = (("prefill", 2048, 1, None, (1, 1)),
                ("restore", 2048, 2, None, (1, 1)),
                ("decode", 2048, 8, None, (1, 1)),
                ("train", 1024, 1, 2, (1, 1)),
                ("prefill", 2048, 2, 2, (2, 2)),
                ("restore", 2048, 2, 2, (2, 2)),
                ("decode", 2048, 8, 2, (2, 2)),
                ("train", 1024, 2, 2, (2, 2)))
DRYRUN_PEAK_REL = 0.20      # counted peak against the allocator's
DRYRUN_BUDGET_S = 25.0
# what must be equal between a count on the card and one on meta
DRYRUN_KEYS = ("flops", "bytes", "bytes_all", "collectives", "launches")


def run_dryrun_phase(card):
    """The dry-run's counts on the card (``launch/dryrun.py``,
    ``launch/exec_cost.py``): each DRYRUN_CELLS cell of DRYRUN_ARCH in
    bf16, every shard on cuda:0, run twice uncounted (the second timed),
    then once counted, then counted on meta devices. Gates: per shard, flops,
    bytes, bytes_all, collectives and kernel launches equal between the
    card and meta; the counted launches equal those the kernels made; the
    counted peak (arguments and live storages) within DRYRUN_PEAK_REL of
    ``torch.cuda.max_memory_allocated`` over the same run. Prints each
    cell's ms beside the roofline's compute and memory terms under
    ``H100_SXM`` and the ms as a multiple of the larger."""
    import dataclasses
    import gc

    import torch
    from repro_torch.config.hardware import H100_SXM
    from repro_torch.config.shapes import SHAPES_BY_NAME
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_mesh

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import restore_kv as rkv
    from repro_torch.kernels import ssm_update as ssu

    def read():
        return {"restore_kv_grouped": rkv.launches,
                "decode_attention": dec.launches,
                "decode_attention_paged": dec.paged_launches,
                "flash_attention": fa.launches, "ssm_update": ssu.launches}

    base_shapes = {"prefill": "prefill_32k", "restore": "restore_32k",
                   "decode": "decode_32k", "train": "train_4k"}
    rows = []
    for kind, seq, batch, layers, ms in DRYRUN_CELLS:
        cfg = get_arch(DRYRUN_ARCH)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        shape = dataclasses.replace(SHAPES_BY_NAME[base_shapes[kind]],
                                    seq_len=seq, global_batch=batch)
        n = ms[0] * ms[1]
        name = (f"{DRYRUN_ARCH} {kind} {batch}x{seq} "
                f"{cfg.n_layers}L {ms[0]}x{ms[1]}")
        counts = {}
        with torch.set_grad_enabled(kind == "train"):
            base = torch.cuda.memory_allocated()
            mesh = make_mesh(ms, ("data", "model"), ["cuda:0"] * n)
            fn, args = dryrun.build_cell(mesh, cfg, shape, device="cuda")
            # a warm-up run, then a timed one (a decode step rewrites the
            # same slot, a train step leaves its input state as it was)
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(*args)
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            before = read()
            counts["cuda"] = dryrun.count_program(fn, args, n)
            torch.cuda.synchronize()
            made = {k: v - before[k] for k, v in read().items()
                    if v - before[k]}
            peak = torch.cuda.max_memory_allocated() - base
            del fn, args
            counts["cuda"].pop("outputs")
            gc.collect()
            torch.cuda.empty_cache()
            counts["meta"] = dryrun.count_cell(
                make_mesh(ms, ("data", "model"), ["meta"] * n), cfg, shape,
                device="meta")
            counts["meta"].pop("outputs")
        c, m = counts["cuda"], counts["meta"]
        for key in DRYRUN_KEYS:
            if c[key] != m[key] or c["per_shard"][key] != m["per_shard"][key]:
                raise AssertionError(f"dryrun {name}: {key} counted on the "
                                     f"card {c['per_shard'][key]} and on "
                                     f"meta {m['per_shard'][key]}")
        if c["total"]["launches"] != made:
            raise AssertionError(f"dryrun {name}: counted launches "
                                 f"{c['total']['launches']}, the kernels "
                                 f"made {made}")
        counted_peak = c["total"]["peak_memory"]
        if abs(counted_peak - peak) > DRYRUN_PEAK_REL * peak:
            raise AssertionError(f"dryrun {name}: counted peak "
                                 f"{counted_peak / 1e9:.3f} GB against "
                                 f"{peak / 1e9:.3f} GB allocated")
        rep = roofline.analyze(cfg, shape, mesh_name=f"{ms[0]}x{ms[1]}",
                               chips=n, flops_per_device=c["flops"],
                               bytes_per_device=c["bytes"],
                               coll_breakdown=c["collectives"], hw=H100_SXM)
        floor_ms = max(rep.compute_s, rep.memory_s) * 1e3
        print(f"dryrun {name}: {wall_ms:.1f} ms measured (a warm run, "
              f"uncounted); counted per device {c['flops'] / 1e12:.3f} "
              f"TFLOP, {c['bytes'] / 1e9:.3f} GB, collectives "
              f"{c['collectives']}, launches {c['total']['launches']} "
              f"(equal to the kernels' and to meta's, per shard); roofline "
              f"under H100_SXM compute {rep.compute_s * 1e3:.3f} ms, memory "
              f"{rep.memory_s * 1e3:.3f} ms: measured {wall_ms / floor_ms:.1f}"
              f"x the larger; peak counted {counted_peak / 1e9:.3f} GB, "
              f"allocated {peak / 1e9:.3f} GB; counted in "
              f"{c['count_s']:.2f} s on the card, {m['count_s']:.2f} s on "
              f"meta ({card})")
        rows.append({"cell": name, "ms": wall_ms, "flops": c["flops"],
                     "bytes": c["bytes"], "collectives": c["collectives"],
                     "launches": c["total"]["launches"],
                     "compute_ms": rep.compute_s * 1e3,
                     "memory_ms": rep.memory_s * 1e3,
                     "multiple": wall_ms / floor_ms,
                     "peak_counted": counted_peak, "peak_allocated": peak})
        gc.collect()
        torch.cuda.empty_cache()
    return rows


PHASES = ("kernels", "smoke", "llama2-7b", "mesh", "qwen2-7b", "gemma2-9b",
          "moe-vlm", "ssm", "hybrid", "encdec", "train",
          "dryrun")


def parse_phases(argv) -> set:
    """``--phases NAME[,NAME]`` (default: every phase of PHASES)."""
    import argparse
    p = argparse.ArgumentParser(description="Chip smoke test of the port.")
    p.add_argument("--phases", default="all",
                   help="comma-separated phases to run, of: "
                   + ", ".join(PHASES) + " (default all)")
    args = p.parse_args(argv)
    if args.phases == "all":
        return set(PHASES)
    names = [n.strip() for n in args.phases.split(",") if n.strip()]
    unknown = [n for n in names if n not in PHASES]
    if unknown or not names:
        p.error(f"unknown phase(s) {unknown or args.phases!r}; choose from "
                + ", ".join(PHASES))
    return set(names)


def main(argv=None) -> None:
    import collections
    import gc

    import torch
    phases = parse_phases(argv)

    def want(*names):
        return any(n in phases for n in names)

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SystemExit(f"chip_smoke: {SRC}/repro_torch not found; run "
                         "from a checkout of the repository")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import restore_kv as rkv
    from repro_torch.kernels import ssm_update as ssu

    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, "
          f"{sh(['nvcc', '--version']).splitlines()[-1]}")
    print(f"card: {card}")
    _build.library()
    print(f"kernels built in {_build.build_seconds:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = []
    if want("kernels"):
        restore = check_restore(card, gen)
        decode, decode_shapes = check_decode(card, gen)
        kernels = [restore, decode,
                   check_paged_decode(card, gen, decode_shapes),
                   check_flash(card, gen), check_ssm_update(card, gen)]
        for k, rows in time_model_shapes(card).items():
            next(x for x in kernels if x["name"] == k)["model_shapes"] = rows
    phase_s = {"kernel checks": time.perf_counter() - t_start}

    def reset():
        rkv.launches = dec.launches = dec.paged_launches = fa.launches = 0
        ssu.launches = 0
        rkv.shapes.clear()
        fa.shapes.clear()
        torch.cuda.reset_peak_memory_stats()

    def read():
        return {"restore_kv_grouped": rkv.launches,
                "decode_attention": dec.launches,
                "decode_attention_paged": dec.paged_launches,
                "flash_attention": fa.launches,
                "ssm_update": ssu.launches}

    counts, regimes = {}, {}
    flash_shapes = collections.Counter()

    def drive(name, fn, needs):
        reset()
        t0 = time.perf_counter()
        out = fn()
        got = read()
        phase_s[name] = time.perf_counter() - t0
        print(f"{name} done in {phase_s[name]:.1f} s, peak allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; kernel "
              f"launches {got}")
        for k in needs:
            if got[k] <= 0:
                raise AssertionError(f"{k} never ran on the {name} path")
        for k, n in got.items():
            counts[k] = counts.get(k, 0) + n
        for (G, S), n in rkv.shapes.items():
            r = restore_regime(G, S)
            regimes[r] = regimes.get(r, 0) + n
        flash_shapes.update(fa.shapes)
        return out

    from repro_torch.launch import serve
    served = {}
    for name, args, needs in SMOKE_SERVES if want("smoke") else ():
        served[name] = drive(name, lambda a=args: recorded_serve(serve, a),
                             needs)
        if SERVE_PRINTS.get(name, "") not in served[name]["out"]:
            raise AssertionError(f"{name}: no line with "
                                 f"{SERVE_PRINTS[name]!r}")
    if want("smoke"):
        one_host, two_hosts, extra = HOSTS_SERVE
        args, needs = next((a, n) for name, a, n in SMOKE_SERVES
                           if name == one_host)
        check_hosts_serve(served[one_host], drive(
            two_hosts, lambda: recorded_serve(serve, args + extra), needs))
        drive("serve llama2-7b smoke --serve-http",
              lambda: serve_http_cli(serve),
              ("restore_kv_grouped", "decode_attention", "flash_attention"))
    gc.collect()
    torch.cuda.empty_cache()
    mesh_rows, mesh_slices = [], []

    def drive_mesh_family(name, kind, model, params, needs):
        """The mesh runs of a hybrid or enc-dec phase on its loaded model,
        then in fp32 on a shallow one (which frees the loaded one's
        copies first), then kernel #3 on every slice shape they gave it
        against its plain version."""
        rows, shapes = drive(f"mesh serving {name}",
                             lambda: run_mesh_families(card, model, params),
                             needs)
        gc.collect()
        torch.cuda.empty_cache()
        rows32, shapes32 = drive(
            f"mesh serving {name} fp32",
            lambda: run_mesh_families_fp32(card, kind), needs)
        t0 = time.perf_counter()
        mesh_slices.extend(check_mesh_decode(card, {**shapes, **shapes32}))
        phase_s[f"mesh serving {name} kernel checks"] = \
            time.perf_counter() - t0
        mesh_rows.extend(rows + rows32)

    if want("llama2-7b", "mesh"):
        model, params = build_model()
    if want("llama2-7b"):
        run_llama_phases(drive, phase_s, model, params)
    if want("mesh"):
        # the reference's mesh serving programs, every shard on the card
        mesh_rows, slice_shapes = drive(
            "mesh serving", lambda: run_mesh_phase(card, model, params),
            ("restore_kv_grouped", "decode_attention", "flash_attention"))
        t0 = time.perf_counter()
        mesh_slices.extend(check_mesh_decode(card, slice_shapes))
        phase_s["mesh serving kernel checks"] = time.perf_counter() - t0
    if want("llama2-7b", "mesh"):
        del model, params                              # free llama2-7b
        gc.collect()
        torch.cuda.empty_cache()
    lm_needs = ("restore_kv_grouped", "decode_attention", "flash_attention")
    if want("qwen2-7b"):
        # qwen2-7b at full width and QWEN_LAYERS layers: the lifecycle,
        # then the engine on both backends (phased), under every gate of
        # llama2-7b's runs
        model, params = build_model("qwen2-7b", layers=QWEN_LAYERS)
        drive("qwen2-7b lifecycle", lambda: run_main_path(model, params),
              lm_needs)
        runs, plain = {}, {}
        for backend, decode_kernel in (("contiguous", "decode_attention"),
                                       ("paged", "decode_attention_paged")):
            runs[backend] = drive(
                f"qwen2-7b engine {backend}",
                lambda b=backend: run_engine(model, params, b),
                ("restore_kv_grouped", decode_kernel, "flash_attention"))
            hold_against_plain(f"qwen2-7b engine {backend}", model, params,
                               runs[backend], plain)
        check_engine(runs["contiguous"], runs["paged"], "qwen2-7b ")
        del model, params, runs, plain                 # free qwen2-7b
        gc.collect()
        torch.cuda.empty_cache()
    if want("gemma2-9b"):
        # gemma2-9b at full width and GEMMA_LAYERS layers through the
        # lifecycle: a session whose prompt outruns the 4096-token window
        # of the local layers in prefill, restore, the recompute replay
        # and decode, and a short one
        model, params = build_model("gemma2-9b", layers=GEMMA_LAYERS)
        drive("gemma2-9b lifecycle",
              lambda: run_main_path(model, params, GEMMA_PROMPTS), lm_needs)
        del model, params                              # free gemma2-9b
        gc.collect()
        torch.cuda.empty_cache()
    if want("moe-vlm"):
        serve_moe_vlm(drive)
    if want("ssm", "mesh"):
        model, params = build_ssm_model()
    if want("ssm"):
        drive("ssm lifecycle", lambda: run_ssm_lifecycle(model, params),
              ("ssm_update",))
        requests = drive("ssm engine contiguous",
                         lambda: run_ssm_engine(model, params),
                         ("ssm_update",))
        t1 = time.perf_counter()
        worst = check_against_plain(model, params, requests, {})
        print(f"{SSM_ARCH} engine against the plain forward (6 requests, "
              f"{time.perf_counter() - t1:.1f} s): logits relative error "
              f"max {worst['cold']:.5f} at first tokens, "
              f"{worst['decode']:.5f} at decoded tokens (limit {PLAIN_REL}"
              f"); generated tokens at most {worst['gap']:.4f} std below "
              f"the plain best (limit {PLAIN_GAP})")
        del requests
    if want("mesh"):
        # the mesh programs of the ssm family: ssm_inner over model
        mesh_rows.append(drive(
            "mesh serving falcon-mamba-7b",
            lambda: run_mesh_ssm(card, model, params, MESH_SSM_SHAPE, 2,
                                 MESH_SSM_SEQ), ("ssm_update",)))
        mesh_s = sum(v for k, v in phase_s.items()
                     if k.startswith("mesh serving"))
        print(f"mesh serving: {mesh_s:.1f} s in all ({card})"
              + (f", over its budget of {MESH_PHASE_BUDGET_S:.0f} s"
                 if mesh_s > MESH_PHASE_BUDGET_S else
                 f", inside its budget of {MESH_PHASE_BUDGET_S:.0f} s"))
    if want("ssm", "mesh"):
        del model, params                              # free falcon-mamba
        gc.collect()
        torch.cuda.empty_cache()
    if want("hybrid"):
        model, params = build_hybrid_model()
        hybrid_needs = ("restore_kv_grouped", "decode_attention",
                        "flash_attention")
        drive("hybrid lifecycle", lambda: run_hybrid_lifecycle(model, params),
              hybrid_needs)
        requests = drive("hybrid engine contiguous",
                         lambda: run_hybrid_engine(model, params),
                         hybrid_needs)
        t1 = time.perf_counter()
        n = check_hybrid_engine(model, params, requests)
        print(f"{HYBRID_ARCH} engine against a B=1 pass over each request "
              f"({len(requests)} requests, {time.perf_counter() - t1:.1f} "
              f"s): the logits of all {n} tokens bitwise equal, every token "
              "the pass's greedy choice")
        del requests
        # the reference's mesh serving programs: Mamba2 over ssm_heads
        drive_mesh_family(HYBRID_ARCH, "hybrid", model, params,
                          hybrid_needs)
        del model, params                              # free zamba2-2.7b
        gc.collect()
        torch.cuda.empty_cache()
    if want("encdec"):
        # whisper-medium at full size: the lifecycle, then the engine on
        # both backends (phased), every request against the plain forward
        model, params = build_encdec_model()
        encdec_needs = ("restore_kv_grouped", "decode_attention",
                        "flash_attention")
        drive(f"{ENCDEC_ARCH} lifecycle",
              lambda: run_encdec_lifecycle(model, params), encdec_needs)
        runs, plain = {}, {}
        for backend in ("contiguous", "paged"):
            runs[backend] = drive(
                f"{ENCDEC_ARCH} engine {backend}",
                lambda b=backend: run_encdec_engine(model, params, b),
                encdec_needs + (("decode_attention_paged",)
                                if backend == "paged" else ()))
            hold_against_plain(f"{ENCDEC_ARCH} engine {backend}", model,
                               params, runs[backend], plain)
        check_engine(runs["contiguous"], runs["paged"], f"{ENCDEC_ARCH} ",
                     methods=("hidden",))
        del runs, plain
        # the reference's mesh serving programs: the cross K/V split
        # along the context
        drive_mesh_family(ENCDEC_ARCH, "encdec", model, params,
                          encdec_needs)
        del model, params                              # free whisper-medium
        gc.collect()
        torch.cuda.empty_cache()
    if want("train"):
        run_training_phases(card, drive, phase_s, counts, kernels)
    dryrun_rows = []
    if want("dryrun"):
        dryrun_rows = drive("dryrun", lambda: run_dryrun_phase(card),
                            ("restore_kv_grouped", "decode_attention",
                             "flash_attention"))
        print(f"dryrun: {phase_s['dryrun']:.1f} s ({card})"
              + (f", over its budget of {DRYRUN_BUDGET_S:.0f} s"
                 if phase_s["dryrun"] > DRYRUN_BUDGET_S else
                 f", inside its budget of {DRYRUN_BUDGET_S:.0f} s"))
    if kernels:
        for k in kernels:
            k["launches"] = counts.get(k["name"], 0)
        kernels[0]["launches_by_regime"] = regimes
        print("restore_kv_grouped launches by regime over the paths: "
              f"{regimes}")
        for s in kernels[3]["shapes"]:
            s["launches"] = flash_shapes[1, s["Sq"], s["Skv"]]
        kernels[3]["launches_by_class"] = flash_shape_classes(flash_shapes)
        print("flash_attention launches at the timed shapes: " + ", ".join(
            f"{s['Sq']} over {s['hist']}: {s['launches']}"
            for s in kernels[3]["shapes"]))
        print("flash_attention launches by shape class over the paths: "
              f"{kernels[3]['launches_by_class']}")
        if mesh_rows:
            kernels[1]["mesh_slices"] = mesh_slices
            kernels[1]["mesh_runs"] = mesh_rows
    elif mesh_rows:
        print(json.dumps({"mesh_runs": mesh_rows,
                          "mesh_slices": mesh_slices}))
    if dryrun_rows:
        print(json.dumps({"dryrun": dryrun_rows}))
    print("seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_s.items())
        + f"; {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    if kernels:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
