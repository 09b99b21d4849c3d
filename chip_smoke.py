#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU and the repository checkout around this file. It

  1. prints the toolchain and the card, and builds the CUDA kernels from
     ``src/repro_torch/kernels/csrc`` (into ``build/kernels``);
  2. holds each kernel against its plain PyTorch version at the main
     path's shapes (plus one extra case each, and fp32 cases) and times
     kernel, plain version and a PyTorch yardstick with CUDA events;
  3. drives the main path: llama2-7b at full width and depth in bf16,
     random weights from a seed, 3 sessions x 2 rounds of
     prefill -> save -> decode (saving hidden states) -> evict -> restore,
     checking restored K/V, greedy decoding (MATCH) and round 1's first
     token against a cache that was never evicted, and that both kernels
     were launched;
  4. prints the kernels' JSON line, then the device line last.

Any failed check raises, so the script exits non-zero and prints no
result. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Published dense peaks (NVIDIA data sheets): bf16 tensor FLOP/s, HBM B/s.
PEAKS = {"sxm": (989e12, 3.35e12), "pcie": (756e12, 2.0e12)}

# |kernel - plain| <= RTOL * |plain| + ATOL, compared in fp32. bf16 keeps
# 8 significant bits: the two outputs are each rounded to bf16 from fp32
# sums taken in another order, so they may differ by one bf16 ulp
# (2^-7 relative); ATOL covers values near zero. fp32 outputs differ only
# by the order of the sums.
TOL = {"bf16": (2.0 ** -7, 1e-3), "fp32": (1e-4, 1e-5)}

SEED = 0
PROMPTS = (1024, 1536, 2000)      # round 0; 2000 exercises bucket padding
ROUND1_TOKENS = 256
DECODE_TOKENS = 16
MATCH_TOKENS = 8


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def card_peaks(name: str):
    return PEAKS["pcie" if "PCIe" in name else "sxm"]


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


def bound(flops: float, nbytes: float, name: str):
    peak_flops, peak_bw = card_peaks(name)
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_close(what: str, got, want, dtype_name: str) -> float:
    rtol, atol = TOL[dtype_name]
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(got.isfinite().all()):
        raise AssertionError(f"{what}: bad shape or non-finite output")
    err = (got - want).abs()
    bad = err > rtol * want.abs() + atol
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside "
                             f"tolerance, max abs err {float(err.max())}")
    return float(err.max())


# ----------------------------------------------------------- kernel checks
def restore_case(G, S, D, KV, hd, A, rows, bias, dtype, gen):
    import torch
    from repro_torch.models.layers.rope import rope_table
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    hidden = rnd(G, S, D)
    wk, wv = rnd(A, D, KV, scale=D ** -0.5), rnd(A, D, KV, scale=D ** -0.5)
    bk, bv = (rnd(A, KV), rnd(A, KV)) if bias else (None, None)
    cos, sin = rope_table(S, hd, 10000.0, dev)
    args = (hidden, wk, wv, bk, bv,
            torch.tensor(rows, dtype=torch.int32, device=dev),
            cos[:S].contiguous(), sin[:S].contiguous())
    return args


def check_row_invariance(rkv, args, full, hd):
    """The same rows launched at other tile offsets and group positions
    give bitwise-equal K/V: what makes restored K/V equal prefill's."""
    hidden, wk, wv, bk, bv, rows, cos, sin = args
    a, b = 5, 5 + min(300, hidden.shape[1] - 5)
    part = rkv.restore_kv_grouped_cuda(
        hidden[1:2, a:b].contiguous(), wk, wv, bk, bv,
        rows[1:2].contiguous(), cos[a:b].contiguous(), sin[a:b].contiguous(),
        head_dim=hd)
    for got, want in zip(part, full):
        if not torch_equal(got, want[1:2, a:b]):
            raise AssertionError("restore kernel output depends on the "
                                 "row's position in the launch")


def torch_equal(x, y) -> bool:
    import torch
    return bool(torch.equal(x, y))


def check_restore(card: str, gen):
    import torch
    from repro_torch.kernels import restore_kv as rkv
    kw = dict(head_dim=128, use_rope=True)
    # main path: one 8-layer group of llama2-7b at S = 1024
    G, S, D, KV = 8, 1024, 4096, 4096
    args = restore_case(G, S, D, KV, 128, 32, list(range(8, 16)), False,
                        torch.bfloat16, gen)
    k, v = rkv.restore_kv_grouped_cuda(*args, **kw)
    torch.cuda.synchronize()
    pk, pv = rkv.restore_kv_grouped_plain(*args, **kw)
    err = max(check_close("restore K (main)", k, pk, "bf16"),
              check_close("restore V (main)", v, pv, "bf16"))
    check_row_invariance(rkv, args, (k, v), 128)
    ms = time_ms(lambda: rkv.restore_kv_grouped_cuda(*args, **kw), 20)
    plain_ms = time_ms(lambda: rkv.restore_kv_grouped_plain(*args, **kw),
                       3, warmup=0)
    hidden, wk, wv, _, _, rows = args[:6]
    w_cat = torch.cat([wk[rows.long()], wv[rows.long()]], -1)
    lib_ms = time_ms(lambda: torch.matmul(hidden, w_cat), 20)
    flops = 2 * G * S * D * 2 * KV
    nbytes = 2 * (G * S * D + 2 * G * D * KV + 2 * G * S * KV) \
        + 2 * 4 * S * 64
    bound_ms, bound_by = bound(flops, nbytes, card)
    print(f"restore_kv_grouped G={G} S={S} D={D} KV={KV} hd=128 bf16: "
          f"max_abs_err {err:.3g}; kernel {ms:.3f} ms, plain {plain_ms:.1f}"
          f" ms (median of 3), torch.matmul K|V yardstick {lib_ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({bound_by}; {flops / 1e9:.0f} GFLOP, "
          f"{nbytes / 1e6:.0f} MB)")
    # extra cases: hd=96 with bias and S off the tile, hd=80, fp32
    for hd, bias, dtype, name in ((96, True, torch.bfloat16, "bf16"),
                                  (96, True, torch.float32, "fp32"),
                                  (80, False, torch.float32, "fp32")):
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
    return {"name": "restore_kv_grouped", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/restore_kv.cu",
            "replaces": "src/repro/kernels/restore_kv.py:138",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def decode_case(B, Kv, G, Smax, hd, lens, dtype, gen):
    import torch
    dev = "cuda"
    q = torch.randn(B * Kv, G, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Smax, Kv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Smax, Kv, hd, generator=gen, device=dev).to(dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32,
                          device=dev).repeat_interleave(Kv)
    return q, k, v, kv_len


def check_decode(card: str, gen):
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
          f"bf16: max_abs_err {err:.3g}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA yardstick {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB)")
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
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:145",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


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
            save[0].save_decode_hidden([save[1]], hidden, lengths.cpu())
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


def build_model():
    """llama2-7b at full width and depth, bf16, random weights from SEED,
    warmed by one short prefill and decode step (library handles and
    allocator pools), so the served requests' times exclude that set-up."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.models.module import count_params

    cfg = get_arch("llama2-7b")
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
    print(f"llama2-7b: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads}x{cfg.head_dim_} heads, d_ff={cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {n_params / 1e9:.2f} B params bf16 "
          f"({2 * n_params / 1e9:.1f} GB); init and warm-up "
          f"{_sync_s(t0):.1f} s on {model.device}")
    return model, params


def run_main_path(model, params):
    """3 sessions x 2 rounds through the HCache manager."""
    import numpy as np
    from repro_torch.core.hcache import HCacheManager
    from repro_torch.storage import ChunkStore, make_array

    store = ChunkStore(make_array("ssd", 4), chunk_tokens=64)
    managers = [HCacheManager(model, store, schedule_override="hidden",
                              restore_group_size=8),
                HCacheManager(model, store, restore_group_size=8)]
    rng = np.random.default_rng(SEED)
    try:
        for s, n0 in enumerate(PROMPTS):
            mgr = managers[0 if s == 0 else 1]
            plan = mgr.plan(n0)
            print(f"session {s}: schedule for {n0} tokens: "
                  f"{plan.summary()}; methods "
                  f"{''.join(m[0].upper() for m in plan.methods)}")
            serve_session(model, params, mgr, f"s{s}", n0, rng)
    finally:
        for m in managers:
            m.close()


def _sync_s(t0):
    import torch
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def serve_session(model, params, mgr, session, n0, rng):
    """Two rounds of one session; raises on any disagreement with the
    never-evicted cache ``ref``."""
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
            out = model.prefill(params, {"tokens": toks[None]},
                                capture_hidden=True)
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
        print(f"{session} round {rnd}: {n_new} new tokens on {n_hist} of "
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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SystemExit(f"chip_smoke: {SRC}/repro_torch not found; run "
                         "from a checkout of the repository")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import restore_kv as rkv

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
    kernels = [check_restore(card, gen), check_decode(card, gen)]

    model, params = build_model()
    rkv.launches = dec.launches = 0
    t0 = time.perf_counter()
    run_main_path(model, params)
    counts = {"restore_kv_grouped": rkv.launches,
              "decode_attention": dec.launches}
    print(f"main path done in {time.perf_counter() - t0:.1f} s; kernel "
          f"launches {counts}")
    for k in kernels:
        k["launches"] = counts[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never ran on the main path")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
