"""Bubble-free restoration scheduler (paper §4.1).

Partitions the model's layers between restoration methods so the compute
stream and the IO stream finish (nearly) simultaneously:

    argmin_{L_H, L_O}  max(C_H·L_H,  IO_H·L_H + IO_KV·L_O)
    s.t. L_H + L_O = N_layers                       (paper min-max)

Two solvers:
  * ``closed_form`` — the paper's §4.1.2 formulas (two-method schemes).
  * ``solve``       — exhaustive search over (L_H, L_KV, L_RE) including the
    three-method mix and heterogeneous layer classes (attention vs mamba),
    which the paper does not need (its models are homogeneous MHA) but our
    assigned archs do. For N ≤ 128 layers this is exact and instant.

Layer placement follows the paper: recompute layers must be a *prefix*
(layer i's recompute consumes layer i-1's output), KV/H layers are ordered
to keep the IO stream busy from t=0.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.config.arch import ArchConfig
from repro_torch.config.hardware import HardwareProfile
from repro_torch.core.cost_model import (LayerCost, MethodTimes,
                                         layer_costs, link_priced_times,
                                         method_times)

METHODS = ("hidden", "kv", "recompute")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Per-layer restoration methods + predicted timing."""

    methods: Tuple[str, ...]          # len == n_layers, in layer order
    compute_time: float               # seconds on the compute stream
    io_time: float                    # seconds on the IO stream
    makespan: float
    bubble: float                     # |compute - io| / makespan

    @property
    def counts(self):
        return {m: self.methods.count(m) for m in METHODS}

    def tasks(self):
        """The ordered restoration task graph this schedule compiles to —
        the same graph the executor runs and ``pipeline.simulate``
        replays (core/restoration.compile_tasks)."""
        from repro_torch.core.restoration import compile_tasks
        return compile_tasks(self.methods)

    def summary(self) -> str:
        c = self.counts
        return (f"{c['hidden']} H + {c['kv']} KV + {c['recompute']} RE | "
                f"compute {self.compute_time * 1e3:.2f}ms io "
                f"{self.io_time * 1e3:.2f}ms bubble {self.bubble:.1%}")


def closed_form(n_layers: int, t: MethodTimes) -> Tuple[int, int]:
    """Paper §4.1.2: (L_H, L_O). Complementary method is KV offload when
    compute is the bottleneck (C_H > IO_H), token recompute otherwise."""
    if t.c_h > t.io_h:
        denom = t.io_kv + t.c_h - t.io_h
        l_h = math.ceil(n_layers * t.io_kv / denom) if denom > 0 else n_layers
    else:
        denom = t.c_token + t.io_h - t.c_h
        l_h = math.ceil(n_layers * t.c_token / denom) if denom > 0 else n_layers
    l_h = max(0, min(n_layers, l_h))
    return l_h, n_layers - l_h


def _evaluate(counts_per_class, class_times, class_ids) -> Tuple[float, float]:
    """(compute_time, io_time) for per-class (n_h, n_kv, n_re) choices."""
    compute = io = 0.0
    for cid, (n_h, n_kv, n_re) in counts_per_class.items():
        t = class_times[cid]
        compute += n_h * t.c_h + n_re * t.c_token
        io += n_h * t.io_h + n_kv * t.io_kv
    return compute, io


def solve(cfg: ArchConfig, n_tokens: int, hw: HardwareProfile, *,
          dtype_bytes: int = 2, allow_recompute: bool = True,
          allow_kv: bool = True, force_hidden: bool = False,
          profile=None, io_streams: int = 1,
          topology=None, link_load=None) -> Schedule:
    """Exact min-max schedule over (possibly heterogeneous) layers.

    ``profile`` (a ``MeasuredProfile``) substitutes observed rates for the
    static hardware numbers; contention pricing shifts layers from IO
    methods toward recompute. One-host store: ``io_streams`` stretches
    every IO leg (N restores share one host link). Distributed store
    (``topology``/``link_load``): each layer's IO is priced on the links
    it touches only — the aggregate (balanced-stripe) form, since this
    solver's IO objective is a serial sum (see ``link_priced_times``)."""
    costs = layer_costs(cfg, n_tokens, dtype_bytes)
    times_per_layer, _ = link_priced_times(
        costs, hw, profile=profile, io_streams=io_streams,
        topology=topology, link_load=link_load, aggregate=True)
    # group layers into classes — identical (cost, priced time); per-link
    # pricing can split equal-cost layers into distinct classes when their
    # links carry different loads
    class_of: List[int] = []
    class_costs: List[LayerCost] = []
    class_times: List[MethodTimes] = []
    for c, t in zip(costs, times_per_layer):
        for i, (cc, ct) in enumerate(zip(class_costs, class_times)):
            if cc == c and ct == t:
                class_of.append(i)
                break
        else:
            class_costs.append(c)
            class_times.append(t)
            class_of.append(len(class_costs) - 1)
    n_per_class = [class_of.count(i) for i in range(len(class_costs))]

    # the exhaustive search is prod over classes of O(n_c^2) options;
    # unequal per-link loads can split every cost class N_links-ways.
    # When that blows past an exact-search budget, coarsen back to
    # cost-only classes with layer-count-weighted mean times — the split
    # decision degrades gracefully to average-link pricing while
    # restore_makespan keeps the exact per-link replay.
    search = 1.0
    for n in n_per_class:
        search *= (n + 1) * (n + 2) / 2
    if search > 2e5:
        class_of, class_costs = [], []
        acc: List[List[float]] = []
        for c, t in zip(costs, times_per_layer):
            for i, cc in enumerate(class_costs):
                if cc == c:
                    class_of.append(i)
                    a = acc[i]
                    a[0] += t.io_h
                    a[1] += t.io_kv
                    a[2] += 1
                    break
            else:
                class_costs.append(c)
                acc.append([t.io_h, t.io_kv, 1])
                class_of.append(len(class_costs) - 1)
        class_times = []
        for c, (io_h, io_kv, n) in zip(class_costs, acc):
            base = method_times(c, hw, profile=profile, io_streams=1)
            class_times.append(dataclasses.replace(
                base, io_h=io_h / n, io_kv=io_kv / n))
        n_per_class = [class_of.count(i) for i in range(len(class_costs))]

    # SSM classes have no KV-offload analog with io==0; their "kv" method is
    # the state offload, costed via io_state inside method_times.
    best = None

    def rec(cid, chosen):
        nonlocal best
        if cid == len(class_costs):
            compute, io = _evaluate(
                {i: c for i, c in enumerate(chosen)}, class_times,
                class_of)
            makespan = max(compute, io)
            if best is None or makespan < best[0]:
                best = (makespan, list(chosen), compute, io)
            return
        n = n_per_class[cid]
        if force_hidden:
            options = [(n, 0, 0)]
        else:
            options = []
            for n_re in range(0, n + 1 if allow_recompute else 1):
                for n_kv in range(0, n - n_re + 1 if allow_kv else 1):
                    options.append((n - n_re - n_kv, n_kv, n_re))
        for opt in options:
            chosen.append(opt)
            rec(cid + 1, chosen)
            chosen.pop()

    rec(0, [])
    makespan, per_class, compute, io = best

    # materialize per-layer methods: recompute layers must be a prefix.
    remaining = {i: list(c) for i, c in enumerate(per_class)}
    methods: List[Optional[str]] = [None] * len(costs)
    for li, cid in enumerate(class_of):          # recompute prefix first
        if remaining[cid][2] > 0:
            methods[li] = "recompute"
            remaining[cid][2] -= 1
    for li, cid in enumerate(class_of):
        if methods[li] is None:
            if remaining[cid][0] > 0:
                methods[li] = "hidden"
                remaining[cid][0] -= 1
            else:
                methods[li] = "kv"
                remaining[cid][1] -= 1
    bubble = abs(compute - io) / makespan if makespan > 0 else 0.0
    return Schedule(tuple(methods), compute, io, makespan, bubble)


def schedule_all_methods(cfg: ArchConfig, n_tokens: int,
                         hw: HardwareProfile, dtype_bytes: int = 2):
    """Schedules for the paper's baselines + HCache (benchmark helper)."""
    n = cfg.n_layers
    return {
        "hcache": solve(cfg, n_tokens, hw, dtype_bytes=dtype_bytes),
        "hcache_only": solve(cfg, n_tokens, hw, dtype_bytes=dtype_bytes,
                             force_hidden=True),
        "kv_offload": Schedule(tuple(["kv"] * n), 0.0, 0.0, 0.0, 0.0),
        "recompute": Schedule(tuple(["recompute"] * n), 0.0, 0.0, 0.0, 0.0),
    }
