"""Restoration pipeline: event-driven timeline of the two streams.

The paper overlaps per-layer hidden-state transmission with the previous
layer's KV projection (Fig 5). The *timing* comes from
replaying the restoration executor's task graph over a hardware profile,
while the *functional* restoration (actual tensors) runs through the same
graph in ``core/restoration.py`` — one source of truth for both.

Stream rules (paper §4.1):
  * recompute layers form a prefix and run on the compute stream from t=0;
  * hidden-state fetches go first on the IO stream (so projections can
    start), KV fetches fill the IO tail;
  * a layer's projection starts when its fetch has completed and the
    compute stream is free.

``simulate`` returns per-stream busy/idle so benchmarks can report bubble
fractions (Fig 12) and the TTFT decomposition (Figs 9/10).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.config.arch import ArchConfig
from repro_torch.config.hardware import GEMM_EFFICIENCY, HardwareProfile
from repro_torch.core.cost_model import MethodTimes, layer_costs, method_times


@dataclasses.dataclass(frozen=True)
class Timeline:
    makespan: float
    io_busy: float
    compute_busy: float
    io_finish: float
    compute_finish: float

    @property
    def io_bubble(self) -> float:
        return 1.0 - self.io_busy / self.makespan if self.makespan else 0.0

    @property
    def compute_bubble(self) -> float:
        return (1.0 - self.compute_busy / self.makespan
                if self.makespan else 0.0)


def simulate(methods: Sequence[str], times: Sequence[MethodTimes], *,
             group_size=1,
             dispatch_overhead: float = 0.0,
             cross: bool = False, cross_times=None) -> Timeline:
    """Simulate a restoration schedule. methods[i] in {hidden, kv, recompute}.

    Thin wrapper over the restoration executor's task graph: the same
    ``compile_tasks`` + ``replay`` that drive the serving engine's
    incremental execution produce this timeline, so the simulated and the
    executed orders cannot drift apart (see core/restoration.py).
    ``group_size`` — a uniform width or a tuple of widths (fetch-aligned
    partition) — coalesces projections into grouped compute tasks and
    ``dispatch_overhead`` charges the per-dispatch launch cost once per
    compute task — the batched data path's makespan knob (DESIGN.md §10).
    ``cross``/``cross_times`` add the enc-dec encoder-blob read and
    cross-KV projection tasks (DESIGN.md §11)."""
    from repro_torch.core.restoration import compile_tasks, replay
    return replay(compile_tasks(methods, group_size=group_size, cross=cross),
                  times, dispatch_overhead=dispatch_overhead,
                  cross_times=cross_times)


def restore_timeline(cfg: ArchConfig, n_tokens: int, hw: HardwareProfile,
                     methods: Sequence[str],
                     dtype_bytes: int = 2, *,
                     group_size=1, profile=None,
                     io_streams: int = 1) -> Timeline:
    times = [method_times(c, hw, profile=profile, io_streams=io_streams)
             for c in layer_costs(cfg, n_tokens, dtype_bytes)]
    overhead = getattr(hw, "dispatch_overhead", 0.0)
    if profile is not None:
        measured = profile.dispatch_overhead()
        if measured is not None:
            overhead = measured
    return simulate(methods, times, group_size=group_size,
                    dispatch_overhead=overhead)


# --------------------------------------------------------- serving estimates
def prefill_time(cfg: ArchConfig, n_new: int, n_hist: int,
                 hw: HardwareProfile,
                 gemm_eff: float = GEMM_EFFICIENCY) -> float:
    """Prefill of ``n_new`` prompt tokens attending over restored history."""
    D, n_q, kv = cfg.d_model, cfg.n_heads * cfg.head_dim_, cfg.kv_dim
    flops = 0.0
    from repro_torch.config.arch import BlockKind
    for kind in cfg.block_kinds():
        if kind == BlockKind.ATTENTION:
            proj = n_new * 2 * (D * n_q + 2 * D * kv + n_q * D)
            ctx = n_hist + n_new
            if cfg.local_window:
                ctx = min(ctx, cfg.local_window)
            quad = 2 * n_new * ctx * n_q * 2
            ffn_mults = 3 if cfg.ffn_glu else 2
            k = cfg.experts_per_token if cfg.n_experts else 1
            ffn = n_new * 2 * ffn_mults * D * cfg.d_ff * k
            flops += proj + quad + ffn
        else:
            inner = cfg.ssm_expand * D
            flops += n_new * (2 * D * 4 * inner + inner * cfg.ssm_state * 6)
    flops += n_new * 2 * D * cfg.vocab_size  # lm head (last token only, ~0)
    return flops / (hw.flops * gemm_eff)


def decode_step_time(cfg: ArchConfig, batch: int, ctx: int,
                     hw: HardwareProfile) -> float:
    """One decode step: max(compute, HBM-bound weight+KV reads)."""
    n_active = cfg.active_param_count()
    flops_t = 2 * n_active * batch / hw.flops
    kv_bytes = cfg.n_layers * 2 * cfg.kv_dim * ctx * 2 * batch
    mem_t = (n_active * 2 + kv_bytes) / hw.hbm_bw
    return max(flops_t, mem_t)


def ttft(cfg: ArchConfig, n_hist: int, n_new: int, hw: HardwareProfile,
         methods: Sequence[str], dtype_bytes: int = 2) -> float:
    """Restoration + prefill = time-to-first-token (paper's headline metric)."""
    restore = restore_timeline(cfg, n_hist, hw, methods, dtype_bytes).makespan
    return restore + prefill_time(cfg, n_new, n_hist, hw)
