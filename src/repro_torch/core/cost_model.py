"""HCache restoration cost model (paper §3.2), generalized to GQA/MoE/SSM.

All quantities are per-layer for a history of ``n_tokens``:

  IO_H    bytes to fetch hidden states      = n·D·dtype
  IO_KV   bytes to fetch the KV cache       = n·2·kv_dim·dtype
  C_H     FLOPs to project H -> K,V         = n·2·D·(2·kv_dim)
  C_RE    FLOPs to recompute from tokens    = attention + FFN (quadratic term)

For MHA (kv_dim == D) these reduce exactly to the paper's formulas:
IO_H = IO_KV/2 and C_RE/C_H = 6 + n/(4·D). For GQA the ratios shift (the
paper scopes this out in §7); the bubble-free scheduler consumes these
numbers and adapts — see DESIGN.md §3.

SSM layers (mamba) have no KV; their "restore" is the ssm-rescan (state
recompute from the layer's saved input), costed at the state-recurrence
FLOPs only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.config.arch import ArchConfig, BlockKind
from repro_torch.config.hardware import GEMM_EFFICIENCY, HardwareProfile


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """Per-layer restoration costs for one layer *class*."""

    kind: str                     # "attention" | "mamba1" | "mamba2"
    io_hidden: float              # bytes
    io_kv: float                  # bytes (0 for SSM: state is tiny/kept)
    io_state: float               # bytes of the recurrent state (SSM)
    c_hidden: float               # FLOPs: restore from hidden
    c_token: float                # FLOPs: recompute from tokens (full layer)
    store_hidden: float           # bytes/token stored when managed as H
    store_kv: float               # bytes/token stored when managed as KV


def attn_layer_cost(cfg: ArchConfig, n_tokens: int,
                    dtype_bytes: int = 2) -> LayerCost:
    D = cfg.d_model
    kv = cfg.kv_dim
    n_q = cfg.n_heads * cfg.head_dim_
    io_h = n_tokens * D * dtype_bytes
    io_kv = n_tokens * 2 * kv * dtype_bytes
    # HCache restore: K and V projections (+ rope, negligible)
    c_h = n_tokens * 2 * D * (2 * kv)
    # full recompute: qkvo projections + scores/weighted-sum + FFN
    c_attn_proj = n_tokens * 2 * (D * n_q + 2 * D * kv + n_q * D)
    # causal: ~n²/2 (q,k) pairs × (QK^T + PV) × 2 FLOPs/MAC × n_q
    c_attn_quad = 2 * n_tokens * n_tokens * n_q
    if cfg.local_window:
        w = min(cfg.local_window, n_tokens)
        c_attn_quad = 4 * n_tokens * w * n_q
    ffn_mults = 3 if cfg.ffn_glu else 2
    if cfg.n_experts:
        c_ffn = n_tokens * 2 * ffn_mults * D * cfg.d_ff * cfg.experts_per_token
    else:
        c_ffn = n_tokens * 2 * ffn_mults * D * cfg.d_ff
    c_re = c_attn_proj + c_attn_quad + c_ffn
    return LayerCost("attention", io_h, io_kv, 0.0, c_h, c_re,
                     D * dtype_bytes, 2 * kv * dtype_bytes)


def mamba_layer_cost(cfg: ArchConfig, n_tokens: int, kind: BlockKind,
                     dtype_bytes: int = 2) -> LayerCost:
    D = cfg.d_model
    inner = cfg.ssm_expand * D
    N = cfg.ssm_state
    io_h = n_tokens * D * dtype_bytes
    # the recurrent state is O(1) in tokens; offloading it is the "KV" analog
    if kind == BlockKind.MAMBA2:
        n_heads = inner // cfg.ssm_headdim
        state_bytes = n_heads * cfg.ssm_headdim * N * 4
        # rescan: in_proj + conv + state recurrence (no output path)
        c_h = n_tokens * 2 * D * (2 * inner + 2 * N + n_heads) * 0.5 \
            + n_tokens * inner * N * 4
        c_re = n_tokens * 2 * D * (2 * inner + 2 * N + n_heads) \
            + n_tokens * inner * N * 6 + n_tokens * 2 * inner * D
    else:
        state_bytes = inner * N * 4
        dt_rank = max(D // 16, 1)
        c_h = n_tokens * 2 * D * inner + n_tokens * inner * N * 4
        c_re = (n_tokens * 2 * D * 2 * inner
                + n_tokens * 2 * inner * (dt_rank + 2 * N)
                + n_tokens * inner * N * 6 + n_tokens * 2 * inner * D)
    return LayerCost(kind.value, io_h, 0.0, state_bytes, c_h, c_re,
                     D * dtype_bytes, 0.0)


def layer_costs(cfg: ArchConfig, n_tokens: int,
                dtype_bytes: int = 2) -> list:
    """One LayerCost per layer of the stack, in order."""
    out = []
    for kind in cfg.block_kinds():
        if kind == BlockKind.ATTENTION:
            out.append(attn_layer_cost(cfg, n_tokens, dtype_bytes))
        else:
            out.append(mamba_layer_cost(cfg, n_tokens, kind, dtype_bytes))
    return out


# ------------------------------------------------------------------ timings
@dataclasses.dataclass(frozen=True)
class MethodTimes:
    """Seconds per layer under a hardware profile (paper §4.1.2 symbols)."""

    io_h: float       # IO_H
    io_kv: float      # IO_KV
    c_h: float        # C_H
    c_token: float    # C_Token

    @property
    def hcache_bound(self) -> float:
        return max(self.io_h, self.c_h)


def method_times(cost: LayerCost, hw: HardwareProfile,
                 gemm_eff: float = GEMM_EFFICIENCY, *,
                 profile=None, io_streams: int = 1,
                 link: Optional[int] = None) -> MethodTimes:
    """Seconds per layer. With a ``MeasuredProfile`` the observed marginal
    rates (seconds/byte, seconds/FLOP) replace the datasheet numbers for
    every kind that has samples; unmeasured kinds keep the static model.
    ``io_streams`` prices shared host-link/storage bandwidth: N sessions
    restoring concurrently each see 1/N of the link, so IO legs stretch
    N-fold while compute legs (per-chip) do not. ``link`` selects the
    per-NIC-link learned rate for the IO kinds when the profile has one
    (distributed store; see ``link_priced_times``).

    ``hw.mesh_devices`` > 1 (DESIGN.md §16) divides the projection
    compute across the tensor-parallel shards — each device projects
    only its KV heads, so C_H scales ÷shards. Recompute stays whole (the
    block-forward rebuild runs replicated, not head-sharded) and the IO
    legs are host-side, untouched by device multiplicity."""
    flops = hw.flops * gemm_eff
    bw = min(hw.storage_bw, hw.host_link_bw)
    m = max(int(io_streams), 1)
    shards = max(int(getattr(hw, "mesh_devices", 1)), 1)
    io_h = cost.io_hidden / bw
    io_kv = cost.io_kv / bw if cost.io_kv else cost.io_state / bw
    c_h = cost.c_hidden / (flops * shards)
    c_token = cost.c_token / flops
    if profile is not None:
        r = profile.rate("io_h", link=link)
        if r is not None:
            io_h = cost.io_hidden * r
        r = profile.rate("io_kv", link=link)
        if r is not None:
            io_kv = (cost.io_kv or cost.io_state) * r
        r = profile.rate("project", mesh=shards)
        if r is not None:
            c_h = cost.c_hidden * r
        r = profile.rate("recompute")
        if r is not None:
            c_token = cost.c_token * r
    return MethodTimes(io_h=io_h * m, io_kv=io_kv * m,
                       c_h=c_h, c_token=c_token)


class LinkLoad:
    """Concurrent restore-stream counts per NIC link.

    The engine reports, for each link of the distributed store, how many
    RESTORING sessions currently have IO in flight on it. Planners then
    charge contention only on the links a candidate restore actually
    touches — ``factor(links)`` is the max load over the touched links
    (the slowest link gates the stripe), replacing PR 7's global
    ``io_streams`` stretch which taxed every restore for every other
    restore even on disjoint links."""

    __slots__ = ("streams",)

    def __init__(self, streams: Optional[Dict[int, int]] = None):
        self.streams = {int(k): int(v)
                        for k, v in (streams or {}).items() if int(v) > 0}

    def factor(self, links: Sequence[int]) -> int:
        if not self.streams:
            return 1
        return max([self.streams.get(int(l), 0) for l in links] + [1])

    def key(self) -> Tuple[Tuple[int, int], ...]:
        """Hashable identity for plan-cache keys."""
        return tuple(sorted(self.streams.items()))

    def __repr__(self):
        return f"LinkLoad({self.streams})"


def link_priced_times(costs: Sequence[LayerCost], hw: HardwareProfile,
                      gemm_eff: float = GEMM_EFFICIENCY, *,
                      profile=None, io_streams: int = 1,
                      topology=None, link_load: Optional[LinkLoad] = None,
                      aggregate: bool = False)\
        -> Tuple[List[MethodTimes], Optional[Dict[int, int]]]:
    """Per-layer times priced on the links each layer's IO touches.

    Without a topology (one-host store) this is the legacy model: every
    IO leg stretched uniformly by ``io_streams``. With a sharded store:

      * ``layer`` placement — layer L's IO occupies exactly link L%N.
        Contention = load on that one link. Returns full per-layer IO
        durations plus a ``{layer: link}`` map; the restoration replay
        runs one virtual IO clock per link, so layers on different
        links genuinely overlap. ``aggregate=True`` (for planners that
        sum IO serially, e.g. the layer-split solver) instead divides
        the IO legs by N — the balanced-stripe approximation of the
        per-link max — and returns no map.
      * ``chunk`` placement — every layer stripes all N links: IO legs
        aggregate N links' bandwidth (÷N) but pay the max load across
        all of them. No per-layer map (no link-level parallelism left
        to expose between layers).

    ``topology`` is duck-typed (``n_shards``/``placement``/
    ``links_for_layer``) so planning code needs no storage import."""
    if topology is None or topology.n_shards <= 1:
        times = [method_times(c, hw, gemm_eff, profile=profile,
                              io_streams=io_streams) for c in costs]
        return times, None
    n = topology.n_shards
    chunk_mode = topology.placement == "chunk"
    all_links = tuple(range(n))
    times: List[MethodTimes] = []
    layer_links: Dict[int, int] = {}
    for li, c in enumerate(costs):
        links = all_links if chunk_mode else topology.links_for_layer(li)
        if link_load is not None:
            m = link_load.factor(links)
        else:
            m = max(int(io_streams), 1)
        link = None if chunk_mode else links[0]
        t = method_times(c, hw, gemm_eff, profile=profile,
                         io_streams=m, link=link)
        if chunk_mode or aggregate:
            t = dataclasses.replace(t, io_h=t.io_h / n, io_kv=t.io_kv / n)
        else:
            layer_links[li] = links[0]
        times.append(t)
    return times, (None if (chunk_mode or aggregate) else layer_links)


def restoration_time(cfg: ArchConfig, n_tokens: int, hw: HardwareProfile,
                     method: str, dtype_bytes: int = 2) -> float:
    """End-to-end restoration time for a *single-method* scheme.

    method in {"hcache", "kv_offload", "recompute"}. The HCache pipeline
    overlaps IO and compute (paper Fig 5): bound = max(ΣIO_H, ΣC_H) + one
    layer's lead-in (negligible, dropped as in §3.2)."""
    total_io_h = total_io_kv = total_c_h = total_c_re = 0.0
    for cost in layer_costs(cfg, n_tokens, dtype_bytes):
        t = method_times(cost, hw)
        total_io_h += t.io_h
        total_io_kv += t.io_kv
        total_c_h += t.c_h
        total_c_re += t.c_token
    if method == "hcache":
        return max(total_io_h, total_c_h)
    if method == "kv_offload":
        return total_io_kv
    if method == "recompute":
        return total_c_re
    raise ValueError(method)


def storage_per_token(cfg: ArchConfig, schedule, dtype_bytes: int = 2) -> float:
    """Bytes/token stored under a schedule (Table 3). ``schedule`` is a
    sequence of per-layer methods from repro_torch.core.scheduler."""
    costs = layer_costs(cfg, 1, dtype_bytes)
    total = 0.0
    for cost, m in zip(costs, schedule):
        if m == "hidden":
            total += cost.store_hidden
        elif m == "kv":
            # SSM layers: "kv" = state-blob offload, O(1) in tokens
            total += cost.store_kv if cost.kind == "attention" else 0.0
        # recompute: nothing stored (tokens are negligible)
    return total
