"""Pipelined restoration executor (paper §4.1) for the ``lm``, ``ssm``,
``hybrid`` and ``encdec`` families.

A ``Schedule`` compiles into an ordered task graph (``compile_tasks``) of
per-layer steps: chunk-store reads of hidden states (``io_h``) and of raw
K/V (``io_kv``), whole-object reads (``blob``: an ``ssm`` or ``hybrid``
session's recurrent states), grouped hidden→K/V projections
(``project``) and recompute-prefix layers (``recompute``), and for an
enc-dec session the read of its encoder-output blob (``io_enc``) and the
cross projection (``project_cross``: the cross K/V of every decoder layer
from that one tensor, ``models.encdec.cross_kv``, as its prefill made
them), priced by ``CrossTimes``. Per-layer tasks of a layer that is not
an attention layer do nothing: such a layer is restored by the state
blob. The same graph serves:

  * ``replay``              — virtual two-stream replay of a task order
                              under a hardware profile → ``Timeline``;
  * ``RestorationExecutor`` — executes the graph, writing each finished
                              layer into a ``RestoreSink``. Its reported
                              ``Timeline`` is ``replay`` over the order it
                              actually ran, so the executor and the
                              analytic model cannot drift apart.

A projection group is one device call: the members' hidden states go up
in one upload from a pinned slot of the manager's ``StagingRing`` on its
copy stream, the model's norm and the grouped restoration kernel
(``kernels.ops.restore_kv_grouped``) run on the compute stream over the
whole weight stack indexed by row once the upload's event has fired, and
the sink receives the group in one call. A group is launched at its own
width and token count: the kernel takes any (G, S) and gives the same
bits for a row whatever the shape, so nothing is padded (the JAX
package pads to a power-of-two token bucket and the plan's widest group
to compile one shape; the plans here are still priced at that bucket).
Group plans come from the manager: a fixed width, a tuple of widths, or
the makespan argmin (``choose_group_size``) over uniform widths and the
fetch-aligned partition (``fetch_aligned_partition``), priced under the
manager's ``MeasuredProfile`` when it has one, which the executor feeds.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config.arch import BlockKind
from repro_torch.core.cost_model import (MethodTimes, layer_costs,
                                         link_priced_times, method_times)
from repro_torch.core.scheduler import Schedule
from repro_torch.distributed.tp import Sharded, gathered, on_device
from repro_torch.models.layers.rope import rope_table

# Task kinds. IO-stream: io_h (hidden fetch), io_kv (raw KV fetch),
# io_enc (enc-dec: the saved encoder-output blob, sized in S_enc), blob
# (SSM-state/token whole-object reads — O(1) in tokens, charged zero
# virtual time as in the paper's model). Compute-stream: recompute (one
# prefix layer from tokens), project (hidden → K,V GEMM for a GROUP of
# layers — one device dispatch per group), project_cross (enc-dec: the
# single encoder output → cross-KV for ALL decoder layers).
IO_KINDS = ("io_h", "io_kv", "io_enc", "blob")
COMPUTE_KINDS = ("recompute", "project", "project_cross")


@dataclasses.dataclass(frozen=True)
class Task:
    kind: str                 # io_h|io_kv|io_enc|blob|recompute|project|
    #                           project_cross
    layer: int                # global layer index (-1 for blob/enc tasks;
    #                           first member for project groups)
    dep: Optional[int] = None  # task-list index that must execute first
    layers: Optional[Tuple[int, ...]] = None   # project group members
    deps: Optional[Tuple[int, ...]] = None     # all fetches a group needs

    @property
    def stream(self) -> str:
        return "io" if self.kind in IO_KINDS else "compute"

    @property
    def members(self) -> Tuple[int, ...]:
        return self.layers if self.layers is not None else (self.layer,)

    @property
    def all_deps(self) -> Tuple[int, ...]:
        if self.deps is not None:
            return self.deps
        return () if self.dep is None else (self.dep,)


@dataclasses.dataclass(frozen=True)
class CrossTimes:
    """Virtual durations of the enc-dec cross-restoration pair: the
    encoder-blob read (one (S_enc, D) tensor) and the cross-KV
    projection (K,V GEMMs for every decoder layer from that one blob —
    the 1 → 2·L expansion DESIGN.md §3 describes)."""

    io: float
    compute: float


def group_widths(group_size, n_hidden: int) -> Tuple[int, ...]:
    """Normalize a group plan — a uniform width (int) or an explicit
    partition (sequence of widths, the fetch-aligned form) — into the
    tuple of group widths that covers ``n_hidden`` hidden layers
    exactly. A short partition is extended with its last width; a long
    one is truncated; widths are clamped positive."""
    if n_hidden <= 0:
        return ()
    if isinstance(group_size, (tuple, list)):
        widths: List[int] = []
        total = 0
        for w in group_size:
            if total >= n_hidden:
                break
            w = max(int(w), 1)
            widths.append(min(w, n_hidden - total))
            total += widths[-1]
        last = widths[-1] if widths else 1
        while total < n_hidden:
            widths.append(min(last, n_hidden - total))
            total += widths[-1]
        return tuple(widths)
    g = max(int(group_size), 1)
    return tuple(min(g, n_hidden - s) for s in range(0, n_hidden, g))


def compile_tasks(methods: Sequence[str], *, n_blobs: int = 0,
                  group_size=1, cross: bool = False) -> List[Task]:
    """Compile a per-layer method assignment into the ordered task graph.

    List order encodes per-stream priority (paper §4.1): the IO stream
    runs hidden fetches first (layer order) so projections can start,
    then the encoder blob (when ``cross`` — its projection gates the
    first cross-attention), then KV fetches fill the IO tail; the
    compute stream runs the recompute prefix from t=0, then projections
    in fetch order, then the cross projection. A projection group
    depends on *all* of its members' fetches; with ``group_size=1`` this
    degenerates exactly to the per-layer graph.

    ``group_size`` is either a uniform width (int) or an explicit
    partition — a tuple of widths, the fetch-aligned non-uniform form
    (small leading groups so projection starts the moment the first
    stripe lands, wide tail groups to amortize dispatch)."""
    tasks: List[Task] = []
    io_of: Dict[int, int] = {}
    hidden_layers = [i for i, m in enumerate(methods) if m == "hidden"]
    for i in hidden_layers:
        io_of[i] = len(tasks)
        tasks.append(Task("io_h", i))
    io_enc = None
    if cross:
        io_enc = len(tasks)
        tasks.append(Task("io_enc", -1))
    for i, m in enumerate(methods):
        if m == "kv":
            tasks.append(Task("io_kv", i))
    for _ in range(n_blobs):
        tasks.append(Task("blob", -1))
    for i, m in enumerate(methods):
        if m == "recompute":
            tasks.append(Task("recompute", i))
    s = 0
    for w in group_widths(group_size, len(hidden_layers)):
        grp = tuple(hidden_layers[s:s + w])
        s += w
        deps = tuple(io_of[i] for i in grp)
        tasks.append(Task("project", grp[0], dep=deps[-1], layers=grp,
                          deps=deps))
    if cross:
        tasks.append(Task("project_cross", -1, dep=io_enc))
    return tasks


def task_duration(task: Task, times: Sequence[MethodTimes],
                  dispatch_overhead: float = 0.0,
                  cross_times: Optional[CrossTimes] = None) -> float:
    """Virtual duration of one task. Compute-stream tasks carry the
    per-dispatch overhead once — a projection group amortizes it over
    all members (the whole point of grouping)."""
    if task.kind == "io_h":
        return times[task.layer].io_h
    if task.kind == "io_kv":
        return times[task.layer].io_kv
    if task.kind == "io_enc":
        return cross_times.io if cross_times else 0.0
    if task.kind == "recompute":
        return times[task.layer].c_token + dispatch_overhead
    if task.kind == "project":
        return (sum(times[li].c_h for li in task.members)
                + dispatch_overhead)
    if task.kind == "project_cross":
        return ((cross_times.compute if cross_times else 0.0)
                + dispatch_overhead)
    return 0.0                                 # blob reads: O(1) in tokens


def task_links(tasks: Sequence[Task],
               layer_links: Optional[Dict[int, int]])\
        -> Optional[Dict[int, int]]:
    """Task-index → NIC-link map for ``replay``: each per-layer IO task
    inherits the link its layer's stripes live on (layer placement only;
    chunk placement has no per-layer link and returns None)."""
    if not layer_links:
        return None
    out = {}
    for i, t in enumerate(tasks):
        if t.stream == "io" and t.layer >= 0:
            link = layer_links.get(t.layer)
            if link is not None:
                out[i] = link
    return out


def replay(tasks: Sequence[Task], times: Sequence[MethodTimes],
           order: Optional[Sequence[int]] = None,
           dispatch_overhead: float = 0.0,
           cross_times: Optional[CrossTimes] = None,
           durations: Optional[Dict[int, float]] = None,
           links: Optional[Dict[int, int]] = None):
    """Two-stream virtual replay of ``tasks`` in ``order`` → Timeline.

    Each stream is serial; a compute task with deps starts no earlier
    than the completion of ALL its deps on the IO stream. ``order``
    defaults to list order (the compiled priority); the executor passes
    the order it actually ran. ``durations`` overrides individual task
    durations (task index → seconds) with *measured* values — the
    executor's observed timeline replays the same graph under what each
    task actually took, so predicted-vs-measured makespan error is a
    like-for-like comparison.

    ``links`` (task index → NIC link, from ``task_links``) splits the IO
    stream into one serial queue PER LINK — the distributed store's
    layer-striped reads genuinely overlap across shards, so the IO
    finish is the max over link clocks, not their sum. Tasks without an
    entry share queue 0 (the one-host degenerate case)."""
    from repro_torch.core.pipeline import Timeline
    if order is None:
        order = range(len(tasks))
    done = [0.0] * len(tasks)
    io_clocks: Dict[int, float] = {}
    comp_t = io_busy = comp_busy = 0.0
    for idx in order:
        t = tasks[idx]
        if durations is not None and idx in durations:
            dur = durations[idx]
        else:
            dur = task_duration(t, times, dispatch_overhead, cross_times)
        if t.stream == "io":
            link = links.get(idx, 0) if links else 0
            io_clocks[link] = io_clocks.get(link, 0.0) + dur
            io_busy += dur
            done[idx] = io_clocks[link]
        else:
            deps = t.all_deps
            start = comp_t if not deps else max(
                comp_t, max(done[d] for d in deps))
            comp_t = start + dur
            comp_busy += dur
            done[idx] = comp_t
    io_t = max(io_clocks.values(), default=0.0)
    return Timeline(max(io_t, comp_t), io_busy, comp_busy, io_t, comp_t)


def _cross_times_at(cfg, hw, dtype_bytes: int, enc_len: int, *,
                    profile=None, io_streams: int = 1)\
        -> Optional[CrossTimes]:
    if not enc_len:
        return None
    tms = [method_times(c, hw, profile=profile, io_streams=io_streams)
           for c in layer_costs(cfg, int(enc_len), dtype_bytes)]
    return CrossTimes(io=tms[0].io_h, compute=sum(t.c_h for t in tms))


def cross_restore_times(mgr, enc_len: int) -> Optional[CrossTimes]:
    """CrossTimes of an enc-dec session with ``enc_len`` stored encoder
    positions (None when zero or unknown): IO one (S_enc, D) blob, compute
    the K/V projection of that blob for every decoder layer."""
    return _cross_times_at(mgr.cfg, mgr.hw, mgr.dtype_bytes, enc_len,
                           profile=mgr.profile, io_streams=mgr.io_streams)


# ------------------------------------------------------------ group plans
GROUP_SIZE_CANDIDATES = (1, 2, 4, 8)


def fetch_aligned_partition(methods: Sequence[str],
                            times: Sequence[MethodTimes], *,
                            dispatch_overhead: float = 0.0,
                            links: Optional[Dict[int, int]] = None)\
        -> Tuple[int, ...]:
    """Group boundaries at fetch-completion times.

    A projection group cannot start before its LAST member's hidden
    fetch lands, so a wide first group leaves the compute stream idle
    for the whole fetch ramp while a width-1 tail pays dispatch overhead
    per layer. The optimal shape is non-uniform: boundaries placed where
    the fetch stream has just caught up — small leading groups, wide
    tail groups. Exact O(n²) DP over the hidden layers: ``f(j)`` =
    earliest compute-stream completion of the first ``j`` projections,
    with fetch ``j`` landing at the io_h prefix sum and the compute
    stream starting busy for the recompute prefix (which replay runs
    before any projection).

    ``links`` (layer → NIC link, distributed store) makes the fetch
    completions per-shard: each link runs its own serial queue, so fetch
    ``j`` lands on its OWN link's running clock. The DP gates a group
    ending at ``j`` on the prefix-max of the completions (the group
    needs ALL members' fetches; per-link clocks are not monotone in
    ``j``), which collapses to the plain prefix sum on one host."""
    hidden = [i for i, m in enumerate(methods) if m == "hidden"]
    n = len(hidden)
    if n <= 1:
        return (1,) * n
    fetch_done = [0.0] * (n + 1)            # per-fetch completion times
    link_clock: Dict[int, float] = {}
    for j, li in enumerate(hidden):
        link = links.get(li, 0) if links else 0
        link_clock[link] = link_clock.get(link, 0.0) + times[li].io_h
        fetch_done[j + 1] = link_clock[link]
    gate = [0.0] * (n + 1)                  # prefix max: all fetches <= j
    for j in range(1, n + 1):
        gate[j] = max(gate[j - 1], fetch_done[j])
    busy0 = sum(times[li].c_token + dispatch_overhead
                for li, m in enumerate(methods) if m == "recompute")
    c_h = [times[li].c_h for li in hidden]
    f = [0.0] * (n + 1)
    parent = [0] * (n + 1)
    f[0] = busy0
    for j in range(1, n + 1):
        best = None
        proj = 0.0
        for i in range(j - 1, -1, -1):      # group = hidden[i:j]
            proj += c_h[i]
            t = max(f[i], gate[j]) + dispatch_overhead + proj
            if best is None or t < best:
                best, parent[j] = t, i
        f[j] = best
    widths: List[int] = []
    j = n
    while j > 0:
        widths.append(j - parent[j])
        j = parent[j]
    return tuple(reversed(widths))


def measured_dispatch_overhead(hw, profile) -> float:
    """Per-launch overhead to price a plan with: the profile's fitted
    projection intercept when it has one, else the hardware guess."""
    if profile is not None:
        measured = profile.dispatch_overhead(
            mesh=getattr(hw, "mesh_devices", 1))
        if measured is not None:
            return measured
    return getattr(hw, "dispatch_overhead", 0.0)


def choose_group_size(cfg, hw, n_tokens: int, methods: Sequence[str], *,
                      dtype_bytes: int = 2, n_blobs: int = 0,
                      cross: bool = False, enc_len: int = 0,
                      profile=None, io_streams: int = 1,
                      fetch_aligned: bool = False,
                      topology=None, link_load=None):
    """Auto group-size planning: replay the grouped task graph over the
    hardware profile for g ∈ {1, 2, 4, 8, L} — plus, with
    ``fetch_aligned``, the non-uniform fetch-completion partition — and
    take the makespan argmin. The same group-aware cost model the
    executor's timeline and ``capacity.restore_makespan`` use, so the
    planner and the metric cannot disagree. Ties prefer fewer groups
    (equal modelled makespan, strictly fewer launches). Returns an int
    (uniform width) or a tuple of widths (non-uniform partition).

    ``profile``/``io_streams`` price the replay with measured rates and
    the current restore multiplicity. The choice is computed at the
    ``s_bucket`` of ``n_tokens`` (and an enc-dec session's cross pair at
    that of ``enc_len``), not the exact lengths, as the JAX package does:
    every session in a bucket picks the same plan."""
    n_hidden = sum(1 for m in methods if m == "hidden")
    if n_hidden <= 1:
        return 1
    n_bucket = s_bucket(max(int(n_tokens), 1))
    times, layer_links = link_priced_times(
        layer_costs(cfg, n_bucket, dtype_bytes), hw, profile=profile,
        io_streams=io_streams, topology=topology, link_load=link_load)
    cross_times = (_cross_times_at(cfg, hw, dtype_bytes, s_bucket(enc_len),
                                   profile=profile, io_streams=io_streams)
                   if cross and enc_len else None)
    overhead = measured_dispatch_overhead(hw, profile)
    cands = sorted({g for g in GROUP_SIZE_CANDIDATES if g < n_hidden}
                   | {n_hidden})

    def makespan(g):
        tasks = compile_tasks(tuple(methods), n_blobs=n_blobs,
                              group_size=g, cross=cross)
        return replay(tasks, times, dispatch_overhead=overhead,
                      cross_times=cross_times,
                      links=task_links(tasks, layer_links)).makespan

    best = min(cands, key=lambda g: (makespan(g), -g))
    if not fetch_aligned:
        return best
    part = fetch_aligned_partition(methods, times,
                                   dispatch_overhead=overhead,
                                   links=layer_links)
    widths = set(part)
    if len(widths) == 1:                 # degenerate partition is uniform
        part = widths.pop()
    # prefer the uniform plan on ties: same modelled makespan, simpler
    return part if makespan(part) < makespan(best) else best


# ----------------------------------------------------- host <-> device words
def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy for the store, losslessly: numpy has no bfloat16,
    so bf16 travels as its raw 2-byte words (int16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def as_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Store words as ``dtype``: int16 words become bf16 bit for bit."""
    if dtype == torch.bfloat16 and x.dtype == torch.int16:
        return x.view(torch.bfloat16)
    return x.to(dtype)


# ----------------------------------------------------- hidden-state codec
def quantize_hidden_int8(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-token int8 quantization of stored hidden states (fp32 in): the
    rows and their fp32 scales (..., 1). The save path and the capacity
    ladder encode with it; restores decode with ``dequantize_hidden_int8``
    or, on the device, ``dequantize_hidden_int8_torch``."""
    scale = np.abs(x).max(axis=-1, keepdims=True).astype(np.float32) / 127.0
    scale = np.maximum(scale, 1e-8)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_hidden_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale.astype(np.float32)


def dequantize_hidden_int8_torch(q: torch.Tensor,
                                 scale: torch.Tensor) -> torch.Tensor:
    """``dequantize_hidden_int8`` where the rows lie (fp32): one IEEE
    multiply per element, so the card gives the numpy codec's bits."""
    return q.float() * scale.float()


def host_float32(words: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """Stored rows of a ``dtype`` model (``to_host``'s words) as fp32,
    exactly: bf16 words widen bit for bit."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(words)).view(
            torch.bfloat16).float().numpy()
    return np.asarray(words, np.float32)


STAGING_SLOTS = 3
FILL_THREADS = 4
# where an executor's host seconds go (``RestorationExecutor.host_split``)
HOST_SPLIT = ("read", "copy", "upload", "launch", "drain")


class StagingRing:
    """Host staging of restoration uploads, owned by the manager and kept
    across restores: ``STAGING_SLOTS`` host buffers (pinned on the card)
    used in turn, each grown when an upload does not fit to the largest
    size in the ring, and the copy stream the uploads run on.

    ``stage(shape, dtype)`` hands out the next slot as a numpy array for
    the host to fill, after waiting for that slot's previous upload to
    finish: rewriting a pinned buffer under an upload in flight would
    change the restored K/V silently. ``upload`` issues the copy with
    ``non_blocking=True`` on the copy stream into a device tensor
    allocated there, records the slot's event, makes the caller's current
    stream (the compute stream) wait on it, and marks the tensor as used
    by that stream (``record_stream``), so the caching allocator does not
    hand its memory to a later copy-stream allocation while the compute
    stream may still read it. An executor dropped mid-restore leaves
    nothing unguarded: the slots and their events live here, and its
    device tensors are freed through the allocator's stream records.
    On the CPU the slots are plain memory and ``upload`` copies.

    ``fill(jobs)`` runs a slot's host copies (one per layer of a group,
    each into its own rows) on ``FILL_THREADS`` worker threads: one
    thread does not reach the host's copy rate into pinned memory, and
    numpy releases the interpreter lock while it copies."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.copy_stream = (torch.cuda.Stream(self.device) if self.cuda
                            else None)
        self._bufs: List[Optional[torch.Tensor]] = [None] * STAGING_SLOTS
        self._events: List[Optional[torch.cuda.Event]] = \
            [None] * STAGING_SLOTS
        self._next = 0
        self._pool: Optional[ThreadPoolExecutor] = None

    def stage(self, shape, dtype) -> Tuple[int, np.ndarray]:
        """(slot, a host array of ``shape`` and numpy ``dtype`` in it)."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            # grow to the ring's largest slot at least: slots used in turn
            # by groups of several widths then stop growing at once
            size = max([nbytes, 1] + [b.numel() for b in self._bufs
                                      if b is not None])
            buf = self._bufs[i] = torch.empty(size, dtype=torch.uint8,
                                              pin_memory=self.cuda)
        return i, buf[:nbytes].numpy().view(dtype).reshape(shape)

    def fill(self, jobs) -> None:
        """Run ``jobs`` (callables writing disjoint parts of a staged
        array) on the worker threads; returns when all are done."""
        if len(jobs) == 1:
            jobs[0]()
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(FILL_THREADS,
                                            thread_name_prefix="staging")
        for f in [self._pool.submit(job) for job in jobs]:
            f.result()

    def upload(self, slot: int, host: np.ndarray,
               dtype: torch.dtype) -> torch.Tensor:
        """The staged ``host`` array of ``slot`` on the device, as
        ``dtype``, ordered before the current stream's later work."""
        words = torch.from_numpy(np.empty(0, host.dtype)).dtype
        src = self._bufs[slot][:host.nbytes].view(words).view(host.shape)
        if not self.cuda:
            return as_dtype(src.clone(), dtype)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.copy_stream):
            x = torch.empty(host.shape, dtype=words, device=self.device)
            x.copy_(src, non_blocking=True)
            event = self._events[slot] = torch.cuda.Event()
            event.record(self.copy_stream)
        compute.wait_event(event)
        x.record_stream(compute)
        return as_dtype(x, dtype)

    def close(self) -> None:
        """Wait for the uploads in flight (their pinned sources) and stop
        the worker threads."""
        if self.cuda:
            self.copy_stream.synchronize()
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


# ------------------------------------------------------------------- sinks
class RestoreSink:
    """Receives restored state one piece at a time, in any order."""

    def put_kv(self, row: int, k, v, start: int = 0) -> None:
        """One attention layer's K/V (k, v: (1, n, kv_heads, head_dim)) at
        tokens [start, start + n); ``row`` indexes the stacked-KV
        buffer."""
        raise NotImplementedError

    def put_kv_group(self, rows: Sequence[int], k, v,
                     start: int = 0) -> None:
        """A whole projection group's K/V; k/v (G, 1, n, kv_heads, hd),
        or ``Sharded`` on the head axis from a sharded pack (a sink whose
        buffers are whole gathers them)."""
        for g, row in enumerate(rows):
            self.put_kv(row, k[g], v[g], start)

    def put_states(self, conv, ssm) -> None:
        """A recurrent session's states, whole: ssm (L, 1, W-1, I) and
        (L, 1, I, N); hybrid (n_super, k-1, 1, W-1, C) and (n_super, k-1,
        1, H, P, N)."""
        raise NotImplementedError

    def put_cross(self, ck, cv, enc_len: int) -> None:
        """An enc-dec session's cross K/V, whole: (L, 1, enc_len, Kv, hd)
        each."""
        raise NotImplementedError

    def finish(self, n_tokens: int) -> None:
        raise NotImplementedError


class CacheAssembler(RestoreSink):
    """Builds a B=1 decode cache: the stacked K/V of the attention layers
    under the adapter's ``kv_names`` (lm k/v (L,1,capacity,Kv,hd), hybrid
    attn_k/attn_v (n_super,1,capacity,Kv,hd)), whose pieces are written
    straight into a buffer of ``capacity`` positions (at least the
    restored length), so decoding can continue in it; the recurrent
    states conv/ssm of an ssm or hybrid session; an enc-dec session's
    cross_k/cross_v and enc_len (1,); and lengths."""

    def __init__(self, model, capacity: Optional[int] = None):
        self.model = model
        self.capacity = capacity
        self.k: Optional[torch.Tensor] = None
        self.v: Optional[torch.Tensor] = None
        self.states: Optional[tuple] = None
        self.cross: Optional[tuple] = None
        self.cache: Optional[dict] = None

    def _buffers(self, n: int):
        if self.k is None:
            c = self.model.cfg
            rows = sum(k == BlockKind.ATTENTION for k in c.block_kinds())
            shape = (rows, 1, max(self.capacity or 0, n), c.n_kv_heads,
                     c.head_dim_)
            self.k = torch.zeros(shape, dtype=self.model.dtype,
                                 device=self.model.device)
            self.v = torch.zeros_like(self.k)
        return self.k, self.v

    def put_kv_group(self, rows, k, v, start=0):
        super().put_kv_group(rows, gathered(k), gathered(v), start)

    def put_kv(self, row, k, v, start=0):
        n = k.shape[1]
        kb, vb = self._buffers(start + n)
        kb[row, :, start:start + n] = k
        vb[row, :, start:start + n] = v

    def put_states(self, conv, ssm):
        self.states = (conv, ssm)

    def put_cross(self, ck, cv, enc_len):
        self.cross = (ck, cv, enc_len)

    def finish(self, n_tokens):
        lengths = torch.tensor([n_tokens], dtype=torch.int32,
                               device=self.model.device)
        self.cache = {}
        names = self.model.adapter.kv_names
        if names is not None:
            self.cache.update(zip(names, self._buffers(n_tokens)))
        if self.model.adapter.n_state_blobs:
            self.cache["conv"], self.cache["ssm"] = self.states
        if self.model.adapter.has_cross:
            ck, cv, enc_len = self.cross
            self.cache.update(cross_k=ck, cross_v=cv, enc_len=torch.tensor(
                [enc_len], dtype=torch.int32, device=self.model.device))
        self.cache["lengths"] = lengths


# ---------------------------------------------------------- param packing
def s_bucket(n: int, minimum: int = 16) -> int:
    """Power-of-two token bucket: the length group plans are priced at,
    RoPE tables are cut at and profile samples are filed under."""
    b = max(int(minimum), 1)
    while b < n:
        b <<= 1
    return b


class RestoreParamPack:
    """The restoration weights of every attention layer: references to the
    model's layer-stacked parameters (no copy; a hybrid stack's attention
    blocks, row ``s`` for block ``s``; an enc-dec decoder's ``ln1`` and
    ``self_attn``), and RoPE tables cut from the shared table that prefill
    and decode gather from too.

    Under an SPMD ``tp`` context (``distributed/tp.py``) the pack also
    holds ``shards``: per shard, contiguous copies of its slice of
    ``wk``/``wv`` (and ``bk``/``bv``) on the flattened KV output axis,
    which is heads-leading, so each slice is one group of KV heads, on
    the shard's device. Kernel #1 takes contiguous weight stacks only, so
    the slices are copies: one more copy of ``wk`` and ``wv`` in all,
    2.1 GB at llama2-7b's full width. ``shard_attn`` is the attention
    geometry of one shard."""

    def __init__(self, model, params, tp=None):
        from repro_torch.models import encdec
        self.model = model
        if model.kind == "hybrid":
            self.blocks, self.attn = params["attn"], model.h.lm.attn
        elif model.kind == "encdec":
            self.blocks = encdec.self_view(params["dec_blocks"])
            self.attn = model.h.attn
        else:
            self.blocks, self.attn = params["blocks"], model.h.attn
        self.tp = tp if tp is not None and tp.spmd else None
        self.shards = None
        if self.tp is not None:
            self.tp.validate_heads(self.attn.n_kv_heads)
            a = self.blocks["attn"]
            parts = {n: self.tp.shard_kv(a[n], a[n].dim() - 1).parts
                     for n in ("wk", "wv", "bk", "bv") if n in a}
            self.shards = [{"attn": {n: p[s] for n, p in parts.items()}}
                           for s in range(self.tp.tp)]
            self.shard_attn = dataclasses.replace(
                self.attn, n_heads=self.attn.n_heads // self.tp.tp,
                n_kv_heads=self.attn.n_kv_heads // self.tp.tp)
        self._tables: Dict[Tuple[int, int],
                           Tuple[torch.Tensor, torch.Tensor]] = {}
        self._rows: Dict[Tuple[int, ...], torch.Tensor] = {}

    def rows(self, rows: Tuple[int, ...]) -> torch.Tensor:
        """``rows`` as an int32 device tensor, uploaded once per tuple
        and without waiting for the device (a pageable upload would)."""
        got = self._rows.get(rows)
        if got is None:
            host = torch.tensor(rows, dtype=torch.int32)
            if self.model.device.type == "cuda":
                host = host.pin_memory()
            got = self._rows[rows] = host.to(self.model.device,
                                             non_blocking=True)
        return got

    def rope_tables(self, n_pos: int, offset: int = 0):
        """cos/sin (n_pos, head_dim//2) for positions [offset,
        offset + n_pos): row slices of a table cut once per power-of-two
        bucket of ``n_pos``."""
        key = (s_bucket(n_pos), offset)
        got = self._tables.get(key)
        if got is None:
            end = offset + key[0]
            cos, sin = rope_table(end, self.attn.head_dim,
                                  self.attn.rope_theta, self.model.device)
            got = (cos[offset:end].contiguous(), sin[offset:end].contiguous())
            self._tables[key] = got
        return got[0][:n_pos], got[1][:n_pos]


def project_group(pack: RestoreParamPack, hidden: torch.Tensor,
                  rows: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """One projection group: hidden (G, S_bucket, D) in the model dtype,
    rows (G,) int32 pack rows -> k, v (G, S_bucket, Kv, hd). The same norm
    and kernel calls as prefill (``models/transformer.py``), so restored
    K/V equals prefill K/V.

    A sharded pack launches kernel #1 once per shard, on the shard's
    weights and the normed stack replicated to its device, and returns
    k, v as ``Sharded`` values split on the head axis (2); each shard's
    heads are the bits of the whole launch (no sum runs over KV
    columns). The compute stream of the first device then waits for every
    other device's launches, so events around the call span them all."""
    from repro_torch.models import transformer as tfm
    normed = tfm.norm_rows(pack.blocks, rows, hidden, pack.model.cfg)
    tp = pack.tp
    if tp is None:
        return tfm.project_kv_rows(pack.blocks, rows, normed, cos, sin,
                                   pack.attn)
    ks, vs = [], []
    for dev, blocks, r, x, c, s in zip(
            tp.devices, pack.shards, *(tp.replicate(t)
                                       for t in (rows, normed, cos, sin))):
        with on_device(dev):
            k, v = tfm.project_kv_rows(blocks, r, x, c, s, pack.shard_attn)
        ks.append(k)
        vs.append(v)
    tp.join()
    return Sharded(ks, 2), Sharded(vs, 2)


# --------------------------------------------------------------- executor
class RestorationExecutor:
    """Execution of one session's restoration into a sink.

    Created by ``HCacheManager.begin_restore``. ``step(max_tasks)`` runs a
    bounded number of tasks, event-driven across the two virtual streams
    (whichever stream's clock is behind goes next); a serving engine
    steps it a few tasks per engine step. ``prefetch_step`` runs IO tasks
    only, before a sink is attached: pieces finished without a sink are
    kept and flushed by ``attach_sink``. Projection tasks are groups under
    the manager's resolved plan (``resolve_group_size``: a width, a tuple
    of widths, or the ``auto``/``fetch`` choice).

    On the card a group's data path is asynchronous: once its members'
    reads have landed the host fills a slot of the manager's
    ``StagingRing``, the upload runs on the ring's copy stream, and the
    compute stream (the caller's current stream, which the engine's
    decode also runs on) waits on the upload's event, runs the norm and
    the restoration kernel and hands the group to the sink (rows stored
    in the int8 codec go up as int8 with their fp32 scales, in two slots,
    and are multiplied out on the compute stream first). No task body
    waits for the device; CUDA events around each group's norm + kernel
    give its device seconds, read once the end event has completed
    (polled in ``step``, drained when the restore is done).
    ``project_wall`` sums those device seconds (wall seconds on the CPU);
    ``wall_time`` the host seconds inside ``step`` and ``prefetch_step``,
    of which ``host_split`` says where they went: ``read`` (store reads
    and waits for them), ``copy`` (filling staging slots), ``upload``
    (waiting for a free slot, issuing the copy), ``launch`` (norm, kernel
    and sink calls) and ``drain`` (waiting for the device at the end).

    With a ``MeasuredProfile`` on the manager every task's observed
    duration is folded into it (``_run_profiled``): IO tasks by the
    store's read service, compute tasks by their device seconds (wall on
    the CPU), skipping the first launch of each projection shape, which
    includes the kernel's build and set-up. ``observed`` keeps them for
    ``measured_timeline``."""

    def __init__(self, mgr, params, session: str,
                 sink: Optional[RestoreSink] = None, start_token: int = 0):
        manifest = mgr.store.get_manifest(session)
        if manifest is None:
            raise KeyError(f"no stored state for session {session!r}")
        self.mgr = mgr
        self.model = mgr.model
        self.params = params
        self.session = session
        self.sink = sink
        self.n_tokens = int(manifest["n_tokens"])
        self.methods = tuple(manifest["methods"])
        # the stored hidden codec: "int8" rows come with an "hs" stream of
        # per-token scales and are dequantized on the device
        self.compress = manifest.get("compress", mgr.compress)
        # tokens [0, start_token) are already in the target slot: the
        # graph restores only the suffix (reads from its first chunk,
        # projections at its bucket, RoPE and sink writes at the offset).
        # The recompute method rebuilds from token 0 and cannot skip.
        start_token = int(start_token)
        if start_token and "recompute" in self.methods:
            raise ValueError("restore-skip is incompatible with "
                             "recompute-method layers")
        if not 0 <= start_token < max(self.n_tokens, 1):
            raise ValueError(f"start_token {start_token} outside "
                             f"[0, {self.n_tokens})")
        self.start_token = start_token
        self.n_eff = self.n_tokens - start_token
        self.schedule = Schedule(self.methods, 0.0, 0.0, 0.0, 0.0)
        mgr.store.sync_clocks(0.0)
        kinds = mgr.cfg.block_kinds()
        self._row_of = {li: r for r, li in enumerate(
            i for i, k in enumerate(kinds) if k == BlockKind.ATTENTION)}
        # an enc-dec session restores its cross state through two tasks of
        # its own (io_enc + project_cross), priced at its encoder length
        adapter = self.model.adapter
        self.has_cross = adapter.has_cross
        self.enc_len = int(manifest.get("enc_len", 0))
        self.cross_times = (cross_restore_times(mgr, self.enc_len)
                            if self.has_cross else None)
        gs = mgr.resolve_group_size(self.n_eff, self.methods,
                                    enc_len=self.enc_len)
        # int = uniform width; tuple = non-uniform partition
        self.group_size = (tuple(int(w) for w in gs)
                           if isinstance(gs, (tuple, list))
                           else max(int(gs), 1))
        self.pack = mgr.param_pack(params)
        self.profile = mgr.profile
        self.dispatch_overhead = measured_dispatch_overhead(mgr.hw,
                                                            self.profile)
        self.tasks = compile_tasks(
            self.methods, n_blobs=adapter.n_state_blobs,
            group_size=self.group_size, cross=self.has_cross)
        self.costs = layer_costs(mgr.cfg, self.n_eff, mgr.dtype_bytes)
        # a multi-host store prices each layer's IO on the links its
        # stripes occupy, under the restores in flight on each link
        self.topology = mgr.store.shard_topology()
        self.link_load = mgr.link_load
        self.times, layer_links = link_priced_times(
            self.costs, mgr.hw, profile=self.profile,
            io_streams=mgr.io_streams, topology=self.topology,
            link_load=self.link_load)
        self._task_links = task_links(self.tasks, layer_links)
        self.executed: List[int] = []
        self._done = [False] * len(self.tasks)
        self._io_queue = [i for i, t in enumerate(self.tasks)
                          if t.stream == "io"]
        self._comp_queue = [i for i, t in enumerate(self.tasks)
                            if t.stream == "compute"]
        self._io_clock = 0.0
        self._io_clocks: Dict[int, float] = {}
        self._comp_clock = 0.0
        self._cur_idx = -1
        self._hio: Dict[int, tuple] = {}      # layer -> (task, h and hs
        #                                       reads; hs None unless int8)
        self._kvio: List[tuple] = []          # (task, layer, k and v tickets)
        self._re_layers = [i for i, m in enumerate(self.methods)
                           if m == "recompute"]
        if self._re_layers != list(range(len(self._re_layers))):
            raise ValueError("recompute layers must form a prefix")
        self.segments = manifest.get("segments",
                                     [[0, self.n_tokens, "prefill"]])
        self._re_kv = None
        self._re_next = 0
        self._finished = False
        self._pending: List[Tuple[str, tuple]] = []   # pieces before a sink
        self._ring = mgr.staging()
        self._cuda = self.model.device.type == "cuda"
        # timed compute spans whose end event has not been read yet:
        # (start event, end event, [(task, kind, work, share, keep)])
        self._inflight: collections.deque = collections.deque()
        self._io_base = mgr.store.read_completion()
        self.io_measured = 0.0       # virtual read completion of this restore
        self.wall_time = 0.0         # seconds inside step() / prefetch_step()
        self.project_wall = 0.0
        self.host_split = dict.fromkeys(HOST_SPLIT, 0.0)
        self.observed: Dict[int, float] = {}
        self._bucket = s_bucket(max(self.n_eff, 1))
        self._enc_bucket = s_bucket(self.enc_len) if self.enc_len else 0
        self._encio = None           # (task, ticket) awaiting project_cross
        self._n_timed = mgr.store.n_timed_devices()
        # the plan this graph was compiled under, for the engine's
        # predicted-vs-measured gauge (list order == compiled priority)
        self.predicted_makespan = replay(
            self.tasks, self.times, dispatch_overhead=self.dispatch_overhead,
            cross_times=self.cross_times, links=self._task_links).makespan

    # ------------------------------------------------------------- plumbing
    @property
    def done(self) -> bool:
        return all(self._done) and not self._kvio

    def links_touched(self) -> Tuple[int, ...]:
        """The NIC links this restore's reads occupy: what the engine
        folds into the manager's ``LinkLoad``."""
        topo = self.topology
        if topo is None or topo.n_shards <= 1:
            return (0,)
        if topo.placement == "chunk":
            return tuple(range(topo.n_shards))
        return tuple(sorted({topo.links_for_layer(li)[0]
                             for li, m in enumerate(self.methods)
                             if m in ("hidden", "kv")}))

    def attach_sink(self, sink: RestoreSink) -> None:
        """Direct the restore into ``sink``, flushing the pieces that
        finished before one was attached (a prefetched executor)."""
        self.sink = sink
        for op, args in self._pending:
            getattr(sink, op)(*args)
        self._pending.clear()

    def _emit(self, op: str, *args) -> None:
        if self.sink is not None:
            getattr(self.sink, op)(*args)
        else:
            self._pending.append((op, args))

    def _order(self) -> List[int]:
        return self.executed + [i for i in range(len(self.tasks))
                                if not self._done[i]]

    def timeline(self):
        """Timeline derived from the order tasks actually executed in."""
        return replay(self.tasks, self.times, self._order(),
                      dispatch_overhead=self.dispatch_overhead,
                      cross_times=self.cross_times, links=self._task_links)

    def measured_timeline(self):
        """``timeline()`` with each task's duration replaced by what it
        was observed to take (modelled values fill unmeasured tasks): the
        measured side of the engine's predicted-vs-measured gauge."""
        return replay(self.tasks, self.times, self._order(),
                      dispatch_overhead=self.dispatch_overhead,
                      cross_times=self.cross_times, durations=self.observed,
                      links=self._task_links)

    def _ready(self, idx: int) -> bool:
        t = self.tasks[idx]
        if any(not self._done[d] for d in t.all_deps):
            return False
        if t.kind == "recompute":
            # prefix layers carry the residual stream in order
            return self._re_layers[self._re_next] == t.layer
        return True

    def _pick(self) -> Optional[int]:
        """Event-driven pick: advance whichever stream is behind."""
        io_idx = self._io_queue[0] if self._io_queue else None
        comp_idx = (self._comp_queue[0]
                    if self._comp_queue and self._ready(self._comp_queue[0])
                    else None)
        if io_idx is None:
            return comp_idx
        if comp_idx is None:
            return io_idx
        return comp_idx if self._comp_clock <= self._io_clock else io_idx

    def step(self, max_tasks: int = 4) -> bool:
        """Execute up to ``max_tasks`` tasks; True when restoration is
        done. A projection group counts as one task."""
        t0 = time.perf_counter()
        for _ in range(max_tasks):
            idx = self._pick()
            if idx is None:
                break
            self._run_task(idx)
        # reap landed K/V reads; once every task has run, drain them
        self._reap_kv(block=all(self._done))
        if self.done and not self._finished and self.sink is not None:
            self.sink.finish(self.n_tokens)
            self._finished = True
        t1 = time.perf_counter()
        self._poll(block=self.done)
        self.host_split["drain"] += time.perf_counter() - t1
        self.wall_time += time.perf_counter() - t0
        return self.done

    def prefetch_step(self, max_tasks: int = 1) -> int:
        """Run up to ``max_tasks`` IO tasks (no sink needed); returns how
        many ran. Warms the reads of a queued session."""
        t0 = time.perf_counter()
        n = 0
        while n < max_tasks and self._io_queue:
            self._run_task(self._io_queue[0])
            n += 1
        self.wall_time += time.perf_counter() - t0
        return n

    def run(self) -> None:
        while not self.step(max_tasks=max(len(self.tasks), 1)):
            pass

    # ------------------------------------------------------------ profiling
    def _task_work(self, t: Task) -> float:
        """Work units of one task: bytes for IO kinds, FLOPs for compute
        kinds, on the cost basis ``method_times`` predicts with."""
        if t.kind == "io_h":
            return self.costs[t.layer].io_hidden
        if t.kind == "io_kv":
            c = self.costs[t.layer]
            return c.io_kv or c.io_state
        if t.kind == "recompute":
            return self.costs[t.layer].c_token
        if t.kind == "project":
            return sum(self.costs[li].c_hidden for li in t.members
                       if li in self._row_of)
        if t.kind in ("io_enc", "project_cross") and self.enc_len:
            costs = layer_costs(self.mgr.cfg, self.enc_len,
                                self.mgr.dtype_bytes)
            return (costs[0].io_hidden if t.kind == "io_enc"
                    else sum(c.c_hidden for c in costs))
        return 0.0

    def _bucket_of(self, kind: str) -> int:
        """The profile bucket of a task: the encoder length's for the
        cross pair, the restore's token count's for the rest."""
        return (self._enc_bucket if kind in ("io_enc", "project_cross")
                else self._bucket)

    def _run_profiled(self, idx: int, t: Task) -> None:
        """Execute an IO task with its read service folded into the
        profile: the striped store accumulates per-device read service
        seconds, and the delta across this task divided by the device
        count (stripes are read in parallel) is the stream seconds the
        cost model predicts. With an IO engine attached the service
        accrues on its workers instead, and the task records at reap time
        from its tickets (``_observe_read``). Compute tasks record their
        own device seconds (``_timed``)."""
        inline = self._n_timed and self.mgr.store.io_engine is None
        base = self.mgr.store.read_service_total() if inline else 0.0
        getattr(self, "_exec_" + t.kind)(t)
        if inline:
            delta = ((self.mgr.store.read_service_total() - base)
                     / self._n_timed)
            if delta > 0.0:
                self.observed[idx] = delta
                self.profile.record(t.kind, self._bucket_of(t.kind),
                                    self._task_work(t), delta)

    def _observe_read(self, idx: int, kind: str, tickets) -> None:
        """Fold a reaped read into the profile from its tickets' own
        service seconds (the slowest shard's: stripes on several shards
        run in parallel), unless the task already recorded inline."""
        if self.profile is None or idx in self.observed:
            return
        dur = max((tk.service for tk in tickets), default=0.0)
        if dur <= 0.0:
            return
        self.observed[idx] = dur
        shard_ids = {tk.shard_id for tk in tickets}
        link = (shard_ids.pop() if len(shard_ids) == 1
                and self.topology is not None else None)
        self.profile.record(kind, self._bucket_of(kind),
                            self._task_work(self.tasks[idx]), dur, link=link)

    def _measure(self, *completions: float) -> None:
        done = max(completions, default=0.0)
        if done:
            self.io_measured = max(self.io_measured, done - self._io_base)

    def _timed(self, fn, samples):
        """Run ``fn`` on the compute stream between two timing points;
        ``samples`` = [(task, kind, work, share, keep)] get ``share`` of
        its seconds each (a projection ``keep``s its sample unless this
        is its shape's first launch). On the card the span's CUDA events
        are read later (``_poll``)."""
        if not self._cuda:
            t0 = time.perf_counter()
            out = fn()
            self._book(time.perf_counter() - t0, samples)
            return out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        self._inflight.append((start, end, samples))
        return out

    def _poll(self, block: bool = False) -> None:
        """Book the timed spans whose end event has completed (all of
        them, waiting for the device, when ``block``)."""
        while self._inflight:
            start, end, samples = self._inflight[0]
            if block:
                end.synchronize()
            elif not end.query():
                return
            self._inflight.popleft()
            self._book(start.elapsed_time(end) / 1e3, samples)

    def _book(self, seconds: float, samples) -> None:
        # a sharded projection group's seconds (every shard's launches)
        # go to its mesh width's own cell (profiler.mesh_kind), so the
        # single-device fit stays clean; nothing else is sharded
        mesh = self.pack.tp.tp if self.pack is not None and self.pack.tp \
            else None
        for idx, kind, work, share, keep in samples:
            s = seconds * share
            if kind == "project":
                self.project_wall += s
            if self.profile is not None and keep and s > 0.0:
                self.observed[idx] = s
                self.profile.record(kind, self._bucket_of(kind), work, s,
                                    mesh=mesh if kind == "project" else None)

    # ---------------------------------------------------------- task bodies
    def _run_task(self, idx: int) -> None:
        t = self.tasks[idx]
        self._cur_idx = idx
        dur = task_duration(t, self.times, self.dispatch_overhead,
                            self.cross_times)
        if t.stream == "io":
            self._io_queue.remove(idx)
            link = (self._task_links.get(idx, 0)
                    if self._task_links else 0)
            self._io_clocks[link] = self._io_clocks.get(link, 0.0) + dur
            self._io_clock = max(self._io_clock, self._io_clocks[link])
        else:
            self._comp_queue.remove(idx)
            start = (self._comp_clock if not t.all_deps else
                     max(self._comp_clock, self._io_clock))
            self._comp_clock = max(self._comp_clock, start) + dur
        if t.stream == "io":
            t0 = time.perf_counter()
            if self.profile is not None:
                self._run_profiled(idx, t)
            else:
                getattr(self, "_exec_" + t.kind)(t)
            self.host_split["read"] += time.perf_counter() - t0
        else:
            getattr(self, "_exec_" + t.kind)(t)
        self._done[idx] = True
        self.executed.append(idx)

    def _exec_io_h(self, t: Task) -> None:
        if t.layer not in self._row_of:
            return          # recurrent layers restore through the blob
        # the reads complete when the projection consumes them
        store, sess, n = self.mgr.store, self.session, self.n_tokens
        d = self.start_token
        self._hio[t.layer] = (
            self._cur_idx,
            store.submit_layer_read(sess, "h", t.layer, n, start_token=d),
            store.submit_layer_read(sess, "hs", t.layer, n, start_token=d)
            if self.compress == "int8" else None)

    def _exec_io_kv(self, t: Task) -> None:
        if t.layer not in self._row_of:
            return          # recurrent layers restore through the blob
        store, sess, n = self.mgr.store, self.session, self.n_tokens
        d = self.start_token
        self._kvio.append((
            self._cur_idx, t.layer,
            store.submit_layer_read(sess, "kvk", t.layer, n, start_token=d),
            store.submit_layer_read(sess, "kvv", t.layer, n, start_token=d)))

    def _land(self, idx: int, kind: str, *reads) -> None:
        """Wait for submitted layer reads and account for them."""
        t0 = time.perf_counter()
        tickets = []
        for r in reads:
            for tk in r.tickets:
                tk.wait()
            tickets += r.tickets
        self._measure(*(tk.completion for tk in tickets))
        self._observe_read(idx, kind, tickets)
        self.host_split["read"] += time.perf_counter() - t0

    def _upload(self, shape, words, jobs, dtype: torch.dtype) -> torch.Tensor:
        """Stage a host array of ``shape`` and numpy ``words`` in the ring
        (each of ``jobs``, called with it, writes its own part) and upload
        it as ``dtype``."""
        t0 = time.perf_counter()
        slot, buf = self._ring.stage(shape, words)
        t1 = time.perf_counter()
        self._ring.fill([functools.partial(job, buf) for job in jobs])
        t2 = time.perf_counter()
        x = self._ring.upload(slot, buf, dtype)
        t3 = time.perf_counter()
        self.host_split["upload"] += (t1 - t0) + (t3 - t2)
        self.host_split["copy"] += t2 - t1
        return x

    def _reap_kv(self, block: bool = False) -> None:
        """Complete the landed K/V reads and emit them to the sink;
        ``block`` drains every outstanding one."""
        cfg, model = self.mgr.cfg, self.model
        remaining = []
        for entry in self._kvio:
            idx, layer, rk, rv = entry
            if not block and not (rk.ready() and rv.ready()):
                remaining.append(entry)
                continue
            self._land(idx, "io_kv", rk, rv)
            shape = (1, self.n_eff, cfg.n_kv_heads, cfg.head_dim_)
            k, v = (self._upload((self.n_eff,) + r.row_shape, r.dtype,
                                 [r.copy_into], model.dtype).view(shape)
                    for r in (rk, rv))
            t0 = time.perf_counter()
            self._emit("put_kv", self._row_of[layer], k, v, self.start_token)
            self.host_split["launch"] += time.perf_counter() - t0
        self._kvio = remaining

    def _exec_project(self, t: Task) -> None:
        model, pack, n = self.model, self.pack, self.n_eff
        members = [li for li in t.members if li in self._row_of]
        if not members:
            return          # recurrent layers restore through the blob
        reads, scales = [], []
        for li in members:
            idx, r, rs = self._hio.pop(li)
            self._land(idx, "io_h", *[x for x in (r, rs) if x is not None])
            reads.append(r)
            scales.append(rs)
        # one row of the group per member; a narrow group's reads are
        # shared by several jobs, so every fill keeps the threads busy
        step = -(-FILL_THREADS // len(reads))
        int8 = scales[0] is not None
        hidden = self._upload(
            (len(reads), n) + reads[0].row_shape, reads[0].dtype,
            [lambda buf, g=g, r=r, j=j: r.copy_into(buf[g], j, step)
             for g, r in enumerate(reads) for j in range(step)],
            torch.int8 if int8 else model.dtype)
        if int8:
            # the int8 rows and their fp32 scales go up in two slots (a
            # little over half a bf16 upload's bytes) and are multiplied
            # out on the compute stream before the projection
            scale = self._upload(
                (len(scales), n, 1), np.float32,
                [lambda buf, g=g, r=r: r.copy_into(buf[g])
                 for g, r in enumerate(scales)], torch.float32)
        t0 = time.perf_counter()
        rows = tuple(self._row_of[li] for li in members)
        cos, sin = pack.rope_tables(n, self.start_token)
        first = self.mgr.first_launch(("project", len(rows), s_bucket(n)))

        def project():
            h = (dequantize_hidden_int8_torch(hidden, scale).to(model.dtype)
                 if int8 else hidden)
            return project_group(pack, h, pack.rows(rows), cos, sin)
        k, v = self._timed(
            project,
            [(self._cur_idx, "project", self._task_work(t), 1.0, not first)])
        self._emit("put_kv_group", rows, k.unsqueeze(1), v.unsqueeze(1),
                   self.start_token)
        self.host_split["launch"] += time.perf_counter() - t0

    def _exec_blob(self, t: Task) -> None:
        """A recurrent session's states, bit for bit as stored."""
        store, sess, model = self.mgr.store, self.session, self.model
        states = []
        for name, dtype in (("state_conv", model.dtype),
                            ("state_ssm", torch.float32)):
            a = np.asarray(store.get_blob(sess, name, 0))
            states.append(self._upload(
                a.shape, a.dtype, [lambda buf, a=a: np.copyto(buf, a)],
                dtype))
        self._emit("put_states", *states)

    def _exec_io_enc(self, t: Task) -> None:
        """Submit the read of the encoder-output blob; the cross
        projection waits for it, so it overlaps the decoder's side."""
        self._encio = (self._cur_idx, self.mgr.store.submit_blob_read(
            self.session, "enc", 0))

    def _exec_project_cross(self, t: Task) -> None:
        """The cross K/V of every decoder layer from the stored encoder
        output, by the call its prefill made (``encdec.cross_kv``), so
        they are the prefill's bits."""
        from repro_torch.models import encdec
        idx, ticket = self._encio
        self._encio = None
        t0 = time.perf_counter()
        enc = np.asarray(ticket.wait()[0])
        self._observe_read(idx, "io_enc", [ticket])
        self.host_split["read"] += time.perf_counter() - t0
        enc_out = self._upload(enc.shape, enc.dtype,
                               [lambda buf: np.copyto(buf, enc)],
                               self.model.dtype)
        t0 = time.perf_counter()
        first = self.mgr.first_launch(("project_cross", enc.shape[0]))
        ck, cv = self._timed(
            lambda: encdec.cross_kv(self.params, enc_out[None],
                                    self.model.h),
            [(self._cur_idx, "project_cross", self._task_work(t), 1.0,
              not first)])
        self._emit("put_cross", ck, cv, int(enc.shape[0]))
        self.host_split["launch"] += time.perf_counter() - t0

    def _exec_recompute(self, t: Task) -> None:
        """The recompute prefix is rebuilt once, at its first task, by
        replaying the session's prefill and decode segments
        (``transformer.lm_replay_kv``), with a VLM session's stored patch
        embeddings where its first prefill had them; each task emits its
        layer. The replay's seconds are shared evenly among the prefix's
        tasks."""
        from repro_torch.models import transformer as tfm
        t0 = time.perf_counter()
        if self._re_kv is None:
            model, store = self.model, self.mgr.store
            toks = np.asarray(store.get_blob(
                self.session, "tok", 0))[:self.n_tokens]
            patches = None
            if store.has_blob(self.session, "patches", 0):
                a = np.asarray(store.get_blob(self.session, "patches", 0))
                patches = self._upload(
                    a.shape, a.dtype, [lambda buf, a=a: np.copyto(buf, a)],
                    model.dtype)
            n_re = len(self._re_layers)
            samples = [(i, "recompute", self._task_work(rt), 1.0 / n_re, True)
                       for i, rt in enumerate(self.tasks)
                       if rt.kind == "recompute"]
            toks = torch.from_numpy(toks.astype(np.int64))
            if self._cuda:
                toks = toks.pin_memory()
            toks = toks.to(model.device, non_blocking=True)
            self._re_kv = self._timed(lambda: tfm.lm_replay_kv(
                self.params, toks, self.segments, model.h, n_re, patches),
                samples)
        k, v = self._re_kv
        self._emit("put_kv", self._row_of[t.layer], k[t.layer], v[t.layer])
        self._re_next += 1
        self.host_split["launch"] += time.perf_counter() - t0

