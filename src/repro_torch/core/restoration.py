"""Pipelined restoration executor (paper §4.1) for the ``lm`` and ``ssm``
families.

A ``Schedule`` compiles into an ordered task graph (``compile_tasks``) of
per-layer steps: chunk-store reads of hidden states (``io_h``) and of raw
K/V (``io_kv``), whole-object reads (``blob``: an ``ssm`` session's
recurrent states), grouped hidden→K/V projections (``project``) and
recompute-prefix layers (``recompute``). Per-layer tasks of a layer that
is not an attention layer do nothing: such a layer is restored by the
state blob. The same graph serves:

  * ``replay``              — virtual two-stream replay of a task order
                              under a hardware profile → ``Timeline``;
  * ``RestorationExecutor`` — executes the graph, writing each finished
                              layer into a ``RestoreSink``. Its reported
                              ``Timeline`` is ``replay`` over the order it
                              actually ran, so the executor and the
                              analytic model cannot drift apart.

A projection group is one device call: the members' hidden states go up
in one upload from pinned host memory, the model's norm and the grouped
restoration kernel (``kernels.ops.restore_kv_grouped``) run over the
whole weight stack indexed by row, and the sink receives the group in one
call. The token axis is padded to a power-of-two bucket (``s_bucket``)
with zero rows that are sliced away. The virtual timeline is the model;
real IO/compute overlap on CUDA streams is later work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config.arch import BlockKind
from repro_torch.core.cost_model import (MethodTimes, layer_costs,
                                         link_priced_times)
from repro_torch.core.scheduler import Schedule
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



# ----------------------------------------------------- host <-> device words
def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy for the store, losslessly: numpy has no bfloat16,
    so bf16 travels as its raw 2-byte words (int16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def host_buffer(shape, dtype: np.dtype, device) -> torch.Tensor:
    """An uninitialised host staging buffer of numpy ``dtype``, pinned when
    it feeds a CUDA upload."""
    pin = torch.device(device).type == "cuda"
    return torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                       pin_memory=pin)


def to_device(x, dtype: torch.dtype, device) -> torch.Tensor:
    """Upload store data (numpy or a host tensor from ``host_buffer``) and
    view it as ``dtype``: int16 words become bf16 bit for bit."""
    if isinstance(x, np.ndarray):
        staged = host_buffer(x.shape, x.dtype, device)
        staged.numpy()[...] = x
        x = staged
    x = x.to(device, non_blocking=x.is_pinned())
    if dtype == torch.bfloat16 and x.dtype == torch.int16:
        return x.view(torch.bfloat16)
    return x.to(dtype)


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
        """A whole projection group's K/V; k/v (G, 1, n, kv_heads, hd)."""
        for g, row in enumerate(rows):
            self.put_kv(row, k[g], v[g], start)

    def put_states(self, conv, ssm) -> None:
        """An ssm session's recurrent states, (L, 1, W-1, I) and (L, 1,
        I, N)."""
        raise NotImplementedError

    def finish(self, n_tokens: int) -> None:
        raise NotImplementedError


class CacheAssembler(RestoreSink):
    """Builds a B=1 decode cache: dict(k, v (L,1,capacity,Kv,hd), lengths)
    for lm, whose pieces are written straight into a buffer of
    ``capacity`` positions (at least the restored length), so decoding
    can continue in it; dict(conv, ssm, lengths) for ssm."""

    def __init__(self, model, capacity: Optional[int] = None):
        self.model = model
        self.capacity = capacity
        self.k: Optional[torch.Tensor] = None
        self.v: Optional[torch.Tensor] = None
        self.states: Optional[tuple] = None
        self.cache: Optional[dict] = None

    def _buffers(self, n: int):
        if self.k is None:
            c = self.model.cfg
            shape = (c.n_layers, 1, max(self.capacity or 0, n),
                     c.n_kv_heads, c.head_dim_)
            self.k = torch.zeros(shape, dtype=self.model.dtype,
                                 device=self.model.device)
            self.v = torch.zeros_like(self.k)
        return self.k, self.v

    def put_kv(self, row, k, v, start=0):
        n = k.shape[1]
        kb, vb = self._buffers(start + n)
        kb[row, :, start:start + n] = k
        vb[row, :, start:start + n] = v

    def put_states(self, conv, ssm):
        self.states = (conv, ssm)

    def finish(self, n_tokens):
        lengths = torch.tensor([n_tokens], dtype=torch.int32,
                               device=self.model.device)
        if self.model.kind == "ssm":
            conv, ssm = self.states
            self.cache = {"conv": conv, "ssm": ssm, "lengths": lengths}
            return
        kb, vb = self._buffers(n_tokens)
        self.cache = {"k": kb, "v": vb, "lengths": lengths}


# ---------------------------------------------------------- param packing
def s_bucket(n: int, minimum: int = 16) -> int:
    """Power-of-two token bucket for projection shapes; the padded tail is
    zeros and its outputs are sliced away before the sink."""
    b = max(int(minimum), 1)
    while b < n:
        b <<= 1
    return b


class RestoreParamPack:
    """The restoration weights of every layer: references to the model's
    layer-stacked parameters (no copy), and RoPE tables cut from the
    shared table that prefill and decode gather from too."""

    def __init__(self, model, params):
        self.model = model
        self.blocks = params["blocks"]
        self.attn = model.h.attn
        self._tables: Dict[Tuple[int, int],
                           Tuple[torch.Tensor, torch.Tensor]] = {}

    def rope_tables(self, n_pos: int, offset: int = 0):
        """cos/sin (n_pos, head_dim//2) for positions [offset,
        offset + n_pos)."""
        key = (n_pos, offset)
        got = self._tables.get(key)
        if got is None:
            end = offset + n_pos
            cos, sin = rope_table(end, self.attn.head_dim,
                                  self.attn.rope_theta, self.model.device)
            got = (cos[offset:end].contiguous(), sin[offset:end].contiguous())
            self._tables[key] = got
        return got


def project_group(pack: RestoreParamPack, hidden: torch.Tensor,
                  rows: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """One projection group: hidden (G, S_bucket, D) in the model dtype,
    rows (G,) int32 pack rows -> k, v (G, S_bucket, Kv, hd). The same norm
    and kernel calls as prefill (``models/transformer.py``), so restored
    K/V equals prefill K/V."""
    from repro_torch.models import transformer as tfm
    normed = tfm.norm_rows(pack.blocks, rows, hidden, pack.model.cfg)
    return tfm.project_kv_rows(pack.blocks, rows, normed, cos, sin,
                               pack.attn)


# --------------------------------------------------------------- executor
class RestorationExecutor:
    """Execution of one session's restoration into a sink.

    Created by ``HCacheManager.begin_restore``. ``step(max_tasks)`` runs a
    bounded number of tasks, event-driven across the two virtual streams
    (whichever stream's clock is behind goes next); a serving engine
    steps it a few tasks per engine step. ``prefetch_step`` runs IO tasks
    only, before a sink is attached: pieces finished without a sink are
    kept and flushed by ``attach_sink``. Projection tasks are groups of
    ``mgr.restore_group_size`` layers. ``project_wall`` sums the wall
    seconds inside projection groups, synchronised with the device;
    ``wall_time`` the seconds inside ``step`` and ``prefetch_step``."""

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
        self.group_size = max(int(mgr.restore_group_size), 1)
        self.pack = mgr.param_pack(params)
        n_hidden = sum(1 for m in self.methods if m == "hidden")
        self._g_pad = min(self.group_size, max(n_hidden, 1))
        self.dispatch_overhead = mgr.hw.dispatch_overhead
        self.tasks = compile_tasks(
            self.methods, n_blobs=self.model.adapter.n_state_blobs,
            group_size=self.group_size)
        self.costs = layer_costs(mgr.cfg, self.n_eff, mgr.dtype_bytes)
        self.topology = mgr.store.shard_topology()
        self.times, layer_links = link_priced_times(
            self.costs, mgr.hw, io_streams=mgr.io_streams,
            topology=self.topology)
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
        self._hio: Dict[int, object] = {}     # layer -> hidden read ticket
        self._kvio: List[tuple] = []          # (layer, k ticket, v ticket)
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
        self._io_base = mgr.store.read_completion()
        self.io_measured = 0.0       # virtual read completion of this restore
        self.wall_time = 0.0         # seconds inside step() / prefetch_step()
        self.project_wall = 0.0

    # ------------------------------------------------------------- plumbing
    @property
    def done(self) -> bool:
        return all(self._done) and not self._kvio

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

    def timeline(self):
        """Timeline derived from the order tasks actually executed in."""
        order = self.executed + [i for i in range(len(self.tasks))
                                 if not self._done[i]]
        return replay(self.tasks, self.times, order,
                      dispatch_overhead=self.dispatch_overhead,
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
        self._reap_kv()
        if self.done and not self._finished and self.sink is not None:
            self.sink.finish(self.n_tokens)
            self._finished = True
        self.io_measured = max(
            self.io_measured, self.mgr.store.read_completion() - self._io_base)
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

    # ---------------------------------------------------------- task bodies
    def _run_task(self, idx: int) -> None:
        t = self.tasks[idx]
        dur = task_duration(t, self.times, self.dispatch_overhead)
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
        getattr(self, "_exec_" + t.kind)(t)
        self._done[idx] = True
        self.executed.append(idx)

    def _exec_io_h(self, t: Task) -> None:
        if t.layer not in self._row_of:
            return          # recurrent layers restore through the blob
        # the read completes when the projection consumes it
        self._hio[t.layer] = self.mgr.store.submit_layer_read(
            self.session, "h", t.layer, self.n_tokens,
            start_token=self.start_token)

    def _exec_io_kv(self, t: Task) -> None:
        if t.layer not in self._row_of:
            return          # recurrent layers restore through the blob
        store, sess, n = self.mgr.store, self.session, self.n_tokens
        d = self.start_token
        self._kvio.append((
            t.layer,
            store.submit_layer_read(sess, "kvk", t.layer, n, start_token=d),
            store.submit_layer_read(sess, "kvv", t.layer, n, start_token=d)))

    def _reap_kv(self) -> None:
        """Complete the K/V reads and emit them to the sink."""
        cfg, model = self.mgr.cfg, self.model
        for layer, rk, rv in self._kvio:
            ak, av = rk.wait(), rv.wait()
            shape = (1, self.n_eff, cfg.n_kv_heads, cfg.head_dim_)
            k = to_device(ak.data, model.dtype, model.device).reshape(shape)
            v = to_device(av.data, model.dtype, model.device).reshape(shape)
            self._emit("put_kv", self._row_of[layer], k, v, self.start_token)
        self._kvio = []

    def _exec_project(self, t: Task) -> None:
        model, pack, n = self.model, self.pack, self.n_eff
        members = [li for li in t.members if li in self._row_of]
        if not members:
            return          # recurrent layers restore through the blob
        S = s_bucket(n)
        G = max(self._g_pad, len(members))
        reads = [self._hio.pop(li).wait() for li in members]
        stack = host_buffer((G, S, reads[0].data.shape[-1]),
                            reads[0].data.dtype, model.device)
        buf = stack.numpy()
        for g, r in enumerate(reads):
            buf[g, :n] = r.data
        buf[:len(reads), n:] = 0
        buf[len(reads):] = 0
        rows = [self._row_of[li] for li in members]
        # pad to the stable group width with a repeated row over zero
        # hidden states; the padded outputs are sliced away below
        rows_pad = torch.tensor(rows + [rows[-1]] * (G - len(rows)),
                                dtype=torch.int32, device=model.device)
        cos, sin = pack.rope_tables(S, self.start_token)
        t0 = time.perf_counter()
        hidden = to_device(stack, model.dtype, model.device)
        k, v = project_group(pack, hidden, rows_pad, cos, sin)
        if k.is_cuda:
            torch.cuda.synchronize(k.device)
        self.project_wall += time.perf_counter() - t0
        g_real = len(members)
        self._emit("put_kv_group", tuple(rows), k[:g_real, None, :n],
                   v[:g_real, None, :n], self.start_token)

    def _exec_blob(self, t: Task) -> None:
        """An ssm session's recurrent states, bit for bit as stored."""
        store, sess, model = self.mgr.store, self.session, self.model
        conv = to_device(store.get_blob(sess, "state_conv", 0), model.dtype,
                         model.device)
        ssm = to_device(store.get_blob(sess, "state_ssm", 0), torch.float32,
                        model.device)
        self._emit("put_states", conv, ssm)

    def _exec_recompute(self, t: Task) -> None:
        """The recompute prefix is rebuilt once, at its first task, by
        replaying the session's prefill and decode segments
        (``transformer.lm_replay_kv``); each task emits its layer."""
        from repro_torch.models import transformer as tfm
        if self._re_kv is None:
            model = self.model
            toks = np.asarray(self.mgr.store.get_blob(
                self.session, "tok", 0))[:self.n_tokens]
            self._re_kv = tfm.lm_replay_kv(
                self.params, torch.from_numpy(toks.astype(np.int64)).to(
                    model.device), self.segments, model.h,
                len(self._re_layers))
        k, v = self._re_kv
        self._emit("put_kv", self._row_of[t.layer], k[t.layer], v[t.layer])
        self._re_next += 1
