"""Inference engine: continuous batching with an HCache restoration phase.

Request lifecycle (paper §5):

    WAITING -> [RESTORING]   if the session has evicted state in the store,
                             an incremental RestorationExecutor runs a
                             bounded number of pipeline tasks per engine
                             step, writing each finished layer straight
                             into the sequence's batch-slot buffers. Any
                             number of sessions restore concurrently, and
                             restoring sessions never block the decode
                             batch of active ones: a restore's uploads
                             run on the manager's copy stream and its
                             projections on the current stream, and no
                             step waits for the device for them until a
                             restore's end. Queued sessions with
                             stored state get their first hidden-layer IO
                             prefetched before a slot even frees;
            -> PREFILL       chunked prompt prefill (SplitFuse-style: at most
                             ``prefill_chunk`` prompt tokens per engine step,
                             so decode iterations stay interleaved);
            -> DECODE        joins the continuous decode batch; every step
                             streams the new token's hidden states to the
                             two-stage saver;
            -> PAUSED        mid-stream eviction under slot pressure: after
                             ``preempt_quantum`` steps of residency a
                             victim (EvictionPolicy) is dumped via
                             ``save_session_pause``, its slot handed to a
                             queued session (AdmissionPolicy), and it
                             re-enters through RESTORING with the last
                             sampled token as a 1-token resume prefill;
            -> DONE          on EOS/max-tokens: the session's state is
                             dumped (``save_session_pause``) and the slot is
                             freed; the session remains restorable.

Cache state lives behind a ``KVCacheBackend`` (serving/kv_cache.py): the
``contiguous`` layout (max_seq positions per slot) or the block-table
``paged`` layout, where admission reserves only the pages a session can
use, so a full page pool, not a full slot table, back-pressures the
queue. The engine touches cache state only through per-slot ``CacheView``
handles, and family-specific decisions go through the model's adapter.

A decode step runs at the full batch width, ``max_batch`` rows; the pause
dump records that width and the session's row, so a recompute-method
restore replays the step at the same shapes and stays bitwise.

Crash recovery: a fresh engine over the same ChunkStore can resume any
session (``recoverable_sessions``) — serving-side fault tolerance is
HCache itself.

Not ported yet, and refused at construction with the ROADMAP item that
brings them: prefix sharing and session forks, the host-storage budget
manager (``capacity=``) and tensor parallelism (``tp > 1``).

A family whose adapter cannot resume (``supports_resume`` false: the
``ssm`` family, whose prefill starts from zero state) serves each
session for one round: a request for a session that already has stored
state is refused, since its prefill would overwrite the restored state
(the JAX package serves such a round from zero state, silently dropping
the history).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.core.capacity import (AdmissionPolicy, EvictionPolicy,
                                       FIFOAdmission, LRUEviction)
from repro_torch.core.cost_model import LinkLoad
from repro_torch.core.hcache import HCacheManager
from repro_torch.serving.kv_cache import (KVCacheBackend, ViewSink,
                                          make_backend)
from repro_torch.serving.request import Phase, Request, SequenceState
from repro_torch.serving.sampling import sample


@dataclasses.dataclass
class EngineMetrics:
    ttft_wall: List[float] = dataclasses.field(default_factory=list)
    # two TTFT populations: sessions that went through restoration vs
    # cold starts. ``ttft_sim`` holds simulated restoration makespans for
    # restored sessions only.
    ttft_sim: List[float] = dataclasses.field(default_factory=list)
    ttft_wall_restored: List[float] = dataclasses.field(default_factory=list)
    ttft_wall_cold: List[float] = dataclasses.field(default_factory=list)
    tbt_wall: List[float] = dataclasses.field(default_factory=list)
    # every completed restoration's simulated makespan, resumes of
    # paused sessions included; the resume subset separately
    restore_sim_all: List[float] = dataclasses.field(default_factory=list)
    restore_sim_resume: List[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0                # mid-stream evictions (PAUSED)
    restored_tokens: int = 0
    restore_steps: int = 0              # engine steps that ran restore tasks
    restore_io_measured: float = 0.0    # striped-device completion (sim SSD)
    decode_steps: int = 0
    snapshot_cost: float = 0.0
    # occupancy / fragmentation gauges (KVCacheBackend.occupancy, sampled
    # once per engine step). live = tokens in occupied slots; reserved =
    # capacity handed out to them — the gap is internal fragmentation
    # (max_seq over-reservation under contiguous, page rounding under
    # paged).
    live_tokens: int = 0                # last sample
    reserved_tokens: int = 0
    free_blocks: int = 0
    live_tokens_peak: int = 0
    reserved_tokens_peak: int = 0
    concurrent_peak: int = 0            # max sessions resident at once
    occupancy_sum: float = 0.0          # running (sum, count)
    occupancy_count: int = 0
    alloc_stalls: int = 0               # admissions deferred: pool exhausted
    io_streams_peak: int = 1            # max concurrent RESTORING slots
    # scheduler-calibration gauges, per completed restore that observed
    # its task durations (a MeasuredProfile on the manager): the bubble
    # (idle share of the slack stream in the measured-duration replay),
    # the planned and the measured makespan and the relative error of
    # the one against the other; profiler_samples is the profile's
    # per-kind sample count (empty when the engine runs uncalibrated)
    restore_bubble_sum: float = 0.0
    restore_bubble_n: int = 0
    makespan_err_sum: float = 0.0
    makespan_err_n: int = 0
    makespan_predicted: List[float] = dataclasses.field(default_factory=list)
    makespan_measured: List[float] = dataclasses.field(default_factory=list)
    profiler_samples: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    device_gauges: List[dict] = dataclasses.field(default_factory=list)
    restore_project_wall: float = 0.0   # sum over completed restores
    restore_wall_sum: float = 0.0

    @property
    def occupancy_mean(self) -> float:
        return (self.occupancy_sum / self.occupancy_count
                if self.occupancy_count else 0.0)

    @property
    def fragmentation_mean(self) -> float:
        return 1.0 - self.occupancy_mean if self.occupancy_count else 0.0

    @property
    def restore_bubble_mean(self) -> float:
        return (self.restore_bubble_sum / self.restore_bubble_n
                if self.restore_bubble_n else 0.0)

    @property
    def makespan_err_mean(self) -> float:
        return (self.makespan_err_sum / self.makespan_err_n
                if self.makespan_err_n else 0.0)

    @staticmethod
    def _summary(xs: List[float]) -> Dict[str, float]:
        if not xs:
            return {"n": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0, "max": 0.0}
        a = np.asarray(xs, np.float64)
        return {"n": int(a.size), "mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)),
                "max": float(a.max())}

    def to_dict(self) -> dict:
        """JSON-serializable dump of every counter and gauge; per-request
        populations summarized as n/mean/p50/p99/max. What ``serve.py
        --metrics-json`` writes."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "device_gauges":
                out[f.name] = [dict(r) for r in v]
            elif f.name == "profiler_samples":
                out[f.name] = dict(v)
            elif isinstance(v, list):
                out[f.name] = self._summary(v)
            else:
                out[f.name] = v
        for prop in ("occupancy_mean", "fragmentation_mean",
                     "restore_bubble_mean", "makespan_err_mean"):
            out[prop] = float(getattr(self, prop))
        return out


class InferenceEngine:
    def __init__(self, model, params, manager: HCacheManager, *,
                 max_batch: int = 4, max_seq: int = 512,
                 prefill_chunk: int = 128, save_hidden: bool = True,
                 temperature: float = 0.0, restore_tasks_per_step: int = 8,
                 prefetch_sessions: int = 2,
                 admission: Optional[AdmissionPolicy] = None,
                 eviction: Optional[EvictionPolicy] = None,
                 preempt_quantum: Optional[int] = None,
                 capacity=None,
                 backend: Union[str, KVCacheBackend] = "contiguous",
                 block_size: int = 16,
                 cache_blocks: Optional[int] = None,
                 prefix_sharing: bool = False,
                 tp: int = 1):
        if prefix_sharing:
            raise NotImplementedError(
                "prefix sharing is not ported yet (ROADMAP queue 1: prefix "
                "sharing and copy-on-write pages)")
        if capacity is not None:
            raise NotImplementedError(
                "the host-storage budget manager is not ported yet "
                "(ROADMAP queue 1: restoration extras, the int8 codec with "
                "CapacityManager)")
        if tp > 1:
            raise NotImplementedError(
                "tensor parallelism is not ported yet (ROADMAP queue 1: "
                "multi-GPU)")
        self.model = model
        self.adapter = model.adapter
        self.params = params
        self.mgr = manager
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.prefill_chunk = prefill_chunk
        self.save_hidden = save_hidden
        self.temperature = temperature
        self.restore_tasks_per_step = restore_tasks_per_step
        self.prefetch_sessions = prefetch_sessions
        self.admission = admission or FIFOAdmission()
        self.eviction = eviction or LRUEviction()
        # minimum resident steps before a DECODE session is
        # eviction-eligible; None disables mid-stream eviction
        self.preempt_quantum = preempt_quantum
        self.kv = make_backend(backend, model, max_batch, max_seq,
                               block_size=block_size, num_blocks=cache_blocks)
        # token callbacks: on_token fires once per emitted token (the
        # resume feed after a pause replays an existing token and does not
        # re-fire); on_finish once per request at retire, with reason
        # "stop" (EOS) or "length"; on_pause at each mid-stream eviction
        self.on_token = None               # fn(seq, tok)
        self.on_finish = None              # fn(seq, reason)
        self.on_pause = None               # fn(seq)
        self.queue: deque = deque()
        self.slots: List[Optional[SequenceState]] = [None] * max_batch
        self.sessions: Dict[str, SequenceState] = {}
        self._prefetch: Dict[str, object] = {}   # session -> warm executor
        self.metrics = EngineMetrics()
        self.step_count = 0

    # ----------------------------------------------------------- submission
    def submit(self, request: Request) -> SequenceState:
        self._refuse_unresumable(request.session_id)
        seq = SequenceState(request=request)
        if request.arrival_time == 0.0:
            seq.request.arrival_time = time.perf_counter()
        if request.arrival_step < 0:
            seq.request.arrival_step = self.step_count
        seq.enqueue_step = self.step_count
        self.queue.append(seq)
        return seq

    def recoverable_sessions(self) -> List[str]:
        return self.mgr.sessions()

    # ------------------------------------------------------------ lifecycle
    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _tokens_needed(self, seq: SequenceState) -> int:
        """Worst-case final token length of this residency: stored
        history + the pending prompt + the decode tokens still owed.
        What a paged reservation must cover (contiguous always reserves
        max_seq)."""
        manifest = self.mgr.store.get_manifest(seq.request.session_id)
        stored = (int(manifest["n_tokens"]) if manifest
                  else seq.history_len)
        return (stored + len(seq.effective_prompt)
                + seq.request.max_new_tokens - len(seq.generated))

    def _admit(self) -> None:
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                break
            seq = self.admission.select(tuple(self.queue), self)
            if seq is None:
                break
            if not self.kv.can_reserve(self._tokens_needed(seq)):
                # allocator backpressure: a free slot exists but the page
                # pool cannot hold the session — wait for retires/frees
                self.metrics.alloc_stalls += 1
                break
            self.queue.remove(seq)
            if not self._place(seq, slot):
                break
        self._prefetch_queued()

    def _refuse_unresumable(self, sid: str) -> None:
        if (not self.adapter.supports_resume
                and self.mgr.store.get_manifest(sid) is not None):
            raise NotImplementedError(
                f"session {sid!r} has stored state, and a "
                f"{self.adapter.kind!r} model cannot prefill on top of "
                "restored state (its prefill starts from zero state; the "
                "JAX package's second round drops the history, ROADMAP "
                "queue 3)")

    def _place(self, seq: SequenceState, slot: int) -> bool:
        """Bind a (possibly resuming) sequence to a free batch slot.
        False iff the backend could not reserve capacity (the sequence is
        requeued and the slot stays free)."""
        sid = seq.request.session_id
        self._refuse_unresumable(sid)
        if not self.kv.reserve(slot, self._tokens_needed(seq)):
            self.metrics.alloc_stalls += 1
            self.queue.appendleft(seq)
            return False
        seq.slot = slot
        seq.admit_step = self.step_count
        seq.view = self.kv.view(slot)
        self.slots[slot] = seq
        self.sessions[sid] = seq
        manifest = self.mgr.store.get_manifest(sid)
        if manifest:
            n_man = int(manifest["n_tokens"])
            seq.phase = Phase.RESTORING
            ex = self._prefetch.pop(sid, None)
            if ex is not None and (
                    ex.n_tokens != n_man
                    or list(ex.methods) != list(manifest["methods"])):
                # the session saved more state after the prefetch
                # started: the warm executor is stale
                ex = None
            if ex is None:
                # this restore joins the already-RESTORING slots on the
                # shared host link: plan it at the new multiplicity
                self._update_io_streams()
                ex = self.mgr.begin_restore(self.params, sid)
            ex.attach_sink(ViewSink(seq.view))
            seq.executor = ex
            # reserve [0, n) now: concurrent decode steps park their
            # scratch K/V write at position n (later overwritten by this
            # session's own prefill), never inside the restored range
            self.kv.set_length(slot, ex.n_tokens)
        else:
            seq.phase = Phase.PREFILL
            self._prefill_step(seq)
        return True

    # ----------------------------------------------------------- preemption
    def _maybe_preempt(self) -> None:
        """Mid-stream eviction under slot pressure (one victim per step):
        pause a resident DECODE session past its quantum, hand its slot
        to the admission policy's next pick. The victim re-enters through
        the RESTORING pipeline."""
        if (self.preempt_quantum is None or not self.save_hidden
                or not self.adapter.supports_resume or not self.queue):
            return
        if self._free_slot() is not None:
            # a slot is open, so preemption is only justified when the
            # second admission gate — the page pool — blocks the queue;
            # pausing a victim recycles its pages
            seq = self.admission.select(tuple(self.queue), self)
            if seq is None or self.kv.can_reserve(self._tokens_needed(seq)):
                return
        candidates = [s for s in self.slots
                      if s is not None and s.phase == Phase.DECODE
                      and s.generated and not s.finished()
                      and self.step_count - s.admit_step
                      >= self.preempt_quantum]
        victim = self.eviction.select_victim(candidates, self)
        if victim is None:
            return
        slot = victim.slot
        self._pause_slot(slot)
        waiting = [s for s in self.queue if s is not victim]
        seq = self.admission.select(tuple(waiting), self)
        if seq is not None:
            self.queue.remove(seq)
            self._place(seq, slot)

    def _save_pause(self, s: SequenceState) -> None:
        """Dump a resident session's restorable state through the
        manager: the history through the last sampled token's
        predecessor, with the decode batch it ran in."""
        self.mgr.saver.drain()
        self.mgr.save_session_pause(
            s.request.session_id, s.view.snapshot(), s.total_len - 1,
            tokens_tail=np.asarray(s.generated[s.tok_saved:-1], np.int32),
            batch_width=self.max_batch, batch_row=s.slot)
        s.tok_saved = len(s.generated) - 1

    def _pause_slot(self, i: int) -> None:
        """Evict the resident of slot ``i`` mid-decode: dump restorable
        state, free the slot, requeue the sequence as PAUSED. The last
        sampled token (whose K/V does not exist yet) becomes the 1-token
        resume prefill after restoration."""
        s = self.slots[i]
        self._save_pause(s)
        s.gen_absorbed = len(s.generated)
        s.pending_prompt = np.asarray([s.generated[-1]], np.int32)
        s.pending_from_gen = True
        s.prefill_done = 0
        s.history_len = 0              # re-set when restoration completes
        s.phase = Phase.PAUSED
        s.slot = -1
        s.executor = None
        s.view.free()
        s.view = None
        s.pauses += 1
        s.enqueue_step = self.step_count
        self.slots[i] = None
        self.queue.append(s)
        self.metrics.preemptions += 1
        if self.on_pause is not None:
            self.on_pause(s)

    # ----------------------------------------------------------- restoration
    def _prefetch_queued(self) -> None:
        """Warm the first IO reads of queued sessions with stored state
        before a slot frees (their executor starts part-done on admit)."""
        for seq in list(self.queue)[:self.prefetch_sessions]:
            sid = seq.request.session_id
            ex = self._prefetch.get(sid)
            if ex is None and self.mgr.store.get_manifest(sid):
                ex = self.mgr.begin_restore(self.params, sid)
                self._prefetch[sid] = ex
            if ex is not None:
                ex.prefetch_step(1)

    def _update_io_streams(self, extra: int = 0) -> None:
        """Report the restore multiplicity to the planner: how many
        sessions are (about to be) pulling the shared host link at once.
        ``extra`` counts a restore being placed this instant, before its
        slot shows RESTORING.

        On a multi-host store, each restoring executor's NIC links are
        also folded into a per-link ``LinkLoad``, so a restore is charged
        only for the links it shares with those in flight (a restore being
        placed has no executor yet and counts on every link)."""
        restoring = [s.executor for s in self.slots
                     if s is not None and s.phase == Phase.RESTORING
                     and s.executor is not None]
        n = max(len(restoring) + extra, 1)
        self.mgr.set_io_streams(n)
        topo = self.mgr.store.shard_topology()
        if topo is not None and topo.n_shards > 1:
            streams: Dict[int, int] = {}
            for ex in restoring:
                for link in ex.links_touched():
                    streams[link] = streams.get(link, 0) + 1
            for link in range(topo.n_shards):
                streams[link] = streams.get(link, 0) + extra
            self.mgr.set_link_load(LinkLoad(streams))
        self.metrics.io_streams_peak = max(self.metrics.io_streams_peak, n)

    def _restore_step(self) -> None:
        """Advance every RESTORING session by a bounded number of pipeline
        tasks. Several sessions restore concurrently; the decode batch of
        active sessions runs in the same engine step regardless."""
        ran = False
        for seq in self.slots:
            if seq is None or seq.phase != Phase.RESTORING:
                continue
            ran = True
            if seq.executor.step(self.restore_tasks_per_step):
                ex = seq.executor
                seq.executor = None
                seq.restored = True
                seq.history_len = ex.n_tokens
                seq.restore_sim = ex.timeline().makespan
                seq.restore_wall = ex.wall_time
                m = self.metrics
                m.restored_tokens += ex.n_tokens - ex.start_token
                m.restore_sim_all.append(seq.restore_sim)
                if seq.pending_from_gen:       # resume of a paused session
                    m.restore_sim_resume.append(seq.restore_sim)
                m.restore_io_measured = max(m.restore_io_measured,
                                            ex.io_measured)
                m.restore_project_wall += ex.project_wall
                m.restore_wall_sum += ex.wall_time
                self._record_calibration(ex)
                seq.phase = Phase.PREFILL
        if ran:
            self.metrics.restore_steps += 1

    def _record_calibration(self, ex) -> None:
        """Calibration gauges of one finished restore: its bubble and its
        planned-vs-measured makespan, when it observed task durations."""
        m = self.metrics
        if ex.observed:
            tl = ex.measured_timeline()
            if tl.makespan > 0:
                # the bottleneck stream's bubble is ~0 by construction;
                # the slack stream's idle share is the bubble the
                # scheduler exists to close
                m.restore_bubble_sum += max(tl.io_bubble, tl.compute_bubble)
                m.restore_bubble_n += 1
                m.makespan_predicted.append(ex.predicted_makespan)
                m.makespan_measured.append(tl.makespan)
                if ex.predicted_makespan > 0:
                    m.makespan_err_sum += (abs(ex.predicted_makespan
                                               - tl.makespan) / tl.makespan)
                    m.makespan_err_n += 1
        if self.mgr.profile is not None:
            m.profiler_samples = self.mgr.profile.sample_counts()

    # -------------------------------------------------------------- prefill
    def _prefill_step(self, seq: SequenceState) -> None:
        """Process up to ``prefill_chunk`` prompt tokens (SplitFuse;
        families whose adapter is not ``chunkable`` take the whole prompt
        in one step).

        After a mid-stream eviction the "prompt" is the resume feed
        (``effective_prompt``): the last sampled token, whose K/V is
        recreated here on top of the restored [0, n) range."""
        if seq.phase != Phase.PREFILL:
            return
        ad = self.adapter
        prompt = seq.effective_prompt
        remaining = prompt[seq.prefill_done:]
        if len(remaining) == 0:
            seq.phase = Phase.DECODE
            return
        chunk = remaining[:self.prefill_chunk] if ad.chunkable else remaining
        hist = seq.history_len + seq.prefill_done
        out = ad.prefill_chunk(self.params, seq, chunk, hist,
                               capture_hidden=self.save_hidden)
        ad.absorb_prefill(seq.view, out, len(chunk), hist)
        seq.view.set_length(hist + len(chunk))
        if self.save_hidden:
            self.mgr.save_prefill(seq.request.session_id, np.asarray(chunk),
                                  out, start=hist)
        seq.prefill_done += len(chunk)
        if seq.pending_from_gen and self.save_hidden:
            seq.tok_saved += len(chunk)   # resume feed landed in tok blob
        if seq.prefill_done >= len(prompt):
            seq.phase = Phase.DECODE
            tok = int(sample(out["logits"], temperature=self.temperature)[0])
            self._emit_token(seq, tok)

    # --------------------------------------------------------------- decode
    def _emit_token(self, seq: SequenceState, tok: int) -> None:
        seq.generated.append(tok)
        if seq.first_token_step is None:
            seq.first_token_step = self.step_count
            seq.ttft_wall = time.perf_counter() - seq.request.arrival_time
            self.metrics.ttft_wall.append(seq.ttft_wall)
            if seq.restored:
                self.metrics.ttft_sim.append(seq.restore_sim)
                self.metrics.ttft_wall_restored.append(seq.ttft_wall)
            else:
                self.metrics.ttft_wall_cold.append(seq.ttft_wall)
        if self.on_token is not None:
            self.on_token(seq, tok)

    def _decode_batch(self) -> None:
        active = [s for s in self.slots
                  if s is not None and s.phase == Phase.DECODE
                  and not s.finished()]
        if not active:
            return
        t0 = time.perf_counter()
        tokens = np.zeros((self.max_batch, 1), np.int64)
        for s in self.slots:
            if s is not None and s.phase == Phase.DECODE and s.generated:
                tokens[s.slot, 0] = s.generated[-1]
        mask = np.zeros((self.max_batch,), bool)
        for s in active:
            mask[s.slot] = True
        lg, hidden = self.kv.decode(self.params, tokens, active=mask)
        # inactive slots advanced their length too — undo
        lengths = self.kv.get_lengths()
        lengths[~mask] -= 1
        self.kv.set_lengths(lengths)
        toks = sample(lg, temperature=self.temperature).cpu().numpy()
        if self.save_hidden and hidden is not None:
            # only truly-active sessions: a session that finished at
            # prefill completion still sits in its slot in DECODE phase
            # until _retire, and saving its masked-out scratch step would
            # overwrite the last legitimate hidden row
            active_slots = {s.slot for s in active}
            sess = [s.request.session_id if (s is not None
                    and s.slot in active_slots) else None
                    for s in self.slots]
            self.metrics.snapshot_cost += self.mgr.save_decode_hidden(
                sess, self.adapter.decode_hidden(hidden), lengths - 1)
        dt = time.perf_counter() - t0
        for s in active:
            self._emit_token(s, int(toks[s.slot]))
            self.metrics.tbt_wall.append(dt)
        self.metrics.decode_steps += 1

    def _retire(self) -> None:
        for i, s in enumerate(self.slots):
            if s is None or not s.finished():
                continue
            if self.save_hidden:
                self._save_pause(s)
            s.phase = Phase.DONE
            s.view.free()
            s.view = None
            self.slots[i] = None
            if self.on_finish is not None:
                r = s.request
                reason = ("stop" if (r.eos_token is not None and s.generated
                                     and s.generated[-1] == r.eos_token)
                          else "length")
                self.on_finish(s, reason)

    # ------------------------------------------------------------ main loop
    def _sample_occupancy(self) -> None:
        occ = self.kv.occupancy()
        m = self.metrics
        m.live_tokens = occ.live_tokens
        m.reserved_tokens = occ.reserved_tokens
        m.free_blocks = occ.free_blocks
        m.live_tokens_peak = max(m.live_tokens_peak, occ.live_tokens)
        m.reserved_tokens_peak = max(m.reserved_tokens_peak,
                                     occ.reserved_tokens)
        resident = sum(1 for s in self.slots if s is not None)
        m.concurrent_peak = max(m.concurrent_peak, resident)
        if occ.reserved_tokens:
            m.occupancy_sum += occ.utilization
            m.occupancy_count += 1
        # one device: the pool row, plus the share of completed-restore
        # wall spent inside the projection launches
        util = (int(round(100.0 * m.restore_project_wall
                          / m.restore_wall_sum))
                if m.restore_wall_sum > 0 else 0)
        rows = self.kv.device_occupancy()
        for r in rows:
            r["proj_util_pct"] = util
        m.device_gauges = rows

    def step(self) -> None:
        self.step_count += 1
        # refresh the planner's view of restore contention (completed
        # restores lower the multiplicity; admission below may raise it)
        self._update_io_streams()
        self._admit()
        self._maybe_preempt()
        self._restore_step()
        for s in list(self.slots):
            if s is not None and s.phase == Phase.PREFILL:
                self._prefill_step(s)
        self._decode_batch()
        self._sample_occupancy()
        self._retire()

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                break
            self.step()
        self.mgr.saver.drain()

    def close(self) -> None:
        """Stop the two-stage saver's daemon threads (and surface any
        write error they captured)."""
        self.mgr.saver.close()

    # --------------------------------------------------------------- output
    def result(self, session_id: str) -> List[int]:
        return list(self.sessions[session_id].generated)
