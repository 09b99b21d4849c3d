"""Session lifecycle policies of the serving engine and its host-storage
budget (the JAX package's ``core/capacity.py``):

  * ``AdmissionPolicy``   — which queued session gets the next free batch
                            slot (FIFO, restore-cost-aware/SJF, priority);
  * ``EvictionPolicy``    — which resident session is paused mid-stream
                            when the queue is backed up (LRU by admission
                            recency, restore-cost-weighted);
  * ``CapacityManager``   — host-storage byte budget: when
                            ``ChunkStore.bytes_used`` exceeds it, idle
                            sessions step down a ladder — hot->cold tier
                            demotion, int8 re-encode of the hidden rows,
                            token-only (restore by recompute), and last
                            an outright drop.

Policies are duck-typed over the engine's ``SequenceState`` (this module
never imports ``repro_torch.serving``); restore-cost estimates come from
the same compiled task graph the executor runs (``core.restoration``), so
a policy's notion of "cheap to restore" and the engine's actual
restoration cost cannot drift apart.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import layer_costs, link_priced_times
from repro_torch.core.restoration import (compile_tasks, cross_restore_times,
                                          measured_dispatch_overhead, replay,
                                          task_links)


# ----------------------------------------------------- restore-cost estimate
def restore_makespan(mgr, n_tokens: int,
                     methods: Optional[Sequence[str]] = None, *,
                     enc_len: int = 0) -> float:
    """Estimated restoration makespan (seconds) for a session of
    ``n_tokens``: the two-stream replay of the task graph the executor
    would run (with an enc-dec session's ``io_enc``/``project_cross``
    pair priced at its ``enc_len`` stored encoder positions), under the
    group plan it would resolve
    (``mgr.resolve_group_size``), priced under the manager's
    ``MeasuredProfile`` where it has samples (``mgr.hw`` elsewhere) and
    with the IO legs stretched by the engine-reported restore
    multiplicity (``mgr.io_streams``; on a multi-host store, on the links
    each layer's stripes occupy under ``mgr.link_load``), so admission
    and eviction cost a restore under the bandwidth it would contend
    for."""
    if n_tokens <= 0:
        return 0.0
    if methods is None:
        methods = mgr.plan(n_tokens).methods
    times, layer_links = link_priced_times(
        layer_costs(mgr.cfg, n_tokens, mgr.dtype_bytes), mgr.hw,
        profile=mgr.profile, io_streams=mgr.io_streams,
        topology=mgr.store.shard_topology(), link_load=mgr.link_load)
    adapter = mgr.model.adapter
    tasks = compile_tasks(tuple(methods), n_blobs=adapter.n_state_blobs,
                          group_size=mgr.resolve_group_size(
                              n_tokens, methods, enc_len=enc_len),
                          cross=adapter.has_cross)
    return replay(tasks, times,
                  dispatch_overhead=measured_dispatch_overhead(mgr.hw,
                                                               mgr.profile),
                  cross_times=(cross_restore_times(mgr, enc_len)
                               if adapter.has_cross else None),
                  links=task_links(tasks, layer_links)).makespan


def session_restore_cost(mgr, session_id: str) -> float:
    """Makespan estimate for a *stored* session, from its manifest
    (0.0 for a cold session with no stored state)."""
    man = mgr.store.get_manifest(session_id)
    if not man:
        return 0.0
    return restore_makespan(mgr, int(man.get("n_tokens", 0)),
                            man.get("methods"),
                            enc_len=int(man.get("enc_len", 0)))


# ------------------------------------------------------------- admission
class AdmissionPolicy:
    """Picks which queued sequence is admitted into a free batch slot."""

    name = "admission"

    def select(self, queue: Sequence, engine):
        raise NotImplementedError


class FIFOAdmission(AdmissionPolicy):
    name = "fifo"

    def select(self, queue, engine):
        return queue[0] if queue else None


class RestoreCostAwareAdmission(AdmissionPolicy):
    """Shortest-restore-first: admit the session whose time-to-resume is
    smallest (cold sessions estimate 0 — prompt prefill is paid either
    way). Minimizes mean TTFT; pure SJF starves long-history sessions,
    so an aging credit (seconds of makespan per engine step waited,
    measured from ``SequenceState.enqueue_step``) lowers a request's
    effective cost the longer it queues — any session eventually ages
    below the cheapest newcomer and must be admitted."""

    name = "restore_cost"

    def __init__(self, aging: float = 0.0):
        self.aging = aging

    def select(self, queue, engine):
        if not queue:
            return None
        now = getattr(engine, "step_count", 0)

        def key(s):
            waited = max(now - getattr(s, "enqueue_step", 0), 0)
            cost = session_restore_cost(engine.mgr, s.request.session_id)
            return (cost - self.aging * waited, s.request.request_id)

        return min(queue, key=key)


class PriorityAdmission(AdmissionPolicy):
    """Highest ``Request.priority`` first; FIFO within a priority tier."""

    name = "priority"

    def select(self, queue, engine):
        if not queue:
            return None
        return max(queue, key=lambda s: (s.request.priority,
                                         -s.request.request_id))


# -------------------------------------------------------------- eviction
class EvictionPolicy:
    """Picks the resident victim to pause when the queue is backed up."""

    name = "eviction"

    def select_victim(self, candidates: Sequence, engine):
        raise NotImplementedError


class LRUEviction(EvictionPolicy):
    """Evict the longest-resident session (earliest admission). With a
    FIFO queue this degenerates to round-robin time slicing."""

    name = "lru"

    def select_victim(self, candidates, engine):
        if not candidates:
            return None
        return min(candidates, key=lambda s: (s.admit_step,
                                              s.request.request_id))


class RestoreCostAwareEviction(EvictionPolicy):
    """Evict the session that will be cheapest to bring back: its future
    restoration covers ``total_len - 1`` tokens (the last sampled token
    is re-fed, not restored). Keeps the expensive long-history sessions
    resident, so the restore traffic the eviction churn generates is
    minimized."""

    name = "restore_cost"

    def select_victim(self, candidates, engine):
        if not candidates:
            return None

        def key(s):
            # an enc-dec session's cross side is priced as admission
            # prices it, at the encoder length its manifest stores
            man = engine.mgr.store.get_manifest(s.request.session_id) or {}
            return (restore_makespan(engine.mgr, max(s.total_len - 1, 0),
                                     enc_len=int(man.get("enc_len", 0))),
                    s.request.request_id)

        return min(candidates, key=key)


EVICTION_POLICIES = {"lru": LRUEviction,
                     "restore_cost": RestoreCostAwareEviction}
ADMISSION_POLICIES = {"fifo": FIFOAdmission,
                      "restore_cost": RestoreCostAwareAdmission,
                      "priority": PriorityAdmission}


# ------------------------------------------------------------ capacity
class CapacityManager:
    """Host-storage budget enforcement and per-session footprints.

    Wired two ways (both optional, both safe together):

      * engine-driven — ``maintain(engine)`` once per engine step keeps
        recency fresh and runs the reclaim ladder;
      * store-driven  — when the hot tier is a ``StorageArray`` with a
        ``budget_bytes``, the manager registers a pressure callback, so a
        write burst reclaims without waiting for the next engine step.
        With an engine attached, the callback walks only on the thread
        that steps the engine (a save there reclaims at once); a write
        on another thread (the two-stage saver's) leaves the reclaim to
        the engine's next ``maintain``: the ladder reads the engine's
        slots and queue, which only that thread may walk.

    Resident, queued and prefetching sessions are protected: their
    streams are being appended to or read by a live executor (whose
    uploads and projections may be in flight on the card) and must not
    be re-encoded under it. One ladder walk runs at a time: a walk that
    finds another running (or is re-entered through the store) returns
    at once. The ladder's stages, mildest first:

      cold       move all chunks hot->cold tier (needs ``store.cold``)
      int8       re-encode "h" to int8 (+ per-token scales)
      recompute  drop "h"/"kv" streams; token-only, restore by recompute
      drop       evict the session outright (last resort)
    """

    LADDER = ("cold", "int8", "recompute", "drop")

    def __init__(self, mgr, *, host_budget_bytes: Optional[int] = None,
                 ladder: Sequence[str] = LADDER):
        self.mgr = mgr
        self.store = mgr.store
        self.ladder = tuple(ladder)
        self.host_budget_bytes = host_budget_bytes
        self.actions: List[Tuple[str, str]] = []   # (stage, session) log
        self._last_active: Dict[str, int] = {}
        self._engine = None
        self._engine_thread: Optional[int] = None
        self._walk = threading.Lock()
        array = self.store.devices
        if hasattr(array, "on_pressure"):
            if host_budget_bytes is not None:
                array.budget_bytes = host_budget_bytes
            elif array.budget_bytes is not None:
                self.host_budget_bytes = array.budget_bytes
            array.on_pressure(lambda _arr: self._on_pressure())

    # ------------------------------------------------------------ tracking
    def attach_engine(self, engine) -> None:
        self._engine = engine
        self._engine_thread = threading.get_ident()

    def _on_pressure(self) -> None:
        if (self._engine is not None
                and threading.get_ident() != self._engine_thread):
            return          # the engine's next maintain reclaims
        self.ensure_host_budget()

    def touch(self, session_id: str, step: int) -> None:
        self._last_active[session_id] = step

    def over_budget(self) -> bool:
        return (self.host_budget_bytes is not None
                and self.store.bytes_used > self.host_budget_bytes)

    def footprint(self, session_id: str) -> int:
        return self.store.bytes_for(session_id)

    def _protected(self) -> set:
        """Sessions the ladder must not touch: resident (streams being
        appended), prefetching (a live executor reads their chunks), and
        queued (in-flight requests: dropping a paused session's stored
        state would lose its history)."""
        eng = self._engine
        if eng is None:
            return set()
        resident = {s.request.session_id for s in eng.slots if s is not None}
        queued = {s.request.session_id for s in eng.queue}
        return resident | queued | set(eng._prefetch)

    def _candidates(self, protected: set) -> List[str]:
        """Evictable stored sessions, coldest (least recently active)
        first; never-seen sessions sort coldest of all."""
        sids = [s for s in self.store.sessions() if s not in protected]
        return sorted(sids, key=lambda s: (self._last_active.get(s, -1), s))

    # ------------------------------------------------------------- reclaim
    def maintain(self, engine) -> None:
        """Per-engine-step upkeep: refresh recency for resident sessions
        and enforce the budget."""
        self._engine_thread = threading.get_ident()
        for s in engine.slots:
            if s is not None:
                self.touch(s.request.session_id, engine.step_count)
        self.ensure_host_budget()

    # ---------------------------------------------------------- promotion
    def consider_promotion(self, session_id: str) -> bool:
        """On a save of a session in the int8 codec, while the budget has
        room for it: re-encode its "h" stream at full fidelity, so the
        stream stops accumulating quantization loss and restores without
        the dequantize. The engine calls this after every save
        (``_after_save``); a no-op without a budget, for sessions not in
        the int8 codec, or when the re-encode (``store_dtype`` bytes per
        element, written to the hot tier) would not fit."""
        if self.host_budget_bytes is None:
            return False
        eng = self._engine
        if eng is not None:
            # as the ladder's _protected(): never re-encode streams a
            # prefetch executor may be reading (a queued request for this
            # resident session can have reads in flight)
            queued = {s.request.session_id for s in eng.queue}
            if session_id in queued or session_id in eng._prefetch:
                return False
        man = self.mgr.store.get_manifest(session_id)
        if not man or man.get("compress", "none") != "int8":
            return False
        headroom = self.host_budget_bytes - self.store.bytes_used
        # int8 "h" bytes == element count
        itemsize = np.dtype(self.mgr.store_dtype).itemsize
        extra = itemsize * self.store.bytes_for(session_id, "h")
        if headroom < extra:
            return False
        if self.mgr.promote_hidden_fp16(session_id):
            self.actions.append(("promote", session_id))
            return True
        return False

    def sweep_promotions(self, limit: int = 1) -> int:
        """Promote up to ``limit`` idle int8 sessions back to the full
        codec while the budget has room, warmest (most recently active)
        first, so a session that went idle right after its demotion need
        not wait for its next save. Called on the engine's idle steps.
        Returns the promotions taken."""
        if self.host_budget_bytes is None or self._walk.locked():
            return 0
        taken = 0
        prot = self._protected()
        sids = [s for s in self.store.sessions() if s not in prot]
        sids.sort(key=lambda s: (-self._last_active.get(s, -1), s))
        for sid in sids:
            if taken >= limit:
                break
            if self.consider_promotion(sid):
                taken += 1
        return taken

    def _apply(self, stage: str, sid: str) -> bool:
        if stage == "cold":
            return self.store.demote_session_to_cold(sid) > 0
        if stage == "int8":
            return self.mgr.demote_hidden_int8(sid)
        if stage == "recompute":
            return self.mgr.degrade_to_recompute(sid)
        if stage == "drop":
            self._last_active.pop(sid, None)
            # no drain: the walk may run on a saver thread, and a session
            # outside _protected() has no rows in flight
            self.mgr.evict(sid, drain=False)
            return True
        raise ValueError(stage)

    def ensure_host_budget(self, protected: Sequence[str] = ()) -> int:
        """Walk the ladder, coldest sessions first within each stage,
        until the hot tier fits the budget (or nothing evictable remains:
        protected sessions alone may exceed it). Returns the number of
        actions taken."""
        if not self.over_budget() or not self._walk.acquire(blocking=False):
            return 0
        taken = 0
        try:
            prot = set(protected) | self._protected()
            for stage in self.ladder:
                for sid in self._candidates(prot):
                    if not self.over_budget():
                        return taken
                    if self.store.bytes_for(sid, include_cold=False) == 0:
                        # a fully aliased session (an undiverged fork, or
                        # one whose chunks went to its sharers) holds no
                        # hot bytes: degrading it would destroy its
                        # history and reclaim nothing
                        continue
                    if self._apply(stage, sid):
                        self.actions.append((stage, sid))
                        taken += 1
                if not self.over_budget():
                    return taken
        finally:
            self._walk.release()
        return taken
