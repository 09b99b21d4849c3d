"""Session lifecycle policies of the serving engine (the policy half of
the JAX package's ``core/capacity.py``):

  * ``AdmissionPolicy``   — which queued session gets the next free batch
                            slot (FIFO, restore-cost-aware/SJF, priority);
  * ``EvictionPolicy``    — which resident session is paused mid-stream
                            when the queue is backed up (LRU by admission
                            recency, restore-cost-weighted).

Policies are duck-typed over the engine's ``SequenceState`` (this module
never imports ``repro_torch.serving``); restore-cost estimates come from
the same compiled task graph the executor runs (``core.restoration``), so
a policy's notion of "cheap to restore" and the engine's actual
restoration cost cannot drift apart. The host-storage budget manager
(``CapacityManager``) waits for the int8 codec.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.cost_model import layer_costs, link_priced_times
from repro_torch.core.restoration import (compile_tasks,
                                          measured_dispatch_overhead, replay,
                                          task_links)


# ----------------------------------------------------- restore-cost estimate
def restore_makespan(mgr, n_tokens: int,
                     methods: Optional[Sequence[str]] = None) -> float:
    """Estimated restoration makespan (seconds) for a session of
    ``n_tokens``: the two-stream replay of the task graph the executor
    would run, under the group plan it would resolve
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
    tasks = compile_tasks(tuple(methods),
                          n_blobs=mgr.model.adapter.n_state_blobs,
                          group_size=mgr.resolve_group_size(n_tokens,
                                                            methods))
    return replay(tasks, times,
                  dispatch_overhead=measured_dispatch_overhead(mgr.hw,
                                                               mgr.profile),
                  links=task_links(tasks, layer_links)).makespan


def session_restore_cost(mgr, session_id: str) -> float:
    """Makespan estimate for a *stored* session, from its manifest
    (0.0 for a cold session with no stored state)."""
    man = mgr.store.get_manifest(session_id)
    if not man:
        return 0.0
    return restore_makespan(mgr, int(man.get("n_tokens", 0)),
                            man.get("methods"))


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
            return (restore_makespan(engine.mgr, max(s.total_len - 1, 0)),
                    s.request.request_id)

        return min(candidates, key=key)


EVICTION_POLICIES = {"lru": LRUEviction,
                     "restore_cost": RestoreCostAwareEviction}
ADMISSION_POLICIES = {"fifo": FIFOAdmission,
                      "restore_cost": RestoreCostAwareAdmission,
                      "priority": PriorityAdmission}
