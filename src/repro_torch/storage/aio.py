"""Async IO engine: per-shard submission queues with bounded depth.

Before this module, every storage read in the restoration executor ran
synchronously in the engine thread — ``FileBackend.read`` blocked on
``np.load`` inline, so "IO overlaps compute" was true only of the
virtual timeline, never of wall clock. The engine here makes the
overlap real:

  * one submission queue + one worker thread **per shard** — reads for
    different shards proceed in parallel (the whole point of striping),
    while reads within a shard stay serial (one NIC, one queue — which
    also thread-confines that shard's virtual clocks to its worker);
  * bounded in-flight depth via ``Queue(maxsize=depth)`` — ``submit``
    backpressures instead of queueing unbounded staging memory;
  * staging buffers: a ``ReadTicket`` owns the parts read so far; the
    consumer calls ``wait()`` (or polls ``ready()``) and takes the
    assembled payload exactly once.

The executor turns each ``io_h``/``io_kv``/``io_enc`` leg into a
submit/complete pair: submit on task dispatch, complete (wait) at the
first consumer — the projection for hidden stripes, the sink write for
KV, the cross-projection for encoder blobs. See DESIGN.md §15.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class ReadTicket:
    """Handle for one submitted read: staging buffer + completion event.

    ``parts`` fills in submission order (one entry per key) inside the
    shard worker; ``wait()`` blocks until the last part lands. The
    virtual-clock completion (max over parts) and accrued service
    seconds ride along so the executor can keep feeding the profiler
    and the measured timeline from async reads."""

    __slots__ = ("keys", "parts", "completion", "service", "shard_id",
                 "_event", "error")

    def __init__(self, keys: Sequence[str], shard_id: int):
        self.keys = list(keys)
        self.parts: List[Any] = []
        self.completion = 0.0            # virtual-clock finish (max of parts)
        self.service = 0.0               # accrued service seconds (profiler)
        self.shard_id = shard_id
        self._event = threading.Event()
        self.error: Optional[BaseException] = None

    def ready(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> List[Any]:
        if not self._event.wait(timeout):
            raise TimeoutError(f"read of {self.keys} did not complete")
        if self.error is not None:
            raise self.error
        return self.parts

    @classmethod
    def completed(cls, keys: Sequence[str], parts: Sequence[Any],
                  completion: float, shard_id: int = 0,
                  service: float = 0.0) -> "ReadTicket":
        """An already-finished ticket — the sync-fallback path (no IO
        engine attached) returns these so consumers never branch."""
        t = cls(keys, shard_id)
        t.parts = list(parts)
        t.completion = completion
        t.service = service
        t._event.set()
        return t


class _Submission:
    __slots__ = ("reads", "ticket")

    def __init__(self, reads, ticket):
        # reads: list of (callable () -> (data, vclock_done), service_fn)
        self.reads = reads
        self.ticket = ticket


class AsyncIOEngine:
    """Per-shard submission-queue thread pool with bounded depth.

    ``submit(shard_id, reads)`` enqueues one ticket whose reads all
    target that shard; the shard's worker drains its queue serially.
    ``depth`` bounds in-flight tickets per shard — a full queue blocks
    the submitter (the executor's dispatch), which is the staging-memory
    backpressure. Workers are daemon threads; ``close()`` drains and
    joins them."""

    def __init__(self, n_shards: int, depth: int = 4):
        self.n_shards = int(n_shards)
        self.depth = int(depth)
        self._queues: List["queue.Queue[Optional[_Submission]]"] = [
            queue.Queue(maxsize=self.depth) for _ in range(self.n_shards)]
        self._workers: List[threading.Thread] = []
        self._closed = False
        self.submitted = 0
        self.completed = 0
        self._stats_lock = threading.Lock()
        for s in range(self.n_shards):
            w = threading.Thread(target=self._worker, args=(s,),
                                 name=f"aio-shard{s}", daemon=True)
            w.start()
            self._workers.append(w)

    def _worker(self, shard_id: int) -> None:
        q = self._queues[shard_id]
        while True:
            sub = q.get()
            if sub is None:
                q.task_done()
                return
            ticket = sub.ticket
            try:
                for fn, service_fn in sub.reads:
                    before = service_fn() if service_fn else 0.0
                    data, done = fn()
                    after = service_fn() if service_fn else 0.0
                    ticket.parts.append(data)
                    ticket.completion = max(ticket.completion, done)
                    ticket.service += max(0.0, after - before)
            except BaseException as e:        # surface to the waiter
                ticket.error = e
            finally:
                ticket._event.set()
                with self._stats_lock:
                    self.completed += 1
                q.task_done()

    def submit(self, shard_id: int, keys: Sequence[str],
               reads: Sequence[Tuple[Callable[[], Tuple[Any, float]],
                                     Optional[Callable[[], float]]]]
               ) -> ReadTicket:
        """Enqueue the reads (all on ``shard_id``) behind one ticket.
        Blocks when the shard already has ``depth`` tickets in flight."""
        if self._closed:
            raise RuntimeError("AsyncIOEngine is closed")
        ticket = ReadTicket(keys, shard_id % self.n_shards)
        self._queues[ticket.shard_id].put(_Submission(list(reads), ticket))
        with self._stats_lock:
            self.submitted += 1
        return ticket

    def drain(self) -> None:
        for q in self._queues:
            q.join()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for q in self._queues:
            q.put(None)
        for w in self._workers:
            w.join(timeout=5.0)

    def stats(self) -> Dict[str, int]:
        with self._stats_lock:
            return {"submitted": self.submitted, "completed": self.completed,
                    "n_shards": self.n_shards, "depth": self.depth}
