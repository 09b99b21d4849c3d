"""Two-stage hidden-state saving (paper §4.2.2).

Stage 1 — snapshot: the device buffer holding one layer's hidden states for
the whole decode batch is copied to a host staging ring in a single
contiguous copy (a device→host cudaMemcpy). The
compute stream only ever waits when the ring is full (backpressure).

Stage 2 — a host daemon drains the ring, splits the batch snapshot into
per-sequence rows, and appends them to the ChunkStore (which assembles the
small rows into large chunks — the write pattern storage favors).

``DirectSaver`` is the ablation baseline (Fig 14): it writes each row
synchronously to the store, charging the device write time to the caller.

Both savers also keep *virtual-time* accounting (`stall_time`) so the TBT
benchmark can compare against the decode-layer time without real disks.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config.hardware import DRAM_BW
from repro_torch.storage.chunk_store import ChunkStore


@dataclasses.dataclass
class SnapshotTask:
    session_ids: Sequence[str]
    stream: str
    layer: int
    start_tokens: Sequence[int]       # per-sequence token offset
    data: np.ndarray                  # (batch, n_tokens, width); with
    #                                   ``layers`` set: (L, batch, n, width)
    # layer-stacked form: one snapshot covers these layers for the whole
    # decode batch (ONE ring submission per step instead of L) — the
    # stage-2 daemon splits per (layer, sequence) row. ``layer`` is
    # ignored when set.
    layers: Optional[Sequence[int]] = None


def _append_task_rows(store: ChunkStore, task: SnapshotTask) -> None:
    """Split a snapshot into per-sequence (and per-layer, for the
    stacked form) rows and append them to the chunk store."""
    data = task.data
    if task.layers is not None:
        for j, layer in enumerate(task.layers):
            for b, sid in enumerate(task.session_ids):
                if sid is None:
                    continue
                store.append_tokens(sid, task.stream, layer,
                                    task.start_tokens[b], data[j, b])
        return
    for b, sid in enumerate(task.session_ids):
        if sid is None:
            continue
        store.append_tokens(sid, task.stream, task.layer,
                            task.start_tokens[b], data[b])


class TwoStageSaver:
    """Snapshot ring + background chunk-assembly daemon."""

    def __init__(self, store: ChunkStore, ring_slots: int = 64,
                 host_bw: float = DRAM_BW, n_threads: int = 2):
        self.store = store
        self.ring: "queue.Queue[Optional[SnapshotTask]]" = queue.Queue(
            maxsize=ring_slots)
        self.host_bw = host_bw
        self.stall_time = 0.0             # virtual seconds the caller waited
        self.snapshot_time = 0.0          # virtual seconds of stage-1 copies
        self._exc: Optional[BaseException] = None
        self._exc_lock = threading.Lock()
        self._threads = [threading.Thread(target=self._daemon, daemon=True)
                         for _ in range(n_threads)]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------- stage 1
    def snapshot(self, task: SnapshotTask) -> float:
        """Submit one layer's hidden states. Returns the virtual stage-1
        cost (host copy time); blocks only if the ring is full."""
        copy_t = task.data.nbytes / self.host_bw
        self.snapshot_time += copy_t
        try:
            self.ring.put_nowait(task)
        except queue.Full:
            self.stall_time += copy_t          # backpressure: caller stalls
            self.ring.put(task)
        return copy_t

    # ------------------------------------------------------------- stage 2
    def _daemon(self):
        while True:
            task = self.ring.get()
            if task is None:
                self.ring.task_done()
                return
            try:
                _append_task_rows(self.store, task)
            except BaseException as e:   # noqa: BLE001 — losing a write
                # silently would corrupt the store; surface via drain()
                with self._exc_lock:
                    if self._exc is None:
                        self._exc = e
            finally:
                self.ring.task_done()

    def drain(self):
        self.ring.join()
        with self._exc_lock:
            exc, self._exc = self._exc, None
        if exc is not None:
            raise exc

    def close(self):
        try:
            self.drain()
        finally:
            for _ in self._threads:
                self.ring.put(None)
            for t in self._threads:
                t.join()


class DirectSaver:
    """Fig 14 ablation: synchronous per-row writes to the store, charging
    the device write time to the decode critical path."""

    def __init__(self, store: ChunkStore):
        self.store = store
        self.stall_time = 0.0
        self.snapshot_time = 0.0

    def snapshot(self, task: SnapshotTask) -> float:
        before = _write_busy(self.store)
        _append_task_rows(self.store, task)
        stall = _write_busy(self.store) - before
        self.stall_time += stall
        return stall

    def drain(self):
        pass

    def close(self):
        pass


def _write_busy(store: ChunkStore) -> float:
    from repro_torch.storage.backend import SimulatedSSD
    return sum(d.write_time_total for d in store.devices
               if isinstance(d, SimulatedSSD))
