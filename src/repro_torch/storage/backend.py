"""Storage backends for the chunk store.

Three tiers, all exposing the same byte-level API:

  DRAMBackend      — host memory (paper's cloud-server fallback).
  SimulatedSSD     — host memory + a bandwidth/latency model of one NVMe
                     device (PM9A3 by default). Reads/writes advance a
                     device-local clock so benchmarks measure contention and
                     striping gains without real disks.
  FileBackend      — real files (persistence across engine restarts —
                     the serving fault-tolerance path).

A ``StorageArray`` is N devices addressed round-robin by the chunk store.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
import urllib.parse
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config.hardware import SSD_READ_BW, SSD_WRITE_BW


class Backend:
    """Byte-addressable key-value device."""

    def write(self, key: str, data: np.ndarray) -> float:
        raise NotImplementedError

    def read(self, key: str) -> np.ndarray:
        raise NotImplementedError

    def read_async(self, key: str) -> "Tuple[np.ndarray, float]":
        """Read + the device-local virtual completion time of this IO.

        Devices without a timing model complete instantly (0.0). The
        restoration executor uses the completion times to interleave
        striped reads with compute (see core/restoration.py)."""
        return self.read(key), 0.0

    def peek(self, key: str) -> np.ndarray:
        """Metadata-path read: no virtual-clock charge on timed devices
        (availability checks must not perturb the IO simulation)."""
        return self.read(key)

    def nrows(self, key: str) -> int:
        """Stored row count (first dim) without paying for a data read
        where the backend can avoid it."""
        return self.peek(key).shape[0]

    def nbytes(self, key: str) -> int:
        """Stored size of one key (accounting path — no clock charge)."""
        return self.peek(key).nbytes

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def contains(self, key: str) -> bool:
        raise NotImplementedError

    def keys(self) -> List[str]:
        raise NotImplementedError

    @property
    def bytes_used(self) -> int:
        raise NotImplementedError


class DRAMBackend(Backend):
    def __init__(self):
        self._store: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()

    def write(self, key, data):
        stored = np.array(data, copy=True)
        # reads hand out this exact array (zero-copy); freezing it makes
        # cross-session aliasing bugs fail loudly instead of corrupting
        # every alias of a shared chunk. Mutating consumers must copy.
        stored.flags.writeable = False
        with self._lock:
            self._store[key] = stored
        return 0.0

    def read(self, key):
        with self._lock:
            return self._store[key]

    def delete(self, key):
        with self._lock:
            self._store.pop(key, None)

    def contains(self, key):
        with self._lock:
            return key in self._store

    def nbytes(self, key):
        with self._lock:
            return self._store[key].nbytes

    def keys(self):
        with self._lock:
            return list(self._store)

    @property
    def bytes_used(self):
        with self._lock:
            return sum(v.nbytes for v in self._store.values())


@dataclasses.dataclass
class SimClock:
    """Per-device virtual clock: busy-until timestamps for read & write."""

    read_busy_until: float = 0.0
    write_busy_until: float = 0.0


class SimulatedSSD(DRAMBackend):
    """DRAM-backed with an NVMe timing model (seq BW + per-IO latency)."""

    def __init__(self, read_bw: float = SSD_READ_BW,
                 write_bw: float = SSD_WRITE_BW, io_latency: float = 80e-6):
        super().__init__()
        self.read_bw = read_bw
        self.write_bw = write_bw
        self.io_latency = io_latency
        self.clock = SimClock()
        self.now = 0.0               # external virtual time (set by the store)
        self.read_time_total = 0.0
        self.write_time_total = 0.0
        # clock arithmetic is read-modify-write; async IO workers and the
        # engine thread may both charge this device
        self._clock_lock = threading.Lock()

    def write(self, key, data):
        super().write(key, data)
        with self._clock_lock:
            dur = self.io_latency + data.nbytes / self.write_bw
            start = max(self.now, self.clock.write_busy_until)
            self.clock.write_busy_until = start + dur
            self.write_time_total += dur
            return self.clock.write_busy_until

    def read(self, key):
        data = super().read(key)
        with self._clock_lock:
            dur = self.io_latency + data.nbytes / self.read_bw
            start = max(self.now, self.clock.read_busy_until)
            self.clock.read_busy_until = start + dur
            self.read_time_total += dur
        return data

    def read_async(self, key):
        return self.read(key), self.clock.read_busy_until

    def peek(self, key):
        return DRAMBackend.read(self, key)        # no clock charge

    def read_completion(self) -> float:
        return self.clock.read_busy_until


class FileBackend(Backend):
    """npy files under a directory — survives process restarts."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        # per-key size cache: bytes_used/nbytes sit on hot accounting
        # paths (budget checks per write) — one listdir walk at open,
        # then invalidated incrementally on write/delete
        self._sizes: Dict[str, int] = {
            urllib.parse.unquote(f[:-4]): os.path.getsize(
                os.path.join(root, f))
            for f in os.listdir(root) if f.endswith(".npy")}

    def _path(self, key: str) -> str:
        # percent-encoding is injective: a session id that legitimately
        # contains "__" (or "%") survives the keys() round-trip, unlike
        # the old "/" <-> "__" substitution
        return os.path.join(self.root,
                            urllib.parse.quote(key, safe="") + ".npy")

    def write(self, key, data):
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:               # np.save would append .npy
            np.save(f, data)
        os.replace(tmp, self._path(key))         # atomic commit
        self._sizes[key] = os.path.getsize(self._path(key))
        return 0.0

    def read(self, key):
        return np.load(self._path(key))

    def delete(self, key):
        self._sizes.pop(key, None)
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def contains(self, key):
        return os.path.exists(self._path(key))

    def nrows(self, key):
        # mmap reads only the npy header, not the chunk data
        return np.load(self._path(key), mmap_mode="r").shape[0]

    def keys(self):
        return [urllib.parse.unquote(f[:-4]) for f in os.listdir(self.root)
                if f.endswith(".npy")]

    def nbytes(self, key):
        size = self._sizes.get(key)
        if size is None:                         # externally-written file
            size = self._sizes[key] = os.path.getsize(self._path(key))
        return size

    @property
    def bytes_used(self):
        return sum(self._sizes.values())


class StorageArray(list):
    """A device array with an optional byte budget.

    Behaves as a plain list of backends (the chunk store addresses it
    round-robin) but additionally tracks a ``budget_bytes`` ceiling and
    fires registered pressure callbacks — typically the capacity
    manager's reclaim ladder — when the tier's total footprint exceeds
    it. Reclaim is guarded by a non-blocking lock: a callback that
    itself writes or deletes through the store cannot recurse into
    another reclaim (same-thread acquire fails), and two threads — e.g.
    an async IO worker hitting a pressure callback while the engine
    thread writes — cannot run the reclaim ladder concurrently."""

    def __init__(self, devices: Sequence[Backend],
                 budget_bytes: Optional[int] = None):
        super().__init__(devices)
        self.budget_bytes = budget_bytes
        self._callbacks: List[Callable[["StorageArray"], None]] = []
        self._reclaim_lock = threading.Lock()

    @property
    def bytes_used(self) -> int:
        return sum(d.bytes_used for d in self)

    def over_budget(self) -> bool:
        return (self.budget_bytes is not None
                and self.bytes_used > self.budget_bytes)

    def on_pressure(self, callback: Callable[["StorageArray"], None]) -> None:
        self._callbacks.append(callback)

    def maybe_reclaim(self) -> None:
        if not self.over_budget():
            return
        if not self._reclaim_lock.acquire(blocking=False):
            return                       # reclaim already running
        try:
            if self.over_budget():       # re-check under the lock
                for cb in self._callbacks:
                    cb(self)
        finally:
            self._reclaim_lock.release()


def make_array(kind: str, n_devices: int, root: Optional[str] = None,
               budget_bytes: Optional[int] = None) -> StorageArray:
    if kind == "dram":
        devs = [DRAMBackend() for _ in range(n_devices)]
    elif kind == "ssd":
        devs = [SimulatedSSD() for _ in range(n_devices)]
    elif kind == "file":
        assert root is not None
        devs = [FileBackend(os.path.join(root, f"dev{i}"))
                for i in range(n_devices)]
    else:
        raise ValueError(kind)
    return StorageArray(devs, budget_bytes=budget_bytes)
