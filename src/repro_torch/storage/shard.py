"""Host shards for the distributed chunk store (DESIGN.md §15).

A ``HostShard`` is one remote host's slice of the store: a device array
(its local SSDs / DRAM / files) reachable only through a ``NICLink`` —
a bandwidth + RTT + per-link-queue model in the same ``SimClock`` style
as ``SimulatedSSD``. A chunk read through a shard first occupies the
owning device (device clock) and then the shard's NIC (link clock); the
returned completion is the link's, so striped restores are priced on the
links they actually touch, not a single global storage figure.

``ShardTopology`` is the placement policy — which shard owns which
(layer, chunk):

  * ``layer`` — layer-striped: layer L lives wholly on shard L % N. A
    layer read touches ONE link; different layers' reads proceed on
    different links in parallel (the restoration replay models the IO
    stream per link).
  * ``chunk`` — token-chunk-striped: chunk C of every layer lives on
    shard C % N. A layer read fans over ALL links and aggregates their
    bandwidth (long histories), at the price of every restore contending
    on every link.

The topology is persisted in each session manifest (the owner map), so
a store reopened with a different shard count can still locate chunks
(placement fallback in ``ChunkStore._backend_for``) and a future remote
restore knows which host to target per stripe.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import List, Optional, Sequence, Tuple

from repro_torch.config.hardware import NIC_BW, NIC_RTT
from repro_torch.storage.backend import (Backend, DRAMBackend,
                                         FileBackend, SimClock, SimulatedSSD,
                                         StorageArray)

PLACEMENTS = ("layer", "chunk")


class NICLink:
    """Per-shard NIC model: bandwidth + RTT with a serial transfer queue.

    Same virtual-clock style as ``SimulatedSSD``: a transfer starts at
    ``max(now, queue busy-until, data ready)`` and occupies the link for
    ``rtt + nbytes / bandwidth`` seconds. ``read_time_total`` accrues
    link service seconds for the profiler (the per-link rate signal).
    Clock arithmetic is lock-guarded — the async IO engine drives links
    from per-shard worker threads while the engine thread issues inline
    metadata reads."""

    def __init__(self, bandwidth: float = NIC_BW, rtt: float = NIC_RTT,
                 shard_id: int = 0):
        self.bandwidth = float(bandwidth)
        self.rtt = float(rtt)
        self.shard_id = int(shard_id)
        self.clock = SimClock()
        self.now = 0.0
        self.read_time_total = 0.0
        self.write_time_total = 0.0
        self._lock = threading.Lock()

    def charge_read(self, nbytes: int, ready: float = 0.0) -> float:
        """Queue one device->host transfer; returns its completion time.
        ``ready`` is when the payload leaves the device (the device
        clock's completion) — the link cannot ship bytes it has not
        received."""
        with self._lock:
            dur = self.rtt + nbytes / self.bandwidth
            start = max(self.now, self.clock.read_busy_until, ready)
            self.clock.read_busy_until = start + dur
            self.read_time_total += dur
            return self.clock.read_busy_until

    def charge_write(self, nbytes: int, ready: float = 0.0) -> float:
        with self._lock:
            dur = self.rtt + nbytes / self.bandwidth
            start = max(self.now, self.clock.write_busy_until, ready)
            self.clock.write_busy_until = start + dur
            self.write_time_total += dur
            return self.clock.write_busy_until

    def read_completion(self) -> float:
        return self.clock.read_busy_until


class HostShard:
    """One host's slice of the distributed store: local devices behind a
    NIC link. ``link=None`` models a local shard (no network hop) — the
    single-shard store degenerates to the old one-host behavior."""

    def __init__(self, shard_id: int, devices: Sequence[Backend],
                 link: Optional[NICLink] = None):
        self.shard_id = int(shard_id)
        self.devices = list(devices)
        self.link = link

    def device_for(self, layer: int, chunk: int) -> Backend:
        return self.devices[(layer + chunk) % len(self.devices)]

    def read_async(self, dev: Backend, key: str)\
            -> Tuple["np.ndarray", float]:
        """Read ``key`` from ``dev`` through this shard's link: device
        service first, then the NIC transfer queued behind the link's
        earlier transfers."""
        data, dev_done = dev.read_async(key)
        if self.link is not None:
            return data, self.link.charge_read(data.nbytes, ready=dev_done)
        return data, dev_done

    def write_through(self, dev: Backend, key: str, data) -> float:
        done = dev.write(key, data)
        if self.link is not None:
            return self.link.charge_write(data.nbytes,
                                          ready=float(done or 0.0))
        return done

    def sync_clock(self, now: float) -> None:
        if self.link is not None:
            self.link.now = now
        for d in self.devices:
            if isinstance(d, SimulatedSSD):
                d.now = now

    def read_completion(self) -> float:
        done = self.link.read_completion() if self.link is not None else 0.0
        for d in self.devices:
            if isinstance(d, SimulatedSSD):
                done = max(done, d.read_completion())
        return done

    def read_service_total(self) -> float:
        """Accrued read service seconds on this shard (devices + link) —
        thread-confined to the shard's async worker, so per-task deltas
        are race-free without a global lock."""
        total = (self.link.read_time_total if self.link is not None
                 else 0.0)
        for d in self.devices:
            if isinstance(d, SimulatedSSD):
                total += d.read_time_total
        return total

    def n_timed(self) -> int:
        return sum(1 for d in self.devices if isinstance(d, SimulatedSSD))


@dataclasses.dataclass(frozen=True)
class ShardTopology:
    """Placement policy: which shard owns which (layer, chunk) — and,
    for the scheduler, which links a layer read touches. Pure math (no
    device handles), so planning code can price per-link contention
    without importing storage state."""

    n_shards: int
    placement: str = "layer"              # "layer" | "chunk"

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement {self.placement!r} not in "
                             f"{PLACEMENTS}")

    def shard_for(self, layer: int, chunk: int) -> int:
        if self.n_shards <= 1:
            return 0
        if self.placement == "layer":
            return layer % self.n_shards
        return chunk % self.n_shards

    def links_for_layer(self, layer: int) -> Tuple[int, ...]:
        """Link ids a full layer read fans over."""
        if self.n_shards <= 1:
            return (0,)
        if self.placement == "layer":
            return (layer % self.n_shards,)
        return tuple(range(self.n_shards))

    def link_of_layer(self, layer: int) -> Optional[int]:
        """The single owning link of a layer, or None when the layer
        stripes several links (chunk placement) — per-link profiler
        samples and per-link replay apply only in the single-link case."""
        links = self.links_for_layer(layer)
        return links[0] if len(links) == 1 else None

    def to_json(self) -> dict:
        return {"n_shards": self.n_shards, "placement": self.placement}

    @classmethod
    def from_json(cls, data: dict) -> "ShardTopology":
        return cls(int(data.get("n_shards", 1)),
                   str(data.get("placement", "layer")))


def make_shards(n_shards: int, devices_per_shard: int, kind: str = "ssd",
                *, root: Optional[str] = None,
                nic_bw: float = NIC_BW, nic_rtt: float = NIC_RTT,
                budget_bytes: Optional[int] = None) -> List[HostShard]:
    """Build a homogeneous shard set. With ``n_shards == 1`` the shard
    still gets a NIC link (one host, one host link) so single- vs
    multi-shard comparisons vary only the shard count, not the model."""
    shards = []
    for s in range(n_shards):
        if kind == "dram":
            devs = [DRAMBackend() for _ in range(devices_per_shard)]
        elif kind == "ssd":
            devs = [SimulatedSSD() for _ in range(devices_per_shard)]
        elif kind == "file":
            assert root is not None
            devs = [FileBackend(os.path.join(root, f"shard{s}", f"dev{i}"))
                    for i in range(devices_per_shard)]
        else:
            raise ValueError(kind)
        link = (NICLink(nic_bw, nic_rtt, shard_id=s)
                if nic_bw is not None else None)
        shards.append(HostShard(s, devs, link))
    if budget_bytes is not None:
        # budget applies to the flattened hot tier (the chunk store
        # wraps all shard devices in one StorageArray)
        pass
    return shards


def flatten_shards(shards: Sequence[HostShard],
                   budget_bytes: Optional[int] = None) -> StorageArray:
    devs: List[Backend] = []
    for s in shards:
        devs.extend(s.devices)
    return StorageArray(devs, budget_bytes=budget_bytes)
