"""Chunk-based storage manager (paper §4.2).

Layout problem: hidden states are *generated* layer-before-token (one layer
of the whole batch at a time, autoregressively growing in tokens) but
*restored* token-before-layer (all tokens of one layer as a batch). The
store therefore:

  * keys data by (session, stream, layer, chunk): a chunk holds
    ``chunk_tokens`` consecutive tokens of one layer — the restoration unit;
  * distributes the chunks of a layer **round-robin across devices** so a
    layer read aggregates the bandwidth of all devices (paper: multiple
    SSDs; here: backend array, possibly simulated);
  * never reserves a layer's worth of contiguous space (output length is
    unpredictable — chunks allocate incrementally, no internal
    fragmentation beyond the final partial chunk).

Chunk size defaults to the paper's 64 tokens. Partial chunks live in a
staging dict until full or flushed.

Streams: "h" (hidden states), "kv" (offloaded KV layers), "tok" (token
ids), "state" (SSM recurrent states). A JSON manifest per session makes the
store self-describing — the serving engine's crash-recovery path rebuilds
sessions from it.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import urllib.parse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config.hardware import PAPER_CHUNK_TOKENS
from repro_torch.storage.aio import AsyncIOEngine, ReadTicket
from repro_torch.storage.backend import Backend, SimulatedSSD, StorageArray
from repro_torch.storage.shard import HostShard, ShardTopology, flatten_shards


def _enc(session: str) -> str:
    """Key-encode a session id: ids may contain '/' (e.g. tenant/user),
    which would collide with the key separator."""
    return urllib.parse.quote(session, safe="")


def _key(session: str, stream: str, layer: int, chunk: int) -> str:
    return f"{_enc(session)}/{stream}/L{layer}/C{chunk}"


def _meta_key(session: str) -> str:
    return f"{_enc(session)}/meta/L0/C0"


@dataclasses.dataclass
class AsyncRead:
    """A batched striped layer read + its virtual completion times.

    ``completion`` is the max over the per-device read clocks touched by
    this read (0.0 for backends without a timing model) — the moment the
    restoration executor may consume ``data``."""

    data: np.ndarray
    completion: float
    device_completions: List[float]


class LayerRead:
    """Handle for a submitted (possibly async) striped layer read.

    One ``ReadTicket`` per shard touched; ``wait()`` reassembles the
    chunks in token order and returns the same ``AsyncRead`` the inline
    path produces, so consumers are agnostic to sync vs async IO. The
    ``links`` attribute names the NIC links this read occupies — the
    executor reports them to the per-link contention pricer."""

    __slots__ = ("tickets", "_order", "_slice", "links", "layer")

    def __init__(self, tickets: List[ReadTicket],
                 order: List[Tuple[int, int]],
                 slice_: Tuple[int, int], links: Tuple[int, ...],
                 layer: int):
        self.tickets = tickets
        self._order = order              # chunk order -> (ticket, part) idx
        self._slice = slice_             # (offset, stop) into the concat
        self.links = links
        self.layer = layer

    def ready(self) -> bool:
        return all(t.ready() for t in self.tickets)

    @property
    def service(self) -> float:
        return sum(t.service for t in self.tickets)

    def wait(self, timeout: Optional[float] = None) -> AsyncRead:
        for t in self.tickets:
            t.wait(timeout)
        parts = [self.tickets[ti].parts[pi] for ti, pi in self._order]
        completions = [self.tickets[ti].completion for ti, _ in self._order]
        out = np.concatenate(parts, axis=0) if parts else \
            np.zeros((0,), np.float32)
        off, stop = self._slice
        return AsyncRead(out[off:stop], max(completions, default=0.0),
                         completions)

    def _parts(self):
        for t in self.tickets:
            t.wait()
        return [self.tickets[ti].parts[pi] for ti, pi in self._order]

    @property
    def row_shape(self) -> Tuple[int, ...]:
        """Shape of one token's row of the read (after it has landed)."""
        return tuple(self._parts()[0].shape[1:])

    @property
    def dtype(self) -> np.dtype:
        return self._parts()[0].dtype

    def copy_into(self, out: np.ndarray, first: int = 0,
                  step: int = 1) -> None:
        """``wait().data`` written into ``out`` chunk by chunk, without
        assembling it first (the restore stages it in pinned memory);
        ``first``/``step`` copy only chunks ``first::step``, so several
        threads can share one read."""
        off, stop = self._slice
        at = 0                           # this part's first token
        for i, part in enumerate(self._parts()):
            lo, hi = max(at, off), min(at + part.shape[0], stop)
            if hi > lo and i % step == first:
                out[lo - off:hi - off] = part[lo - at:hi - at]
            at += part.shape[0]


@dataclasses.dataclass
class _Partial:
    start_token: int
    rows: List[np.ndarray]

    @property
    def n(self) -> int:
        return sum(r.shape[0] for r in self.rows)


class ChunkStore:
    """Round-robin chunked store over a backend array.

    Optionally two-tiered: ``cold_devices`` is a second (cheaper, slower)
    array that cold sessions demote to wholesale
    (``demote_session_to_cold``); reads fall back hot -> cold per key, so
    a re-activated session may be tier-mixed (new chunks land hot while
    its history stays cold) without any promotion step. ``bytes_used``
    counts the HOT tier only — it is the budgeted quantity; the cold
    tier is accounted separately (``bytes_cold``)."""

    def __init__(self, devices: Optional[Sequence[Backend]] = None,
                 chunk_tokens: int = PAPER_CHUNK_TOKENS,
                 cold_devices: Optional[Sequence[Backend]] = None,
                 *, shards: Optional[Sequence[HostShard]] = None,
                 placement: str = "layer",
                 budget_bytes: Optional[int] = None,
                 io_engine: Optional[AsyncIOEngine] = None):
        if shards is not None:
            # distributed store (DESIGN.md §15): each shard's devices sit
            # behind its NIC link; the flattened StorageArray keeps the
            # budget/pressure accounting identical to the one-host store
            self.shards: Optional[List[HostShard]] = list(shards)
            self.topology: Optional[ShardTopology] = ShardTopology(
                len(self.shards), placement)
            self.devices = flatten_shards(self.shards,
                                          budget_bytes=budget_bytes)
        else:
            assert devices is not None
            self.shards = None
            self.topology = None
            self.devices = (devices if isinstance(devices, StorageArray)
                            else list(devices))
        self.io_engine = io_engine
        self.cold = list(cold_devices) if cold_devices else None
        self.chunk_tokens = chunk_tokens
        self._partials: Dict[Tuple[str, str, int], _Partial] = {}
        # content-addressed sharing (DESIGN.md §12): a logical key may
        # alias a physical key owned by another session (fork / prefix
        # index). ``_refs`` counts holders of a physical key INCLUDING
        # its owner (absent entry == plain unshared key, refcount 1);
        # ``_orphans`` marks physical keys whose owning session no longer
        # holds them (owner dropped, or content shadowed out) — they are
        # excluded from per-session accounting, drops, and demotions, and
        # are physically deleted when their last alias/pin releases.
        self._alias: Dict[str, str] = {}
        self._refs: Dict[str, int] = {}
        self._orphans: set = set()
        self._pin_n = 0
        self._shadow_n = 0
        # RLock: the sharing bookkeeping runs inside append/flush, which
        # already hold the staging lock
        self._lock = threading.RLock()
        # device -> owning shard, for routing fallback-located chunks
        # through the correct NIC link
        self._dev_shard: Dict[int, HostShard] = {}
        if self.shards is not None:
            for s in self.shards:
                for d in s.devices:
                    self._dev_shard[id(d)] = s

    # ------------------------------------------------------------- placement
    def _shard_for(self, layer: int, chunk: int) -> Optional[HostShard]:
        if self.shards is None:
            return None
        return self.shards[self.topology.shard_for(layer, chunk)]

    def _device_for(self, layer: int, chunk: int) -> Backend:
        shard = self._shard_for(layer, chunk)
        if shard is not None:
            return shard.device_for(layer, chunk)
        return self.devices[(layer + chunk) % len(self.devices)]

    def _cold_for(self, layer: int, chunk: int) -> Backend:
        return self.cold[(layer + chunk) % len(self.cold)]

    def _backend_for(self, layer: int, chunk: int, key: str) -> Backend:
        """Device holding ``key``: hot placement first, cold fallback.
        In sharded mode, a key absent at its computed placement is
        searched across all shards — a store reopened with a different
        shard count (the owner map in the manifest records the writer's
        topology) still finds every chunk."""
        dev = self._device_for(layer, chunk)
        if not dev.contains(key):
            if self.shards is not None:
                for d in self.devices:
                    if d is not dev and d.contains(key):
                        return d
            if self.cold is not None:
                cold = self._cold_for(layer, chunk)
                if cold.contains(key):
                    return cold
        return dev

    def shard_topology(self) -> Optional[ShardTopology]:
        """Placement policy for planning code (None = one-host store)."""
        return self.topology

    def attach_io_engine(self, engine: Optional[AsyncIOEngine]) -> None:
        self.io_engine = engine

    def close(self) -> None:
        if self.io_engine is not None:
            self.io_engine.close()
            self.io_engine = None

    def _maybe_reclaim(self) -> None:
        """Budget check after a write burst (never under ``self._lock`` —
        pressure callbacks re-enter the store to demote/drop sessions)."""
        reclaim = getattr(self.devices, "maybe_reclaim", None)
        if reclaim is not None:
            reclaim()

    # ------------------------------------------------- shared-chunk plumbing
    @staticmethod
    def _coords(key: str) -> Tuple[int, int]:
        """(layer, chunk) parsed back out of a key (shadow suffixes on
        the chunk component are ignored — placement is by coordinates)."""
        parts = key.split("/")
        return int(parts[2][1:]), int(parts[3][1:].split("@")[0])

    def _resolve(self, key: str) -> str:
        """Physical key behind a logical key (identity when unshared)."""
        return self._alias.get(key, key)

    def _incref(self, phys: str) -> None:
        with self._lock:
            self._refs[phys] = self._refs.get(phys, 1) + 1

    def _release_phys(self, phys: str) -> None:
        """Drop one holder of a physical key; delete the bytes when the
        last holder releases (the deferred-eviction rule: a shared chunk
        outlives its owning session until the last referent lets go)."""
        with self._lock:
            r = self._refs.get(phys, 1) - 1
            if r <= 0:
                self._refs.pop(phys, None)
                self._orphans.discard(phys)
                for d in self._all_devices():
                    if d.contains(phys):
                        d.delete(phys)
                return
            if r == 1 and phys not in self._orphans:
                self._refs.pop(phys, None)     # back to plain owned
            else:
                self._refs[phys] = r

    def _prepare_write(self, session: str, stream: str, layer: int,
                       chunk: int) -> None:
        """Copy-on-write for the host tier: called before (over)writing a
        physical chunk/blob key. If the logical key aliases another
        session's data, the alias is dropped (the writer diverges onto
        its own bytes). If the key's current content is held by other
        sessions/pins, that content is shadowed out to a renamed physical
        key first, so the sharers keep reading the old bytes."""
        k = _key(session, stream, layer, chunk)
        with self._lock:
            phys = self._alias.pop(k, None)
            if phys is not None:
                self._release_phys(phys)
                return                          # k itself holds no bytes yet
            others = self._refs.get(k, 1) - (0 if k in self._orphans else 1)
            if others <= 0:
                return
            self._shadow_n += 1
            shadow = f"{k}@s{self._shadow_n}"
            dev = self._backend_for(layer, chunk, k)
            if dev.contains(k):
                dev.write(shadow, np.asarray(dev.peek(k)))
                dev.delete(k)
            for lk, pk in self._alias.items():
                if pk == k:
                    self._alias[lk] = shadow
            self._refs[shadow] = others
            self._refs.pop(k, None)
            self._orphans.discard(k)
            self._orphans.add(shadow)

    # ------------------------------------------------------------- sharing
    def pin_chunks(self, session: str, stream: str, layer: int,
                   chunks: Sequence[int]) -> List[str]:
        """Pin chunk content against deletion (prefix index): each pin id
        holds one reference to the chunk's current physical bytes, which
        therefore survive the owning session's eviction. Returns opaque
        pin ids for ``alias_chunk``/``unpin``."""
        ids = []
        with self._lock:
            for ci in chunks:
                phys = self._resolve(_key(session, stream, layer, int(ci)))
                self._pin_n += 1
                pid = f"__pin/{self._pin_n}"
                self._alias[pid] = phys
                self._incref(phys)
                ids.append(pid)
        return ids

    def chunk_rows(self, session: str, stream: str, layer: int,
                   chunk: int) -> int:
        """Rows (tokens) of a stored chunk, 0 when absent — the prefix
        index probes coverage with this before pinning (``pin_chunks``
        pins whatever key resolves; pinning a hole would hand out a pin
        id that aliases nothing)."""
        with self._lock:
            k = self._resolve(_key(session, stream, layer, int(chunk)))
            dev = self._backend_for(layer, int(chunk), k)
            return int(dev.nrows(k)) if dev.contains(k) else 0

    def unpin(self, pin_ids: Sequence[str]) -> None:
        with self._lock:
            for pid in pin_ids:
                phys = self._alias.pop(pid, None)
                if phys is not None:
                    self._release_phys(phys)

    def alias_chunk(self, session: str, stream: str, layer: int,
                    chunk: int, ref_key: str) -> None:
        """Map ``session``'s (stream, layer, chunk) onto existing bytes
        (``ref_key``: an ordinary key or a pin id). The new session reads
        the shared bytes; its first write to the chunk diverges onto its
        own copy (``_prepare_write``)."""
        logical = _key(session, stream, layer, chunk)
        with self._lock:
            phys = self._resolve(ref_key)
            old = self._alias.pop(logical, None)
            if old is not None:
                self._release_phys(old)
            self._alias[logical] = phys
            self._incref(phys)

    def share_session(self, src: str, dst: str, *, copy: bool = False)\
            -> int:
        """Alias every stored chunk/blob of ``src`` into ``dst`` (fork).
        ``copy=True`` materializes real copies instead (sharing-off
        reference behavior — byte-identical semantics, no dedup).
        Returns the number of keys shared/copied."""
        self.flush(src)
        prefix = _enc(src) + "/"
        dstp = _enc(dst) + "/"
        with self._lock:
            seen = set()
            for d in self._all_devices():
                for k in d.keys():
                    if (k.startswith(prefix) and "/meta/" not in k
                            and k not in self._orphans):
                        seen.add(k)
            seen.update(lk for lk in self._alias
                        if lk.startswith(prefix))
            for k in sorted(seen):
                newk = dstp + k[len(prefix):]
                layer, chunk = self._coords(k)
                phys = self._resolve(k)
                if copy:
                    dev = self._backend_for(layer, chunk, phys)
                    self._device_for(layer, chunk).write(
                        newk, np.asarray(dev.peek(phys)))
                else:
                    self._alias[newk] = phys
                    self._incref(phys)
        self._maybe_reclaim()
        return len(seen)

    @property
    def dedup_bytes(self) -> int:
        """Bytes that sharing avoided storing twice: one count of the
        physical bytes per session-visible alias (pins excluded — they
        keep data alive but do not stand for a second copy)."""
        saved = 0
        with self._lock:
            entries = [(lk, pk) for lk, pk in self._alias.items()
                       if not lk.startswith("__pin/")]
        for lk, pk in entries:
            layer, chunk = self._coords(pk)
            dev = self._backend_for(layer, chunk, pk)
            if dev.contains(pk):
                saved += dev.nbytes(pk)
        return saved

    # ----------------------------------------------------------------- write
    def append_tokens(self, session: str, stream: str, layer: int,
                      start_token: int, data: np.ndarray) -> None:
        """Append ``data`` (n_tokens, width) for one layer starting at
        ``start_token``; fills chunks and flushes the complete ones."""
        C = self.chunk_tokens
        with self._lock:
            key = (session, stream, layer)
            part = self._partials.get(key)
            if part is None:
                part = _Partial(start_token - start_token % C, [])
                pad = start_token - part.start_token
                if pad:
                    # resuming mid-chunk (multi-round session): recover the
                    # previously-flushed partial chunk as the prefix —
                    # through the alias map, so a forked/prefix-matched
                    # session seeds its divergent chunk from shared bytes
                    ci = part.start_token // C
                    kstr = self._resolve(_key(session, stream, layer, ci))
                    dev = self._backend_for(layer, ci, kstr)
                    if dev.contains(kstr):
                        prev = np.asarray(dev.read(kstr))[:pad]
                    else:
                        prev = np.zeros((0,) + data.shape[1:], data.dtype)
                    if prev.shape[0] < pad:
                        prev = np.concatenate(
                            [prev, np.zeros((pad - prev.shape[0],)
                                            + data.shape[1:], data.dtype)])
                    part.rows.append(prev)
                self._partials[key] = part
            part.rows.append(np.asarray(data))
            while part.n >= C:
                block = np.concatenate(part.rows, axis=0)
                chunk_idx = part.start_token // C
                self._prepare_write(session, stream, layer, chunk_idx)
                self._device_for(layer, chunk_idx).write(
                    _key(session, stream, layer, chunk_idx), block[:C])
                part.start_token += C
                part.rows = [block[C:]] if block.shape[0] > C else []

    def flush(self, session: str) -> None:
        """Persist all partial chunks of a session (padded to chunk size is
        NOT needed — partial chunks are stored at their true length)."""
        with self._lock:
            for (s, stream, layer), part in list(self._partials.items()):
                if s != session or part.n == 0:
                    continue
                block = np.concatenate(part.rows, axis=0)
                chunk_idx = part.start_token // self.chunk_tokens
                self._prepare_write(s, stream, layer, chunk_idx)
                self._device_for(layer, chunk_idx).write(
                    _key(session, stream, layer, chunk_idx), block)
                del self._partials[(s, stream, layer)]
        self._maybe_reclaim()

    def put_blob(self, session: str, stream: str, layer: int,
                 data: np.ndarray) -> None:
        """Whole-object write (SSM states, token ids)."""
        self._prepare_write(session, stream, layer, 0)
        self._device_for(layer, 0).write(_key(session, stream, layer, 0),
                                         np.asarray(data))
        self._maybe_reclaim()

    def get_blob(self, session: str, stream: str, layer: int) -> np.ndarray:
        key = self._resolve(_key(session, stream, layer, 0))
        return self._backend_for(layer, 0, key).read(key)

    def has_blob(self, session: str, stream: str, layer: int) -> bool:
        key = self._resolve(_key(session, stream, layer, 0))
        return self._backend_for(layer, 0, key).contains(key)

    # ------------------------------------------------------------------ read
    def read_layer(self, session: str, stream: str, layer: int,
                   n_tokens: int, start_token: int = 0) -> np.ndarray:
        """Restoration read: all chunks of one layer, token order.

        With SimulatedSSD devices the per-device clocks advance in parallel
        (round-robin striping aggregates bandwidth); completion time is
        queried via ``read_completion``."""
        return self.read_layer_async(session, stream, layer, n_tokens,
                                     start_token=start_token).data

    def read_layer_async(self, session: str, stream: str, layer: int,
                         n_tokens: int, start_token: int = 0) -> AsyncRead:
        """Batched striped read of one layer with completion times.

        Issues every chunk read up front (each device queues its own IOs
        on its clock) and returns the assembled array plus the per-device
        virtual completion times — the executor overlaps compute with the
        stripe instead of re-simulating the IO separately.

        ``start_token`` is the restore-skip entry point: only the chunks
        covering tokens [start_token, n_tokens) are read (and charged on
        the device clocks); the returned data starts at ``start_token``.

        In sharded mode every chunk read additionally occupies its
        shard's NIC link: ``done`` becomes the link completion, so the
        virtual timeline prices the network hop, and chunks on distinct
        shards overlap on distinct links."""
        C = self.chunk_tokens
        first = start_token // C
        n_chunks = (n_tokens + C - 1) // C
        parts = []
        completions = []
        for ci in range(first, n_chunks):
            key = self._resolve(_key(session, stream, layer, ci))
            data, done, _ = self._read_chunk_async(layer, ci, key)
            parts.append(data)
            completions.append(done)
        out = np.concatenate(parts, axis=0) if parts else \
            np.zeros((0,), np.float32)
        off = start_token - first * C
        return AsyncRead(out[off:n_tokens - first * C],
                         max(completions, default=0.0), completions)

    def _read_chunk_async(self, layer: int, chunk: int, key: str)\
            -> Tuple[np.ndarray, float, Optional[HostShard]]:
        """One chunk read routed through the owning shard's link (when
        sharded and hot); returns (data, virtual completion, shard)."""
        dev = self._backend_for(layer, chunk, key)
        shard = self._dev_shard.get(id(dev))
        if shard is not None and shard.link is not None:
            data, done = shard.read_async(dev, key)
            return data, done, shard
        data, done = dev.read_async(key)
        return data, done, shard

    # ------------------------------------------------------- async submission
    def _shard_groups(self, session: str, stream: str, layer: int,
                      n_tokens: int, start_token: int):
        """Chunk reads of one layer grouped by owning shard, in chunk
        order: {shard_key: [(chunk_pos, dev, shard, key), ...]}."""
        C = self.chunk_tokens
        first = start_token // C
        n_chunks = (n_tokens + C - 1) // C
        groups: Dict[int, List] = {}
        pos = 0
        for ci in range(first, n_chunks):
            key = self._resolve(_key(session, stream, layer, ci))
            dev = self._backend_for(layer, ci, key)
            shard = self._dev_shard.get(id(dev))
            sid = shard.shard_id if shard is not None else 0
            groups.setdefault(sid, []).append((pos, dev, shard, key))
            pos += 1
        off = start_token - first * C
        return groups, (off, n_tokens - first * C)

    def submit_layer_read(self, session: str, stream: str, layer: int,
                          n_tokens: int, start_token: int = 0) -> LayerRead:
        """Submit a striped layer read: one ticket per shard on the async
        IO engine (reads overlap the caller for real), or — with no
        engine attached — already-completed tickets from inline reads, so
        consumers never branch on the IO mode."""
        groups, slice_ = self._shard_groups(session, stream, layer,
                                            n_tokens, start_token)
        tickets: List[ReadTicket] = []
        order: List[Optional[Tuple[int, int]]] = [None] * sum(
            len(g) for g in groups.values())
        links = []
        for sid in sorted(groups):
            entries = groups[sid]
            keys = [e[3] for e in entries]
            if entries and entries[0][2] is not None \
                    and entries[0][2].link is not None:
                links.append(sid)
            ti = len(tickets)
            for pi, (pos, _, _, _) in enumerate(entries):
                order[pos] = (ti, pi)
            if self.io_engine is not None:
                shard0 = entries[0][2]
                service_fn = (shard0.read_service_total
                              if shard0 is not None else None)
                reads = []
                for _, dev, shard, key in entries:
                    if shard is not None and shard.link is not None:
                        reads.append((
                            lambda s=shard, d=dev, k=key: s.read_async(d, k),
                            service_fn))
                    else:
                        reads.append((
                            lambda d=dev, k=key: d.read_async(k),
                            service_fn))
                tickets.append(self.io_engine.submit(sid, keys, reads))
            else:
                parts, completion, service = [], 0.0, 0.0
                for _, dev, shard, key in entries:
                    if shard is not None and shard.link is not None:
                        before = shard.read_service_total()
                        data, done = shard.read_async(dev, key)
                        service += shard.read_service_total() - before
                    else:
                        data, done = dev.read_async(key)
                    parts.append(data)
                    completion = max(completion, done)
                tickets.append(ReadTicket.completed(
                    keys, parts, completion, sid, service))
        return LayerRead(tickets, order, slice_, tuple(links), layer)

    def submit_blob_read(self, session: str, stream: str,
                         layer: int) -> ReadTicket:
        """Async whole-object read (encoder blobs, SSM states)."""
        key = self._resolve(_key(session, stream, layer, 0))
        dev = self._backend_for(layer, 0, key)
        shard = self._dev_shard.get(id(dev))
        sid = shard.shard_id if shard is not None else 0
        if self.io_engine is not None:
            if shard is not None and shard.link is not None:
                read = (lambda: shard.read_async(dev, key),
                        shard.read_service_total)
            else:
                read = (lambda: dev.read_async(key), None)
            return self.io_engine.submit(sid, [key], [read])
        if shard is not None and shard.link is not None:
            data, done = shard.read_async(dev, key)
        else:
            data, done = dev.read_async(key)
        return ReadTicket.completed([key], [data], done, sid)

    def layer_available(self, session: str, stream: str, layer: int,
                        n_tokens: int = 1) -> bool:
        """True when the chunks covering tokens [0, n_tokens) exist.

        Checking chunk 0 alone is wrong for multi-chunk layers: a crash
        mid-save leaves a prefix of chunks, and the restore path must not
        claim the full range is readable."""
        C = self.chunk_tokens
        n_chunks = max((n_tokens + C - 1) // C, 1)
        with self._lock:
            part = self._partials.get((session, stream, layer))
            part_start = part.start_token if part is not None else None
            part_end = (part.start_token + part.n
                        if part is not None else None)
        for ci in range(n_chunks):
            lo = ci * C
            hi = min(n_tokens, lo + C)
            kstr = self._resolve(_key(session, stream, layer, ci))
            dev = self._backend_for(layer, ci, kstr)
            # the stream's final chunk is stored at its true (short)
            # length — existence alone does not cover the range
            if dev.contains(kstr) and lo + dev.nrows(kstr) >= hi:
                continue
            # staged (unflushed) rows are chunk-aligned and include any
            # recovered flushed prefix, so they cover [part_start, part_end)
            if (part_start is not None and part_start <= lo
                    and part_end >= hi):
                continue
            return False
        return True

    # ------------------------------------------------------------- manifest
    def put_manifest(self, session: str, manifest: dict) -> None:
        if self.topology is not None:
            # owner map: the topology the session's chunks were placed
            # under — a store reopened with a different shard count uses
            # it to locate stripes (and a remote restore to target hosts)
            manifest = dict(manifest)
            manifest["shards"] = self.topology.to_json()
        raw = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
        self.devices[0].write(_meta_key(session), raw.copy())
        if self.cold is not None:
            # hot copy is now authoritative — a stale cold copy from an
            # earlier tier demotion must not shadow future drops/reads
            self.cold[0].delete(_meta_key(session))
        self._maybe_reclaim()

    def get_manifest(self, session: str) -> Optional[dict]:
        key = _meta_key(session)
        dev = self._backend_for(0, 0, key)
        if not dev.contains(key):
            return None
        # metadata path: admission/eviction policies poll manifests every
        # step — must not charge the simulated-device read clock
        raw = dev.peek(key)
        return json.loads(raw.tobytes().decode())

    def _all_devices(self) -> List[Backend]:
        return list(self.devices) + (self.cold or [])

    def sessions(self) -> List[str]:
        out = set()
        for d in self._all_devices():
            for k in d.keys():
                if "/meta/" in k:
                    out.add(urllib.parse.unquote(k.split("/")[0]))
        return sorted(out)

    # -------------------------------------------------------------- eviction
    def _drop_key(self, d: Backend, k: str) -> int:
        """Owner-side delete of one device key; returns bytes physically
        freed. Shared keys are NOT deleted — the owner's hold is dropped
        and the bytes become an orphan kept alive by the remaining
        aliases/pins (deferred eviction)."""
        with self._lock:
            if k in self._orphans:
                return 0                      # not this session's bytes
            if self._refs.get(k, 1) > 1:
                self._refs[k] -= 1
                self._orphans.add(k)
                return 0
            self._refs.pop(k, None)
            freed = d.nbytes(k)
            d.delete(k)
            return freed

    def _drop_aliases(self, prefix: str) -> None:
        with self._lock:
            for lk in [lk for lk in self._alias if lk.startswith(prefix)]:
                self._release_phys(self._alias.pop(lk))

    def drop_session(self, session: str) -> None:
        with self._lock:
            for key in list(self._partials):
                if key[0] == session:
                    del self._partials[key]
        prefix = _enc(session) + "/"
        for d in self._all_devices():
            for k in d.keys():
                if k.startswith(prefix):
                    self._drop_key(d, k)
        self._drop_aliases(prefix)

    def drop_stream(self, session: str, stream: str) -> int:
        """Delete every chunk of one (session, stream); returns bytes
        freed (shared chunks drop the owner's hold without freeing —
        their bytes free when the last referent releases). Used by the
        capacity ladder to degrade a session to a cheaper representation
        (e.g. drop 'h' after re-encoding)."""
        with self._lock:
            for key in list(self._partials):
                if key[0] == session and key[1] == stream:
                    del self._partials[key]
        prefix = f"{_enc(session)}/{stream}/"
        freed = 0
        for d in self._all_devices():
            for k in d.keys():
                if k.startswith(prefix):
                    freed += self._drop_key(d, k)
        self._drop_aliases(prefix)
        return freed

    # ------------------------------------------------------ tier demotion
    def demote_session_to_cold(self, session: str) -> int:
        """Move every stored key of a session from the hot tier to the
        cold tier (DRAM -> SSD for idle sessions). Returns bytes moved
        (0 when there is no cold tier or nothing hot remains). Reads fall
        back to the cold tier per key, so demotion is transparent to
        restoration; new appends for a re-activated session land hot."""
        if self.cold is None:
            return 0
        self.flush(session)
        prefix = _enc(session) + "/"
        moved = 0
        for d in self.devices:
            for k in d.keys():
                if not k.startswith(prefix):
                    continue
                # demotion of a shared chunk is deferred until its last
                # referent releases it: a sibling session may be resident
                # and restoring from these bytes right now
                if k in self._orphans or self._refs.get(k, 1) > 1:
                    continue
                layer, chunk = self._coords(k)
                data = d.peek(k)
                self._cold_for(layer, chunk).write(k, np.asarray(data))
                moved += data.nbytes
                d.delete(k)
        return moved

    def stream_in_cold(self, session: str, stream: str) -> bool:
        """True when any chunk of (session, stream) lives in the cold
        tier — the capacity ladder uses this to re-encode a stream back
        into the tier it came from (a cold-demoted session's int8
        re-encode must not re-enter the budgeted hot tier)."""
        if self.cold is None:
            return False
        prefix = f"{_enc(session)}/{stream}/"
        return any(k.startswith(prefix) for d in self.cold for k in d.keys())

    def demote_stream_to_cold(self, session: str, stream: str) -> int:
        """Move one (session, stream)'s chunks hot -> cold; returns bytes
        moved. Stream-scoped sibling of ``demote_session_to_cold``."""
        if self.cold is None:
            return 0
        self.flush(session)
        prefix = f"{_enc(session)}/{stream}/"
        moved = 0
        for d in self.devices:
            for k in d.keys():
                if not k.startswith(prefix):
                    continue
                if k in self._orphans or self._refs.get(k, 1) > 1:
                    continue                   # deferred: shared bytes
                layer, chunk = self._coords(k)
                data = d.peek(k)
                self._cold_for(layer, chunk).write(k, np.asarray(data))
                moved += data.nbytes
                d.delete(k)
        return moved

    # -------------------------------------------------------------- accounting
    @property
    def bytes_used(self) -> int:
        """Hot-tier footprint — the budgeted quantity."""
        return sum(d.bytes_used for d in self.devices)

    @property
    def bytes_cold(self) -> int:
        return sum(d.bytes_used for d in self.cold) if self.cold else 0

    def bytes_for(self, session: str, stream: Optional[str] = None,
                  include_cold: bool = True) -> int:
        """Per-session (optionally per-stream) stored bytes, both tiers
        by default. Computed by key scan — always consistent with the
        devices, including after a FileBackend reopen.

        Dedup-aware: shared bytes are counted once, toward the session
        that OWNS the physical key. Aliased streams (a fork reading a
        sibling's chunks) and orphans (bytes whose owner dropped but that
        pins/aliases keep alive) cost the session nothing — the capacity
        manager therefore never evicts a session to reclaim bytes it is
        not actually paying for."""
        prefix = _enc(session) + "/" + (f"{stream}/" if stream else "")
        devices = self._all_devices() if include_cold else list(self.devices)
        return sum(d.nbytes(k) for d in devices
                   for k in d.keys()
                   if k.startswith(prefix) and k not in self._orphans)

    def sync_clocks(self, now: float) -> None:
        for d in self.devices:
            if isinstance(d, SimulatedSSD):
                d.now = now
        if self.shards is not None:
            for s in self.shards:
                s.sync_clock(now)

    def read_completion(self) -> float:
        done = 0.0
        for d in self.devices:
            if isinstance(d, SimulatedSSD):
                done = max(done, d.read_completion())
        if self.shards is not None:
            for s in self.shards:
                done = max(done, s.read_completion())
        return done

    def n_timed_devices(self) -> int:
        """Devices with a read-service clock (SimulatedSSD), hot + cold —
        0 means reads carry no timing (plain DRAM) and the restoration
        profiler has no IO signal to fold."""
        return sum(1 for d in self._all_devices()
                   if isinstance(d, SimulatedSSD))

    def read_service_total(self) -> float:
        """Accumulated per-device read service seconds across all timed
        devices. The restoration profiler snapshots this around each IO
        task: the delta, divided by the device count (stripes are served
        in parallel), is the task's observed IO-stream seconds — queueing
        behind other sessions' reads is excluded, so the sample is the
        contention-free service time the cost model's 1-stream rate
        predicts."""
        return sum(d.read_time_total for d in self._all_devices()
                   if isinstance(d, SimulatedSSD))
