"""KV-cache backends behind one ``CacheView`` seam.

The serving engine never touches cache buffers directly. All state lives
in a ``KVCacheBackend``:

  * ``ContiguousBackend`` — every batch slot owns ``max_seq`` contiguous
    positions of a stacked ``(L, B, Smax, Kv, hd)`` buffer; for an ``ssm``
    model, a row of the recurrent-state buffers ``conv (L, B, W-1, I)``
    and ``ssm (L, B, I, N)`` instead; for a ``hybrid`` model both: the
    attention blocks' ``attn_k``/``attn_v`` (n_super, B, Smax, Kv, hd) and
    the Mamba2 blocks' ``conv``/``ssm`` (n_super, k-1, B, ...), whose
    batch axis is the third;
  * ``PagedBackend``      — block tables over a physical page pool
    ``(L, num_blocks, block_size, Kv, hd)`` plus a ``BlockAllocator``
    free list. A slot reserves only the pages its session can use, so
    the pool, not ``max_batch × max_seq``, caps concurrency;
  * ``EncDecBackend`` and ``PagedEncDecBackend`` — the enc-dec pairings
    (whisper): the decoder self-K/V (``self_k``/``self_v``) in the
    contiguous layout or the page pool, and beside it whole per-slot cross
    state, ``cross_k``/``cross_v`` (L, B, enc_seq, Kv, hd), with a per-slot
    ``enc_len`` (host copy ``enc_len_np``, uploaded with each decode
    step), so sessions with different encoder lengths batch together. The
    cross context never grows after the encoder runs: it has no append
    frontier for a block table to track. ``make_backend`` resolves
    ``contiguous``/``paged`` to these for an enc-dec model.

Consumers all go through a slot-bound ``CacheView`` handle:

    view.write_layer(row, k, v, start)        one restored layer
    view.write_layer_group(rows, k, v, start) a restoration group
    view.write_kv(k, v, start)                stacked prefill K/V
    view.write_states(piece)                  recurrent conv/ssm states, or
                                              cross K/V and enc_len
    view.cross_state()                        an enc-dec slot's cross K/V
    view.gather_hist(hist)                    history K/V for a prefill
    view.snapshot()                           B=1 dict for a pause dump
    view.set_length(n)                        live-length bookkeeping
    view.free()                               release the slot

``ViewSink`` adapts a ``CacheView`` to the restoration executor's
``RestoreSink``. Every write lands in place in the device buffers (the
JAX package returns new arrays from donated updates). Lengths and block
tables live on the host; a decode step uploads them once, with its
tokens and the paged write addresses, in one copy, and nothing is read
back from the device per slot.

Paged decode writes the new token's K/V into its page and attention
reads the pool through the block table (``transformer.
lm_decode_step_paged``, kernel ``decode_attention_paged``); the history
of a chunked prefill is gathered into the contiguous (L, 1, hist, Kv,
hd) shape, so the prefill runs the same launches on both backends.
Masked attention weights are exactly zero past the live length, so the
two layouts give the same bits.

Prefix sharing: several slots (and the engine's ``PrefixIndex``) may
map one physical page. ``adopt_shared`` maps an already-populated page
run as a slot's prefix, and every write path (the views' writes and a
decode step's batched write) first runs the copy-on-write barrier
``_ensure_private``, which gives the slot a private copy of each shared
page it is about to write (one device copy of the page, all layers, per
pool), so a sibling keeps its bytes. The barrier reads the slots' lengths
from the host mirror and adds no synchronisation to a decode step.
Index-held pages are a cache: a reservation short of pages spills them
(``_alloc_pages``). The pool holds back the copy debt, the private pages
that writes into shared pages may still demand (``copy_debt``): a
reservation, an adoption or a fork's parked pages that would leave less
than that is refused (``reserve`` returns False, ``hold_blocks`` parks
nothing), so a copy-on-write write always finds its page.

Tensor parallelism (``ShardedPagedBackend``, "paged-tp"; DESIGN.md §16):
under an SPMD ``TPContext`` the pool is split on the KV-head axis, one
``(L, NB, bs, Kv/tp, hd)`` pool per shard on the shard's device (a
``Sharded`` value); the host block table and lengths are the same for
every shard and go up once per device. Writes put each shard's head
slice at the same page positions, a copy-on-write clones the page on
every shard, and history gathers and snapshots gather the shards onto the
first device, where prefill and the host store stay whole. The other
layouts (contiguous, ssm, hybrid, enc-dec) ignore the context: only the
restoration pack shards for them, and the sink gathers projected heads
back onto the buffer's device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.restoration import RestoreSink, s_bucket
from repro_torch.distributed.tp import Sharded, TPContext, gathered


@dataclasses.dataclass
class OccupancyStats:
    """Gauges for EngineMetrics: how much of the reserved cache capacity
    holds live tokens."""

    live_tokens: int            # tokens of occupied slots (sum of lengths)
    reserved_tokens: int        # capacity handed out to occupied slots
    capacity_tokens: int        # total backend capacity
    free_blocks: int            # paged: free pages; contiguous: free slots

    @property
    def utilization(self) -> float:
        """live / reserved — 1.0 means no internal fragmentation."""
        return (self.live_tokens / self.reserved_tokens
                if self.reserved_tokens else 0.0)

    @property
    def fragmentation(self) -> float:
        return 1.0 - self.utilization if self.reserved_tokens else 0.0


class BlockAllocator:
    """Refcounted LIFO free list over ``num_blocks`` physical pages (LIFO
    so pages freed by an eviction are immediately reused — cache-warm on
    real hardware, and deterministic for the reuse tests).

    Pages are reference counted so several block-table rows (and the
    prefix index) may map the same physical page: ``alloc`` hands a page
    out at refcount 1, ``incref`` adds a holder, and ``free`` drops one
    holder per page — the page returns to the free list only when its
    last holder releases it. Freeing a page that has no live holders
    raises instead of silently corrupting the free list (a double free
    used to append the page twice, letting the allocator grant the same
    physical page to two sessions)."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref: List[int] = [0] * num_blocks

    @property
    def free_count(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages, or None when the pool cannot satisfy the request
        (callers treat None as admission backpressure — never a partial
        grant)."""
        if n < 0 or n > len(self._free):
            return None
        taken = [self._free.pop() for _ in range(n)]
        for b in taken:
            self._ref[b] = 1
        return taken

    def incref(self, block: int) -> None:
        if self._ref[block] <= 0:
            raise RuntimeError(
                f"incref of unallocated page {block} (refcount "
                f"{self._ref[block]}) — sharing a page that is already "
                f"on the free list")
        self._ref[block] += 1

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one holder per page; a page with no remaining holders
        returns to the free list (reversed, preserving LIFO reuse
        order for the common unshared case)."""
        for b in reversed(list(blocks)):
            if self._ref[b] <= 0:
                raise RuntimeError(
                    f"double free of page {b}: page is already free "
                    f"(refcount {self._ref[b]})")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)


# -------------------------------------------------------------------- views
class CacheView:
    """Slot-bound handle; the only way engine, restoration and save code
    touch cache state. ``takes_shards``: the group writes take K/V split
    by heads (``Sharded``) as they come from a sharded restoration pack;
    other views are given them whole."""

    takes_shards = False

    def write_layer(self, row: int, k, v, start: int = 0) -> None:
        """One attention layer's restored K/V at tokens [start, start+n);
        k, v: (1, n, Kv, hd); row indexes the stacked-KV buffer."""
        raise NotImplementedError

    def write_layer_group(self, rows: Sequence[int], k, v,
                          start: int = 0) -> None:
        """A whole restoration group's K/V; rows are stacked-KV rows,
        k/v (G, 1, n, Kv, hd)."""
        for g, row in enumerate(rows):
            self.write_layer(row, k[g], v[g], start)

    def write_kv(self, k, v, start: int) -> None:
        """Stacked prefill K/V (L, 1, n, Kv, hd) at token offset start."""
        raise NotImplementedError

    def write_states(self, piece: dict) -> None:
        """Whole states into this view's slot: recurrent ``conv`` and
        ``ssm`` with a batch axis of one where the backend's buffers have
        their batch axis (ssm (L, 1, ...), hybrid (n_super, k-1, 1,
        ...)); or an enc-dec slot's ``cross_k``/``cross_v`` (L, 1, n, Kv,
        hd) and ``enc_len``."""
        raise NotImplementedError(
            f"the {type(self).__name__} holds no recurrent states")

    def cross_state(self):
        """An enc-dec slot's live cross context: (cross_k, cross_v)
        (L, 1, enc_len, Kv, hd) views and enc_len."""
        raise NotImplementedError(
            f"the {type(self).__name__} holds no cross state")

    def gather_hist(self, hist: int):
        """History K/V for a prefill, a stacked (L, 1, hist, Kv, hd)
        pair."""
        raise NotImplementedError

    def snapshot(self) -> dict:
        """B=1 restorable dict (what ``save_session_pause`` dumps); the
        K/V buffers cover at least the slot's live length."""
        raise NotImplementedError

    def set_length(self, n: int) -> None:
        raise NotImplementedError

    def free(self) -> None:
        """Release the slot's reserved capacity (retire / mid-stream
        eviction). The view must not be used afterwards."""
        raise NotImplementedError


class ViewSink(RestoreSink):
    """Layout-agnostic ``RestoreSink``: every restored piece goes through
    the ``CacheView``, so the executor does not know whether the slot is
    contiguous or paged."""

    def __init__(self, view: CacheView):
        self.view = view

    def put_kv(self, row, k, v, start=0):
        self.view.write_layer(row, k, v, start)

    def put_kv_group(self, rows, k, v, start=0):
        if not self.view.takes_shards:
            k, v = gathered(k), gathered(v)
        self.view.write_layer_group(rows, k, v, start)

    def put_states(self, conv, ssm):
        self.view.write_states({"conv": conv, "ssm": ssm})

    def put_cross(self, ck, cv, enc_len):
        self.view.write_states({"cross_k": ck, "cross_v": cv,
                                "enc_len": enc_len})

    def finish(self, n_tokens):
        self.view.set_length(n_tokens)


# ----------------------------------------------------------------- backends
class KVCacheBackend:
    """Owns all decode-cache state for the engine's ``max_batch`` slots.
    ``lengths_np`` is the host copy of the live lengths; the device sees
    them at the next decode step."""

    name = "backend"

    def view(self, slot: int) -> CacheView:
        raise NotImplementedError

    def can_reserve(self, n_tokens: int) -> bool:
        """Admission backpressure check: could a slot hold ``n_tokens``?"""
        raise NotImplementedError

    def reserve(self, slot: int, n_tokens: int) -> bool:
        """Bind capacity for up to ``n_tokens`` to ``slot``. False means
        the pool is exhausted (the caller must requeue, not proceed)."""
        raise NotImplementedError

    def free_slot(self, slot: int) -> None:
        raise NotImplementedError

    def decode(self, params, tokens: np.ndarray, active=None):
        """One batched decode step over tokens (max_batch, 1); advances
        every slot's length by one. ``active`` (max_batch,) bool marks the
        slots whose session takes this step; the others keep their
        recurrent state (a K/V write of theirs lands past their live
        length, where it is never read). Returns (logits, per-layer hidden
        states)."""
        raise NotImplementedError

    def occupancy(self) -> OccupancyStats:
        raise NotImplementedError

    def _upload(self, *parts: np.ndarray) -> List[torch.Tensor]:
        """Host int arrays -> device int64 tensors, in one copy. On the
        card it goes through pinned memory without waiting for the device
        (a pageable upload would wait for the stream's earlier work)."""
        flat = torch.from_numpy(np.concatenate(
            [np.asarray(p, np.int64).ravel() for p in parts]))
        if self.model.device.type == "cuda":
            flat = flat.pin_memory()
        dev = flat.to(self.model.device, non_blocking=True)
        out, at = [], 0
        for p in parts:
            n = int(np.asarray(p).size)
            out.append(dev[at:at + n].view(np.asarray(p).shape))
            at += n
        return out

    def _step_extras(self) -> dict:
        """Host arrays a decode step uploads beside its tokens and lengths
        (an enc-dec backend's ``enc_len``), by cache key."""
        return {}

    def get_lengths(self) -> np.ndarray:
        return self.lengths_np.copy()

    def set_lengths(self, lengths: np.ndarray) -> None:
        self.lengths_np[:] = lengths

    def set_length(self, slot: int, n: int) -> None:
        self.lengths_np[slot] = n

    def device_occupancy(self) -> List[dict]:
        """Per-device gauges (one row for one device): ``device``,
        ``free_pages``, ``occupancy_pct`` (reserved capacity in use),
        ``util_pct`` (live tokens / reserved capacity)."""
        occ = self.occupancy()
        pct = int(round(100.0 * occ.reserved_tokens
                        / max(occ.capacity_tokens, 1)))
        return [{"device": 0, "free_pages": int(occ.free_blocks),
                 "occupancy_pct": pct,
                 "util_pct": int(round(100.0 * occ.utilization))}]


# ------------------------------------------------------------- contiguous
class _ContiguousView(CacheView):
    def __init__(self, backend: "ContiguousBackend", slot: int):
        self.b = backend
        self.slot = slot

    def write_states(self, piece):
        at = (slice(None),) * self.b.state_axis
        for key in ("conv", "ssm"):
            self.b.state[key][at + (self.slot,)] = piece[key][at + (0,)]

    def write_layer(self, row, k, v, start=0):
        n = k.shape[1]
        self.b.k[row, self.slot, start:start + n] = k[0]
        self.b.v[row, self.slot, start:start + n] = v[0]

    def write_kv(self, k, v, start):
        n = k.shape[2]
        self.b.k[:, self.slot, start:start + n] = k[:, 0]
        self.b.v[:, self.slot, start:start + n] = v[:, 0]

    def gather_hist(self, hist):
        i = self.slot
        return self.b.k[:, i:i + 1, :hist], self.b.v[:, i:i + 1, :hist]

    def snapshot(self):
        i = self.slot
        out = {name: self.b.bufs[name][:, i:i + 1]
               for name in self.b.snap_names}
        at = (slice(None),) * self.b.state_axis + (slice(i, i + 1),)
        out.update((key, t[at]) for key, t in self.b.state.items())
        return out

    def set_length(self, n):
        self.b.set_length(self.slot, n)

    def free(self):
        self.b.free_slot(self.slot)


class ContiguousBackend(KVCacheBackend):
    """``max_seq`` contiguous positions per slot; a reservation always
    costs ``max_seq`` capacity, whatever the session's true length. An
    ``ssm`` model's slot holds its recurrent states (``state``) instead of
    K/V, a ``hybrid`` model's both (its states' batch axis is
    ``state_axis``, 2, behind the super-block and block axes); a decode
    step leaves the states of inactive slots as they were."""

    name = "contiguous"

    def __init__(self, model, max_batch: int, max_seq: int):
        self.model = model
        self.max_batch = max_batch
        self.max_seq = max_seq
        cache = self._make_cache()
        self.state = {key: cache[key] for key in ("conv", "ssm")
                      if key in cache}
        self.state_axis = 2 if model.kind == "hybrid" else 1
        self.bufs = {name: t for name, t in cache.items()
                     if name not in ("lengths", "enc_len")
                     and name not in self.state}
        # the buffers a pause snapshot holds: all but an enc-dec slot's
        # cross state, which restores from the session's encoder blob
        self.snap_names = [n for n in self.bufs
                           if n not in ("cross_k", "cross_v")]
        k_name, v_name = model.adapter.kv_names or (None, None)
        self.k, self.v = cache.get(k_name), cache.get(v_name)
        self.lengths_np = np.zeros((max_batch,), np.int64)
        self._reserved = [0] * max_batch

    def _make_cache(self) -> dict:
        return self.model.init_cache(self.max_batch, self.max_seq)

    def view(self, slot):
        return _ContiguousView(self, slot)

    def can_reserve(self, n_tokens):
        # a free slot always implies a full max_seq reservation; sessions
        # longer than max_seq were never servable under this layout
        return True

    def reserve(self, slot, n_tokens):
        self._reserved[slot] = self.max_seq
        return True

    def free_slot(self, slot):
        self._reserved[slot] = 0

    def decode(self, params, tokens, active=None):
        extras = self._step_extras()
        tok, lengths, *more = self._upload(tokens, self.lengths_np,
                                           *extras.values())
        cache = dict(self.bufs, **self.state,
                     lengths=lengths.to(torch.int32))
        cache.update((k, t.to(torch.int32)) for k, t in zip(extras, more))
        idle = ([] if active is None or not self.state
                else np.nonzero(~np.asarray(active, bool))[0].tolist())
        at = (slice(None),) * self.state_axis + (idle,)
        kept = {key: t[at] for key, t in self.state.items() if idle}
        lg, _, hidden = self.model.decode_step_full(params, cache, tok)
        for key, t in kept.items():
            self.state[key][at] = t
        self.lengths_np += 1
        return lg, hidden

    def occupancy(self):
        live = int(sum(int(self.lengths_np[i])
                       for i, r in enumerate(self._reserved) if r))
        reserved = int(sum(self._reserved))
        free_slots = sum(1 for r in self._reserved if not r)
        return OccupancyStats(live, reserved, self.max_batch * self.max_seq,
                              free_slots)


# ------------------------------------------------------------------ paged
class _PagedView(CacheView):
    def __init__(self, backend: "PagedBackend", slot: int):
        self.b = backend
        self.slot = slot

    def _slots(self, start: int, n: int) -> torch.Tensor:
        """Flat pool positions (page·bs + offset) of logical tokens
        [start, start + n), uploaded once."""
        b = self.b
        pos = start + np.arange(n)
        flat = (b.table_np[self.slot][pos // b.block_size].astype(np.int64)
                * b.block_size + pos % b.block_size)
        if n and int(flat.max()) >= b.num_blocks * b.block_size:
            raise RuntimeError(f"slot {self.slot}: tokens [{start}, "
                               f"{start + n}) exceed its reservation")
        return b._upload(flat)[0]

    def write_layer(self, row, k, v, start=0):
        self.write_layer_group((row,), k[None], v[None], start)

    def _private(self, start: int, n: int) -> None:
        """Copy-on-write barrier for tokens [start, start + n)."""
        bs = self.b.block_size
        if n > 0:
            self.b._ensure_private(
                self.slot, range(start // bs, (start + n - 1) // bs + 1))

    def write_layer_group(self, rows, k, v, start=0):
        b = self.b
        self._private(start, k.shape[2])
        idx = self._slots(start, k.shape[2])
        kf, vf = b.flat_pools()
        for g, row in enumerate(rows):
            kf[row, idx] = k[g, 0]
            vf[row, idx] = v[g, 0]

    def write_kv(self, k, v, start):
        self._private(start, k.shape[2])
        idx = self._slots(start, k.shape[2])
        kf, vf = self.b.flat_pools()
        kf[:, idx] = k[:, 0]
        vf[:, idx] = v[:, 0]

    def _gather(self, n_pages: int):
        b = self.b
        pages = b._upload(b.table_np[self.slot][:n_pages])[0]
        shape = (b.k_pool.shape[0], 1, n_pages * b.block_size) \
            + tuple(b.k_pool.shape[3:])
        return (b.k_pool[:, pages].reshape(shape),
                b.v_pool[:, pages].reshape(shape))

    def gather_hist(self, hist):
        k, v = self._gather(-(-hist // self.b.block_size))
        return k[:, :, :hist], v[:, :, :hist]

    def snapshot(self):
        k, v = self._gather(len(self.b.slot_blocks[self.slot]))
        return dict(zip(self.b.model.adapter.kv_names, (k, v)))

    def set_length(self, n):
        self.b.set_length(self.slot, n)

    def free(self):
        self.b.free_slot(self.slot)


def paged_write_index(block_table: np.ndarray, lengths: np.ndarray,
                      num_blocks: int, block_size: int):
    """Where each row's new token lands in a paged pool, from host copies
    of the block table (B, MB) and the lengths (B,): (rows, flat pool
    positions ``page·bs + offset``) of the rows whose logical page is
    allocated. A row whose page is a sentinel, or lies past the table (the
    row is exactly full), drops its write."""
    MB = block_table.shape[1]
    page = np.asarray(lengths, np.int64) // block_size
    rows = np.nonzero(page < MB)[0]
    blk = block_table[rows, page[rows]].astype(np.int64)
    keep = blk < num_blocks
    rows, blk = rows[keep], blk[keep]
    return rows, blk * block_size + np.asarray(lengths)[rows] % block_size


class PagedBackend(KVCacheBackend):
    """Block-table paged KV cache.

    Physical pages ``(L, num_blocks, block_size, Kv, hd)`` are shared by
    all slots; ``table_np[slot, j]`` maps a slot's logical page *j* to a
    physical page (entries == ``num_blocks`` are unallocated sentinels:
    the decode step drops writes to them and attention never reads
    them). Reservations are made in whole pages for the session's
    worst-case final length, so admission is bounded by actual need, not
    ``max_batch × max_seq``."""

    name = "paged"
    cross: dict = {}        # an enc-dec pairing's per-slot cross buffers

    def __init__(self, model, max_batch: int, max_seq: int, *,
                 block_size: int = 16, num_blocks: Optional[int] = None):
        if not model.adapter.supports_paged:
            raise NotImplementedError(
                f"paged KV cache requires an lm-family model; "
                f"{model.cfg.name} is {model.kind!r}")
        self.model = model
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.block_size = block_size
        self.blocks_per_seq = -(-max_seq // block_size)
        self.num_blocks = (max_batch * self.blocks_per_seq
                           if num_blocks is None else num_blocks)
        self.k_pool, self.v_pool = self._make_pools()
        self.table_np = np.full((max_batch, self.blocks_per_seq),
                                self.num_blocks, np.int32)
        self.lengths_np = np.zeros((max_batch,), np.int64)
        self.allocator = BlockAllocator(self.num_blocks)
        self.slot_blocks: List[List[int]] = [[] for _ in range(max_batch)]
        # set by the engine under prefix sharing: pages held by the index
        # are reclaimable under pressure (``_alloc_pages``)
        self.prefix_index = None
        self.cow_copies = 0

    def _make_pools(self):
        cache = self.model.init_paged_cache(self.max_batch, self.num_blocks,
                                            self.block_size,
                                            self.blocks_per_seq)
        return cache["k_pool"], cache["v_pool"]

    def flat_pools(self):
        """The pools as (L, num_blocks·bs, Kv, hd) views."""
        L = self.k_pool.shape[0]
        shape = (L, self.num_blocks * self.block_size) \
            + tuple(self.k_pool.shape[3:])
        return self.k_pool.view(shape), self.v_pool.view(shape)

    def view(self, slot):
        return _PagedView(self, slot)

    # ------------------------------------------------- copy-on-write pages
    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Allocator grant, spilling least recently used prefix-index
        pages on a shortfall (index-held pages are never a reservation)."""
        got = self.allocator.alloc(n)
        if got is None and self.prefix_index is not None:
            short = n - self.allocator.free_count
            if self.prefix_index.release(short) > 0:
                got = self.allocator.alloc(n)
        return got

    def copy_debt(self) -> int:
        """Private pages that writes into shared pages can still demand:
        over each page some slot maps, the copies its writers may need,
        ``min(maps, holders - index_holds - 1)``. Every mapping slot may
        write anywhere below its reservation, and each writer but the
        last needs a copy; the last needs one too while a parked fork
        still holds the page. An index hold costs no copy: a write that
        leaves only the index sharing the page drops the index's entry
        when no page is spare (``_ensure_private``)."""
        maps: dict = {}
        for blks in self.slot_blocks:
            for b in blks:
                maps[b] = maps.get(b, 0) + 1
        held = (self.prefix_index.held() if self.prefix_index is not None
                else {})
        ref = self.allocator.refcount
        return sum(max(0, min(n, ref(b) - held.get(b, 0) - 1))
                   for b, n in maps.items())

    def headroom(self) -> int:
        """Pages a reservation may still take: free pages and spillable
        index pages, less the copy debt. The backend keeps it >= 0, so a
        copy-on-write write always finds its page."""
        avail = self.allocator.free_count
        if self.prefix_index is not None:
            avail += self.prefix_index.releasable()
        return avail - self.copy_debt()

    def _ensure_private(self, slot: int, logical_pages) -> None:
        """Copy-on-write barrier: each listed logical page of ``slot``
        that maps a shared physical page (refcount > 1) is copied to a
        fresh private page before the caller writes through it; the rest
        of the prefix stays shared. A page shared with the prefix index
        alone is copied only when the pool has a page to spare; else the
        index forgets it and the slot writes in place."""
        blks = self.slot_blocks[slot]
        for lp in sorted(set(int(p) for p in logical_pages)):
            if lp >= len(blks) or self.allocator.refcount(blks[lp]) <= 1:
                continue
            src = blks[lp]
            if (self.prefix_index is not None
                    and self.allocator.refcount(src)
                    - self.prefix_index.held().get(src, 0) == 1
                    and self.headroom() < 1):
                self.prefix_index.forget(src)
                continue
            fresh = self._alloc_pages(1)
            if fresh is None:
                raise RuntimeError(
                    "page pool exhausted during copy-on-write divergence: "
                    "the copy debt was not held back (a bug in the "
                    "backend's accounting)")
            dst = fresh[0]
            self._copy_page(src, dst)
            self.allocator.free([src])          # drop this slot's hold
            blks[lp] = dst
            self.table_np[slot, lp] = dst
            self.cow_copies += 1

    def _copy_page(self, src: int, dst: int) -> None:
        """Page ``src`` of every layer into page ``dst``, in both pools."""
        self.k_pool[:, dst] = self.k_pool[:, src]
        self.v_pool[:, dst] = self.v_pool[:, src]

    def hold_blocks(self, blocks: Sequence[int]) -> bool:
        """Add a caller-owned hold on each page (a fork's parked pages)
        if the copy debt that adds still fits the pool; else add none
        and return False."""
        blocks = [int(b) for b in blocks]
        for b in blocks:
            self.allocator.incref(b)
        if self.headroom() >= 0:
            return True
        self.allocator.free(blocks)
        return False

    def adopt_shared(self, slot: int, blocks: Sequence[int], *,
                     owned: bool = False) -> None:
        """Map an already-populated shared page run as the slot's logical
        prefix (a prefix-index hit or a fork's parked pages).
        ``owned=False`` adds a hold on each page (the donor keeps its
        own); ``owned=True`` takes over holds the caller owns. Runs
        before ``reserve`` tops the row up with private pages."""
        if self.slot_blocks[slot]:
            raise RuntimeError(f"adopt_shared on a non-empty slot {slot}")
        blocks = [int(b) for b in blocks]
        if not owned:
            for b in blocks:
                self.allocator.incref(b)
        self.slot_blocks[slot] = list(blocks)
        row = self.table_np[slot]
        row[:] = self.num_blocks
        row[:len(blocks)] = blocks

    def release_blocks(self, blocks: Sequence[int]) -> None:
        """Drop caller-owned holds bound to no slot (a fork's parked pages
        that will never be adopted)."""
        self.allocator.free(list(blocks))

    def shared_page_stats(self):
        """(shared, private) physical page counts: a page is shared when
        more than one holder maps it."""
        refs = self.allocator._ref
        return (sum(1 for r in refs if r > 1),
                sum(1 for r in refs if r == 1))

    def _blocks_needed(self, n_tokens: int) -> int:
        need = max(-(-max(n_tokens, 1) // self.block_size), 1)
        # a session whose worst case exceeds max_seq (or the whole pool)
        # gets at most one full table row — matching the contiguous
        # layout, where overflow decode writes past the reservation are
        # silently dropped rather than crashing or wedging admission
        return min(need, self.blocks_per_seq, self.num_blocks)

    def can_reserve(self, n_tokens):
        return self._blocks_needed(n_tokens) <= self.headroom()

    def reserve(self, slot, n_tokens):
        """Top the slot up to the pages of ``n_tokens``. False, with
        nothing allocated, when that would leave less than the copy debt
        (shared pages the slot adopted count in it), so the caller frees
        the slot."""
        have = self.slot_blocks[slot]
        grow = max(self._blocks_needed(n_tokens) - len(have), 0)
        if grow > self.headroom():
            return False
        if not grow:
            return True
        blocks = self._alloc_pages(grow)
        if blocks is None:
            return False
        have.extend(blocks)
        row = self.table_np[slot]
        row[:] = self.num_blocks
        row[:len(have)] = have
        return True

    def free_slot(self, slot):
        self.allocator.free(self.slot_blocks[slot])
        self.slot_blocks[slot] = []
        self.table_np[slot, :] = self.num_blocks
        self.lengths_np[slot] = 0

    def decode(self, params, tokens, active=None):
        # copy-on-write before the batched write: the step writes a token
        # at every occupied slot's length (the engine rolls the idle ones
        # back), so each slot's frontier page must be private first
        bs = self.block_size
        for slot, blks in enumerate(self.slot_blocks):
            if blks:
                self._ensure_private(slot, (int(self.lengths_np[slot]) // bs,))
        rows, slots = paged_write_index(self.table_np, self.lengths_np,
                                        self.num_blocks, self.block_size)
        extras = self._step_extras()
        tok, lengths, table, rows_t, slots_t, *more = self._upload(
            tokens, self.lengths_np, self.table_np, rows, slots,
            *extras.values())
        cache = {"k_pool": self.k_pool, "v_pool": self.v_pool,
                 "block_table": self._per_pool(table.to(torch.int32)),
                 "lengths": lengths.to(torch.int32),
                 "write": self._per_pool(rows_t, slots_t), **self.cross}
        cache.update((k, t.to(torch.int32)) for k, t in zip(extras, more))
        lg, _, hidden = self.model.decode_step_paged(params, cache, tok)
        self.lengths_np += 1
        return lg, hidden

    def _per_pool(self, *ts):
        """A decode step's table or write addresses as its pools take
        them: ``ts`` itself (one tensor, or the tuple)."""
        return ts[0] if len(ts) == 1 else ts

    def occupancy(self):
        live = int(sum(int(self.lengths_np[i])
                       for i, blks in enumerate(self.slot_blocks) if blks))
        reserved = sum(len(b) for b in self.slot_blocks) * self.block_size
        return OccupancyStats(live, reserved,
                              self.num_blocks * self.block_size,
                              self.allocator.free_count)


# ------------------------------------------------------------------ sharded
class DeviceAllocatorView:
    """Read-only per-shard window onto the shared ``BlockAllocator``.

    Head sharding replicates the page structure: every shard holds the
    same page ids (1/tp of each page's bytes), so the free list and
    refcounts are common state; a per-shard allocator would desynchronise
    the block tables. The view proxies the shared counts and scales only
    the byte gauges by its shard."""

    def __init__(self, backend: "ShardedPagedBackend", device: int):
        self.b = backend
        self.device = device

    @property
    def num_blocks(self) -> int:
        return self.b.allocator.num_blocks

    @property
    def free_count(self) -> int:
        return self.b.allocator.free_count

    def refcount(self, block: int) -> int:
        return self.b.allocator.refcount(block)

    def pool_bytes(self) -> int:
        return sum(p.parts[self.device].numel()
                   * p.parts[self.device].element_size()
                   for p in (self.b.k_pool, self.b.v_pool))


class _ShardedPagedView(_PagedView):
    """Writes put each shard's head slice into its own pool at the same
    page positions; gathers bring the shards whole onto the first
    device."""

    takes_shards = True

    def _parts(self, x, axis: int) -> List[torch.Tensor]:
        """The shards' head slices of ``x`` (whole, or ``Sharded`` on
        ``axis``), each on its shard's device."""
        tp = self.b.tp
        parts = (x.parts if isinstance(x, Sharded)
                 else x.chunk(tp.tp, axis))
        return [p.to(d) for p, d in zip(parts, tp.devices)]

    def _write(self, rows, k, v, start: int) -> None:
        b = self.b
        n = k.shape[2]
        self._private(start, n)
        idxs = b.tp.replicate(self._slots(start, n))
        for kf, vf, ks, vs, idx in zip(*b.flat_pools(), self._parts(k, 3),
                                       self._parts(v, 3), idxs):
            if rows is None:
                kf[:, idx] = ks[:, 0]
                vf[:, idx] = vs[:, 0]
                continue
            for g, row in enumerate(rows):
                kf[row, idx] = ks[g, 0]
                vf[row, idx] = vs[g, 0]

    def write_layer_group(self, rows, k, v, start=0):
        self._write(rows, k, v, start)

    def write_kv(self, k, v, start):
        self._write(None, k, v, start)

    def _gather(self, n_pages: int):
        b = self.b
        pages = b.tp.replicate(b._upload(b.table_np[self.slot][:n_pages])[0])
        out = []
        for pool in (b.k_pool, b.v_pool):
            parts = [p[:, pg].reshape((p.shape[0], 1, n_pages * b.block_size)
                                      + tuple(p.shape[3:]))
                     for p, pg in zip(pool.parts, pages)]
            out.append(b.tp.unshard(Sharded(parts, 3)))
        return tuple(out)


class ShardedPagedBackend(PagedBackend):
    """The paged backend with its pool split on the KV-head axis over an
    SPMD ``TPContext``: ``k_pool``/``v_pool`` are ``Sharded`` (L, NB, bs,
    Kv, hd) values, one (L, NB, bs, Kv/tp, hd) pool per shard. Allocator,
    tables, copy debt and prefix sharing are the single-device code over
    the one page structure; a decode step uploads table, lengths and
    write addresses once and copies them to each other device, and
    ``transformer.block_decode_paged`` runs kernel #4 once per shard."""

    name = "paged-tp"

    def __init__(self, model, max_batch: int, max_seq: int, *,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 tp: Optional[TPContext] = None):
        if tp is None or not tp.spmd:
            raise ValueError("the sharded page pool needs a tensor-"
                             "parallel context of tp > 1")
        if model.adapter.has_cross:
            raise ValueError(f"the sharded page pool holds no cross state; "
                             f"{model.cfg.name} is served by the paged "
                             "enc-dec backend, unsharded")
        tp.validate_heads(model.cfg.n_kv_heads)
        self.tp = tp
        self.shards = tp.tp
        super().__init__(model, max_batch, max_seq, block_size=block_size,
                         num_blocks=num_blocks)

    def _make_pools(self):
        c = self.model.cfg
        shape = (c.n_layers, self.num_blocks, self.block_size,
                 c.n_kv_heads // self.tp.tp, c.head_dim_)
        return tuple(Sharded([torch.zeros(shape, dtype=self.model.dtype,
                                          device=d)
                              for d in self.tp.devices], 3)
                     for _ in range(2))

    def flat_pools(self):
        """Per shard, the pools as (L, num_blocks·bs, Kv/tp, hd) views."""
        return tuple([p.view((p.shape[0], self.num_blocks * self.block_size)
                             + tuple(p.shape[3:])) for p in pool.parts]
                     for pool in (self.k_pool, self.v_pool))

    def view(self, slot):
        return _ShardedPagedView(self, slot)

    def _copy_page(self, src, dst):
        for pool in (self.k_pool, self.v_pool):
            for p in pool.parts:
                p[:, dst] = p[:, src]

    def _per_pool(self, *ts):
        per = list(zip(*(self.tp.replicate(t) for t in ts)))
        return [p[0] if len(ts) == 1 else p for p in per]

    def device_views(self) -> List[DeviceAllocatorView]:
        return [DeviceAllocatorView(self, d) for d in range(self.shards)]

    def device_occupancy(self):
        base = super().device_occupancy()[0]
        return [dict(base, device=v.device, pool_bytes=v.pool_bytes())
                for v in self.device_views()]


# ------------------------------------------------------------------ encdec
class _CrossStateMixin:
    """Cross-state handling shared by both enc-dec views: the cross
    buffers are whole per slot, whatever the layout of the decoder
    self-K/V. The backend provides ``cross`` (cross_k, cross_v buffers),
    ``enc_seq`` and ``enc_len_np``."""

    def write_states(self, piece):
        b, slot = self.b, self.slot
        for key in ("cross_k", "cross_v"):
            if key not in piece:
                continue
            val = piece[key]
            n = val.shape[2]
            if n > b.enc_seq:
                # admission counts decoder positions only: an oversized
                # encoder context must fail loudly here
                raise ValueError(
                    f"encoder context of {n} frames exceeds the backend's "
                    f"enc_seq={b.enc_seq}; raise --enc-seq (or "
                    "InferenceEngine(enc_seq=))")
            buf = b.cross[key]
            buf[:, slot, :n] = val[:, 0]
            # zeros up to the power-of-two bucket, as the JAX package pads
            # its write; the tail is past enc_len, masked everywhere
            buf[:, slot, n:min(s_bucket(max(n, 1)), b.enc_seq)] = 0
        if "enc_len" in piece:
            b.enc_len_np[slot] = int(piece["enc_len"])

    def cross_state(self):
        b, i = self.b, self.slot
        n = int(b.enc_len_np[i])
        return (b.cross["cross_k"][:, i:i + 1, :n],
                b.cross["cross_v"][:, i:i + 1, :n], n)


class _CrossBackendMixin:
    """An enc-dec backend's per-slot cross state and its host lengths."""

    def _init_cross(self, model, max_batch: int, max_seq: int,
                    enc_seq: Optional[int]) -> None:
        if model.kind != "encdec":
            raise NotImplementedError(
                f"the {self.name} KV cache requires an encoder-decoder "
                f"model; {model.cfg.name} is {model.kind!r}")
        self.enc_seq = int(enc_seq or max_seq)
        self.enc_len_np = np.zeros((max_batch,), np.int64)

    def _step_extras(self):
        return {"enc_len": self.enc_len_np}

    def free_slot(self, slot):
        self.enc_len_np[slot] = 0
        super().free_slot(slot)


class _EncDecView(_CrossStateMixin, _ContiguousView):
    """Self-K/V writes and gathers through the contiguous view (keys
    ``self_k``/``self_v``); a snapshot holds the self-K/V only."""


class EncDecBackend(_CrossBackendMixin, ContiguousBackend):
    """Contiguous decoder self-K/V (``max_seq`` positions per slot) and
    whole per-slot cross state of ``enc_seq`` encoder positions (default
    ``max_seq``)."""

    name = "encdec"

    def __init__(self, model, max_batch: int, max_seq: int, *,
                 enc_seq: Optional[int] = None):
        self._init_cross(model, max_batch, max_seq, enc_seq)
        super().__init__(model, max_batch, max_seq)
        self.cross = {k: self.bufs[k] for k in ("cross_k", "cross_v")}

    def _make_cache(self):
        return self.model.init_cache(self.max_batch, self.max_seq,
                                     enc_seq=self.enc_seq)

    def view(self, slot):
        return _EncDecView(self, slot)


class _PagedEncDecView(_CrossStateMixin, _PagedView):
    """Decoder self-K/V through the pool; cross state whole per slot, as
    in the contiguous pairing."""


class PagedEncDecBackend(_CrossBackendMixin, PagedBackend):
    """Paged decoder self-K/V and whole per-slot cross state: the part
    that grows with decoded tokens rides the pool, so admission is
    bounded by the decoder's need and a pause frees pages."""

    name = "paged-encdec"

    def __init__(self, model, max_batch: int, max_seq: int, *,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 enc_seq: Optional[int] = None):
        self._init_cross(model, max_batch, max_seq, enc_seq)
        super().__init__(model, max_batch, max_seq, block_size=block_size,
                         num_blocks=num_blocks)
        cross = model.init_cross(max_batch, self.enc_seq)
        self.cross = {k: cross[k] for k in ("cross_k", "cross_v")}

    def view(self, slot):
        return _PagedEncDecView(self, slot)


BACKENDS = {"contiguous": ContiguousBackend, "paged": PagedBackend}


def make_backend(spec: Union[str, KVCacheBackend], model, max_batch: int,
                 max_seq: int, *, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 enc_seq: Optional[int] = None,
                 tp: Optional[TPContext] = None) -> KVCacheBackend:
    """Engine-facing factory: a name ('contiguous' | 'paged' |
    'paged-tp') or an already-built backend instance. For an enc-dec
    model 'contiguous' resolves to ``EncDecBackend`` and 'paged' to
    ``PagedEncDecBackend``, each with ``enc_seq`` encoder positions per
    slot. An SPMD ``tp`` upgrades 'paged' to the sharded pool
    (``ShardedPagedBackend``), which 'paged-tp' names (a ValueError
    without an SPMD ``tp``); the other layouts ignore ``tp``."""
    if isinstance(spec, KVCacheBackend):
        return spec
    if spec not in BACKENDS and spec != "paged-tp":
        raise ValueError(f"unknown KV-cache backend {spec!r}; "
                         f"one of {sorted(BACKENDS)}")
    encdec = model.kind == "encdec"
    if spec == "paged-tp" or (spec == "paged" and not encdec
                              and tp is not None and tp.spmd):
        return ShardedPagedBackend(model, max_batch, max_seq,
                                   block_size=block_size,
                                   num_blocks=num_blocks, tp=tp)
    if spec == "paged":
        if encdec:
            return PagedEncDecBackend(model, max_batch, max_seq,
                                      block_size=block_size,
                                      num_blocks=num_blocks, enc_seq=enc_seq)
        return PagedBackend(model, max_batch, max_seq,
                            block_size=block_size, num_blocks=num_blocks)
    if encdec:
        return EncDecBackend(model, max_batch, max_seq, enc_seq=enc_seq)
    return ContiguousBackend(model, max_batch, max_seq)
