"""Device-side prefix index for cross-session KV sharing (a copy of the
JAX package's ``serving/prefix_index.py``; DESIGN.md §12).

The index maps *page-granular token prefixes* to the physical pages of a
``PagedBackend`` pool that already hold their KV. Keying is a rolling
token-hash: page ``p``'s key is ``sha1(key[p-1] || tokens[p*bs:(p+1)*bs])``
— an incremental content address, so looking up a prompt walks one hash
per page and stops at the first miss (the longest indexed prefix). Each
entry additionally records its page's raw tokens and its parent entry, so
a hash collision can never alias two different prefixes: a match requires
the parent chain AND the page tokens to agree exactly.

Lifecycle: a session *publishes* its full pages when its prefill
completes (and again when it pauses/retires, just before its slot frees);
publishing increfs each page in the ``BlockAllocator``, so the pages
survive the publisher's eviction. Admission *matches* a new session's
prompt (or a stored session's token history — the restore-skip path) and
adopts the shared pages into the new slot with another incref; the CoW
machinery in the backend privatizes a page only when someone writes to
it. Index-held pages are a cache, not a reservation: under pool pressure
the backend spills least-recently-used entries whose page nobody else
maps (``release``), so sharing never deadlocks admission.

Host backing: entries may carry *pins* on the publisher's persisted
chunk streams (``ChunkStore.pin_chunks``). A fresh session admitted via
a prefix hit never computes — or saves — hidden states for the matched
tokens, so the engine aliases the pinned chunks into the new session's
streams at match time; later pause/restore cycles then find a complete
history. Entries without host backing still serve engines that never
save (``save_hidden=False``) and the restore-skip path (the stored
session owns its full streams already).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np


def roll_hash(prev: Optional[bytes], page) -> bytes:
    """One step of the rolling page hash: ``sha1(prev || page_tokens)``,
    byte for byte the JAX package's."""
    h = hashlib.sha1(prev or b"\x00")
    h.update(np.ascontiguousarray(page, dtype=np.int64).tobytes())
    return h.digest()


def hash_chain(tokens, block_size: int,
               prev: Optional[bytes] = None) -> List[bytes]:
    """Rolling hashes of every FULL ``block_size`` page of ``tokens``.
    Passing the last element back as ``prev`` (with only the new tokens)
    extends a chain incrementally (one round of a conversation at a
    time)."""
    toks = np.asarray(tokens).reshape(-1)
    chain: List[bytes] = []
    key = prev
    for p in range(len(toks) // block_size):
        key = roll_hash(key, toks[p * block_size:(p + 1) * block_size])
        chain.append(key)
    return chain


def common_chain_prefix(a: List[bytes], b: List[bytes]) -> int:
    """Length (in pages) of the common prefix of two hash chains. Each
    element already commits to its whole history, so equality at depth d
    implies equality at every shallower depth — one comparison per page."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


@dataclasses.dataclass
class HostPin:
    """Pinned host-chunk backing of one entry: enough chunks of each
    persisted stream to cover the entry's tokens [0, depth·bs)."""

    methods: List[str]                       # publisher's per-layer methods
    pins: Dict[Tuple[str, int], List[str]]   # (stream, layer) -> pin ids
    n_chunks: int
    # the publisher's history segments (its manifest's), which an
    # aliasing session's manifest takes clipped at the match: what a
    # recompute replay of the shared history must run
    segments: List[list] = dataclasses.field(default_factory=list)

    def all_ids(self) -> List[str]:
        return [pid for ids in self.pins.values() for pid in ids]


@dataclasses.dataclass
class _Entry:
    key: bytes                 # rolling hash through this page
    depth: int                 # pages covered (tokens = depth * block_size)
    block: int                 # physical page holding page depth-1's KV
    page_tokens: Tuple[int, ...]   # raw tokens of page depth-1 (collision
    #                                guard: hashes index, tokens decide)
    parent: Optional[bytes]    # key of the depth-1 entry (chain identity)
    children: set = dataclasses.field(default_factory=set)
    pin: Optional[HostPin] = None
    used: int = 0              # LRU clock value of the last touch


class PrefixIndex:
    """Rolling token-hash → shared physical page map over one backend."""

    def __init__(self, backend):
        self.backend = backend             # PagedBackend (owns allocator)
        self.store = None                  # ChunkStore, set by the engine
        self._entries: Dict[bytes, _Entry] = {}
        self._clock = 0
        # gauges (mirrored into EngineMetrics by the engine)
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.published_pages = 0
        self.released_pages = 0

    # --------------------------------------------------------------- keys
    @property
    def bs(self) -> int:
        return self.backend.block_size

    @staticmethod
    def _roll(prev: Optional[bytes], page: np.ndarray) -> bytes:
        return roll_hash(prev, page)

    def _touch(self, e: _Entry) -> None:
        self._clock += 1
        e.used = self._clock

    # -------------------------------------------------------------- match
    def match(self, tokens, limit: Optional[int] = None,
              need_host: bool = False, record: bool = True):
        """Longest indexed page-aligned prefix of ``tokens``.

        Returns ``(blocks, matched_tokens, deepest_entry)`` — the
        physical pages holding tokens [0, matched_tokens) in order. The
        caller adopts them (incref) before anything can release the
        entries. ``limit`` caps the match in tokens (a fresh session must
        keep at least one prompt token to produce its first logits);
        ``need_host`` restricts the walk to entries with pinned host
        chunks (engines that persist streams need the host-side analogue
        of the shared pages). ``record=False`` leaves the hit-rate
        gauges alone (admission estimates probe without consuming)."""
        bs = self.bs
        toks = np.asarray(tokens).reshape(-1)
        n = len(toks) if limit is None else min(len(toks), int(limit))
        if record:
            self.lookups += 1
        blocks: List[int] = []
        key: Optional[bytes] = None
        entry: Optional[_Entry] = None
        depth = 0
        while (depth + 1) * bs <= n:
            page = toks[depth * bs:(depth + 1) * bs]
            nxt = self._roll(key, page)
            e = self._entries.get(nxt)
            if (e is None or e.parent != key
                    or e.page_tokens != tuple(int(t) for t in page)
                    or (need_host and e.pin is None)):
                break
            key, entry, depth = nxt, e, depth + 1
            blocks.append(e.block)
            self._touch(e)
        if blocks and record:
            self.hits += 1
            self.hit_tokens += depth * bs
        return blocks, depth * bs, entry

    # ------------------------------------------------------------ publish
    def publish(self, tokens, n_tokens: int, slot_blocks, pin_fn=None)\
            -> int:
        """Index every full page of ``tokens[:n_tokens]`` held in
        ``slot_blocks``. Existing entries are touched (their pages are
        as good as ours — identical tokens project identical KV); new
        entries incref the publisher's page and, when ``pin_fn`` is
        given, pin host chunks covering their tokens
        (``pin_fn(depth_pages) -> HostPin | None``). Returns the number
        of newly indexed pages."""
        bs = self.bs
        toks = np.asarray(tokens).reshape(-1)
        pages = min(int(n_tokens), len(toks)) // bs
        pages = min(pages, len(slot_blocks))
        key: Optional[bytes] = None
        added = 0
        for depth in range(1, pages + 1):
            page = toks[(depth - 1) * bs:depth * bs]
            nxt = self._roll(key, page)
            e = self._entries.get(nxt)
            if (e is not None and e.parent == key
                    and e.page_tokens == tuple(int(t) for t in page)):
                self._touch(e)
                key = nxt
                continue
            if e is not None:
                # same hash, different content/chain (collision) — keep
                # the resident entry, stop extending ours
                break
            block = int(slot_blocks[depth - 1])
            try:
                self.backend.allocator.incref(block)
            except RuntimeError:
                break                      # page already freed: stale row
            e = _Entry(key=nxt, depth=depth, block=block,
                       page_tokens=tuple(int(t) for t in page),
                       parent=key, pin=pin_fn(depth) if pin_fn else None)
            self._entries[nxt] = e
            if key is not None and key in self._entries:
                self._entries[key].children.add(nxt)
            self._touch(e)
            self.published_pages += 1
            added += 1
            key = nxt
        return added

    # ------------------------------------------------------------ release
    def _remove(self, e: _Entry) -> None:
        self.backend.allocator.free([e.block])
        if e.pin is not None and self.store is not None:
            self.store.unpin(e.pin.all_ids())
        if e.parent is not None and e.parent in self._entries:
            self._entries[e.parent].children.discard(e.key)
        del self._entries[e.key]

    def releasable(self) -> int:
        """Pages the index could hand back to the pool right now (held
        only by the index — nobody's block table maps them). Because any
        matcher increfs every page up to its match depth, such entries
        always sit at the deep end of their chains, so releasing them
        never strands a reachable entry."""
        return sum(1 for e in self._entries.values()
                   if self.backend.allocator.refcount(e.block) == 1)

    def release(self, n_pages: int) -> int:
        """Spill up to ``n_pages`` least-recently-used index-only pages
        back to the allocator (leaf entries first, so every remaining
        entry stays reachable from the root of its chain)."""
        freed = 0
        while freed < max(int(n_pages), 1):
            cands = [e for e in self._entries.values()
                     if not e.children
                     and self.backend.allocator.refcount(e.block) == 1]
            if not cands:
                break
            victim = min(cands, key=lambda e: e.used)
            self._remove(victim)
            self.released_pages += 1
            freed += 1
        return freed

    def clear(self) -> int:
        """Drop every entry (engine close / tests): decrefs all held
        pages and unpins all host chunks."""
        n = 0
        while self._entries:
            leaves = [e for e in self._entries.values() if not e.children]
            for e in leaves:
                self._remove(e)
                n += 1
        return n

    def __len__(self) -> int:
        return len(self._entries)
