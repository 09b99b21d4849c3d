"""Similarity-steered session router (DESIGN.md §14; the JAX package's
``frontend/router.py`` over the port's engine).

Maps incoming conversations onto engine sessions the way proxycache
steers llama.cpp slots: a bounded table of router slots, each remembering
which engine session it steers, the exact token history that session's
cached/stored state covers, a rolling page-hash chain over that history
(the same ``sha1(prev || page)`` hashes serving/prefix_index.py keys
device pages by), and a heat score. Routing a prompt:

1. **exact** — the conversation id is already bound to a slot: reuse its
   session, submitting only the suffix past the cached history (the
   engine restores the stored history instead of re-prefilling it);
2. **restore-on-match** — no id binding, but some live slot's or stored
   session's ENTIRE history is an exact token prefix of the prompt and
   covers at least ``reuse_threshold`` of it: a returning conversation
   that resent its full transcript. The slot is (re)bound, the prompt
   trimmed to the suffix, and the engine's normal RESTORING path brings
   the state back — restoration instead of recomputation, the paper's
   claim measured end to end;
3. **fork-on-shared-prefix** — the matched session belongs to a
   *different, still-bound* conversation (a branch point, e.g. two users
   continuing from one checkpoint). With prefix sharing on, the source
   is forked (``InferenceEngine.fork_session``: content-addressed host
   chunk aliases + parked CoW pages) and the new conversation continues
   on the fork; with sharing off it falls through to a fresh session —
   stealing the slot would corrupt the still-live original;
4. **fresh** — free slot first, else the coldest idle slot is rebound
   (cold-first placement). The displaced session's state is already in
   the store (the engine saves at retire — save-to-store precedes any
   overwrite by construction) and moves to the router's stored registry,
   where restore-on-match can still find it.

The router itself never touches device state: it only decides session
ids and trims prompts; restoration, prefix-sharing and capacity policy
all stay in the engine. Thread-safe: ``route`` runs on the event loop,
``complete`` on the engine-pump thread.

A model whose prefill cannot resume on restored state (the ``ssm`` and
``hybrid`` families: ``adapter.supports_resume`` is false) is never
steered: every request routes ``fresh`` over its full rendered prompt,
so it gets the one-shot answer (the JAX package's router would route a
returning conversation ``exact`` or ``restore`` and prefill the suffix
on top of a zero state, dropping the history).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.prefix_index import common_chain_prefix, hash_chain


@dataclasses.dataclass
class RouterSlot:
    index: int
    session_id: Optional[str] = None
    conversation_id: Optional[str] = None
    # exact token history the session's stored state covers: the routed
    # prompt plus all but the last generated token (the engine keeps the
    # last sampled token as the resume feed, outside the stored range)
    tokens: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32))
    chain: List[bytes] = dataclasses.field(default_factory=list)
    heat: float = 0.0              # hits, decayed on overwrite scans
    last_used: int = 0             # router clock of the last route
    busy: bool = False             # a request is in flight on the session

    def free(self) -> bool:
        return self.session_id is None


@dataclasses.dataclass
class StoredSession:
    """A session displaced from the slot table; still restorable."""
    session_id: str
    tokens: np.ndarray
    chain: List[bytes]
    last_used: int = 0


@dataclasses.dataclass
class RouteDecision:
    session_id: str
    prompt: np.ndarray             # suffix to submit (full prompt if fresh)
    kind: str                      # exact | restore | fork | fresh
    full_tokens: np.ndarray        # the full rendered prompt (bookkeeping)
    matched_tokens: int = 0
    slot: Optional[RouterSlot] = None
    forked_from: Optional[str] = None


class RouterBusy(RuntimeError):
    """The conversation already has a request in flight."""


class SessionRouter:
    def __init__(self, engine=None, *, n_slots: int = 8,
                 block_size: int = 16, reuse_threshold: float = 0.5,
                 steer: bool = True, max_stored: int = 64):
        self.engine = engine
        self.n_slots = int(n_slots)
        self.block_size = int(block_size)
        self.reuse_threshold = float(reuse_threshold)
        # steer=False is the route-blind baseline the SLO harness
        # compares against: every request lands on a fresh session and
        # pays its full history as prefill. A model that cannot resume
        # is served that way whatever ``steer`` says.
        adapter = getattr(getattr(engine, "model", None), "adapter", None)
        self.steer = bool(steer) and getattr(adapter, "supports_resume",
                                             True)
        self.slots = [RouterSlot(i) for i in range(self.n_slots)]
        self.stored: Dict[str, StoredSession] = {}
        self.max_stored = int(max_stored)
        self._by_conv: Dict[str, RouterSlot] = {}
        self._lock = threading.Lock()
        self._clock = 0
        self._next_id = 0
        # gauges
        self.lookups = 0
        self.exact_hits = 0
        self.similarity_hits = 0
        self.forks = 0
        self.fresh = 0
        self.overwrites = 0
        self.overflow = 0

    @property
    def hit_rate(self) -> float:
        hits = self.exact_hits + self.similarity_hits + self.forks
        return hits / self.lookups if self.lookups else 0.0

    def stats(self) -> dict:
        return {"lookups": self.lookups, "exact_hits": self.exact_hits,
                "similarity_hits": self.similarity_hits,
                "forks": self.forks, "fresh": self.fresh,
                "overwrites": self.overwrites, "overflow": self.overflow,
                "hit_rate": self.hit_rate,
                "live_slots": sum(1 for s in self.slots if not s.free()),
                "stored_sessions": len(self.stored)}

    # ------------------------------------------------------------ matching
    def _full_prefix_len(self, cand_tokens: np.ndarray,
                         cand_chain: List[bytes],
                         tokens: np.ndarray,
                         chain: List[bytes]) -> int:
        """len(cand_tokens) iff the candidate's ENTIRE history is an
        exact prefix of ``tokens``, else 0. Hash chains cover full pages
        (one compare per page); the sub-page tail is verified on raw
        tokens — hashes accelerate, tokens decide."""
        n = len(cand_tokens)
        if n == 0 or n >= len(tokens):
            # a usable match must leave at least one suffix token to
            # prefill (the engine needs fresh logits for the next token)
            return 0
        bs = self.block_size
        pages = n // bs
        if common_chain_prefix(cand_chain, chain) < pages:
            return 0
        if not np.array_equal(cand_tokens[pages * bs:],
                              tokens[pages * bs:n]):
            return 0
        return n

    def _best_match(self, tokens: np.ndarray, chain: List[bytes]):
        """Longest full-history prefix match over live slots and the
        stored registry. Returns (kind, obj, matched) with kind in
        {"slot", "stored", None}."""
        best = (None, None, 0)
        for s in self.slots:
            if s.free() or s.busy:
                continue
            m = self._full_prefix_len(s.tokens, s.chain, tokens, chain)
            if m > best[2]:
                best = ("slot", s, m)
        for st in self.stored.values():
            m = self._full_prefix_len(st.tokens, st.chain, tokens, chain)
            if m > best[2]:
                best = ("stored", st, m)
        return best

    # ----------------------------------------------------------- placement
    def _place_slot(self) -> Optional[RouterSlot]:
        """Free slot first, else the coldest idle slot (heat, then
        recency); every slot busy -> None (untracked overflow)."""
        for s in self.slots:
            if s.free():
                return s
        idle = [s for s in self.slots if not s.busy]
        if not idle:
            return None
        victim = min(idle, key=lambda s: (s.heat, s.last_used))
        self._displace(victim)
        return victim

    def _displace(self, slot: RouterSlot) -> None:
        """Move the slot's session to the stored registry. Its state is
        already persisted — the engine saves every retiring session
        before its slot frees — so overwrite never loses state."""
        if slot.session_id is not None and len(slot.tokens):
            self.stored[slot.session_id] = StoredSession(
                slot.session_id, slot.tokens, slot.chain, slot.last_used)
            while len(self.stored) > self.max_stored:
                lru = min(self.stored.values(), key=lambda s: s.last_used)
                del self.stored[lru.session_id]
        if slot.conversation_id is not None:
            self._by_conv.pop(slot.conversation_id, None)
        for s in self.slots:
            s.heat *= 0.5          # decay: old hits fade across overwrites
        slot.session_id = None
        slot.conversation_id = None
        slot.tokens = np.zeros((0,), np.int32)
        slot.chain = []
        slot.heat = 0.0
        self.overwrites += 1

    def _bind(self, slot: RouterSlot, session_id: str,
              conversation_id: Optional[str]) -> None:
        if slot.conversation_id is not None:
            self._by_conv.pop(slot.conversation_id, None)
        slot.session_id = session_id
        slot.conversation_id = conversation_id
        if conversation_id is not None:
            self._by_conv[conversation_id] = slot
        slot.busy = True
        slot.heat += 1.0
        slot.last_used = self._clock

    def _fresh_id(self) -> str:
        self._next_id += 1
        return f"fd-{self._next_id}"

    # --------------------------------------------------------------- route
    def route(self, tokens, conversation_id: Optional[str] = None)\
            -> RouteDecision:
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if len(tokens) == 0:
            raise ValueError("cannot route an empty prompt")
        chain = hash_chain(tokens, self.block_size)
        with self._lock:
            self._clock += 1
            self.lookups += 1
            if not self.steer:
                self.fresh += 1
                return RouteDecision(self._fresh_id(), tokens, "fresh",
                                     tokens)
            # 1. exact conversation-id binding
            slot = (self._by_conv.get(conversation_id)
                    if conversation_id else None)
            if slot is not None:
                if slot.busy:
                    raise RouterBusy(
                        f"conversation {conversation_id!r} already has a "
                        f"request in flight")
                m = self._full_prefix_len(slot.tokens, slot.chain,
                                          tokens, chain)
                if m:
                    self.exact_hits += 1
                    self._bind(slot, slot.session_id, conversation_id)
                    return RouteDecision(slot.session_id, tokens[m:],
                                         "exact", tokens,
                                         matched_tokens=m, slot=slot)
                # the client rewrote history: the cached state no longer
                # prefixes the prompt — unbind and fall through
                self._displace(slot)
            # 2/3. similarity: longest full-history prefix match
            kind, obj, m = self._best_match(tokens, chain)
            if m and m / len(tokens) >= self.reuse_threshold:
                if kind == "slot" and obj.conversation_id is not None \
                        and conversation_id is not None \
                        and obj.conversation_id != conversation_id:
                    # branch point: a DIFFERENT bound conversation owns
                    # the match — fork rather than steal (sharing on)
                    d = self._try_fork(obj.session_id, tokens, m,
                                       conversation_id)
                    if d is not None:
                        return d
                elif kind == "slot":
                    self.similarity_hits += 1
                    self._bind(obj, obj.session_id, conversation_id)
                    return RouteDecision(obj.session_id, tokens[m:],
                                         "restore", tokens,
                                         matched_tokens=m, slot=obj)
                else:                      # stored registry hit
                    slot = self._place_slot()
                    if slot is not None:
                        st: StoredSession = obj
                        del self.stored[st.session_id]
                        slot.tokens = st.tokens
                        slot.chain = st.chain
                        self.similarity_hits += 1
                        self._bind(slot, st.session_id, conversation_id)
                        return RouteDecision(st.session_id, tokens[m:],
                                             "restore", tokens,
                                             matched_tokens=m, slot=slot)
            # 4. fresh placement
            return self._route_fresh(tokens, conversation_id)

    def _route_fresh(self, tokens: np.ndarray,
                     conversation_id: Optional[str]) -> RouteDecision:
        sid = self._fresh_id()
        slot = self._place_slot()
        self.fresh += 1
        if slot is None:
            self.overflow += 1      # untracked: not matchable later
            return RouteDecision(sid, tokens, "fresh", tokens)
        self._bind(slot, sid, conversation_id)
        return RouteDecision(sid, tokens, "fresh", tokens,
                             slot=slot)

    def _try_fork(self, src: str, tokens: np.ndarray, m: int,
                  conversation_id: Optional[str])\
            -> Optional[RouteDecision]:
        """Fork ``src`` for a branching conversation. None when forking
        is unavailable (no engine, sharing off, source un-forkable) —
        the caller falls back to a fresh session."""
        eng = self.engine
        if eng is None or not getattr(eng, "prefix_sharing", False):
            return None
        new_id = self._fresh_id()
        try:
            eng.fork_session(src, new_id)
        except (KeyError, ValueError):
            return None
        slot = self._place_slot()
        self.forks += 1
        if slot is None:
            self.overflow += 1
            return RouteDecision(new_id, tokens[m:], "fork", tokens,
                                 matched_tokens=m, forked_from=src)
        slot.tokens = tokens[:m].copy()
        slot.chain = hash_chain(slot.tokens, self.block_size)
        self._bind(slot, new_id, conversation_id)
        return RouteDecision(new_id, tokens[m:], "fork", tokens,
                             matched_tokens=m, slot=slot,
                             forked_from=src)

    def cancel(self, decision: RouteDecision) -> None:
        """Submission failed after routing (e.g. backpressure): release
        the slot's in-flight mark so the conversation can retry."""
        with self._lock:
            slot = decision.slot
            if slot is not None and slot.session_id == decision.session_id:
                slot.busy = False

    def adopt_conversation(self, decision: RouteDecision,
                           conversation_id: str) -> None:
        """Bind a conversation id minted AFTER routing (the API mints one
        for clients that sent none, so their next round can hit exactly)."""
        with self._lock:
            slot = decision.slot
            if (slot is None or slot.session_id != decision.session_id
                    or slot.conversation_id is not None):
                return
            slot.conversation_id = conversation_id
            self._by_conv[conversation_id] = slot

    # ------------------------------------------------------------ complete
    def complete(self, decision: RouteDecision,
                 generated: List[int]) -> None:
        """Fold a finished round back into the slot: the session's
        stored history is now the full prompt plus all generated tokens
        but the last (the engine keeps the last sampled token as the
        resume feed, so the NEXT round's rendered prompt continues from
        exactly here)."""
        with self._lock:
            slot = decision.slot
            if slot is None or slot.session_id != decision.session_id:
                return             # overflow / already displaced
            hist = np.concatenate(
                [decision.full_tokens,
                 np.asarray(generated[:-1], np.int32)]).astype(np.int32)
            bs = self.block_size
            # the old history is a strict prefix of the new one (exact/
            # restore matched it; fresh started empty; fork copied it),
            # so the chain extends incrementally from its last full page
            prev = len(slot.chain)
            prev_key = slot.chain[-1] if slot.chain else None
            slot.chain = slot.chain + hash_chain(hist[prev * bs:], bs,
                                                 prev=prev_key)
            slot.tokens = hist
            slot.busy = False
            slot.last_used = self._clock
