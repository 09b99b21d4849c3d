"""HCacheManager — the paper's system glued together (``lm`` family).

  * plan: the per-layer restoration schedule (bubble-free scheduler),
    priced under the paper's Hopper profile by default;
  * save: prefill hidden states (and K/V of ``kv``-method layers) into the
    chunk store, decode hidden states through the two-stage saver, and
    the token stream plus a manifest, which also records the history's
    prefill and decode segments for the recompute replay;
  * restore: rebuild the session's K/V cache from the store through the
    ``RestorationExecutor``.

Stored hidden states keep the model's dtype bit for bit: fp32 as float32,
bf16 as its raw 2-byte words (numpy has no bfloat16), so a save/restore
cycle is lossless at 2 bytes per element on the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config.hardware import PAPER_H800, HardwareProfile
from repro_torch.core.pipeline import Timeline
from repro_torch.core.restoration import (CacheAssembler, RestorationExecutor,
                                          RestoreParamPack, RestoreSink,
                                          to_host)
from repro_torch.core.scheduler import Schedule, solve
from repro_torch.storage.chunk_store import ChunkStore
from repro_torch.storage.two_stage import SnapshotTask, TwoStageSaver


@dataclasses.dataclass
class RestoreResult:
    cache: dict                      # dict(k, v, lengths), B = 1
    schedule: Schedule
    timeline: Timeline               # virtual restoration timing
    wall_time: float                 # seconds, synchronised with the device
    project_wall: float              # of which in projection groups
    n_tokens: int


class HCacheManager:
    def __init__(self, model, store: ChunkStore, *,
                 hw: HardwareProfile = PAPER_H800,
                 saver: Optional[TwoStageSaver] = None, dtype_bytes: int = 2,
                 schedule_override: Optional[str] = None,
                 restore_group_size: int = 8):
        self.model = model
        self.cfg = model.cfg
        self.store = store
        self.hw = hw
        self._plans = {}
        self.restore_group_size = max(int(restore_group_size), 1)
        self._pack = None
        self._pack_params = None
        self.saver = saver or TwoStageSaver(store)
        self.dtype_bytes = dtype_bytes
        self.schedule_override = schedule_override   # None|hidden|kv|recompute

    def close(self) -> None:
        """Drain and stop the saver's threads."""
        self.saver.close()

    def param_pack(self, params):
        """Restoration weights for ``params``, built once and reused."""
        if self._pack is None or self._pack_params is not params:
            self._pack = RestoreParamPack(self.model, params)
            self._pack_params = params
        return self._pack

    # ------------------------------------------------------------- planning
    def plan(self, n_tokens: int) -> Schedule:
        """Bucketed bubble-free schedule (power-of-two token buckets)."""
        if self.schedule_override:
            methods = (self.schedule_override,) * self.cfg.n_layers
            return Schedule(methods, 0.0, 0.0, 0.0, 0.0)
        bucket = 1 << max(int(np.ceil(np.log2(max(n_tokens, 128)))), 7)
        if bucket not in self._plans:
            self._plans[bucket] = solve(
                self.cfg, bucket, self.hw, dtype_bytes=self.dtype_bytes,
                allow_recompute=self.model.adapter.supports_recompute,
                topology=self.store.shard_topology())
        return self._plans[bucket]

    # ----------------------------------------------------------------- save
    def save_prefill(self, session: str, tokens, prefill_out: dict, *,
                     start: int = 0) -> None:
        """Persist one sequence's prefill (B must be 1 in ``prefill_out``).
        ``start > 0`` appends to a stored session under its stored
        per-layer methods."""
        adapter = self.model.adapter
        toks = np.asarray(tokens).reshape(-1)
        prev = self.store.get_manifest(session) if start > 0 else None
        if prev and prev.get("methods"):
            # a resumed session keeps its stored methods: re-planning could
            # flip a layer across a bucket boundary and leave a hole
            methods = list(prev["methods"])
        else:
            methods = list(self.plan(start + toks.shape[0]).methods)
        self.store.put_blob(session, "tok", 0, toks if start == 0 else
                            np.concatenate([self._tokens(session)[:start],
                                            toks]))
        for li, method in enumerate(methods):
            if method == "hidden":
                self.store.append_tokens(
                    session, "h", li, start,
                    to_host(adapter.prefill_hidden(prefill_out, li)))
            elif method == "kv":
                k, v = adapter.prefill_kv(prefill_out, li)
                self.store.append_tokens(session, "kvk", li, start,
                                         to_host(k.reshape(k.shape[0], -1)))
                self.store.append_tokens(session, "kvv", li, start,
                                         to_host(v.reshape(v.shape[0], -1)))
        # the history as it was computed, for the recompute replay
        segments = (list(prev.get("segments", [[0, start, "prefill"]]))
                    if prev else [])
        segments.append([start, int(toks.shape[0]), "prefill"])
        self.store.flush(session)
        self.store.put_manifest(session, {
            "n_tokens": int(start + toks.shape[0]), "methods": methods,
            "segments": segments, "arch": self.cfg.name})

    def save_decode_hidden(self, session_ids: Sequence[Optional[str]],
                           hidden: torch.Tensor, lengths) -> float:
        """Two-stage save of one decode step's hidden states: one
        layer-stacked (L, B, 1, D) snapshot; the saver's daemon splits it
        per (layer, sequence). ``lengths`` (B,) are the new tokens'
        positions. Returns the virtual stage-1 cost in seconds."""
        L = hidden.shape[0]
        return self.saver.snapshot(SnapshotTask(
            session_ids=list(session_ids), stream="h", layer=-1,
            start_tokens=[int(x) for x in np.asarray(lengths)],
            data=to_host(hidden), layers=list(range(L))))

    def save_session_pause(self, session: str, cache: dict, n_tokens: int,
                           *, tokens_tail) -> None:
        """After decoding: drain the saver, append the decoded tokens and
        the K/V of ``kv``-method layers from the live cache (row 0), and
        mark the store restorable at ``n_tokens``."""
        self.saver.drain()
        manifest = self.store.get_manifest(session)
        if manifest is None:
            raise KeyError(f"no stored state for session {session!r}")
        prev_n = int(manifest["n_tokens"])
        tail = np.asarray(tokens_tail).reshape(-1)
        self.store.put_blob(session, "tok", 0, np.concatenate(
            [self._tokens(session)[:prev_n], tail.astype(np.int64)]))
        for li, method in enumerate(manifest["methods"]):
            if method != "kv":
                continue
            for stream, name in (("kvk", "k"), ("kvv", "v")):
                x = cache[name][li][0, prev_n:n_tokens]
                self.store.append_tokens(session, stream, li, prev_n,
                                         to_host(x.reshape(x.shape[0], -1)))
        self.store.flush(session)
        if n_tokens > prev_n:
            manifest.setdefault("segments", [[0, prev_n, "prefill"]]).append(
                [prev_n, int(n_tokens) - prev_n, "decode"])
        manifest["n_tokens"] = int(n_tokens)
        self.store.put_manifest(session, manifest)

    # -------------------------------------------------------------- restore
    def _tokens(self, session: str) -> np.ndarray:
        return np.asarray(self.store.get_blob(session, "tok", 0))

    def begin_restore(self, params, session: str,
                      sink: RestoreSink) -> RestorationExecutor:
        """An executor that restores ``session`` into ``sink``."""
        return RestorationExecutor(self, params, session, sink=sink)

    def restore(self, params, session: str, *,
                capacity: Optional[int] = None) -> RestoreResult:
        """Rebuild the session's K/V cache (B = 1) from the store, in a
        buffer of at least ``capacity`` positions."""
        self.saver.drain()
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        t0 = time.perf_counter()
        sink = CacheAssembler(self.model, capacity)
        ex = self.begin_restore(params, session, sink)
        ex.run()
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        wall = time.perf_counter() - t0
        return RestoreResult(sink.cache, ex.schedule, ex.timeline(), wall,
                             ex.project_wall, ex.n_tokens)

    # -------------------------------------------------------------- eviction
    def evict(self, session: str) -> None:
        """Drop everything stored for ``session``."""
        self.saver.drain()
        self.store.drop_session(session)

    def sessions(self) -> List[str]:
        return self.store.sessions()
