"""HCacheManager — the paper's system glued together (``lm``, ``ssm``,
``hybrid`` and ``encdec`` families).

  * plan: the per-layer restoration schedule (bubble-free scheduler),
    priced under the paper's Hopper profile by default, or under a
    ``MeasuredProfile`` that the restores feed (``profile=``), and the
    projection group plan of each restore (``resolve_group_size``);
  * save: prefill hidden states (and K/V of ``kv``-method layers) into the
    chunk store, decode hidden states through the two-stage saver, and
    the token stream plus a manifest, which also records the history's
    prefill and decode segments for the recompute replay;
  * restore: rebuild the session's K/V cache from the store through the
    ``RestorationExecutor``.

An attention-free (``ssm``) stack has no per-token state: the planner
gives its layers the ``kv`` method, whose per-layer pieces are skipped,
and the session's whole recurrent state (conv and ssm of every layer) is
stored as two blobs, at prefill and at every pause or retire, and
restored by the graph's ``blob`` task. A ``hybrid`` stack (zamba2) does
both: its attention blocks save and restore per token like an ``lm``
stack's layers, its Mamba2 blocks' states go to the two blobs. A decode
step's hidden stack holds the attention blocks only; the adapter's
``decode_layers`` names the global layer of each of its rows, under which
the rows are filed. An ``encdec`` session (whisper) saves its decoder's
hidden states like an ``lm`` stack's and, at its first prefill, the
encoder output as the "enc" blob (its length in the manifest's
``enc_len``): the restore rebuilds the cross K/V of every decoder layer
from that one tensor.

Stored hidden states and states keep their dtype bit for bit: fp32 as
float32, bf16 as its raw 2-byte words (numpy has no bfloat16), so a
save/restore cycle is lossless at 2 bytes per element on the card
(``store_dtype``).

Hidden codecs: a session's "h" stream is stored as above (``"none"``) or,
with ``compress="int8"`` or after the capacity ladder's
``demote_hidden_int8``, as per-token int8 rows plus an "hs" stream of
fp32 scales (``quantize_hidden_int8``), dequantized on the device at
restore. The codec is per session (``_compress_for``; the manifest's
``"compress"``), and every later append of the session follows it.
``promote_hidden_fp16`` re-encodes an int8 stream at ``store_dtype``;
``degrade_to_recompute`` drops every stream but the tokens, so the
session restores all of its layers by the recompute replay.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch.config.arch import BlockKind
from repro_torch.config.hardware import PAPER_H800, HardwareProfile
from repro_torch.core.cost_model import layer_costs, link_priced_times
from repro_torch.core.pipeline import Timeline
from repro_torch.core.restoration import (CacheAssembler, RestorationExecutor,
                                          RestoreParamPack, RestoreSink,
                                          StagingRing, choose_group_size,
                                          dequantize_hidden_int8,
                                          fetch_aligned_partition,
                                          host_float32,
                                          measured_dispatch_overhead,
                                          quantize_hidden_int8, s_bucket,
                                          to_host)
from repro_torch.core.scheduler import Schedule, solve
from repro_torch.storage.chunk_store import ChunkStore
from repro_torch.storage.two_stage import SnapshotTask, TwoStageSaver


@dataclasses.dataclass
class RestoreResult:
    cache: dict                      # dict(k, v, lengths); for ssm
    #                                  dict(conv, ssm, lengths); for hybrid
    #                                  dict(attn_k, attn_v, conv, ssm,
    #                                  lengths); for encdec dict(self_k,
    #                                  self_v, cross_k, cross_v, enc_len,
    #                                  lengths); B = 1
    schedule: Schedule
    timeline: Timeline               # virtual restoration timing
    wall_time: float                 # seconds, synchronised with the device
    project_wall: float              # device seconds of projection groups
    host_split: dict                 # executor host seconds by part
    n_tokens: int


class HCacheManager:
    def __init__(self, model, store: ChunkStore, *,
                 hw: HardwareProfile = PAPER_H800,
                 saver: Optional[TwoStageSaver] = None, dtype_bytes: int = 2,
                 schedule_override: Optional[str] = None,
                 restore_group_size=8, profile=None, compress: str = "none"):
        self.model = model
        self.cfg = model.cfg
        self.store = store
        self.hw = hw
        self._plans: Dict[tuple, Schedule] = {}
        self._group_plans: Dict[tuple, object] = {}
        # online calibration: a MeasuredProfile the executors fold their
        # observed task times into and every planning call (plan,
        # resolve_group_size, capacity.restore_makespan) prices with;
        # None keeps the static HardwareProfile model
        self.profile = profile
        # projection group plan: a width (1 = per layer), a tuple of
        # widths, "auto" (per restore, the makespan argmin over uniform
        # widths and the fetch-aligned partition) or "fetch" (the
        # fetch-aligned partition)
        if restore_group_size in ("auto", "fetch"):
            self.restore_group_size = restore_group_size
        elif isinstance(restore_group_size, (tuple, list)):
            self.restore_group_size = tuple(
                max(int(w), 1) for w in restore_group_size)
        else:
            self.restore_group_size = max(int(restore_group_size), 1)
        self._pack = None
        self._pack_params = None
        self._ring: Optional[StagingRing] = None
        self._launched: Set[tuple] = set()
        self.saver = saver or TwoStageSaver(store)
        self.dtype_bytes = dtype_bytes
        self.io_streams = 1          # concurrent restores (engine-reported)
        # multi-host store: restore streams per NIC link (a
        # ``cost_model.LinkLoad``, engine-reported); None on one-host
        # stores, where ``io_streams`` is the whole story
        self.link_load = None
        self.schedule_override = schedule_override   # None|hidden|kv|recompute
        # the hidden codec of new sessions ("none" | "int8"), and the
        # per-session codecs the capacity ladder set (synced from the
        # manifest when a session resumes under a fresh manager)
        self.compress = compress
        self._session_compress: Dict[str, str] = {}

    @property
    def store_dtype(self) -> np.dtype:
        """The numpy dtype of stored hidden rows at full fidelity: fp32,
        or bf16's raw 2-byte words."""
        return np.dtype(np.int16 if self.model.dtype == torch.bfloat16
                        else np.float32)

    def _compress_for(self, session: str) -> str:
        return self._session_compress.get(session, self.compress)

    def close(self) -> None:
        """Drain and stop the saver's threads; wait for uploads in flight."""
        self.saver.close()
        if self._ring is not None:
            self._ring.close()

    def param_pack(self, params):
        """Restoration weights for ``params`` (a hybrid stack's attention
        blocks), built once and reused; None for an attention-free
        stack."""
        if self.model.kind == "ssm":
            return None
        if self._pack is None or self._pack_params is not params:
            self._pack = RestoreParamPack(self.model, params)
            self._pack_params = params
        return self._pack

    def staging(self) -> StagingRing:
        """The restores' staging ring and copy stream, made once."""
        if self._ring is None:
            self._ring = StagingRing(self.model.device)
        return self._ring

    def first_launch(self, shape: tuple) -> bool:
        """True the first time a restore launches at ``shape``: that launch
        carries the kernel's build and set-up, so the profiler skips it."""
        if shape in self._launched:
            return False
        self._launched.add(shape)
        return True

    def set_io_streams(self, n: int) -> None:
        """Engine-reported restore multiplicity: how many sessions pull
        the store at once; plans are memoized per multiplicity."""
        self.io_streams = max(int(n), 1)

    def set_link_load(self, load) -> None:
        """Engine-reported restore streams per NIC link (multi-host
        store); plans are memoized per load (``_price_key``)."""
        self.link_load = load

    def set_profile(self, profile) -> None:
        """Attach (or detach) a MeasuredProfile; memoized plans priced
        under the old one are flushed."""
        if profile is not self.profile:
            self.profile = profile
            self.invalidate_plans()

    def invalidate_plans(self) -> None:
        """Flush every memoized schedule and group plan (after a change
        of ``hw``). Profile drift and multiplicity need no flush: both
        are part of the cache keys (``_price_key``)."""
        self._plans.clear()
        self._group_plans.clear()

    def _price_key(self) -> tuple:
        """The calibration state a plan was priced under: the profile's
        epoch (it bumps when a fit drifts), the IO multiplicity and the
        per-link load."""
        epoch = self.profile.epoch if self.profile is not None else -1
        load = self.link_load.key() if self.link_load is not None else None
        return (epoch, self.io_streams, load)

    # ------------------------------------------------------------- planning
    def plan(self, n_tokens: int) -> Schedule:
        """Bucketed bubble-free schedule (power-of-two token buckets),
        priced under the measured profile and the IO multiplicity (part of
        the memoization key)."""
        if self.schedule_override:
            methods = (self.schedule_override,) * self.cfg.n_layers
            return Schedule(methods, 0.0, 0.0, 0.0, 0.0)
        bucket = 1 << max(int(np.ceil(np.log2(max(n_tokens, 128)))), 7)
        key = (bucket, self._price_key())
        if key not in self._plans:
            self._plans[key] = solve(
                self.cfg, bucket, self.hw, dtype_bytes=self.dtype_bytes,
                allow_recompute=self.model.adapter.supports_recompute,
                profile=self.profile, io_streams=self.io_streams,
                topology=self.store.shard_topology(), link_load=self.link_load)
        return self._plans[key]

    def resolve_group_size(self, n_tokens: int, methods, *,
                           enc_len: int = 0):
        """The projection group plan of one restore: the fixed width or
        tuple, or under ``"auto"``/``"fetch"`` the plan priced at the
        restore's S-bucket (``choose_group_size``, with an enc-dec
        session's cross pair at the bucket of its ``enc_len``, or the
        forced fetch-aligned partition). Returns an int width or a tuple
        of widths, memoized per (S-bucket, methods, enc-bucket,
        ``_price_key``): a profile-epoch bump or a multiplicity change
        re-plans, a converged profile reuses. The one resolution point
        for the executor and ``capacity.restore_makespan``."""
        if self.restore_group_size not in ("auto", "fetch"):
            return self.restore_group_size
        adapter = self.model.adapter
        cross = adapter.has_cross and enc_len > 0
        key = (s_bucket(max(int(n_tokens), 1)), tuple(methods),
               s_bucket(enc_len) if cross else 0, self._price_key())
        got = self._group_plans.get(key)
        if got is None:
            if self.restore_group_size == "fetch":
                got = self._fetch_partition(n_tokens, methods)
            else:
                got = choose_group_size(
                    self.cfg, self.hw, n_tokens, methods,
                    dtype_bytes=self.dtype_bytes,
                    n_blobs=adapter.n_state_blobs,
                    cross=adapter.has_cross, enc_len=enc_len,
                    profile=self.profile, io_streams=self.io_streams,
                    topology=self.store.shard_topology(),
                    link_load=self.link_load, fetch_aligned=True)
            self._group_plans[key] = got
        return got

    def _fetch_partition(self, n_tokens: int, methods):
        """The forced fetch-aligned partition, priced at the S-bucket
        under the current profile and multiplicity; an all-equal
        partition collapses to its uniform width."""
        bucket = s_bucket(max(int(n_tokens), 1))
        times, layer_links = link_priced_times(
            layer_costs(self.cfg, bucket, self.dtype_bytes), self.hw,
            profile=self.profile, io_streams=self.io_streams,
            topology=self.store.shard_topology(), link_load=self.link_load)
        part = fetch_aligned_partition(
            methods, times,
            dispatch_overhead=measured_dispatch_overhead(self.hw,
                                                         self.profile),
            links=layer_links)
        if not part:
            return 1
        return part[0] if len(set(part)) == 1 else part

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
            # a resumed session keeps its stored methods and codec:
            # re-planning could flip a layer across a bucket boundary and
            # leave a hole, and a capacity demotion must hold
            methods = list(prev["methods"])
            comp = prev.get("compress", self.compress)
            if comp != self.compress:
                self._session_compress[session] = comp
        else:
            methods = list(self.plan(start + toks.shape[0]).methods)
        self.store.put_blob(session, "tok", 0, toks if start == 0 else
                            np.concatenate([self._tokens(session)[:start],
                                            toks]))
        self._save_patches(session, prefill_out.get("patches"), start)
        kinds = self.cfg.block_kinds()
        for li, method in enumerate(methods):
            if kinds[li] != BlockKind.ATTENTION:
                continue        # recurrent layers: the state blobs below
            if method == "hidden":
                self._append_hidden(session, li, start,
                                    adapter.prefill_hidden(prefill_out, li))
            elif method == "kv":
                k, v = adapter.prefill_kv(prefill_out, li)
                self.store.append_tokens(session, "kvk", li, start,
                                         to_host(k.reshape(k.shape[0], -1)))
                self.store.append_tokens(session, "kvv", li, start,
                                         to_host(v.reshape(v.shape[0], -1)))
        states = prefill_out.get("states") or prefill_out.get("mamba_states")
        if states is not None:
            self._save_states(session, *states)
        # the history as it was computed, for the recompute replay
        segments = (list(prev.get("segments", [[0, start, "prefill"]]))
                    if prev else [])
        segments.append([start, int(toks.shape[0]), "prefill"])
        manifest = {"n_tokens": int(start + toks.shape[0]),
                    "methods": methods, "segments": segments,
                    "arch": self.cfg.name,
                    "compress": self._compress_for(session)}
        if adapter.has_cross:
            if "enc_out" in prefill_out:
                # the encoder output, bit for bit: one (S_enc, D) tensor
                # from which the restore projects every layer's cross K/V
                enc = prefill_out["enc_out"][0]
                self.store.put_blob(session, "enc", 0, to_host(enc))
                manifest["enc_len"] = int(enc.shape[0])
            elif prev:
                # a resume prefill runs no encoder: keep the stored length
                manifest["enc_len"] = int(prev.get("enc_len", 0))
        self.store.flush(session)
        self.store.put_manifest(session, manifest)

    def _save_patches(self, session: str, patches, start: int) -> None:
        """A VLM prefill's patch embeddings (1, n_vis, D) as the session's
        "patches" blob, which the recompute replay splices back in (the
        reference keeps only the tokens, so its recompute layers see token
        embeddings there). Patches enter at start 0 only; a fresh
        text-only session drops a stale blob of its id."""
        if patches is None:
            if start == 0 and self.store.has_blob(session, "patches", 0):
                self.store.drop_stream(session, "patches")
            return
        if start:
            raise ValueError(f"{session}: patch embeddings enter a "
                             f"session's first prefill only, not at {start}")
        self.store.put_blob(session, "patches", 0, to_host(patches[0]))

    def _append_hidden(self, session: str, layer: int, start: int,
                       h: torch.Tensor) -> None:
        """One layer's prefill hidden rows (n, D) in the session's codec."""
        if self._compress_for(session) == "int8":
            q, scale = quantize_hidden_int8(
                h.detach().float().cpu().numpy())
            self.store.append_tokens(session, "h", layer, start, q)
            self.store.append_tokens(session, "hs", layer, start, scale)
        else:
            self.store.append_tokens(session, "h", layer, start, to_host(h))

    def _store_rows(self, h: np.ndarray) -> np.ndarray:
        """fp32 rows as full-fidelity stored rows (``store_dtype``)."""
        return to_host(torch.from_numpy(np.ascontiguousarray(
            h, np.float32)).to(self.model.dtype))

    def save_decode_hidden(self, session_ids: Sequence[Optional[str]],
                           hidden: torch.Tensor, lengths) -> float:
        """Two-stage save of one decode step's hidden states: one
        layer-stacked (R, B, 1, D) snapshot; the saver's daemon splits it
        per (layer, sequence), row r going to the adapter's
        ``decode_layers(R)[r]`` (a hybrid stack's rows are its attention
        blocks, global layers k-1, 2k-1, ...). ``lengths`` (B,) are the new
        tokens' positions. Returns the virtual stage-1 cost in seconds.

        The rows of sessions in the int8 codec are quantized on the host
        after the copy (per token, so a row at a time gives the bulk
        codec's bits) and go to "h" and "hs" in snapshots of their own."""
        layers = list(self.model.adapter.decode_layers(hidden.shape[0]))
        starts = [int(x) for x in np.asarray(lengths)]
        ids = list(session_ids)
        h = to_host(hidden)
        int8_rows = [b for b, s in enumerate(ids)
                     if s is not None and self._compress_for(s) == "int8"]
        if not int8_rows:
            return self.saver.snapshot(SnapshotTask(
                session_ids=ids, stream="h", layer=-1, start_tokens=starts,
                data=h, layers=layers))
        cost = 0.0
        plain = [b for b in range(len(ids)) if b not in int8_rows]
        if plain:
            cost += self.saver.snapshot(SnapshotTask(
                session_ids=[ids[b] for b in plain], stream="h", layer=-1,
                start_tokens=[starts[b] for b in plain], data=h[:, plain],
                layers=layers))
        for b in int8_rows:
            q, scale = quantize_hidden_int8(
                host_float32(h[:, b:b + 1], self.model.dtype))
            cost += self.saver.snapshot(SnapshotTask(
                [ids[b]], "h", -1, [starts[b]], q, layers=layers))
            cost += self.saver.snapshot(SnapshotTask(
                [ids[b]], "hs", -1, [starts[b]], scale, layers=layers))
        return cost

    def save_session_pause(self, session: str, cache: dict, n_tokens: int,
                           *, tokens_tail, batch_width: int = 1,
                           batch_row: int = 0) -> None:
        """After decoding: drain the saver, append the decoded tokens and
        the K/V of ``kv``-method layers from the live cache (row 0), dump
        the recurrent states of an ``ssm`` or ``hybrid`` cache whole, and
        mark the store restorable at ``n_tokens``. The decode segment is
        recorded with the batch it ran in (``batch_width`` rows, the
        session at ``batch_row``) when that is wider than one, so the
        recompute replay runs the same shapes."""
        self.saver.drain()
        manifest = self.store.get_manifest(session)
        if manifest is None:
            raise KeyError(f"no stored state for session {session!r}")
        prev_n = int(manifest["n_tokens"])
        tail = np.asarray(tokens_tail).reshape(-1)
        old = self._tokens(session)[:prev_n]
        self.store.put_blob(session, "tok", 0, np.concatenate(
            [old, tail.astype(old.dtype)]))
        adapter = self.model.adapter
        kinds = self.cfg.block_kinds()
        for li, method in enumerate(manifest["methods"]):
            if (method != "kv" or kinds[li] != BlockKind.ATTENTION
                    or n_tokens <= prev_n):   # no new tokens: no K/V tail
                continue
            for stream, name in zip(("kvk", "kvv"), adapter.kv_names):
                x = cache[name][adapter.kv_row(li)][0, prev_n:n_tokens]
                self.store.append_tokens(session, stream, li, prev_n,
                                         to_host(x.reshape(x.shape[0], -1)))
        if "ssm" in cache:
            self._save_states(session, cache["conv"], cache["ssm"])
        self.store.flush(session)
        if n_tokens > prev_n:
            seg = [prev_n, int(n_tokens) - prev_n, "decode"]
            if batch_width > 1:
                seg += [int(batch_width), int(batch_row)]
            manifest.setdefault("segments", [[0, prev_n, "prefill"]]).append(
                seg)
        manifest["n_tokens"] = int(n_tokens)
        self.store.put_manifest(session, manifest)

    def _save_states(self, session: str, conv: torch.Tensor,
                     ssm: torch.Tensor) -> None:
        """The recurrent states of every recurrent layer as two whole
        blobs: ssm (L, 1, W-1, I) and (L, 1, I, N); hybrid (n_super, k-1,
        1, W-1, C) and (n_super, k-1, 1, H, P, N)."""
        self.store.put_blob(session, "state_conv", 0, to_host(conv))
        self.store.put_blob(session, "state_ssm", 0, to_host(ssm))

    # -------------------------------------------------------------- restore
    def _tokens(self, session: str) -> np.ndarray:
        return np.asarray(self.store.get_blob(session, "tok", 0))

    def begin_restore(self, params, session: str,
                      sink: Optional[RestoreSink] = None,
                      start_token: int = 0) -> RestorationExecutor:
        """An executor that restores ``session`` into ``sink`` (attached
        later when None). ``start_token > 0`` restores only the tokens from
        there on, for a slot that already holds [0, start_token)."""
        return RestorationExecutor(self, params, session, sink=sink,
                                   start_token=start_token)

    def fork_session(self, src: str, dst: str, *, share: bool = True)\
            -> dict:
        """Clone ``src``'s stored state under ``dst``: ``share=True``
        aliases its chunks and blobs in the store (the bytes exist once
        until a side diverges), ``share=False`` copies them. Returns the
        cloned manifest."""
        self.saver.drain()
        man = self.store.get_manifest(src)
        if man is None:
            raise KeyError(f"cannot fork {src!r}: no stored state")
        if self.store.get_manifest(dst) is not None:
            raise ValueError(f"fork target {dst!r} already has state")
        self.store.share_session(src, dst, copy=not share)
        self.store.put_manifest(dst, dict(man))
        if src in self._session_compress:
            self._session_compress[dst] = self._session_compress[src]
        return dict(man)

    def restore(self, params, session: str, *,
                capacity: Optional[int] = None) -> RestoreResult:
        """Rebuild the session's cache (B = 1) from the store: K/V in a
        buffer of at least ``capacity`` positions, and a recurrent
        session's states."""
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
                             ex.project_wall, dict(ex.host_split),
                             ex.n_tokens)

    # ---------------------------------------------------- capacity demotion
    def _hidden_layers(self, man: dict, session: str, n: int,
                       streams=("h",)) -> List[int]:
        kinds = self.cfg.block_kinds()
        return [li for li, m in enumerate(man["methods"])
                if m == "hidden" and kinds[li] == BlockKind.ATTENTION
                and all(self.store.layer_available(session, st, li, n)
                        for st in streams)]

    def demote_hidden_int8(self, session: str) -> bool:
        """Re-encode a session's stored hidden rows to the int8 codec
        (about half the "h" bytes). Later appends of the session follow
        the codec, and restores dequantize. False when not applicable.
        Like the other ladder stages it does not drain the saver: it may
        run on a saver thread, and the ladder touches only sessions with
        no rows in flight (``CapacityManager._protected``)."""
        man = self.store.get_manifest(session)
        if not man or man.get("compress", "none") == "int8":
            return False
        n = int(man.get("n_tokens", 0))
        layers = self._hidden_layers(man, session, n)
        if n == 0 or not layers:
            return False
        # the re-encode is appended hot: a cold-demoted stream goes back
        # to the cold tier afterwards, or this stage would grow the
        # budgeted bytes
        was_cold = self.store.stream_in_cold(session, "h")
        data = {li: host_float32(self.store.read_layer(session, "h", li, n),
                                 self.model.dtype) for li in layers}
        self.store.drop_stream(session, "h")
        self.store.drop_stream(session, "hs")
        for li, h in data.items():
            q, scale = quantize_hidden_int8(h)
            self.store.append_tokens(session, "h", li, 0, q)
            self.store.append_tokens(session, "hs", li, 0, scale)
        self.store.flush(session)
        if was_cold:
            self.store.demote_stream_to_cold(session, "h")
            self.store.demote_stream_to_cold(session, "hs")
        man["compress"] = "int8"
        self.store.put_manifest(session, man)
        if was_cold:
            # put_manifest writes the manifest hot; a cold session's
            # metadata follows its chunks
            self.store.demote_stream_to_cold(session, "meta")
        self._session_compress[session] = "int8"
        return True

    def promote_hidden_fp16(self, session: str) -> bool:
        """Inverse of ``demote_hidden_int8``: re-encode the int8 rows at
        ``store_dtype`` and drop the scales, so later appends and restores
        run at full fidelity again (the rows already quantized keep their
        error). False when not applicable."""
        man = self.store.get_manifest(session)
        if not man or man.get("compress", "none") != "int8":
            return False
        n = int(man.get("n_tokens", 0))
        layers = self._hidden_layers(man, session, n, ("h", "hs"))
        if n == 0 or not layers:
            return False
        data = {li: self._store_rows(dequantize_hidden_int8(
            self.store.read_layer(session, "h", li, n),
            self.store.read_layer(session, "hs", li, n))) for li in layers}
        self.store.drop_stream(session, "h")
        self.store.drop_stream(session, "hs")
        for li, h in data.items():
            self.store.append_tokens(session, "h", li, 0, h)
        self.store.flush(session)
        man["compress"] = "none"
        self.store.put_manifest(session, man)
        self._session_compress[session] = "none"
        return True

    def degrade_to_recompute(self, session: str) -> bool:
        """Drop a session's hidden and K/V streams, keeping the tokens and
        the manifest (with its segments): every layer then restores by
        the recompute replay. False for families without recompute."""
        if not self.model.adapter.supports_recompute:
            return False
        man = self.store.get_manifest(session)
        if not man or all(m == "recompute" for m in man["methods"]):
            return False
        if not self.store.has_blob(session, "tok", 0):
            return False
        if self._tokens(session).shape[0] < int(man.get("n_tokens", 0)):
            return False
        for stream in ("h", "hs", "kvk", "kvv"):
            self.store.drop_stream(session, stream)
        man["methods"] = ["recompute"] * len(man["methods"])
        man["compress"] = "none"
        self._session_compress.pop(session, None)
        self.store.put_manifest(session, man)
        return True

    # -------------------------------------------------------------- eviction
    def evict(self, session: str, *, drain: bool = True) -> None:
        """Drop everything stored for ``session``, after the saver's rows
        in flight (``drain=False`` on a saver thread, where the capacity
        ladder may run: it drops only sessions with no rows in flight)."""
        if drain:
            self.saver.drain()
        self._session_compress.pop(session, None)
        self.store.drop_session(session)

    def sessions(self) -> List[str]:
        return self.store.sessions()
