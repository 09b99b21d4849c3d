"""Model facade for the ``lm`` family (the main path of this port).

``Model`` resolves the device and hyper-parameters and delegates compute
to its ``LMAdapter`` (models/adapter.py):

    init(seed)                          -> parameter dict on the device
    prefill(params, batch, ...)         -> logits + K/V (+ hidden states)
    decode_step(params, cache, tokens)  -> (logits, cache)
    decode_step_full(...)               -> (logits, cache, hidden states)
    decode_step_paged(...)              -> the same over a paged KV pool
    restore_kv_from_hidden(...)         -> the paper's restoration op
    init_cache / init_paged_cache       -> zeroed serving caches

It runs on ``cuda`` unless the caller passes ``device="cpu"``; with no
device given and no CUDA device present it raises instead of running on
the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.config.arch import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.adapter import LMAdapter

LM_FAMILIES = ("dense",)


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``device`` as given, else ``cuda``; raises when no CUDA device is
    present and none was asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "on the CPU")
    return torch.device("cuda")


class Model:
    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None):
        if cfg.family not in LM_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet")
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.h = tfm.LMHyper(cfg=cfg, dtype=dtype)
        self.kind = "lm"
        self.adapter = LMAdapter(self)

    def init(self, seed: int = 0) -> dict:
        """Random parameters from a ``torch.Generator`` on the model's
        device, seeded with ``seed``."""
        return self.adapter.init(
            torch.Generator(device=self.device).manual_seed(seed))

    def prefill(self, params, batch, *, capture_hidden=False, hist_kv=None,
                hist_len=None):
        return self.adapter.prefill(params, batch,
                                    capture_hidden=capture_hidden,
                                    hist_kv=hist_kv, hist_len=hist_len)

    def decode_step(self, params, cache, tokens):
        lg, cache, _ = self.decode_step_full(params, cache, tokens)
        return lg, cache

    def decode_step_full(self, params, cache, tokens):
        """(logits, cache, per-layer hidden states) — HCache save path."""
        return self.adapter.decode_step_full(params, cache, tokens)

    def decode_step_paged(self, params, cache, tokens):
        """(logits, cache, hidden states) over a paged KV pool; the cache
        carries the step's write addresses (``transformer.
        lm_decode_step_paged``)."""
        return self.adapter.decode_step_paged(params, cache, tokens)

    def restore_kv_from_hidden(self, params, hidden, *, positions):
        """The paper's restoration op over stacked hidden states."""
        return self.adapter.restore_kv_from_hidden(params, hidden,
                                                   positions=positions)

    def init_cache(self, batch: int, ctx_len: int) -> dict:
        """Zeroed contiguous decode cache: k/v (L, batch, ctx_len, Kv, hd),
        lengths (batch,) int32."""
        c = self.cfg
        kv = torch.zeros((c.n_layers, batch, ctx_len, c.n_kv_heads,
                          c.head_dim_), dtype=self.dtype, device=self.device)
        return {"k": kv, "v": torch.zeros_like(kv),
                "lengths": torch.zeros((batch,), dtype=torch.int32,
                                       device=self.device)}

    def init_paged_cache(self, batch: int, num_blocks: int, block_size: int,
                         max_blocks_per_seq: int) -> dict:
        """Zeroed block-table paged decode cache: k_pool/v_pool (L,
        num_blocks, block_size, Kv, hd) physical pages; block_table (batch,
        max_blocks_per_seq) int32 with ``num_blocks`` as the unallocated
        sentinel; lengths (batch,) int32."""
        if not self.adapter.supports_paged:
            raise NotImplementedError(
                f"paged KV cache requires an lm-family model; "
                f"{self.cfg.name} is {self.kind!r}")
        c = self.cfg
        kv = torch.zeros((c.n_layers, num_blocks, block_size, c.n_kv_heads,
                          c.head_dim_), dtype=self.dtype, device=self.device)
        return {"k_pool": kv, "v_pool": torch.zeros_like(kv),
                "block_table": torch.full(
                    (batch, max_blocks_per_seq), num_blocks,
                    dtype=torch.int32, device=self.device),
                "lengths": torch.zeros((batch,), dtype=torch.int32,
                                       device=self.device)}
