"""Model facade for the ``lm`` families (the main path of this port):
dense, MoE (granite-moe, grok-1: routed expert FFNs) and VLM (internvl2:
patch embeddings at the head of a prompt, ``batch["patches"]``), all
served by the transformer stack and ``LMAdapter``; for the
attention-free ``ssm`` family (falcon-mamba); for the ``hybrid``
family (zamba2: Mamba2 blocks with an attention block every k); and for
the encoder-decoder family (whisper: ``batch["frames"]`` (B, S_enc, D)
frame embeddings feed the encoder, ``models/encdec.py``).

``Model`` resolves the device and hyper-parameters and delegates compute
to its family adapter (models/adapter.py):

    init(seed)                          -> parameter dict on the device
    prefill(params, batch, ...)         -> logits + K/V or final recurrent
                                           states (+ hidden states)
    decode_step(params, cache, tokens)  -> (logits, cache)
    decode_step_full(...)               -> (logits, cache, hidden states)
    decode_step_paged(...)              -> the same over a paged KV pool
                                           (lm, encdec's self K/V)
    restore_kv_from_hidden(...)         -> the paper's restoration op (lm,
                                           hybrid's attention blocks,
                                           encdec's decoder self K/V)
    restore_ssm_states(...)             -> ssm-rescan (ssm, hybrid)
    init_cache / init_paged_cache       -> zeroed serving caches
    init_cross(batch, enc_seq)          -> zeroed per-slot cross state
                                           (encdec)

It runs on ``cuda`` unless the caller passes ``device="cpu"``; with no
device given and no CUDA device present it raises instead of running on
the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.config.arch import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.adapter import (EncDecAdapter, HybridAdapter,
                                       LMAdapter, SSMAdapter)
from repro_torch.models.encdec import EncDecHyper
from repro_torch.models.hybrid import HybridHyper
from repro_torch.models.ssm import SSMHyper

LM_FAMILIES = ("dense", "moe", "vlm")


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
        self.cfg = cfg
        self.dtype = dtype
        if cfg.is_encoder_decoder:
            self.h = EncDecHyper(cfg=cfg, dtype=dtype)
            self.kind = "encdec"
            self.adapter = EncDecAdapter(self)
        elif cfg.family in LM_FAMILIES:
            self.h = tfm.LMHyper(cfg=cfg, dtype=dtype)
            self.kind = "lm"
            self.adapter = LMAdapter(self)
        elif cfg.family == "ssm":
            self.h = SSMHyper(cfg=cfg, dtype=dtype)
            self.kind = "ssm"
            self.adapter = SSMAdapter(self)
        elif cfg.family == "hybrid":
            self.h = HybridHyper(cfg=cfg, dtype=dtype)
            self.kind = "hybrid"
            self.adapter = HybridAdapter(self)
        else:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet")
        self.device = resolve_device(device)

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

    def restore_ssm_states(self, params, hidden):
        """ssm-rescan: per-layer final states from stacked hidden states."""
        return self.adapter.restore_ssm_states(params, hidden)

    def init_cross(self, batch: int, enc_seq: int) -> dict:
        """Zeroed per-slot cross state of an encdec model: cross_k/cross_v
        (L, batch, enc_seq, Kv, hd) and enc_len (batch,) int32."""
        c = self.cfg
        kv = torch.zeros((c.n_layers, batch, enc_seq, c.n_kv_heads,
                          c.head_dim_), dtype=self.dtype, device=self.device)
        return {"cross_k": kv, "cross_v": torch.zeros_like(kv),
                "enc_len": torch.zeros((batch,), dtype=torch.int32,
                                       device=self.device)}

    def init_cache(self, batch: int, ctx_len: int, *,
                   enc_seq: Optional[int] = None) -> dict:
        """Zeroed contiguous decode cache with lengths (batch,) int32: lm
        k/v (L, batch, ctx_len, Kv, hd); ssm conv (L, batch, W-1, I) in
        the model dtype and ssm (L, batch, I, N) fp32 (no token axis);
        hybrid attn_k/attn_v (n_super, batch, ctx_len, Kv, hd), conv
        (n_super, k-1, batch, W-1, I+2N) in the model dtype and ssm
        (n_super, k-1, batch, H, P, N) fp32; encdec self_k/self_v (L,
        batch, ctx_len, Kv, hd) and ``init_cross(batch, enc_seq)``
        (``enc_seq`` defaults to ctx_len)."""
        c = self.cfg
        lengths = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        if self.kind == "encdec":
            kv = torch.zeros((c.n_layers, batch, ctx_len, c.n_kv_heads,
                              c.head_dim_), dtype=self.dtype,
                             device=self.device)
            return {"self_k": kv, "self_v": torch.zeros_like(kv),
                    **self.init_cross(batch, enc_seq or ctx_len),
                    "lengths": lengths}
        if self.kind == "hybrid":
            h, m = self.h, self.h.mamba
            kv = torch.zeros((h.n_super, batch, ctx_len, c.n_kv_heads,
                              c.head_dim_), dtype=self.dtype,
                             device=self.device)
            lead = (h.n_super, h.k - 1, batch)
            return {"attn_k": kv, "attn_v": torch.zeros_like(kv),
                    "conv": torch.zeros(lead + (m.d_conv - 1,
                                                m.conv_channels),
                                        dtype=self.dtype, device=self.device),
                    "ssm": torch.zeros(lead + (m.n_heads, m.head_dim,
                                               m.d_state),
                                       dtype=torch.float32,
                                       device=self.device),
                    "lengths": lengths}
        if self.kind == "ssm":
            m = self.h.mamba
            return {"conv": torch.zeros((c.n_layers, batch, m.d_conv - 1,
                                         m.d_inner), dtype=self.dtype,
                                        device=self.device),
                    "ssm": torch.zeros((c.n_layers, batch, m.d_inner,
                                        m.d_state), dtype=torch.float32,
                                       device=self.device),
                    "lengths": lengths}
        kv = torch.zeros((c.n_layers, batch, ctx_len, c.n_kv_heads,
                          c.head_dim_), dtype=self.dtype, device=self.device)
        return {"k": kv, "v": torch.zeros_like(kv), "lengths": lengths}

    def init_paged_cache(self, batch: int, num_blocks: int, block_size: int,
                         max_blocks_per_seq: int) -> dict:
        """Zeroed block-table paged decode cache (an encdec model's self
        K/V; its cross state is ``init_cross``): k_pool/v_pool (L,
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
