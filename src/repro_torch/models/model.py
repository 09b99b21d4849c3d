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
    forward(params, batch, skip_logits) -> the training forward (every
                                           family: final hidden states or
                                           logits, and the MoE aux)
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
    *_spec / *_sharding                 -> the mesh programs' inputs as
                                           meta tensors and their logical
                                           layouts under ``ShardingRules``
                                           (``launch/dryrun.py``,
                                           ``distributed/mesh_serving.py``)

It runs on ``cuda`` unless the caller passes ``device="cpu"``; with no
device given and no CUDA device present it raises instead of running on
the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.config.shapes import InputShape

from repro_torch.config.arch import ArchConfig
from repro_torch.distributed.sharding import pad_heads
from repro_torch.models import transformer as tfm
from repro_torch.models.adapter import (EncDecAdapter, HybridAdapter,
                                       LMAdapter, SSMAdapter)
from repro_torch.models.encdec import EncDecHyper
from repro_torch.models.hybrid import HybridHyper
from repro_torch.models.layers.attention import live_q_columns
from repro_torch.models.module import param_axes
from repro_torch.models.ssm import SSMHyper

LM_FAMILIES = ("dense", "moe", "vlm")
DEC_PROMPT = 128      # whisper decoder prompt length in prefill cells
DEC_TRAIN = 448       # whisper decoder target length in train cells
DEC_BUF = 1024        # whisper decoder self-K/V buffer of decode cells
N_VIS = 256           # internvl2 patch positions


def _meta(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` that holds no data (the JAX
    package's ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


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
    """``model_axis``: the width of the mesh's model axis the parameters
    are laid out for: an ``lm`` stack pads its query heads to a multiple
    of it (``distributed.sharding.pad_heads``; the padded slices of wq,
    bq and wo are zero and stay zero through training). A family whose
    heads would need padding for other stacks is refused."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None,
                 model_axis: int = 1):
        self.cfg = cfg
        self.dtype = dtype
        self.model_axis = int(model_axis)
        if cfg.family not in LM_FAMILIES and cfg.n_heads and pad_heads(
                cfg.n_heads, cfg.n_kv_heads, self.model_axis)[0] \
                != cfg.n_heads:
            raise ValueError(
                f"{cfg.name}: padding its {cfg.n_heads} heads for a model "
                f"axis of {self.model_axis} is ported for the lm families "
                "only (ROADMAP.md, queue 1)")
        if cfg.is_encoder_decoder:
            self.h = EncDecHyper(cfg=cfg, dtype=dtype)
            self.kind = "encdec"
            self.adapter = EncDecAdapter(self)
        elif cfg.family in LM_FAMILIES:
            self.h = tfm.LMHyper(cfg=cfg, dtype=dtype,
                                 model_axis=self.model_axis)
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
        device, seeded with ``seed``; on ``meta`` (the dry-run's
        placeholder devices) leaves that hold no data, as ``param_axes``
        builds them."""
        if self.device.type == "meta":
            return self.adapter.init(torch.Generator(), self.device)
        return self.adapter.init(
            torch.Generator(device=self.device).manual_seed(seed))

    def param_axes(self) -> dict:
        """The logical axes of every parameter leaf (the JAX package's
        ``split(model.init(...))[1]``), from an init on the meta device."""
        return param_axes(self.adapter.init(torch.Generator(),
                                            torch.device("meta")))

    def head_pad_masks(self) -> dict:
        """{leaf path: bool mask broadcastable to the leaf} of the live
        query columns of an lm stack's wq, bq (the last dimension) and wo
        (its rows); empty when no head is padded."""
        if self.kind != "lm" or not self.h.attn.padded_heads:
            return {}
        live = live_q_columns(self.h.attn).to(self.device)
        out = {"['blocks']['attn']['wq']": live[None, None, :],
               "['blocks']['attn']['wo']": live[None, :, None]}
        if self.cfg.qkv_bias:
            out["['blocks']['attn']['bq']"] = live[None, :]
        return out

    def forward(self, params, batch, *, skip_logits: bool = False) -> dict:
        """Training forward over ``batch["tokens"]`` (B,S), with
        ``batch["patches"]`` (B, n_vis, D) for a VLM and
        ``batch["frames"]`` (B, S_enc, D) for an encoder-decoder:
        dict(logits (B,S,V), aux), or dict(final_x (B,S,D), aux) with
        ``skip_logits`` (the chunked loss computes the logits). aux is the
        MoE layers' summed load-balance aux (a tensor), 0.0 for the other
        families."""
        return self.adapter.forward(params, batch, skip_logits=skip_logits)

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

    # ================================== the mesh programs' input specs
    def _tok(self, b: int, s: int) -> torch.Tensor:
        return _meta((b, s), torch.int32)

    def train_batch_spec(self, shape: InputShape) -> dict:
        c = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if self.kind == "encdec":
            return {"frames": _meta((B, S, c.d_model), self.dtype),
                    "tokens": self._tok(B, DEC_TRAIN),
                    "targets": self._tok(B, DEC_TRAIN)}
        batch = {"tokens": self._tok(B, S), "targets": self._tok(B, S)}
        if c.family == "vlm":
            batch["patches"] = _meta((B, N_VIS, c.d_model), self.dtype)
        return batch

    def train_batch_sharding(self, rules) -> dict:
        """The specs of ``train_batch_spec``'s leaves under ``rules``
        (``distributed.sharding.ShardingRules``); ``training/sharded.py``
        splits its batch by them."""
        r = rules
        out = {"tokens": r.spec(("batch", "seq")),
               "targets": r.spec(("batch", "seq"))}
        if self.kind == "encdec":
            out["frames"] = r.spec(("batch", "seq", "d_model"))
            out["targets"] = r.spec(("batch", None))
            out["tokens"] = r.spec(("batch", None))
        if self.cfg.family == "vlm":
            out["patches"] = r.spec(("batch", None, "d_model"))
        return out

    def prefill_batch_spec(self, shape: InputShape) -> dict:
        """A prefill cell's batch: an enc-dec model's frames (B, S, D) and
        its DEC_PROMPT-token decoder prompt, else the train batch's
        tokens (and patches)."""
        if self.kind == "encdec":
            B, S = shape.global_batch, shape.seq_len
            return {"frames": _meta((B, S, self.cfg.d_model), self.dtype),
                    "tokens": self._tok(B, DEC_PROMPT)}
        batch = self.train_batch_spec(shape)
        batch.pop("targets")
        return batch

    def prefill_batch_sharding(self, rules) -> dict:
        """``distributed/mesh_serving.py`` places its batch by these."""
        out = self.train_batch_sharding(rules)
        out.pop("targets")
        return out

    def cache_spec(self, batch: int, ctx_len: int) -> dict:
        """A decode cell's cache (a fully populated context) as meta
        tensors, in the JAX package's layout: an enc-dec model's
        ``ctx_len`` is the cross (encoder) side, its self K/V a DEC_BUF
        buffer and ``enc_len`` a scalar."""
        c = self.cfg
        lengths = _meta((batch,), torch.int32)
        if self.kind == "lm":
            kv = _meta((c.n_layers, batch, ctx_len, c.n_kv_heads,
                        c.head_dim_), self.dtype)
            return {"k": kv, "v": kv, "lengths": lengths}
        if self.kind == "hybrid":
            h, m = self.h, self.h.mamba
            kv = _meta((h.n_super, batch, ctx_len, c.n_kv_heads,
                        c.head_dim_), self.dtype)
            lead = (h.n_super, h.k - 1, batch)
            return {"attn_k": kv, "attn_v": kv,
                    "conv": _meta(lead + (m.d_conv - 1, m.conv_channels),
                                  self.dtype),
                    "ssm": _meta(lead + (m.n_heads, m.head_dim, m.d_state),
                                 torch.float32),
                    "lengths": lengths}
        if self.kind == "encdec":
            kv_self = _meta((c.n_layers, batch, DEC_BUF, c.n_heads,
                             c.head_dim_), self.dtype)
            kv_cross = _meta((c.n_layers, batch, ctx_len, c.n_heads,
                              c.head_dim_), self.dtype)
            return {"self_k": kv_self, "self_v": kv_self,
                    "cross_k": kv_cross, "cross_v": kv_cross,
                    "enc_len": _meta((), torch.int32), "lengths": lengths}
        m = self.h.mamba
        return {"conv": _meta((c.n_layers, batch, m.d_conv - 1, m.d_inner),
                              self.dtype),
                "ssm": _meta((c.n_layers, batch, m.d_inner, m.d_state),
                             torch.float32),
                "lengths": lengths}

    def cache_sharding(self, rules) -> dict:
        """The specs of ``cache_spec``'s leaves under ``rules``: the K/V
        split along the context (``kv_seq``; an enc-dec model's self K/V
        whole along it, its cross K/V split), the recurrent states along
        ``ssm_inner`` (Mamba1) or ``ssm_heads`` (Mamba2; its conv state
        along ``ssm_inner``)."""
        r = rules
        kv = r.spec(("layers", "batch", "kv_seq", "kv_heads", "head_dim"))
        lengths = r.spec(("batch",))
        if self.kind == "lm":
            return {"k": kv, "v": kv, "lengths": lengths}
        if self.kind == "hybrid":
            return {"attn_k": kv, "attn_v": kv,
                    "conv": r.spec(("layers", None, "batch", "conv_w",
                                    "ssm_inner")),
                    "ssm": r.spec(("layers", None, "batch", "ssm_heads",
                                   None, "ssm_state")),
                    "lengths": lengths}
        if self.kind == "encdec":
            kv_self = r.spec(("layers", "batch", None, "kv_heads",
                              "head_dim"))
            return {"self_k": kv_self, "self_v": kv_self,
                    "cross_k": kv, "cross_v": kv, "enc_len": (),
                    "lengths": lengths}
        return {"conv": r.spec(("layers", "batch", "conv_w", "ssm_inner")),
                "ssm": r.spec(("layers", "batch", "ssm_inner", "ssm_state")),
                "lengths": lengths}
