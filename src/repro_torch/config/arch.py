"""Architecture configuration.

One dataclass covers every assigned family:

  dense GQA transformers   (qwen2, qwen2.5, starcoder2, gemma2)
  MoE transformers         (granite-moe, grok-1)
  pure SSM                 (falcon-mamba, Mamba1)
  hybrid SSM+attention     (zamba2, Mamba2 + shared attention blocks)
  encoder-decoder          (whisper, conv frontend stubbed)
  VLM backbone             (internvl2, ViT frontend stubbed)

The config is *static* metadata: model builders read it at trace time, the
cost model reads it for restoration analysis, and the dry-run reads it to
construct input ShapeDtypeStructs.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence


class BlockKind(str, enum.Enum):
    """Kind of a residual block in the stack."""

    ATTENTION = "attention"
    MAMBA1 = "mamba1"
    MAMBA2 = "mamba2"


class AttnKind(str, enum.Enum):
    GLOBAL = "global"          # full causal attention
    LOCAL = "local"            # sliding-window causal attention
    ENCODER = "encoder"        # bidirectional (whisper encoder)
    CROSS = "cross"            # cross attention (whisper decoder)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Static description of one architecture."""

    name: str
    family: str                              # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # --- attention details -------------------------------------------------
    head_dim: Optional[int] = None           # default d_model // n_heads
    qkv_bias: bool = False                   # qwen2 family
    rope_theta: float = 10000.0
    use_rope: bool = True                    # whisper uses learned/sinusoidal positions
    local_window: Optional[int] = None       # gemma2 sliding window
    layer_pattern: Optional[str] = None      # e.g. "LG" repeated (gemma2), None=all global
    logit_softcap: Optional[float] = None    # gemma2 final-logit softcap
    attn_softcap: Optional[float] = None     # gemma2 attention softcap
    # --- FFN ----------------------------------------------------------------
    ffn_activation: str = "silu"             # silu | gelu | relu (glu except whisper)
    ffn_glu: bool = True                     # gated linear unit (llama-style)
    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0                       # 0 => dense FFN
    experts_per_token: int = 0
    moe_shared_ff: int = 0                   # granite has none; reserved
    # --- SSM ----------------------------------------------------------------
    ssm_state: int = 0                       # mamba d_state
    ssm_conv: int = 4                        # causal conv width
    ssm_expand: int = 2                      # mamba inner expansion
    ssm_headdim: int = 64                    # mamba2 head dim
    # --- hybrid (zamba2) ----------------------------------------------------
    hybrid_attn_every: int = 0               # shared attn block every k mamba blocks
    # --- enc-dec (whisper) --------------------------------------------------
    encoder_layers: int = 0                  # whisper: same count as decoder
    is_encoder_decoder: bool = False
    max_source_positions: int = 0            # whisper encoder length after conv
    # --- embeddings / norms --------------------------------------------------
    norm: str = "rmsnorm"                    # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embedding_scale: bool = False            # gemma multiplies by sqrt(d_model)
    post_attn_norm: bool = False             # gemma2 extra norms
    # --- modality frontend stub ----------------------------------------------
    frontend: Optional[str] = None           # "audio_conv" | "vit_patch" | None
    frontend_dim: int = 0                    # raw feature dim fed to the stub
    # --- source provenance ---------------------------------------------------
    source: str = ""

    # ------------------------------------------------------------------ props
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.n_heads, 1)

    @property
    def kv_dim(self) -> int:
        """Per-token, per-layer KV width of ONE of K or V (elements)."""
        return self.n_kv_heads * self.head_dim_

    @property
    def is_attention_free(self) -> bool:
        return self.n_heads == 0

    @property
    def is_mha(self) -> bool:
        return self.n_heads > 0 and self.n_kv_heads == self.n_heads

    def block_kinds(self) -> Sequence[BlockKind]:
        """Kind of each block in the main (decoder) stack, in order."""
        if self.family == "ssm":
            return [BlockKind.MAMBA1] * self.n_layers
        if self.family == "hybrid":
            kinds = []
            for i in range(self.n_layers):
                if self.hybrid_attn_every and (i % self.hybrid_attn_every
                                               == self.hybrid_attn_every - 1):
                    kinds.append(BlockKind.ATTENTION)
                else:
                    kinds.append(BlockKind.MAMBA2)
            return kinds
        return [BlockKind.ATTENTION] * self.n_layers

    def attn_kinds(self) -> Sequence[AttnKind]:
        """For attention blocks only: local/global pattern (gemma2)."""
        if not self.layer_pattern:
            return [AttnKind.GLOBAL] * self.n_layers
        pat = self.layer_pattern
        out = []
        for i in range(self.n_layers):
            out.append(AttnKind.LOCAL if pat[i % len(pat)] == "L" else AttnKind.GLOBAL)
        return out

    # ------------------------------------------------------------- parameters
    def param_count(self) -> int:
        """Total parameter count (embedding included once if tied)."""
        d, hd = self.d_model, self.head_dim_
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        per_layer = 0
        kinds = self.block_kinds()
        attn_kinds = [k for k in kinds if k == BlockKind.ATTENTION]
        for kind in kinds:
            if kind == BlockKind.ATTENTION:
                attn = d * n_q + 2 * d * n_kv + n_q * d
                if self.qkv_bias:
                    attn += n_q + 2 * n_kv
                per_layer += attn + self._ffn_params()
            else:
                per_layer += self._mamba_params(kind)
        total = per_layer
        # encoder stack (whisper): MHA + non-GLU FFN, plus cross-attn in decoder
        if self.is_encoder_decoder:
            enc_attn = 4 * d * d
            enc_ffn = 2 * d * self.d_ff
            total += self.encoder_layers * (enc_attn + enc_ffn)
            total += self.n_layers * (4 * d * d)  # decoder cross-attention
        emb = self.vocab_size * d
        total += emb if self.tie_embeddings else 2 * emb
        return total

    def _ffn_params(self) -> int:
        d, f = self.d_model, self.d_ff
        one_ffn = (3 if self.ffn_glu else 2) * d * f
        if self.n_experts:
            return self.n_experts * one_ffn + d * self.n_experts  # + router
        return one_ffn

    def _mamba_params(self, kind: BlockKind) -> int:
        d = self.d_model
        inner = self.ssm_expand * d
        if kind == BlockKind.MAMBA2:
            n_heads = inner // self.ssm_headdim
            in_proj = d * (2 * inner + 2 * self.ssm_state + n_heads)
            return in_proj + inner * self.ssm_conv + n_heads + inner * d
        # mamba1
        dt_rank = max(d // 16, 1)
        in_proj = d * 2 * inner
        x_proj = inner * (dt_rank + 2 * self.ssm_state)
        dt_proj = dt_rank * inner + inner
        out_proj = inner * d
        conv = inner * self.ssm_conv
        return in_proj + x_proj + dt_proj + out_proj + conv + inner * self.ssm_state + inner

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.param_count()
        dense_ffn = (3 if self.ffn_glu else 2) * self.d_model * self.d_ff
        inactive = (self.n_experts - self.experts_per_token) * dense_ffn
        return self.param_count() - self.n_layers * inactive

    # ------------------------------------------------------- HCache geometry
    def hidden_bytes_per_token_layer(self, dtype_bytes: int = 2) -> int:
        return self.d_model * dtype_bytes

    def kv_bytes_per_token_layer(self, dtype_bytes: int = 2) -> int:
        return 2 * self.kv_dim * dtype_bytes

    def scaled(self, **overrides) -> "ArchConfig":
        """Reduced config of the same family (for smoke tests)."""
        return dataclasses.replace(self, **overrides)


def reduced_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config: few layers, narrow width, small vocab."""
    n_heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    ratio = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1) if cfg.n_heads else 1
    n_kv = max(n_heads // min(ratio, n_heads), 1) if n_heads else 0
    head_dim = 16
    d_model = max(n_heads, 2) * head_dim if n_heads else 64
    layers = 4
    if cfg.family == "hybrid":
        layers = 2 * max(cfg.hybrid_attn_every, 2)
    over = dict(
        n_layers=layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim if n_heads else None,
        d_ff=4 * d_model if not cfg.n_experts else 32,
        vocab_size=256,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.family in ("hybrid",) else cfg.ssm_headdim,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.n_experts else 0,
        encoder_layers=2 if cfg.is_encoder_decoder else 0,
        max_source_positions=64 if cfg.is_encoder_decoder else 0,
        local_window=16 if cfg.local_window else None,
        frontend_dim=8 if cfg.frontend else 0,
    )
    return cfg.scaled(**over)
