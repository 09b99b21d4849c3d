"""LMAdapter — the seam between the ``lm`` model and the HCache manager:
how a prefill and a decode step are invoked and which pieces of a prefill
output are persisted. The other families' adapters are not ported yet."""
from __future__ import annotations

import torch


class LMAdapter:
    kind = "lm"
    supports_recompute = True

    def __init__(self, model):
        self.model = model

    def init(self, generator: torch.Generator) -> dict:
        from repro_torch.models import transformer as tfm
        return tfm.init_lm(generator, self.model.h, self.model.device)

    def prefill(self, params, batch, *, capture_hidden=False, hist_kv=None,
                hist_len=None):
        from repro_torch.models import transformer as tfm
        return tfm.lm_forward(params, batch["tokens"], self.model.h,
                              hist_kv=hist_kv, hist_len=hist_len,
                              capture_hidden=capture_hidden, emit_kv=True,
                              final_logits_only=True)

    def decode_step_full(self, params, cache, tokens):
        from repro_torch.models import transformer as tfm
        return tfm.lm_decode_step(params, cache, tokens, self.model.h)

    def restore_kv_from_hidden(self, params, hidden, *, positions):
        from repro_torch.models import transformer as tfm
        return tfm.lm_restore_kv(params, hidden, self.model.h,
                                 positions=positions)

    def prefill_hidden(self, out: dict, li: int) -> torch.Tensor:
        """Layer ``li``'s hidden states (S, D) from a B=1 prefill output."""
        return out["hidden"][li][0]

    def prefill_kv(self, out: dict, li: int):
        """Layer ``li``'s (k, v), each (S, Kv, hd), from a B=1 prefill."""
        return out["kv"][0][li][0], out["kv"][1][li][0]
