"""Family adapters — the seam between a model family and the HCache
manager and serving engine: how a prefill, a prefill chunk and a decode
step are invoked, how a prefill's output lands in a ``CacheView``, and
which pieces of a prefill output are persisted. ``LMAdapter`` serves the
``lm`` families (dense, MoE and VLM), ``SSMAdapter`` the attention-free
``ssm`` family (falcon-mamba), ``HybridAdapter`` the ``hybrid`` family
(zamba2), ``EncDecAdapter`` the encoder-decoder family (whisper).

The adapter does not import ``repro_torch.serving``: the serving seam
methods are duck-typed over the engine's ``SequenceState`` and the
backend's ``CacheView``.

Capability flags (as the JAX package's ``FamilyAdapter`` has them):
``chunkable`` (the prompt may be split into SplitFuse chunks),
``supports_resume`` (a paused session resumes by prefilling over its
restored history), ``supports_paged`` (the block-table backend applies),
``supports_mesh`` (``distributed/mesh_serving.py`` runs the family's
prefill and decode over a (data x model) mesh),
``supports_recompute``, ``kv_names`` (cache keys of the stacked K/V),
``kv_row`` (a layer's row in that stack), ``decode_layers`` (the global
layer of each row of a decode step's hidden stack), ``n_state_blobs``
(whole recurrent-state blobs in the restore graph) and ``has_cross``
(the restore graph includes the encoder blob's read and the cross
projection).
"""
from __future__ import annotations

import numpy as np
import torch


class FamilyAdapter:
    kind = "?"
    chunkable = False
    supports_resume = False
    supports_paged = False
    supports_mesh = False
    supports_recompute = False
    kv_names = None
    n_state_blobs = 0
    has_cross = False

    def __init__(self, model):
        self.model = model

    def _tokens(self, chunk) -> torch.Tensor:
        return torch.from_numpy(np.asarray(chunk, np.int64))[None].to(
            self.model.device)

    def decode_hidden(self, hidden):
        """The (L, B, 1, D) hidden stack a decode step persists."""
        return hidden

    def decode_layers(self, n_rows: int):
        """The global layer id of each of the ``n_rows`` rows of
        ``decode_hidden``'s stack, under which the manager files them."""
        return list(range(n_rows))

    def kv_row(self, li: int) -> int:
        """Stacked-K/V row of global layer ``li`` (every layer of the lm
        families is an attention layer)."""
        return li

    def prefill_kv(self, out: dict, li: int):
        """Layer ``li``'s (k, v), each (S, Kv, hd), from a B=1 prefill."""
        row = self.kv_row(li)
        return out["kv"][0][row][0], out["kv"][1][row][0]

    def forward(self, params, batch, *, skip_logits: bool = False):
        """The training forward: dict(final_x (B,S,D), aux) with
        ``skip_logits``, else dict(logits (B,S,V), aux)."""
        out = self.train_forward(params, batch)
        if skip_logits:
            return out
        from repro_torch.models.layers.embedding import logits
        c = self.model.cfg
        return {"logits": logits(params["embed"], out["final_x"],
                                 softcap=c.logit_softcap,
                                 true_vocab=c.vocab_size),
                "aux": out["aux"]}

    def decode_step_paged(self, params, cache, tokens):
        raise NotImplementedError(
            f"paged decode requires an lm-family model; "
            f"{self.model.cfg.name} is {self.kind!r}")

    def restore_kv_from_hidden(self, params, hidden, *, positions):
        raise ValueError(f"{self.model.cfg.name}: attention-free arch; use "
                         "restore_ssm_states (ssm-rescan)")

    def restore_ssm_states(self, params, hidden):
        raise ValueError(f"{self.model.cfg.name}: no SSM states")


class LMAdapter(FamilyAdapter):
    kind = "lm"
    chunkable = True
    supports_resume = True
    supports_paged = True
    supports_mesh = True
    supports_recompute = True
    kv_names = ("k", "v")

    def init(self, generator: torch.Generator, device=None) -> dict:
        from repro_torch.models import transformer as tfm
        return tfm.init_lm(generator, self.model.h,
                           device or self.model.device)

    def prefill(self, params, batch, *, capture_hidden=False, hist_kv=None,
                hist_len=None):
        """A VLM batch's ``patches`` (B, n_vis, D) replace the embeddings
        of its first n_vis tokens; the output carries them, so that the
        manager persists them with the session."""
        from repro_torch.models import transformer as tfm
        patches = batch.get("patches")
        out = tfm.lm_forward(params, batch["tokens"], self.model.h,
                             patch_embeds=patches, hist_kv=hist_kv,
                             hist_len=hist_len,
                             capture_hidden=capture_hidden, emit_kv=True,
                             final_logits_only=True)
        if patches is not None:
            out["patches"] = patches
        return out

    def train_forward(self, params, batch):
        """A VLM batch's ``patches`` (B, n_vis, D) replace the embeddings
        of its first n_vis tokens; a MoE stack returns its aux."""
        from repro_torch.models import transformer as tfm
        return tfm.lm_train_forward(params, batch["tokens"], self.model.h,
                                    patch_embeds=batch.get("patches"))

    def decode_step_full(self, params, cache, tokens):
        from repro_torch.models import transformer as tfm
        return tfm.lm_decode_step(params, cache, tokens, self.model.h)

    def decode_step_paged(self, params, cache, tokens):
        from repro_torch.models import transformer as tfm
        return tfm.lm_decode_step_paged(params, cache, tokens, self.model.h)

    def restore_kv_from_hidden(self, params, hidden, *, positions):
        from repro_torch.models import transformer as tfm
        return tfm.lm_restore_kv(params, hidden, self.model.h,
                                 positions=positions)

    # -------------------------------------------------- serving: prefill
    def prefill_chunk(self, params, seq, chunk, hist, *, capture_hidden):
        """One prefill chunk of a resident sequence: ``chunk`` a 1-D token
        array, ``hist`` the tokens already in its ``CacheView``. Text only,
        as in the reference: the engine's requests carry no patches."""
        hist_kv = seq.view.gather_hist(hist) if hist else None
        return self.prefill(params, {"tokens": self._tokens(chunk)},
                            capture_hidden=capture_hidden, hist_kv=hist_kv,
                            hist_len=hist if hist_kv is not None else None)

    def absorb_prefill(self, view, out, n, hist) -> None:
        """Write a prefill output's K/V (``n`` tokens at offset ``hist``)
        through the view; the caller owns ``view.set_length``."""
        k, v = out["kv"]
        view.write_kv(k, v, hist)

    def prefill_hidden(self, out: dict, li: int) -> torch.Tensor:
        """Layer ``li``'s hidden states (S, D) from a B=1 prefill output."""
        return out["hidden"][li][0]


class SSMAdapter(FamilyAdapter):
    """Mamba1 stacks: the prefill runs the whole prompt from zero state
    (``ssm_forward`` takes no initial state, so the prompt is not
    chunkable and a session cannot resume on top of restored state), and
    the recurrent states are restored as one blob."""

    kind = "ssm"
    n_state_blobs = 1
    supports_mesh = True

    def init(self, generator: torch.Generator, device=None) -> dict:
        from repro_torch.models import ssm
        return ssm.init_ssm_lm(generator, self.model.h,
                               device or self.model.device)

    def prefill(self, params, batch, *, capture_hidden=False, hist_kv=None,
                hist_len=None):
        from repro_torch.models import ssm
        return ssm.ssm_forward(params, batch["tokens"], self.model.h,
                               capture_hidden=capture_hidden,
                               emit_state=True, final_logits_only=True)

    def train_forward(self, params, batch):
        from repro_torch.models import ssm
        return ssm.ssm_train_forward(params, batch["tokens"], self.model.h)

    def decode_step_full(self, params, cache, tokens):
        from repro_torch.models import ssm
        return ssm.ssm_decode_step(params, cache, tokens, self.model.h)

    def restore_ssm_states(self, params, hidden):
        from repro_torch.models import ssm
        return ssm.ssm_restore_states(params, hidden, self.model.h)

    def prefill_chunk(self, params, seq, chunk, hist, *, capture_hidden):
        return self.prefill(params, {"tokens": self._tokens(chunk)},
                            capture_hidden=capture_hidden)

    def absorb_prefill(self, view, out, n, hist) -> None:
        """Write the prefill's final states into the view's slot."""
        conv, ssm = out["states"]
        view.write_states({"conv": conv, "ssm": ssm})

    def prefill_kv(self, out: dict, li: int):
        raise ValueError(f"{self.model.cfg.name}: attention-free arch has "
                         "no K/V to persist")


class HybridAdapter(FamilyAdapter):
    """Mamba2 + attention stacks (zamba2): the prefill runs the whole
    prompt from zero state (not chunkable, no resume, as ``ssm``); the
    attention blocks' K/V sit in ``attn_k``/``attn_v`` (row ``li // k`` for
    global layer ``li``) and restore from hidden states, the Mamba2
    blocks' states as one blob. Contiguous backend only; no recompute (an
    attention block's replay would need the Mamba2 blocks between)."""

    kind = "hybrid"
    supports_mesh = True
    kv_names = ("attn_k", "attn_v")
    n_state_blobs = 1

    def init(self, generator: torch.Generator, device=None) -> dict:
        from repro_torch.models import hybrid
        return hybrid.init_hybrid(generator, self.model.h,
                                  device or self.model.device)

    def prefill(self, params, batch, *, capture_hidden=False, hist_kv=None,
                hist_len=None):
        from repro_torch.models import hybrid
        return hybrid.hybrid_forward(params, batch["tokens"], self.model.h,
                                     capture_hidden=capture_hidden,
                                     emit_state=True, final_logits_only=True)

    def train_forward(self, params, batch):
        from repro_torch.models import hybrid
        return hybrid.hybrid_train_forward(params, batch["tokens"],
                                           self.model.h)

    def decode_step_full(self, params, cache, tokens):
        from repro_torch.models import hybrid
        return hybrid.hybrid_decode_step(params, cache, tokens, self.model.h)

    def restore_kv_from_hidden(self, params, hidden, *, positions):
        from repro_torch.models import hybrid
        return hybrid.hybrid_restore_attn_kv(params, hidden, self.model.h,
                                             positions=positions)

    def restore_ssm_states(self, params, hidden):
        from repro_torch.models import hybrid
        return hybrid.hybrid_restore_mamba_states(params, hidden,
                                                  self.model.h)

    def prefill_chunk(self, params, seq, chunk, hist, *, capture_hidden):
        return self.prefill(params, {"tokens": self._tokens(chunk)},
                            capture_hidden=capture_hidden)

    def absorb_prefill(self, view, out, n, hist) -> None:
        """Write the attention K/V at offset ``hist`` and the Mamba2
        blocks' final states into the view's slot."""
        k, v = out["kv"]
        view.write_kv(k, v, hist)
        conv, ssm = out["mamba_states"]
        view.write_states({"conv": conv, "ssm": ssm})

    def decode_hidden(self, hidden):
        """The attention blocks' stack (n_super, B, 1, D) of a decode
        step's (mamba_hidden, attn_hidden)."""
        return hidden[1]

    def decode_layers(self, n_rows: int):
        """Row ``s`` of the attention stack is global layer s·k + k-1."""
        k = self.model.h.k
        return [s * k + k - 1 for s in range(n_rows)]

    def kv_row(self, li: int) -> int:
        return li // self.model.h.k

    def prefill_hidden(self, out: dict, li: int) -> torch.Tensor:
        return out["attn_hidden"][self.kv_row(li)][0]


class EncDecAdapter(FamilyAdapter):
    """Encoder-decoder stacks (whisper). Chunkable: the encoder pass and
    the cross projection run once, on the first chunk of a residency
    (``hist == 0``, which needs the request's frames); later chunks, and
    the prefill of a resumed or later round, attend over the self-K/V
    history and the cross state already in the view. The decoder self-K/V
    pages like an ``lm`` cache; the cross state is whole per slot. No
    recompute: a decoder layer's replay would need the cross context, as
    in the reference."""

    kind = "encdec"
    chunkable = True
    supports_resume = True
    supports_paged = True
    supports_mesh = True
    kv_names = ("self_k", "self_v")
    has_cross = True

    def init(self, generator: torch.Generator, device=None) -> dict:
        from repro_torch.models import encdec
        return encdec.init_encdec(generator, self.model.h,
                                  device or self.model.device)

    def prefill(self, params, batch, *, capture_hidden=False, hist_kv=None,
                hist_len=None):
        """The encoder over ``batch["frames"]`` (B, S_enc, D), then the
        decoder over ``batch["tokens"]`` from position 0; the output
        carries the encoder output (``enc_out``), which the manager
        stores as the session's "enc" blob, and the cross K/V. A prefill
        over restored history goes through ``prefill_chunk``, which takes
        the cross state from the slot."""
        from repro_torch.models import encdec
        if hist_kv is not None:
            raise ValueError("an enc-dec prefill over history needs the "
                             "slot's cross state: use prefill_chunk")
        h = self.model.h
        enc_out, _ = encdec.encode(params, batch["frames"], h)
        out = encdec.decode_prefill(params, batch["tokens"], enc_out, h,
                                    capture_hidden=capture_hidden,
                                    emit_kv=True, final_logits_only=True)
        out["enc_out"] = enc_out
        return out

    def train_forward(self, params, batch):
        """The encoder over ``batch["frames"]`` (B, S_enc, D), then the
        decoder over ``batch["tokens"]``."""
        from repro_torch.models import encdec
        return encdec.encdec_train_forward(params, batch["frames"],
                                           batch["tokens"], self.model.h)

    def decode_step_full(self, params, cache, tokens):
        from repro_torch.models import encdec
        return encdec.decode_step(params, cache, tokens, self.model.h)

    def decode_step_paged(self, params, cache, tokens):
        from repro_torch.models import encdec
        return encdec.decode_step_paged(params, cache, tokens, self.model.h)

    def restore_kv_from_hidden(self, params, hidden, *, positions):
        from repro_torch.models import encdec
        return encdec.restore_self_kv(params, hidden, self.model.h,
                                      positions=positions)

    def prefill_chunk(self, params, seq, chunk, hist, *, capture_hidden):
        from repro_torch.models import encdec
        toks = self._tokens(chunk)
        if hist:
            ck, cv, _ = seq.view.cross_state()
            return encdec.decode_prefill(
                params, toks, None, self.model.h,
                capture_hidden=capture_hidden, emit_kv=True,
                final_logits_only=True, hist_kv=seq.view.gather_hist(hist),
                hist_len=hist, cross=(ck, cv), pos_offset=hist)
        frames = seq.request.frames
        if frames is None:
            raise ValueError(
                f"enc-dec session {seq.request.session_id!r} has no stored "
                "state and no Request.frames: a first-residency whisper "
                "request must carry its encoder frame embeddings")
        frames = torch.from_numpy(np.asarray(frames, np.float32)).to(
            self.model.device)
        if frames.dim() == 2:
            frames = frames[None]
        return self.prefill(params, {"tokens": toks, "frames": frames},
                            capture_hidden=capture_hidden)

    def absorb_prefill(self, view, out, n, hist) -> None:
        """The chunk's self K/V at offset ``hist``; on a first residency
        also the cross state, whole (on resume it is already in the
        view, restored or never evicted)."""
        k, v = out["kv"]
        view.write_kv(k, v, hist)
        if hist == 0:
            ck, cv = out["cross_kv"]
            view.write_states({"cross_k": ck, "cross_v": cv,
                               "enc_len": int(ck.shape[2])})

    def prefill_hidden(self, out: dict, li: int) -> torch.Tensor:
        return out["hidden"][li][0]
