"""Deterministic tokenizer + chat template for the serving front door (a
copy of the JAX package's ``frontend/tokenizer.py``).

The repro models are randomly initialized and speak raw token ids, not
natural language, so the front door needs a tokenizer whose only job is
to be **deterministic and exactly round-trippable**: the same rendered
conversation must always produce the same token prefix (the router's
similarity matching and the engine's restore path both key off exact
token prefixes), and a model-generated token id must survive a
decode→re-encode cycle bit-exactly (round N+1 re-renders the assistant's
round-N reply as message content).

Two charsets:

* ordinary text encodes byte-level: each UTF-8 byte maps to
  ``byte % vocab_size`` (injective whenever vocab_size >= 256, which
  every config here satisfies — ``reduced_for_smoke`` pins vocab=256);
* model-generated ids decode into the Unicode supplementary private-use
  plane, ``chr(PUA_BASE + id)``, and those codepoints encode straight
  back to ``id``. Arbitrary ids round-trip exactly regardless of vocab.

The chat template is prefix-stable: rendering a conversation history is
always a strict token prefix of rendering that history plus more
messages, because every message renders self-contained
(``<|role|>content<|end|>``) and the trailing assistant header that ends
a prompt is exactly how the next assistant message starts.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Union

import numpy as np

PUA_BASE = 0xF0000          # supplementary private-use area A (65536 slots)


class ByteTokenizer:
    """Byte-level text → tokens; PUA codepoints ↔ raw token ids."""

    def __init__(self, vocab_size: int):
        if vocab_size < 2:
            raise ValueError(f"vocab_size {vocab_size} too small")
        self.vocab_size = int(vocab_size)

    def encode(self, text: str) -> np.ndarray:
        ids: List[int] = []
        for ch in text:
            cp = ord(ch)
            if PUA_BASE <= cp < PUA_BASE + self.vocab_size:
                ids.append(cp - PUA_BASE)
            else:
                ids.extend(b % self.vocab_size for b in ch.encode("utf-8"))
        return np.asarray(ids, np.int32)

    def decode(self, ids: Iterable[int]) -> str:
        """Model-generated ids → text. Every id becomes a PUA codepoint,
        so ``encode(decode(ids)) == ids`` holds for ANY id sequence —
        byte-level decoding could not promise that (an id >= 128 is not
        a complete UTF-8 sequence)."""
        return "".join(chr(PUA_BASE + int(i) % self.vocab_size)
                       for i in ids)


Content = Union[str, Sequence[int], np.ndarray]


class ChatTemplate:
    """Messages → token prompt, rendered deterministically.

    Message content may be a string (tokenized byte-level / PUA) or an
    explicit token-id list (passed through — benches and tests use this
    to drive exact workloads through the OpenAI-shaped API)."""

    def __init__(self, tokenizer: ByteTokenizer):
        self.tok = tokenizer

    def _content_tokens(self, content: Content) -> np.ndarray:
        if isinstance(content, str):
            return self.tok.encode(content)
        return np.asarray(list(content), np.int32) % self.tok.vocab_size

    def render(self, messages: List[dict],
               add_assistant_header: bool = True) -> np.ndarray:
        parts = []
        for m in messages:
            role = str(m.get("role", "user"))
            parts.append(self.tok.encode(f"<|{role}|>"))
            parts.append(self._content_tokens(m.get("content", "")))
            parts.append(self.tok.encode("<|end|>"))
        if add_assistant_header:
            parts.append(self.tok.encode("<|assistant|>"))
        if not parts:
            return np.zeros((0,), np.int32)
        return np.concatenate(parts).astype(np.int32)
