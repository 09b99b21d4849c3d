"""OpenAI-compatible API layer, transport-agnostic (DESIGN.md §14; the
JAX package's ``frontend/api.py`` over the port's engine).

``FrontDoor.handle(method, path, body)`` implements
``/v1/chat/completions`` and ``/v1/completions`` (plus ``/v1/models``,
``/healthz``, ``/metrics``) against the engine pump and session router —
no sockets anywhere, so tests and the SLO harness drive the exact
request path the HTTP binding (frontend/server.py) serves, byte for
byte. ``handle`` returns ``(status, payload)``; a streaming request's
payload is an async generator of SSE-framed strings
(``data: {json}\n\n`` … ``data: [DONE]\n\n``) the binding writes through
as chunks, one per emitted token — the first chunk leaves before
generation completes.

Round tracking: every response carries a ``conversation_id`` (client-
supplied or minted here). A client that passes it back gets an exact
router hit; a client that only resends its transcript is recovered by
the router's prefix-similarity match. Either way the engine restores the
conversation's stored state and prefills only the new suffix.

Backpressure maps to HTTP statuses: pump queue-depth cap →
429 ``overloaded``; a second in-flight request on one conversation →
409 ``conversation_busy``. An engine that raised answers 500
``engine_error`` (a stream that already began ends with an ``error``
chunk before ``[DONE]``), and so does every request after it.

An enc-dec model (whisper) is not served: its first round needs the
session's encoder frames, and a chat or completion request carries
none (the JAX package's front door submits such a request and its
engine raises on the pump thread). ``unservable`` gives the reason.
"""
from __future__ import annotations

import asyncio
import json
import time
from typing import Optional

import numpy as np

from repro_torch.frontend.pump import (EngineFailed, EnginePump,
                                       Overloaded, Subscription)
from repro_torch.frontend.router import (RouteDecision, RouterBusy,
                                         SessionRouter)
from repro_torch.frontend.tokenizer import ByteTokenizer, ChatTemplate
from repro_torch.serving.request import Request


def sse(obj) -> str:
    return f"data: {json.dumps(obj)}\n\n"


SSE_DONE = "data: [DONE]\n\n"


def _error(status: int, etype: str, message: str):
    return status, {"error": {"type": etype, "message": message,
                              "code": status}}


def unservable(model) -> Optional[str]:
    """Why the front door cannot serve ``model``, or None."""
    if getattr(model.adapter, "has_cross", False):
        return (f"{model.cfg.name} is an enc-dec model: its first round "
                "needs the session's encoder frames (Request.frames), and "
                "an OpenAI chat or completion request carries none")
    return None


class FrontDoor:
    def __init__(self, pump: EnginePump,
                 router: Optional[SessionRouter] = None, *,
                 model_name: str = "hcache-repro",
                 default_max_tokens: int = 16):
        self.pump = pump
        engine = pump.engine
        why = unservable(engine.model)
        if why is not None:
            raise ValueError(f"the front door cannot serve {why}")
        self.router = router if router is not None else SessionRouter(
            engine, block_size=getattr(engine.kv, "block_size", 16))
        self.model_name = model_name
        self.default_max_tokens = int(default_max_tokens)
        self.tokenizer = ByteTokenizer(engine.model.cfg.vocab_size)
        self.template = ChatTemplate(self.tokenizer)
        # fold finished rounds back into the router on the pump thread
        pump.on_request_finished = self._request_finished

    def _request_finished(self, sub: Subscription) -> None:
        decision = sub.meta.get("decision")
        if decision is not None:
            self.router.complete(decision, sub.tokens)

    # ------------------------------------------------------------ dispatch
    async def handle(self, method: str, path: str, body=None):
        """Returns ``(status, payload)``; payload is a JSON-able dict or,
        for streaming requests, an async generator of SSE strings."""
        method = method.upper()
        path = path.split("?", 1)[0].rstrip("/") or "/"
        if method == "GET" and path == "/healthz":
            if self.pump.error is not None:
                return 500, {"status": "error",
                             "error": repr(self.pump.error)}
            return 200, {"status": "ok",
                         "pending": self.pump.pending()}
        if method == "GET" and path == "/v1/models":
            return 200, {"object": "list",
                         "data": [{"id": self.model_name,
                                   "object": "model",
                                   "owned_by": "repro"}]}
        if method == "GET" and path == "/metrics":
            fut = self.pump.call(self.pump.engine.metrics.to_dict)
            metrics = await asyncio.wrap_future(fut)
            return 200, {"engine": metrics,
                         "router": self.router.stats(),
                         "pump": {"pending": self.pump.pending(),
                                  "max_pending": self.pump.max_pending}}
        if method == "POST" and path == "/v1/chat/completions":
            return await self._chat(body or {})
        if method == "POST" and path == "/v1/completions":
            return await self._completions(body or {})
        return _error(404, "not_found", f"no route for {method} {path}")

    # ------------------------------------------------------------- routing
    async def _route_and_submit(self, tokens: np.ndarray, body: dict):
        """Route on the pump thread (router state + fork must not race
        ``engine.step()``), then submit. Returns ``(sub, decision,
        conversation_id)`` or raises the mapped API error."""
        conv_id = body.get("conversation_id") or body.get("session_id")
        decision: RouteDecision = await asyncio.wrap_future(
            self.pump.call(self.router.route, tokens, conv_id))
        max_tokens = int(body.get("max_tokens")
                         or self.default_max_tokens)
        eos = body.get("eos_token")
        request = Request(decision.session_id, decision.prompt,
                          max_new_tokens=max_tokens,
                          eos_token=int(eos) if eos is not None else None,
                          priority=int(body.get("priority", 0)))
        try:
            sub = self.pump.submit(request)
        except (Overloaded, EngineFailed):
            self.router.cancel(decision)
            if decision.kind == "fork":
                # the fork will never be admitted: drop its parked pages
                self.pump.call(self.pump.engine.release_fork,
                               decision.session_id)
            raise
        sub.meta["decision"] = decision
        if conv_id is None:
            conv_id = f"conv-{request.request_id}"
            self.router.adopt_conversation(decision, conv_id)
        return sub, decision, conv_id

    @staticmethod
    def _route_info(decision: RouteDecision) -> dict:
        return {"session_id": decision.session_id,
                "route": decision.kind,
                "matched_tokens": int(decision.matched_tokens),
                "forked_from": decision.forked_from}

    # ---------------------------------------------------------------- chat
    async def _chat(self, body: dict):
        messages = body.get("messages")
        if not messages or not isinstance(messages, list):
            return _error(400, "invalid_request",
                          "messages must be a non-empty list")
        try:
            tokens = self.template.render(messages)
        except (TypeError, ValueError) as e:
            return _error(400, "invalid_request", f"bad messages: {e}")
        return await self._serve(tokens, body, chat=True)

    async def _completions(self, body: dict):
        prompt = body.get("prompt")
        if prompt is None:
            return _error(400, "invalid_request", "prompt is required")
        if isinstance(prompt, str):
            tokens = self.tokenizer.encode(prompt)
        else:
            try:
                tokens = (np.asarray(list(prompt), np.int32)
                          % self.tokenizer.vocab_size)
            except (TypeError, ValueError) as e:
                return _error(400, "invalid_request", f"bad prompt: {e}")
        if len(tokens) == 0:
            return _error(400, "invalid_request", "prompt is empty")
        return await self._serve(tokens, body, chat=False)

    async def _serve(self, tokens: np.ndarray, body: dict, *, chat: bool):
        try:
            sub, decision, conv_id = await self._route_and_submit(tokens,
                                                                  body)
        except RouterBusy as e:
            return _error(409, "conversation_busy", str(e))
        except Overloaded as e:
            return _error(429, "overloaded", str(e))
        except EngineFailed as e:
            return _error(500, "engine_error", str(e))
        oid = f"{'chatcmpl' if chat else 'cmpl'}-{sub.request.request_id}"
        if body.get("stream"):
            gen = (self._stream_chat(oid, conv_id, decision, sub) if chat
                   else self._stream_completion(oid, conv_id, decision,
                                                sub))
            return 200, gen
        async for _ in sub.events():
            pass
        if sub.error is not None:
            self.router.cancel(decision)
            return _error(500, "engine_error", repr(sub.error))
        return 200, self._final(oid, conv_id, decision, sub, chat=chat)

    def _final(self, oid: str, conv_id: str, decision: RouteDecision,
               sub: Subscription, *, chat: bool) -> dict:
        text = self.tokenizer.decode(sub.tokens)
        usage = {"prompt_tokens": int(len(decision.full_tokens)),
                 "completion_tokens": len(sub.tokens),
                 "total_tokens": (int(len(decision.full_tokens))
                                  + len(sub.tokens))}
        base = {"id": oid, "created": int(time.time()),
                "model": self.model_name, "conversation_id": conv_id,
                "usage": usage, "hcache": self._route_info(decision)}
        if chat:
            base["object"] = "chat.completion"
            base["choices"] = [{"index": 0,
                                "message": {"role": "assistant",
                                            "content": text},
                                "finish_reason": sub.finish_reason}]
        else:
            base["object"] = "text_completion"
            base["choices"] = [{"index": 0, "text": text,
                                "tokens": list(sub.tokens),
                                "finish_reason": sub.finish_reason}]
        return base

    # ------------------------------------------------------------- streams
    def _chunk(self, oid: str, conv_id: str, delta: dict,
               finish: Optional[str]) -> dict:
        return {"id": oid, "object": "chat.completion.chunk",
                "created": int(time.time()), "model": self.model_name,
                "conversation_id": conv_id,
                "choices": [{"index": 0, "delta": delta,
                             "finish_reason": finish}]}

    async def _stream_chat(self, oid, conv_id, decision, sub):
        yield sse(self._chunk(oid, conv_id, {"role": "assistant"}, None))
        async for ev in sub.events():
            kind = ev[0]
            if kind == "token":
                yield sse(self._chunk(
                    oid, conv_id,
                    {"content": self.tokenizer.decode([ev[1]])}, None))
            elif kind == "finish":
                if sub.error is not None:
                    yield self._stream_error(decision, sub)
                    break
                final = self._chunk(oid, conv_id, {}, ev[1])
                final["hcache"] = self._route_info(decision)
                yield sse(final)
        yield SSE_DONE

    def _stream_error(self, decision: RouteDecision,
                      sub: Subscription) -> str:
        self.router.cancel(decision)
        return sse(_error(500, "engine_error", repr(sub.error))[1])

    async def _stream_completion(self, oid, conv_id, decision, sub):
        async for ev in sub.events():
            kind = ev[0]
            if kind == "token":
                yield sse({"id": oid, "object": "text_completion",
                           "model": self.model_name,
                           "conversation_id": conv_id,
                           "choices": [{"index": 0,
                                        "text": self.tokenizer.decode(
                                            [ev[1]]),
                                        "token": int(ev[1]),
                                        "finish_reason": None}]})
            elif kind == "finish" and sub.error is not None:
                yield self._stream_error(decision, sub)
            elif kind == "finish":
                yield sse({"id": oid, "object": "text_completion",
                           "model": self.model_name,
                           "conversation_id": conv_id,
                           "hcache": self._route_info(decision),
                           "choices": [{"index": 0, "text": "",
                                        "finish_reason": ev[1]}]})
        yield SSE_DONE
