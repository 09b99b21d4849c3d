"""Serving front door of the port (DESIGN.md §14): OpenAI-compatible async
API, similarity-steered session router, engine pump, stdlib HTTP binding;
the JAX package's ``frontend`` over the port's engine."""
from repro_torch.frontend.api import SSE_DONE, FrontDoor, sse, unservable
from repro_torch.frontend.pump import (EngineFailed, EnginePump, Overloaded,
                                       Subscription)
from repro_torch.frontend.router import (RouteDecision, RouterBusy,
                                         RouterSlot, SessionRouter,
                                         StoredSession)
from repro_torch.frontend.server import HttpFrontDoor, serve_engine
from repro_torch.frontend.tokenizer import ByteTokenizer, ChatTemplate

__all__ = ["ByteTokenizer", "ChatTemplate", "EngineFailed", "EnginePump",
           "FrontDoor", "HttpFrontDoor", "Overloaded", "RouteDecision", "RouterBusy",
           "RouterSlot", "SSE_DONE", "SessionRouter", "StoredSession",
           "Subscription", "serve_engine", "sse", "unservable"]
