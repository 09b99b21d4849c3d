"""Thin stdlib HTTP binding for the front door (DESIGN.md §14; the JAX
package's ``frontend/server.py`` over the port's engine).

An ``asyncio.start_server`` socket loop that parses just enough
HTTP/1.1 to serve the ``FrontDoor`` handler: request line, headers,
``Content-Length`` body. Responses are either a JSON document
(``Content-Length``-framed) or — when the handler returns an async
generator — an SSE stream written chunk-by-chunk with ``Connection:
close`` framing (the client reads until EOF), each chunk flushed with
``drain()`` so tokens leave the process the moment the pump posts them.

No third-party HTTP stack: the repo's container has none, and the
handler layer is where all the behavior lives anyway — this module is
deliberately only sockets and framing. ``serve_engine`` is the
``launch/serve.py --serve-http`` entry: it owns the pump/router/api
wiring and shuts everything down cleanly (pump quiesce → engine.close)
on cancellation, Ctrl-C or its ``stop`` event.
"""
from __future__ import annotations

import asyncio
import json
from typing import Optional

from repro_torch.frontend.api import FrontDoor
from repro_torch.frontend.pump import EnginePump
from repro_torch.frontend.router import SessionRouter

_MAX_BODY = 16 * 1024 * 1024


class HttpFrontDoor:
    """One listening socket bound to one ``FrontDoor``."""

    def __init__(self, api: FrontDoor, host: str = "127.0.0.1",
                 port: int = 0):
        self.api = api
        self.host = host
        self.port = port                   # 0 -> ephemeral, set by start()
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> "HttpFrontDoor":
        self._server = await asyncio.start_server(self._client,
                                                  self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # ------------------------------------------------------------ protocol
    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            req = await self._read_request(reader)
            if req is None:
                return
            method, path, body = req
            try:
                status, payload = await self.api.handle(method, path, body)
            except Exception as e:         # noqa: BLE001 - last resort 500
                status, payload = 500, {"error": {"type": "internal",
                                                  "message": str(e)}}
            if hasattr(payload, "__aiter__"):
                await self._write_stream(writer, status, payload)
            else:
                await self._write_json(writer, status, payload)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader):
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) < 2:
            return None
        method, path = parts[0], parts[1]
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        n = min(int(headers.get("content-length", 0) or 0), _MAX_BODY)
        body = None
        if n:
            raw = await reader.readexactly(n)
            try:
                body = json.loads(raw)
            except json.JSONDecodeError:
                body = None
        return method, path, body

    @staticmethod
    async def _write_json(writer: asyncio.StreamWriter, status: int,
                          payload: dict) -> None:
        doc = json.dumps(payload).encode("utf-8")
        writer.write(
            f"HTTP/1.1 {status} {_reason(status)}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(doc)}\r\n"
            f"Connection: close\r\n\r\n".encode("latin-1") + doc)
        await writer.drain()

    @staticmethod
    async def _write_stream(writer: asyncio.StreamWriter, status: int,
                            agen) -> None:
        writer.write(
            f"HTTP/1.1 {status} {_reason(status)}\r\n"
            f"Content-Type: text/event-stream\r\n"
            f"Cache-Control: no-cache\r\n"
            f"Connection: close\r\n\r\n".encode("latin-1"))
        await writer.drain()
        async for chunk in agen:
            writer.write(chunk.encode("utf-8"))
            await writer.drain()           # one flush per token chunk


def _reason(status: int) -> str:
    return {200: "OK", 400: "Bad Request", 404: "Not Found",
            409: "Conflict", 429: "Too Many Requests",
            500: "Internal Server Error"}.get(status, "OK")


async def serve_engine(engine, host: str = "127.0.0.1", port: int = 8080,
                       *, max_pending: int = 64,
                       router: Optional[SessionRouter] = None,
                       ready: Optional[asyncio.Event] = None,
                       stop: Optional[asyncio.Event] = None):
    """Wire pump → router → api → socket and serve until cancelled or
    ``stop`` is set; tears the stack down in reverse (socket, pump
    quiesce, engine.close). The pump builds the CUDA kernels before it
    starts; once the socket listens, the line ``front door listening on
    http://HOST:PORT`` names the bound port and ``ready`` is set. An
    engine the front door cannot serve (``api.unservable``) raises
    ``ValueError`` before anything listens."""
    pump = EnginePump(engine, max_pending=max_pending)
    try:
        api = FrontDoor(pump, router)
    except ValueError:
        engine.close()
        raise
    pump.start()
    srv = HttpFrontDoor(api, host, port)
    try:
        await srv.start()
        print(f"front door listening on http://{host}:{srv.port} "
              f"(model {api.model_name})", flush=True)
        if ready is not None:
            ready.set()
        await (stop if stop is not None else asyncio.Event()).wait()
    finally:
        await srv.close()
        pump.close()
