"""Engine pump: drives ``InferenceEngine.step()`` on a background thread
and fans emitted tokens out to per-request async queues (DESIGN.md §14;
the JAX package's ``frontend/pump.py`` over the port's engine).

Threading model — exactly two sides touch the engine:

* the **pump thread** owns every engine call: it drains an inbox of
  submitted requests, runs ``engine.step()`` while any work is pending,
  executes deferred calls (``call`` — the router's fork path runs here),
  and sleeps on a condition variable when idle (no busy-spin between
  request arrivals). The engine's ``on_token``/``on_finish``/``on_pause``
  callbacks therefore fire on this thread;
* the **event loop** (or any other thread) only enqueues: ``submit``
  appends to the inbox and wakes the pump; token fan-out crosses back via
  ``loop.call_soon_threadsafe`` into each request's ``asyncio.Queue``.

PyTorch keeps grad mode, the current device and the current stream per
thread, so the pump thread sets them itself: no autograd recording
(``torch.no_grad``), and on a card the device of the engine's model and
the stream that was current on the thread that built the pump (the
restoration's compute stream is the caller's current stream). ``start``
builds the CUDA kernels before the thread starts, so no request waits
for the compiler. With a ``CapacityManager`` on the engine, the pump
thread attaches itself as the engine's thread, so store pressure is
reclaimed there.

Backpressure: ``submit`` raises ``Overloaded`` once the number of
unfinished requests (inbox + engine queue + resident) reaches
``max_pending`` — the API layer maps that to HTTP 429 / ``overloaded``.

Failure: an exception inside ``engine.step()`` (or a deferred call's
engine work) ends the pump thread. Every open subscription finishes with
reason ``"error"`` and the exception in ``Subscription.error``, pending
deferred calls fail with it, later ``submit``/``call`` raise
``EngineFailed``, and ``close()`` re-raises it after closing the engine.
Nothing is caught and carried on past. A request the engine refuses at
``submit`` (its own validation) finishes alone with that error.

``close()`` quiesces (finishes in-flight work unless ``force``), stops
the thread, drains the two-stage saver and calls ``engine.close()`` — a
clean shutdown leaks no threads.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from repro_torch.serving.request import Request


class Overloaded(RuntimeError):
    """Queue-depth cap reached; shed the request (HTTP 429)."""


class EngineFailed(RuntimeError):
    """The engine raised on the pump thread; the pump serves no more."""


class Subscription:
    """Per-request fan-out endpoint. The pump posts ``("token", id)``,
    ``("pause", None)`` and a final ``("finish", reason)`` event (reason
    ``"stop"``, ``"length"`` or ``"error"``, with the exception in
    ``error``); with an event loop attached the same events also land in
    ``queue`` for async consumption. Timestamps are perf_counter at post
    time."""

    def __init__(self, request: Request,
                 loop: Optional[asyncio.AbstractEventLoop] = None):
        self.request = request
        self.loop = loop
        self.queue: Optional[asyncio.Queue] = (
            asyncio.Queue() if loop is not None else None)
        self.tokens: List[int] = []
        self.token_times: List[float] = []
        self.submit_time = time.perf_counter()
        self.finish_time: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.pauses = 0
        self.done = threading.Event()
        self.meta: dict = {}       # API/router context (route decision)

    @property
    def first_token_time(self) -> Optional[float]:
        return self.token_times[0] if self.token_times else None

    @property
    def ttft(self) -> Optional[float]:
        if not self.token_times:
            return None
        return self.token_times[0] - self.submit_time

    @property
    def tbt(self) -> List[float]:
        return [b - a for a, b in zip(self.token_times,
                                      self.token_times[1:])]

    def post(self, event) -> None:
        kind, _ = event
        if kind == "token":
            self.tokens.append(event[1])
            self.token_times.append(time.perf_counter())
        elif kind == "pause":
            self.pauses += 1
        elif kind == "finish":
            self.finish_time = time.perf_counter()
            self.finish_reason = event[1]
        if self.queue is not None and self.loop is not None:
            try:
                self.loop.call_soon_threadsafe(self.queue.put_nowait,
                                               event)
            except RuntimeError:
                pass               # loop already closed: keep bookkeeping
        if kind == "finish":
            self.done.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.post(("finish", "error"))

    async def events(self):
        """Async iterator over events through the final ``finish``."""
        if self.queue is None:
            raise RuntimeError("subscription has no event loop attached")
        while True:
            ev = await self.queue.get()
            yield ev
            if ev[0] == "finish":
                return

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


class EnginePump:
    def __init__(self, engine, *, max_pending: int = 64,
                 idle_wait: float = 0.05):
        self.engine = engine
        self.max_pending = int(max_pending)
        self.idle_wait = float(idle_wait)
        self._subs: Dict[int, Subscription] = {}   # request_id -> sub
        self._inbox: deque = deque()
        self._calls: deque = deque()
        self._cond = threading.Condition()
        self._stop = False
        self._force_stop = False
        self.error: Optional[BaseException] = None
        self.on_request_finished = None            # fn(sub), pump thread
        device = torch.device(getattr(engine.model, "device", "cpu"))
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._stream = (torch.cuda.current_stream(device)
                        if device.type == "cuda" else None)
        engine.on_token = self._on_token
        engine.on_finish = self._on_finish
        engine.on_pause = self._on_pause
        self._thread = threading.Thread(target=self._run,
                                        name="engine-pump", daemon=True)
        self.closed = False

    # ------------------------------------------------------------- ingress
    def start(self) -> "EnginePump":
        if self.device.type == "cuda":
            from repro_torch.kernels._build import library
            library()                 # build before any request waits
        self._thread.start()
        return self

    def pending(self) -> int:
        """Unfinished requests anywhere in the pipeline."""
        return len(self._inbox) + len(self._subs)

    def _raise_if_failed(self) -> None:
        if self.error is not None:
            raise EngineFailed(f"the engine failed: {self.error!r}") \
                from self.error

    def submit(self, request: Request,
               loop: Optional[asyncio.AbstractEventLoop] = None)\
            -> Subscription:
        """Thread-safe ingress. Raises ``Overloaded`` at the queue-depth
        cap and ``EngineFailed`` once the engine has raised. Pass
        ``loop`` (or call from a running loop) to receive events on an
        asyncio queue as well."""
        if loop is None:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                loop = None
        with self._cond:
            self._raise_if_failed()
            if self.closed or self._stop:
                raise RuntimeError("pump is closed")
            if self.pending() >= self.max_pending:
                raise Overloaded(
                    f"{self.pending()} requests pending "
                    f"(max_pending={self.max_pending})")
            request.arrival_time = time.perf_counter()
            sub = Subscription(request, loop)
            self._subs[request.request_id] = sub
            self._inbox.append(request)
            self._cond.notify()
        return sub

    def call(self, fn, *args, **kw) -> concurrent.futures.Future:
        """Run ``fn`` on the pump thread between engine steps (engine
        internals are single-threaded — the router's fork path must not
        race ``step()``). Executes inline when the pump isn't running."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._cond:
            if self.error is not None:
                fut.set_exception(EngineFailed(
                    f"the engine failed: {self.error!r}"))
                return fut
            if self._thread.is_alive():
                self._calls.append((fut, fn, args, kw))
                self._cond.notify()
                return fut
        try:
            fut.set_result(fn(*args, **kw))
        except BaseException as e:       # noqa: BLE001 - relayed
            fut.set_exception(e)
        return fut

    # ----------------------------------------------------------- callbacks
    def _on_token(self, seq, tok: int) -> None:
        sub = self._subs.get(seq.request.request_id)
        if sub is not None:
            sub.post(("token", int(tok)))

    def _on_pause(self, seq) -> None:
        sub = self._subs.get(seq.request.request_id)
        if sub is not None:
            sub.post(("pause", None))

    def _on_finish(self, seq, reason: str) -> None:
        sub = self._subs.pop(seq.request.request_id, None)
        if sub is None:
            return
        if self.on_request_finished is not None:
            self.on_request_finished(sub)
        sub.post(("finish", reason))

    # ----------------------------------------------------------- main loop
    def _engine_busy(self) -> bool:
        eng = self.engine
        return bool(eng.queue) or any(s is not None for s in eng.slots)

    def _work(self) -> bool:
        return bool(self._inbox or self._calls or self._engine_busy())

    def _thread_scope(self) -> contextlib.ExitStack:
        """Grad mode, device and stream of the pump thread."""
        scope = contextlib.ExitStack()
        scope.enter_context(torch.no_grad())
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            scope.enter_context(torch.cuda.stream(self._stream))
        return scope

    def _run(self) -> None:
        try:
            capacity = getattr(self.engine, "capacity", None)
            if capacity is not None:
                capacity.attach_engine(self.engine)
            with self._thread_scope():
                self._loop()
        except BaseException as e:
            self._fail(e)
            raise                 # the thread ends; its hook reports it

    def _submit(self, request: Request) -> None:
        """Hand one request to the engine; a request the engine refuses
        at submit (its state untouched) finishes alone with the error."""
        try:
            self.engine.submit(request)
        except (ValueError, NotImplementedError) as e:
            sub = self._subs.pop(request.request_id, None)
            if sub is not None:
                sub.fail(e)

    def _loop(self) -> None:
        eng = self.engine
        was_busy = False
        while True:
            drain = False
            with self._cond:
                if not self._work() and not self._stop:
                    if was_busy:
                        # quiesce: flush the two-stage saver so stored
                        # state is complete while the engine idles
                        was_busy = False
                        drain = True
                    else:
                        self._cond.wait(timeout=self.idle_wait)
                if self._stop and (self._force_stop or not self._work()):
                    break
                inbox, self._inbox = list(self._inbox), deque()
                calls, self._calls = list(self._calls), deque()
            for request in inbox:
                self._submit(request)
            if drain:
                eng.mgr.saver.drain()
            for fut, fn, args, kw in calls:
                if fut.set_running_or_notify_cancel():
                    try:
                        fut.set_result(fn(*args, **kw))
                    except BaseException as e:   # noqa: BLE001 - relayed
                        fut.set_exception(e)
            if self._engine_busy():
                eng.step()
                was_busy = True

    def _fail(self, error: BaseException) -> None:
        """The pump thread's end after an engine exception: every open
        subscription and pending call gets the error."""
        with self._cond:
            self.error = error
            subs = list(self._subs.values())
            self._subs.clear()
            self._inbox.clear()
            calls, self._calls = list(self._calls), deque()
        for fut, *_ in calls:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(EngineFailed(
                    f"the engine failed: {error!r}"))
        for sub in subs:
            sub.fail(error)

    # ------------------------------------------------------------ shutdown
    def close(self, force: bool = False, timeout: float = 60.0) -> None:
        """Quiesce (unless ``force``), stop the pump thread, drain the
        saver, close the engine; then re-raise the engine's exception if
        the pump thread died of one. Idempotent."""
        if self.closed:
            return
        with self._cond:
            self._stop = True
            self._force_stop = force
            self._cond.notify()
        if self._thread.is_alive():
            self._thread.join(timeout)
        self.closed = True
        try:
            self.engine.mgr.saver.drain()
        finally:
            self.engine.close()
        if self.error is not None:
            raise EngineFailed(f"the engine failed: {self.error!r}") \
                from self.error
