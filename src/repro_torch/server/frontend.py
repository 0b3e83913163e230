"""Async streaming HTTP frontend over the continuous-batching ``ServeEngine``.

Stdlib-only (asyncio + a hand-rolled HTTP/1.1 layer — no Flask/aiohttp
dependency), built for throughput: the asyncio event loop only parses
requests and shuttles bytes, while ONE pump thread owns every torch call and
every CUDA launch and drives ``ServeEngine.step()`` continuously.  Handlers
talk to the engine through the scheduler's admission queue; per-token
streaming rides the ``Request.on_token``/``on_finish`` callbacks, which hop
thread -> event loop via ``loop.call_soon_threadsafe`` into a per-request
``asyncio.Queue``.

Endpoints:

``POST /v1/generate``
    Body ``{"prompt": [ints], "max_new_tokens": n, "priority":
    "low|normal|high", "deadline_s": s}``.  Streams newline-delimited JSON
    (chunked transfer encoding): one ``{"token": t}`` line per generated
    token, then a final ``{"done": true, "status": ..., "n_tokens": ...,
    "ttft_s": ...}`` summary line.  Headers are deferred until the first
    engine event, so a request shed *after* admission (deadline expiry,
    displaced by a higher tier) still gets a clean ``503`` instead of an
    empty 200 stream.

``GET /healthz``
    Queue depth, shed/admission counters, and drain state as JSON — the
    load-balancer view of backpressure.

``GET /metrics``
    Prometheus text exposition of the engine's ``repro_torch.obs``
    registry (TTFT/queue-wait histograms, queue depth, flag/replay rates,
    energy/token, guard events).  Lock-free: a scrape never blocks the
    pump thread and never touches torch or the device.

``GET /v1/stats``
    The same registry as JSON, plus the full ``EngineStats`` view and
    health payload — what an autoscaler polls.

Overload behaviour is the scheduler's: with ``ServeEngine(policy="priority",
max_pending=N)`` a full queue sheds (HTTP 503 with shed telemetry) rather
than buffering unboundedly, and expired TTFT SLOs shed queued requests
before they waste decode slots.  ``drain()`` stops admission (503
``draining``) but finishes every already-admitted stream before ``close()``
tears the pump down — a rolling-restart never clips a live response.

Counterpart of ``repro.server.frontend``.  On a GPU the pump thread first
makes the engine's device current in itself (PyTorch keeps the current
device and stream per thread), so every kernel launches on that device's
default stream, the one the engine's parameters and state were made on.
``on_token`` hands the event loop the ``int`` the engine emits; the scrapes
read Python numbers only (registry floats, ``EngineStats``' lists), so a
scrape never waits on the device.  A CUDA error or a kernel build failure
inside a step stops the pump like any other error: ``_fail_open`` ends every
stream, ``/healthz`` reports ``pump_alive: false`` and ``close()`` re-raises.
One difference: handlers never take a lock.  A handler puts its request and
a future on the pump's inbox and awaits the future; the pump submits every
request in the inbox before each step.  A submission so waits at most one
model step, and the event loop none: the reference's handler blocks the loop
on the pump's lock, which the pump re-takes at once and can hold against it
for many steps.  A request that reaches a stopped pump gets a ``503``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import itertools
import json
import queue
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from ..serve import Priority, Request

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            503: "Service Unavailable"}


#: 503 responses advertise this via ``Retry-After`` so well-behaved clients
#: (``repro_torch.server.client.RetryPolicy`` honours it) back off together.
RETRY_AFTER_S = 1


def _json_response(status: int, obj: Dict[str, Any],
                   headers: Optional[Dict[str, str]] = None) -> bytes:
    body = json.dumps(obj).encode()
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    return (f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"{extra}Connection: close\r\n\r\n").encode() + body


def _unavailable(obj: Dict[str, Any]) -> bytes:
    """503 with the backpressure header every shed/overload path shares."""
    return _json_response(503, obj,
                          headers={"Retry-After": str(RETRY_AFTER_S)})


def _text_response(status: int, text: str,
                   content_type: str = "text/plain; charset=utf-8") -> bytes:
    body = text.encode()
    return (f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n").encode() + body


#: Content type of the Prometheus text exposition format.
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class ServeFrontend:
    """Asyncio HTTP server wrapping one ``ServeEngine``."""

    def __init__(self, engine, pump_idle_s: float = 0.005,
                 request_timeout_s: Optional[float] = None):
        self.engine = engine
        self._pump_idle_s = pump_idle_s
        # wall-clock budget per /v1/generate request (None: unbounded).  On
        # expiry the request is cancelled — the engine reaps its slot — and
        # the client sees a 503 (pre-stream) or a terminal "cancelled" line.
        self._request_timeout_s = request_timeout_s
        # handler submissions, (request, future) pairs: only the pump mutates
        # the scheduler, and it takes them between steps, so a submission
        # waits at most one model call and the event loop never waits
        self._inbox: queue.SimpleQueue = queue.SimpleQueue()
        self._pump_done = False
        self._work = threading.Event()
        self._stop = threading.Event()
        self._pump_error: Optional[BaseException] = None
        self._draining = False
        self._uids = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.address: Optional[Tuple[str, int]] = None

    # ---- engine pump (the only thread that touches torch) --------------------

    def _pump(self) -> None:
        try:
            dev = getattr(self.engine, "device", None)
            if dev is not None and dev.type == "cuda":
                torch.cuda.set_device(dev)
            while not self._stop.is_set():
                self._take_submissions()
                if not self.engine.scheduler.drained():
                    self.engine.step()
                else:
                    self._work.wait(self._pump_idle_s)
                    self._work.clear()
        except BaseException as e:            # surface, never die silently
            self._pump_error = e
            self._fail_open()
        finally:
            # a handler that finds ``_pump_done`` set after its put answers
            # itself; one that does not is answered here
            self._pump_done = True
            self._refuse_submissions()

    def _take_submissions(self) -> None:
        """Submit every request in the inbox (pump thread)."""
        while True:
            try:
                req, fut = self._inbox.get_nowait()
            except queue.Empty:
                return
            try:
                fut.set_result(self.engine.submit(req))
            except Exception as e:            # the handler's error, not ours
                fut.set_exception(e)

    def _refuse_submissions(self) -> None:
        """Answer every request in the inbox of a stopped pump with None."""
        while True:
            try:
                _, fut = self._inbox.get_nowait()
            except queue.Empty:
                return
            fut.set_result(None)

    def _fail_open(self) -> None:
        """The pump died: terminate every live stream cleanly instead of
        leaving clients blocked on an events queue that will never fill.
        ``fire_finish`` is idempotent, so this cannot double-deliver."""
        sched = self.engine.scheduler
        for req in list(sched.active.values()) + list(sched.pending):
            if not req.done:
                req.done = req.truncated = True
            req.fire_finish()

    # ---- lifecycle -----------------------------------------------------------

    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> Tuple[str, int]:
        """Bind and start serving; returns the (host, port) actually bound
        (port 0 picks an ephemeral port)."""
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="serve-engine-pump")
        self._thread.start()
        self._server = await asyncio.start_server(self._handle, host, port)
        self.address = self._server.sockets[0].getsockname()[:2]
        return self.address

    async def drain(self, timeout_s: float = 60.0) -> bool:
        """Graceful drain: stop admitting, finish every in-flight request.
        Returns True when the engine fully drained within the timeout."""
        self._draining = True
        self._work.set()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        # racy read by design: drained() only inspects container emptiness
        while not self.engine.scheduler.drained():
            if self._pump_error is not None or loop.time() > deadline:
                return False
            await asyncio.sleep(0.005)
        return True

    async def close(self) -> None:
        """Stop the pump and the listener (call ``drain()`` first for a
        graceful shutdown)."""
        self._stop.set()
        self._work.set()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._thread is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._thread.join)
        if self._pump_error is not None:
            raise self._pump_error

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        await self._server.serve_forever()

    # ---- telemetry -----------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        s, sched = self.engine.stats, self.engine.scheduler
        return {
            "status": "draining" if self._draining else "ok",
            "pending": sched.n_pending,
            "active": sched.n_active,
            "slots": sched.slots,
            "policy": sched.policy,
            "max_pending": sched.max_pending,
            "admitted": s.admitted,
            "completed": s.completed,
            "truncated": s.truncated,
            "shed": sched.n_shed,
            "cancelled": s.cancelled,
            "pump_alive": self._pump_error is None,
            "shed_rate": sched.n_shed / max(s.admitted + sched.n_shed
                                            + sched.n_pending, 1),
            "tokens_generated": s.tokens_generated,
            "decode_steps": s.decode_steps,
            "backend": s.backend,
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition of the engine's ObsBus registry.

        Runs on the asyncio thread while the pump steps — racy read by
        design, same as ``drain()``: registry cells are plain floats
        behind the registry's own fine-grained lock (never held across a
        torch call), so a scrape can never stall the pump mid-step."""
        obs = getattr(self.engine, "obs", None)
        if obs is None:
            return ""
        return obs.registry.render_prometheus()

    def stats_json(self) -> Dict[str, Any]:
        """JSON twin of ``/metrics``: health + the full EngineStats view +
        the raw registry.  Lock-free for the same reason as
        :meth:`metrics_text`; ``to_dict`` only reads python lists and
        registry counters, never a tensor."""
        obs = getattr(self.engine, "obs", None)
        return {
            "health": self.health(),
            "engine": self.engine.stats.to_dict(),
            "metrics": obs.registry.render_json() if obs is not None else {},
        }

    # ---- HTTP plumbing -------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            method, path, headers, body = await self._read_request(reader)
            if method == "GET" and path == "/healthz":
                writer.write(_json_response(200, self.health()))
            elif method == "GET" and path == "/metrics":
                writer.write(_text_response(200, self.metrics_text(),
                                            PROMETHEUS_CONTENT_TYPE))
            elif method == "GET" and path == "/v1/stats":
                writer.write(_json_response(200, self.stats_json()))
            elif method == "POST" and path == "/v1/generate":
                await self._generate(writer, body)
            else:
                writer.write(_json_response(
                    404, {"error": f"no route {method} {path}"}))
            await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError):
            pass                               # client went away mid-stream
        except ValueError as e:
            try:
                writer.write(_json_response(400, {"error": str(e)}))
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader):
        line = (await reader.readline()).decode("latin-1").strip()
        if not line:
            raise asyncio.IncompleteReadError(b"", None)
        try:
            method, path, _ = line.split(None, 2)
        except ValueError:
            raise ValueError(f"malformed request line {line!r}")
        headers: Dict[str, str] = {}
        while True:
            raw = await reader.readline()
            if raw in (b"\r\n", b"\n", b""):
                break
            key, _, val = raw.decode("latin-1").partition(":")
            headers[key.strip().lower()] = val.strip()
        n = int(headers.get("content-length", "0") or 0)
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body

    # ---- streaming generation ------------------------------------------------

    def _parse_generate(self, body: bytes) -> Request:
        try:
            payload = json.loads(body or b"{}")
        except json.JSONDecodeError as e:
            raise ValueError(f"invalid JSON body: {e}")
        prompt = payload.get("prompt", [])
        if not isinstance(prompt, list) or \
                not all(isinstance(t, int) for t in prompt):
            raise ValueError("prompt must be a list of token ids")
        try:
            priority = Priority[str(payload.get("priority", "normal")).upper()]
        except KeyError:
            raise ValueError(f"unknown priority {payload.get('priority')!r}")
        deadline = payload.get("deadline_s")
        return Request(
            uid=next(self._uids), prompt=prompt,
            max_new_tokens=int(payload.get("max_new_tokens", 8)),
            priority=priority,
            deadline_s=None if deadline is None else float(deadline))

    async def _submit(self, req: Request) -> Optional[bool]:
        """``engine.submit`` on the pump thread, awaited on the event loop:
        True admitted, False shed on admission, None the pump has stopped."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._inbox.put((req, fut))
        self._work.set()
        if self._pump_done:
            self._refuse_submissions()
        return await asyncio.wrap_future(fut)

    async def _next_event(self, events: asyncio.Queue, deadline: Optional[float],
                          loop: asyncio.AbstractEventLoop):
        if deadline is None:
            return await events.get()
        return await asyncio.wait_for(events.get(),
                                      max(deadline - loop.time(), 0.0))

    async def _generate(self, writer: asyncio.StreamWriter,
                        body: bytes) -> None:
        req = self._parse_generate(body)
        if self._draining:
            writer.write(_unavailable({"error": "draining", "uid": req.uid}))
            return
        loop = asyncio.get_running_loop()
        deadline = (None if self._request_timeout_s is None
                    else loop.time() + self._request_timeout_s)
        events: asyncio.Queue = asyncio.Queue()
        req.on_token = lambda r, tok: loop.call_soon_threadsafe(
            events.put_nowait, ("token", tok))
        req.on_finish = lambda r: loop.call_soon_threadsafe(
            events.put_nowait, ("finish", None))
        accepted = await self._submit(req)
        if accepted is None:
            writer.write(_unavailable({"error": "engine stopped",
                                       "uid": req.uid}))
            return
        if not accepted:
            writer.write(_unavailable(self._shed_payload(req)))
            return
        # defer the status line until the engine says something: a request
        # shed from the queue gets a 503, not an empty 200 stream
        try:
            kind, tok = await self._next_event(events, deadline, loop)
        except asyncio.TimeoutError:
            req.cancelled = True               # engine reaps the slot/queue
            self._work.set()
            writer.write(_unavailable(
                {"error": "timeout", "uid": req.uid, "status": "cancelled",
                 "timeout_s": self._request_timeout_s}))
            return
        if kind == "finish" and req.shed:
            writer.write(_unavailable(self._shed_payload(req)))
            return
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: application/x-ndjson\r\n"
                     b"Transfer-Encoding: chunked\r\n"
                     b"Connection: close\r\n\r\n")
        try:
            while True:
                if kind == "token":
                    await self._chunk(writer, {"token": tok})
                elif kind == "finish":
                    await self._chunk(writer, {
                        "done": True, "uid": req.uid, "status": req.status,
                        "n_tokens": len(req.out_tokens),
                        "ttft_s": req.ttft_s,
                        "deadline_met": req.deadline_met(),
                    })
                    break
                try:
                    kind, tok = await self._next_event(events, deadline, loop)
                except asyncio.TimeoutError:
                    req.cancelled = True
                    self._work.set()
                    await self._chunk(writer, {
                        "done": True, "uid": req.uid, "status": "cancelled",
                        "n_tokens": len(req.out_tokens),
                        "error": "timeout",
                        "timeout_s": self._request_timeout_s})
                    break
        except (ConnectionResetError, BrokenPipeError):
            # client went away mid-stream: release the decode slot
            req.cancelled = True
            self._work.set()
            raise
        writer.write(b"0\r\n\r\n")             # chunked stream terminator

    def _shed_payload(self, req: Request) -> Dict[str, Any]:
        return {"error": "overloaded", "uid": req.uid, "status": "shed",
                "reason": req.shed_reason,
                "shed_rate": self.health()["shed_rate"]}

    @staticmethod
    async def _chunk(writer: asyncio.StreamWriter, obj: Dict[str, Any]) -> None:
        data = (json.dumps(obj) + "\n").encode()
        writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        await writer.drain()
