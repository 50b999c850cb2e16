"""Stdlib HTTP/SSE front-end over the always-on async engine.

The paper's users reach Isambard-AI through web front-ends, so the serving
stack terminates HTTP itself: one ``asyncio.start_server`` acceptor shares
the event loop with ``AsyncEngine``'s stepping task — no framework, no extra
dependency, one process.  Endpoints:

* ``POST /v1/generate`` — body ``{"prompt": [ints], "max_new_tokens": 16,
  "temperature": 0.0, "top_k": 0, "priority": 0, "deadline_s": null,
  "online": true, "stream": true}``.  With ``stream`` (the default) the
  response is Server-Sent Events: one ``event: token`` frame per emission
  batch (``data`` carries ``{"tokens": [...], "index": N}``) and a final
  ``event: done`` frame with the finish summary; the connection closes
  after ``done`` (``Connection: close`` — no chunked framing needed).
  With ``"stream": false`` the full completion returns as one JSON object.
* ``GET /metrics`` — the registry in Prometheus text exposition format;
  under a multi-replica router, each replica engine's registry renders too,
  prefixed ``replica<N>_``.
* ``GET /stats`` — ``engine.stats()`` as JSON.
* ``GET /healthz`` — readiness probe: 200 while the service can accept
  work, 503 while draining or with no admittable replica; the body reports
  per-replica lifecycle states under a router.

Hardening (the paper's front-ends face real browsers):

* Malformed framing, bad ``Content-Length``, oversized headers/bodies and
  non-JSON payloads all return a structured ``{"error": ...}`` 400 — a
  client can never crash the acceptor with a reader exception.
* A client that disconnects mid-stream aborts its request: the SSE loop's
  failed write closes the stream generator, whose teardown cancels the
  engine request and frees its blocks — no generating into a dead socket.
* Submissions during shutdown / degraded mode (``ServiceUnavailable``)
  return 503.

Request knob validation happens in ``engine.submit`` (negative
``max_new_tokens``/``priority``, non-positive ``deadline_s``, empty or
oversized prompts) and surfaces as a 400 with the error message.

The parser handles exactly what the front-end needs — request line, headers,
``Content-Length`` bodies — and rejects everything else; it is a serving
research harness, not a hardened proxy (deploy behind one for anything
public-facing).

A copy of the JAX package's ``serving/http.py`` but for the order of
``HttpFrontend.shutdown``.  Since Python 3.12.1 ``Server.wait_closed()``
waits for every open connection to close, so the reference's order (close
the acceptor, wait for it, then drain the engine) streams every open
request to its end before admission stops: no 503 while draining, and the
drain's hard timeout does not bound the wait.  Here the engine drains
first, with the acceptor closed, and the connections are awaited after.
"""

from __future__ import annotations

import asyncio
import json
import signal
from typing import Callable, Optional

from repro_torch.serving.async_engine import AsyncEngine
from repro_torch.serving.faults import ServiceUnavailable

MAX_HEADER_BYTES = 16384
MAX_BODY_BYTES = 4 * 1024 * 1024

_STATUS = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    413: "Payload Too Large",
    500: "Internal Server Error",
    503: "Service Unavailable",
}


def _head(status: int, content_type: str, *, length: Optional[int] = None) -> bytes:
    lines = [
        f"HTTP/1.1 {status} {_STATUS.get(status, 'Unknown')}",
        f"Content-Type: {content_type}",
        "Connection: close",
        "Cache-Control: no-store",
    ]
    if length is not None:
        lines.append(f"Content-Length: {length}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


def _sse_frame(event: str, data: dict) -> bytes:
    return f"event: {event}\ndata: {json.dumps(data)}\n\n".encode()


async def _respond_json(writer: asyncio.StreamWriter, status: int, obj: dict) -> None:
    body = (json.dumps(obj) + "\n").encode()
    writer.write(_head(status, "application/json", length=len(body)) + body)
    await writer.drain()


async def _read_request(reader: asyncio.StreamReader):
    """Parse one request: (method, path, headers, body) or None on EOF."""
    head = await reader.readuntil(b"\r\n\r\n")
    if len(head) > MAX_HEADER_BYTES:
        raise ValueError("headers too large")
    lines = head.decode("latin-1").split("\r\n")
    method, path, _ = lines[0].split(" ", 2)
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    try:
        n = int(headers.get("content-length", 0))
    except (TypeError, ValueError):
        raise ValueError("invalid Content-Length") from None
    if n < 0:
        raise ValueError("invalid Content-Length")
    if n > MAX_BODY_BYTES:
        raise ValueError(f"body too large ({n} > {MAX_BODY_BYTES} bytes)")
    body = await reader.readexactly(n) if n else b""
    return method, path, headers, body


class HttpFrontend:
    """One-process HTTP/SSE service over an ``AsyncEngine``.

    ``port=0`` binds an ephemeral port (tests); after ``start()`` the bound
    port is in ``self.port``.
    """

    def __init__(self, async_engine: AsyncEngine, host: str = "127.0.0.1", port: int = 8080):
        self.async_engine = async_engine
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self.async_engine.start()
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        await self.async_engine.stop()

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        async with self._server:
            await self._server.serve_forever()

    async def shutdown(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: close the acceptor (no new connections),
        drain the engine (in-flight requests finish; new submissions and
        ``/healthz`` on already-open connections get 503), stop the
        stepping loop, then wait for the open connections to close.
        Returns True when the drain beat the hard ``timeout`` (requests
        still open then end with an ``"error"`` finish)."""
        server, self._server = self._server, None
        if server is not None:
            server.close()
        drained = await self.async_engine.shutdown(timeout)
        if server is not None:
            await server.wait_closed()
        return drained

    # -- request handling ----------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            try:
                parsed = await _read_request(reader)
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            except (ValueError, asyncio.LimitOverrunError) as e:
                await _respond_json(writer, 400, {"error": str(e)})
                return
            method, path, _, body = parsed
            if path == "/healthz":
                await self._healthz(writer)
            elif path == "/metrics":
                if method != "GET":
                    await _respond_json(writer, 405, {"error": "GET only"})
                    return
                eng = self.async_engine.engine
                text = eng.metrics.render_text()
                # router fleet: append every replica engine's registry with
                # a replica<N>_ name prefix (one scrape, no collisions)
                for rep in getattr(eng, "replicas", ()):
                    text += rep.engine.metrics.render_text(prefix=f"replica{rep.id}_")
                data = text.encode()
                writer.write(_head(200, "text/plain; version=0.0.4", length=len(data)) + data)
                await writer.drain()
            elif path == "/stats":
                await _respond_json(writer, 200, self.async_engine.engine.stats())
            elif path == "/v1/generate":
                if method != "POST":
                    await _respond_json(writer, 405, {"error": "POST only"})
                    return
                await self._generate(writer, body)
            else:
                await _respond_json(writer, 404, {"error": f"no route {path}"})
        except ConnectionError:
            pass  # client went away mid-stream
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except ConnectionError:
                pass

    async def _healthz(self, writer: asyncio.StreamWriter) -> None:
        """Readiness: 200 while the service can accept a request, 503 while
        draining or with every replica out of rotation.  Under a router the
        body carries per-replica lifecycle states."""
        eng = self.async_engine.engine
        draining = self.async_engine.draining
        replicas = getattr(eng, "replicas", None)
        if replicas is None:
            body = {"ok": not draining, "draining": draining}
        else:
            states = {str(r.id): r.state.value for r in replicas}
            ok = not draining and any(r.admittable for r in replicas)
            body = {"ok": ok, "draining": draining, "replicas": states}
        await _respond_json(writer, 200 if body["ok"] else 503, body)

    async def _generate(self, writer: asyncio.StreamWriter, body: bytes) -> None:
        try:
            payload = json.loads(body.decode() or "{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            prompt = payload.get("prompt")
            if not isinstance(prompt, list) or not all(isinstance(t, int) for t in prompt):
                raise ValueError("prompt must be a list of token ids")
            kw = dict(
                max_new_tokens=int(payload.get("max_new_tokens", 16)),
                online=bool(payload.get("online", True)),
                temperature=float(payload.get("temperature", 0.0)),
                top_k=int(payload.get("top_k", 0)),
                priority=int(payload.get("priority", 0)),
                deadline_s=(
                    None if payload.get("deadline_s") is None else float(payload["deadline_s"])
                ),
            )
            stream = bool(payload.get("stream", True))
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            await _respond_json(writer, 400, {"error": str(e)})
            return

        if not stream:
            try:
                final, toks = await self.async_engine.generate(prompt, **kw)
            except ServiceUnavailable as e:  # draining / degraded fleet
                await _respond_json(writer, 503, {"error": str(e)})
                return
            except ValueError as e:  # submit() validation
                await _respond_json(writer, 400, {"error": str(e)})
                return
            await _respond_json(
                writer,
                200,
                {
                    "req_id": final.req_id,
                    "tokens": toks,
                    "reason": final.reason,
                    "ttft_s": final.ttft_s,
                    "preemptions": final.preemptions,
                },
            )
            return

        gen = self.async_engine.submit_stream(prompt, **kw)
        try:
            try:
                first = await gen.__anext__()
            except ServiceUnavailable as e:  # draining / degraded fleet
                await _respond_json(writer, 503, {"error": str(e)})
                return
            except ValueError as e:  # submit() validation
                await _respond_json(writer, 400, {"error": str(e)})
                return
            # headers go out only once submission succeeded; each event frame
            # is drained immediately so tokens reach the client as emitted
            writer.write(_head(200, "text/event-stream"))
            await writer.drain()
            ev = first
            while True:
                if ev.kind == "token":
                    writer.write(
                        _sse_frame("token", {"req_id": ev.req_id, "tokens": list(ev.tokens), "index": ev.index})
                    )
                else:
                    writer.write(
                        _sse_frame(
                            "done",
                            {
                                "req_id": ev.req_id,
                                "reason": ev.reason,
                                "n_tokens": ev.n_tokens,
                                "ttft_s": ev.ttft_s,
                                "preemptions": ev.preemptions,
                            },
                        )
                    )
                await writer.drain()
                if ev.kind == "finish":
                    break
                ev = await gen.__anext__()
        finally:
            # closing the generator before its finish event cancels the
            # engine request (submit_stream's teardown) — a client that
            # disconnected mid-stream stops consuming slots and blocks
            await gen.aclose()


async def serve_http(
    engine,
    host: str = "127.0.0.1",
    port: int = 8080,
    *,
    metrics_json: Optional[str] = None,
    trace_out: Optional[str] = None,
    drain_timeout_s: float = 10.0,
    shutdown_event: Optional[asyncio.Event] = None,
    on_ready: Optional[Callable[["HttpFrontend"], None]] = None,
) -> None:
    """Blocking entry: wrap ``engine`` (an ``InferenceEngine`` or a
    ``Router`` fleet) in an AsyncEngine + HttpFrontend and serve until
    SIGTERM/SIGINT or ``shutdown_event``.

    Shutdown is graceful: admission stops (503), active requests get up to
    ``drain_timeout_s`` to finish, then ``metrics_json`` / ``trace_out``
    flush — a kill doesn't lose the observability record.  ``on_ready``
    fires with the frontend once the port is bound (tests use it with
    ``port=0``).
    """
    front = HttpFrontend(AsyncEngine(engine), host=host, port=port)
    await front.start()
    print(f"[serve] http/sse listening on http://{front.host}:{front.port}", flush=True)
    stop = shutdown_event if shutdown_event is not None else asyncio.Event()
    loop = asyncio.get_running_loop()
    installed = []
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
            installed.append(sig)
        except (NotImplementedError, RuntimeError, ValueError):
            pass  # non-unix loop or non-main thread: event-only shutdown
    if on_ready is not None:
        on_ready(front)
    try:
        await stop.wait()
        print("[serve] shutdown requested; draining", flush=True)
        drained = await front.shutdown(drain_timeout_s)
        print(f"[serve] drain {'complete' if drained else 'timed out'}", flush=True)
    finally:
        for sig in installed:
            loop.remove_signal_handler(sig)
        await front.stop()
        eng = front.async_engine.engine
        if metrics_json:
            eng.metrics.write_json(metrics_json)
            print(f"[serve] metrics snapshot -> {metrics_json}", flush=True)
        if trace_out:
            eng.tracer.write(trace_out)
            print(f"[serve] chrome trace -> {trace_out}", flush=True)
