"""Always-on asyncio serving loop over the paged engine.

The paper's access model is cloud-style — Jupyter notebooks, MLOps pipelines
and web front-ends submitting continuously — so the engine must serve while
requests *arrive*, not drain a pre-loaded batch.  ``AsyncEngine`` wraps one
``InferenceEngine`` in a single background asyncio task that steps the
scheduler core for as long as there is work and sleeps on an event when
idle; callers get per-token streaming:

* ``submit_stream(prompt, ...)`` — async generator yielding ``StreamEvent``
  records: one ``kind="token"`` event per emission batch (a plain decode
  step yields one token; an accepted speculative window yields several) and
  a final ``kind="finish"`` carrying the reason, TTFT and preemption count.
* ``generate(prompt, ...)`` — convenience await: collects the stream and
  returns ``(finish_event, tokens)``.

Threading model (the engine itself is not thread-safe, so every engine call
is serialized):

* ``engine.step()`` runs on one stepping thread that belongs to this object
  (a one-worker ``ThreadPoolExecutor``, started with the loop and shut down
  by ``stop()``) — the event loop stays responsive to new connections and
  submissions while a step runs.  PyTorch keeps the current device and
  stream per thread, and on the card the first steps build the kernels
  and warm up and capture the fused step's CUDA graphs, which later steps
  replay: all of it stays on one thread, where ``asyncio.to_thread`` could
  hand successive steps to different threads of the loop's default pool.
  ``step_threads`` names the threads that ran steps (one).
* Submissions NEVER touch the engine from a coroutine: they append to an
  inbox and set a wake event; the run loop drains the inbox *between*
  steps (no step is in flight at that point).  ``engine.submit`` is host
  work and runs on the loop thread; an abort frees its request's slot,
  which queues device work (the slot's table row and K/V rows cleared), so
  aborts run on the stepping thread, behind the step that preceded them.
* The engine's ``on_token`` / ``on_finish`` hooks fire on the stepping
  thread mid-step; they forward events into per-request ``asyncio.Queue``s
  with ``loop.call_soon_threadsafe`` — the only cross-thread handoff.
* Whatever the loop thread runs while a step is in flight (an HTTP
  handler reading ``engine.stats()`` or the metrics registry) makes no CUDA
  call: a CUDA call from another thread during a graph capture in the
  default ``"global"`` error mode fails the capture.  ``stats()`` and the
  registry read host state only.

The closed-loop ``engine.run_until_drained()`` drives the exact same
``step()``; this module adds arrival/departure plumbing only, so every
batch-mode test exercises the same scheduling and execution path the
always-on service runs.

Lifecycle extras for production service:

* ``cancel(req_id)`` enqueues an abort that the run loop applies between
  steps (``engine.abort`` frees blocks and prefix refs; the stream gets a
  ``finish`` event with the abort reason).  A consumer that abandons
  ``submit_stream`` mid-flight cancels its request automatically — a dead
  SSE socket stops burning decode slots.
* ``shutdown(timeout)`` is graceful drain: admission stops (new submissions
  raise ``ServiceUnavailable`` → HTTP 503), active requests finish within
  the hard timeout, then the loop stops.  ``launch.serve --http`` wires
  SIGTERM/SIGINT to it.

``engine`` may be a single ``InferenceEngine`` or a ``serving.router
.Router`` fleet — both expose the same ``submit`` / ``step`` / ``abort`` /
``has_work`` / hook surface, so always-on multi-replica serving is the
same loop.  The JAX package's ``serving/async_engine.py`` with the
stepping thread above.
"""

from __future__ import annotations

import asyncio
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import AsyncIterator, Optional

from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.faults import ServiceUnavailable
from repro_torch.serving.scheduler import Request


@dataclass(frozen=True)
class StreamEvent:
    """One streamed serving event.

    ``kind="token"``: ``tokens`` holds the newly emitted token ids and
    ``index`` the position of ``tokens[0]`` in the request's generated
    sequence (speculative decoding emits several tokens per event).
    ``kind="finish"``: ``reason`` is the request's finish reason —
    ``"eos"``/``"length"`` for normal completion, ``"cancelled"`` /
    ``"deadline_exceeded"`` / ``"aborted"`` for aborts, ``"error"`` for a
    failed loop; ``n_tokens`` the final generated length, ``ttft_s`` the
    time to first token and ``preemptions`` how often the request was
    evicted+resumed (failovers, under a router).
    """

    kind: str
    req_id: int
    tokens: tuple = ()
    index: int = 0
    reason: str = ""
    n_tokens: int = 0
    ttft_s: Optional[float] = None
    preemptions: int = 0


class AsyncEngine:
    """One background stepping task + streaming submission over an engine."""

    def __init__(self, engine: InferenceEngine):
        self.engine = engine
        self._inbox: deque = deque()  # tagged ops: ("submit", ...) / ("abort", ...)
        self._streams: dict[int, asyncio.Queue] = {}
        self._wake = asyncio.Event()
        self._idle = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._draining = False
        self._executor: Optional[ThreadPoolExecutor] = None  # the stepping thread
        self.step_threads: set[str] = set()  # names of the threads that ran steps
        engine.on_token = self._on_token
        engine.on_finish = self._on_finish

    # -- engine hooks (called on the stepping thread, mid-step) ---------
    def _on_token(self, req: Request, toks: list[int]) -> None:
        q = self._streams.get(req.req_id)
        if q is None or self._loop is None:
            return
        ev = StreamEvent(
            kind="token",
            req_id=req.req_id,
            tokens=tuple(toks),
            index=len(req.generated) - len(toks),
        )
        self._loop.call_soon_threadsafe(q.put_nowait, ev)

    def _on_finish(self, req: Request) -> None:
        q = self._streams.get(req.req_id)
        if q is None or self._loop is None:
            return
        eos = bool(req.generated) and req.generated[-1] == self.engine.eos
        ev = StreamEvent(
            kind="finish",
            req_id=req.req_id,
            reason=req.finish_reason or ("eos" if eos else "length"),
            n_tokens=len(req.generated),
            ttft_s=req.ttft,
            preemptions=req.preemptions,
        )
        self._loop.call_soon_threadsafe(q.put_nowait, ev)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        """Start the background stepping task (idempotent; needs a running
        event loop).  ``submit_stream`` auto-starts on first use."""
        if self._task is None or self._task.done():
            self._loop = asyncio.get_running_loop()
            if self._executor is None:
                self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="engine-step")
            self._task = self._loop.create_task(self._run(), name="engine-step-loop")

    async def stop(self) -> None:
        """Cancel the stepping task and shut the stepping thread down
        (pending streams are failed with an ``"error"`` finish event)."""
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._executor is not None:
            # a step the cancel interrupted runs to its end on the thread
            executor, self._executor = self._executor, None
            await asyncio.to_thread(executor.shutdown)
        self._fail_streams("error")

    async def __aenter__(self) -> "AsyncEngine":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    async def drain(self) -> None:
        """Wait until the engine has no waiting/active work and the inbox
        is empty (the async analogue of ``run_until_drained``)."""
        await self._idle.wait()

    async def shutdown(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admission (subsequent submissions raise
        ``ServiceUnavailable``), wait for active requests to finish — at
        most ``timeout`` seconds — then stop the loop.  Returns True when
        the drain completed, False when the hard timeout cut it short
        (remaining streams are failed with an ``"error"`` finish)."""
        self._draining = True
        drained = True
        if self._task is not None and not self._task.done():
            try:
                await asyncio.wait_for(self.drain(), timeout)
            except asyncio.TimeoutError:
                drained = False
        await self.stop()
        return drained

    @property
    def draining(self) -> bool:
        return self._draining

    def cancel(self, req_id: int, reason: str = "cancelled") -> None:
        """Abort a request from any thread/coroutine: the run loop applies
        ``engine.abort`` between steps (blocks + prefix refs released, the
        stream receives a ``finish`` event with ``reason``).  Unknown or
        already-finished ids are a no-op."""
        self._inbox.append(("abort", req_id, reason))
        self._idle.clear()
        self._wake.set()

    def _fail_streams(self, reason: str) -> None:
        for req_id, q in list(self._streams.items()):
            q.put_nowait(StreamEvent(kind="finish", req_id=req_id, reason=reason))

    # -- the always-on loop ---------------------------------------------
    def _step(self) -> int:
        self.step_threads.add(threading.current_thread().name)
        return self.engine.step()

    async def _run(self) -> None:
        eng = self.engine
        loop = asyncio.get_running_loop()
        try:
            while True:
                # drain submissions on the loop thread; no step is in
                # flight here, so engine.submit is safe.  Aborts queue
                # device work: they run on the stepping thread
                while self._inbox:
                    op = self._inbox.popleft()
                    if op[0] == "abort":
                        _, req_id, reason = op
                        await loop.run_in_executor(self._executor, eng.abort, req_id, reason)
                        continue
                    _, fut, prompt, kw = op
                    if fut.cancelled():
                        continue
                    try:
                        req = eng.submit(prompt, **kw)
                    except Exception as e:  # validation errors -> caller
                        fut.set_exception(e)
                        continue
                    q: asyncio.Queue = asyncio.Queue()
                    self._streams[req.req_id] = q
                    fut.set_result((req, q))
                if eng.has_work:
                    self._idle.clear()
                    await loop.run_in_executor(self._executor, self._step)
                else:
                    self._idle.set()
                    self._wake.clear()
                    await self._wake.wait()
                    self._idle.clear()
        except asyncio.CancelledError:
            raise
        except Exception:
            # a step blew up: fail every open stream so callers unblock,
            # then surface the error on the task
            self._fail_streams("error")
            raise

    # -- submission ------------------------------------------------------
    async def submit_stream(
        self,
        prompt: list[int],
        *,
        max_new_tokens: int = 32,
        online: bool = True,
        temperature: float = 0.0,
        top_k: int = 0,
        priority: int = 0,
        deadline_s: Optional[float] = None,
    ) -> AsyncIterator[StreamEvent]:
        """Submit a request and stream its events until it finishes.

        Yields ``StreamEvent``s; the last one has ``kind="finish"``.
        Validation errors from ``engine.submit`` raise here; while the
        service drains (``shutdown``) submissions raise
        ``ServiceUnavailable``.  Abandoning the generator before the finish
        event cancels the underlying request (its blocks free instead of
        generating for a consumer that left)."""
        if self._draining:
            raise ServiceUnavailable("service is draining; not accepting requests")
        self.start()
        fut = asyncio.get_running_loop().create_future()
        self._inbox.append(
            (
                "submit",
                fut,
                list(prompt),
                dict(
                    max_new_tokens=max_new_tokens,
                    online=online,
                    temperature=temperature,
                    top_k=top_k,
                    priority=priority,
                    deadline_s=deadline_s,
                ),
            )
        )
        self._idle.clear()
        self._wake.set()
        req, q = await fut
        finished = False
        try:
            while True:
                ev = await q.get()
                yield ev
                if ev.kind == "finish":
                    finished = True
                    return
        finally:
            self._streams.pop(req.req_id, None)
            if not finished:
                self.cancel(req.req_id)

    async def generate(self, prompt: list[int], **kw) -> tuple[StreamEvent, list[int]]:
        """Await a whole request: returns (finish event, generated tokens)."""
        toks: list[int] = []
        final: Optional[StreamEvent] = None
        async for ev in self.submit_stream(prompt, **kw):
            if ev.kind == "token":
                toks.extend(ev.tokens)
            else:
                final = ev
        assert final is not None
        return final, toks
