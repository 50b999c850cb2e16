"""Request-lifecycle event tracer for the paged serving engine.

Answers the question the flat counters can't: *where did this request's
latency go?*  The engine records structured events — submit, admit (with
prefix-hit detail), every prefill chunk, first token, speculative
accept/reject, rollback, eviction, SLO preempt/resume, finish — into a
bounded ring buffer with
an injectable monotonic clock (the same clock as ``serving.metrics``), so a
drained run replays as a per-request timeline.

Two consumption paths:

* **In-process** — ``events`` / ``events_for(req_id)`` return the raw
  ``TraceEvent`` records; tests assert per-request ordering
  (submit < admit < chunk* < first_token < finish) on exact ManualClock
  timestamps.
* **Chrome trace / Perfetto** — ``to_chrome()`` emits the Trace Event
  Format (one JSON object with a ``traceEvents`` list): instants as
  ``ph="i"``, spans as complete ``ph="X"`` events with microsecond
  ``ts``/``dur``, plus ``thread_name`` metadata so the viewer shows **one
  track per batch slot and one for the scheduler**.  ``write(path)`` then
  opens directly in ``chrome://tracing`` or https://ui.perfetto.dev.

The ring buffer (``capacity`` events, oldest dropped first, drops counted)
bounds memory for always-on tracing; recording an event is one dataclass
construction and a deque append — cheap enough to stay on by default, and
entirely host-side (no device syncs: span durations on the default path
measure *dispatch* time; enable the engine's ``profile=True`` to bracket
dispatches with ``block_until_ready`` for device-inclusive phase times).
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

SCHEDULER_TRACK = 0


def slot_track(slot: int) -> int:
    """Track id for a batch slot (track 0 is the scheduler)."""
    return slot + 1


def replica_track(replica_id: int) -> int:
    """Track id for a replica on a router tracer (track 0 is the router)."""
    return replica_id + 1


@dataclass
class TraceEvent:
    name: str
    ts: float  # clock seconds (monotonic, engine clock)
    track: int = SCHEDULER_TRACK
    dur: Optional[float] = None  # None = instant, else span length in seconds
    req_id: Optional[int] = None
    args: dict = field(default_factory=dict)


class Tracer:
    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        capacity: int = 4096,
        track_label: Optional[Callable[[int], str]] = None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity={capacity}")
        self._clock = clock
        self.capacity = capacity
        # maps a track id to its viewer lane name; default: engine layout
        # (track 0 = scheduler, track N = slot N-1).  The router passes its
        # own labeler (track 0 = router, track N = replica N-1).
        self.track_label = track_label
        self._events: deque[TraceEvent] = deque(maxlen=capacity)
        self.recorded = 0  # total events ever recorded (>= len(events))

    # -- recording -----------------------------------------------------
    def now(self) -> float:
        return self._clock()

    def instant(
        self,
        name: str,
        *,
        track: int = SCHEDULER_TRACK,
        req_id: Optional[int] = None,
        **args,
    ) -> None:
        self._events.append(TraceEvent(name, self._clock(), track, None, req_id, args))
        self.recorded += 1

    def span(
        self,
        name: str,
        start: float,
        *,
        end: Optional[float] = None,
        track: int = SCHEDULER_TRACK,
        req_id: Optional[int] = None,
        **args,
    ) -> None:
        """A complete span from ``start`` to ``end`` (default: now)."""
        if end is None:
            end = self._clock()
        self._events.append(
            TraceEvent(name, start, track, max(end - start, 0.0), req_id, args)
        )
        self.recorded += 1

    # -- consumption ---------------------------------------------------
    @property
    def events(self) -> list[TraceEvent]:
        return list(self._events)

    @property
    def dropped(self) -> int:
        """Events pushed out of the ring buffer."""
        return self.recorded - len(self._events)

    def events_for(self, req_id: int) -> list[TraceEvent]:
        return [e for e in self._events if e.req_id == req_id]

    def clear(self) -> None:
        self._events.clear()
        self.recorded = 0

    # -- export --------------------------------------------------------
    def to_chrome(self) -> dict:
        """Chrome Trace Event Format (JSON object flavour).

        Timestamps rebase to the earliest buffered event and convert to
        microseconds; one ``thread_name`` metadata row per used track keeps
        the per-slot / scheduler lanes labelled in the viewer.
        """
        evs = sorted(self._events, key=lambda e: (e.ts, e.track))
        t0 = evs[0].ts if evs else 0.0
        out: list[dict] = [
            {"ph": "M", "pid": 0, "tid": 0, "ts": 0, "name": "process_name",
             "args": {"name": "paged-engine"}},
        ]
        for t in sorted({e.track for e in evs} | {SCHEDULER_TRACK}):
            if self.track_label is not None:
                label = self.track_label(t)
            else:
                label = "scheduler" if t == SCHEDULER_TRACK else f"slot {t - 1}"
            out.append(
                {"ph": "M", "pid": 0, "tid": t, "ts": 0, "name": "thread_name",
                 "args": {"name": label}}
            )
        for e in evs:
            args = dict(e.args)
            if e.req_id is not None:
                args["req_id"] = e.req_id
            rec = {
                "name": e.name,
                "pid": 0,
                "tid": e.track,
                "ts": round((e.ts - t0) * 1e6, 3),
                "args": args,
            }
            if e.dur is None:
                rec["ph"] = "i"
                rec["s"] = "t"  # instant scoped to its thread/track
            else:
                rec["ph"] = "X"
                rec["dur"] = round(e.dur * 1e6, 3)
            out.append(rec)
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "metadata": {"dropped_events": self.dropped, "recorded_events": self.recorded},
        }

    def write(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
