"""Replicas of tensor-parallel engines behind one router, across processes.

The JAX router holds its engines by reference in one process.  Here a
replica of a tensor-parallel engine spans ``tp`` rank processes (one engine
a rank, ``InferenceEngine(mesh=)``), and replica ``i`` is led from global
rank ``i * tp`` (``launch.mesh.make_replica_meshes``).  The router runs on
global rank 0, which is also replica 0's lead, so it drives every other
replica through a stand-in:

* ``RemoteEngine`` (on rank 0): the engine surface the ``Router`` and
  ``Replica`` read (``submit``, ``step``, ``abort``, ``has_work``,
  ``queue`` and ``slots`` for the load score, ``prefix.match_tokens``,
  ``chunked()``, ``block_size``, ``eos``, ``stats()``, the counters
  ``tokens_out`` / ``prefill_tokens`` / ``prefix_hit_tokens``, the
  ``on_token`` / ``on_finish`` hooks and ``launch_counts()``).  Each call is one round trip to the lead: a
  message, then its reply.
* ``serve_remote(engine, group)`` (on a lead): the loop that takes each
  message, applies it to the lead's own engine (whose ``step`` in turn
  sends the step's message to the replica's followers, which run
  ``follow()`` as under ``--tp`` alone) and replies.

**The wire.**  Messages travel point to point (``send_object_list`` /
``recv_object_list``) on a gloo group of the leads ``{0, tp, 2 tp, ...}``
(``fleet_group``), on the host whatever the engines' device.  Every rank of
the world makes that group, as ``new_group`` asks, but only the leads use
it; the engines' own step messages and collectives run on each replica's
groups.  Rank 0 issues its replica 0 work and its fleet messages in one
thread of control (the router's step, or a stats read between steps under
a lock), and each group sees its own messages in one order on every member,
so they cannot interleave differently on different ranks.

**A reply** carries the call's result (or the exception it raised, which
``RemoteEngine`` raises again on rank 0), the hooks the lead's engine fired
during the call in their order (``("token", req_id, tokens)``,
``("finish", req_id, fields)``), and a snapshot of what the router reads
between calls: queue length, occupied slots, ``has_work``, the counters,
and the lead's cumulative kernel launch counts
(``kernels.paged_attention.LAUNCHES`` is per process: ``Replica`` reads
them through ``launch_counts()``).  Rank 0 replays the hooks on its
``RemoteRequest`` mirrors, in the lead's order, before the call returns.

**A ``RemoteRequest``** mirrors what the router reads of the lead's
request: ``req_id``, ``prompt``, ``generated`` (extended by each token
hook), ``finish_reason`` and ``state``.
Assigning ``generated`` (the router's failover resume, which seeds the
delivered tokens right after ``submit``) sets the mirror and queues the
tokens for the lead, which sets them on its request before it applies
anything else of the next message: before its next step, so they ride in
the submission its followers take at that step (``InferenceEngine``'s
module docstring).

``stop_followers()`` ends the lead's loop after the lead released its own
followers, and keeps the lead's final ``stats()``; a replica the router
failed (crashed or unhealthy) is released the same way.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch.distributed as dist

from repro_torch.kernels import paged_attention
from repro_torch.serving.scheduler import RequestState

# the engine counters the router reads between calls
COUNTERS = ("tokens_out", "prefill_tokens", "prefix_hit_tokens")


def lead_ranks(replicas: int, tp: int) -> list[int]:
    """The global rank of each replica's lead: ``i * tp``."""
    return [i * tp for i in range(replicas)]


def fleet_group(replicas: int, tp: int):
    """The gloo group of the replicas' leads.  Every rank of the world
    calls it (``new_group`` is collective); the followers never use it."""
    return dist.new_group(ranks=lead_ranks(replicas, tp), backend="gloo")


def _send(obj, dst: int, group) -> None:
    dist.send_object_list([obj], dst=dst, group=group)


def _recv(src: int, group):
    box = [None]
    dist.recv_object_list(box, src=src, group=group)
    return box[0]


# ---------------------------------------------------------------------------
# the lead's side
# ---------------------------------------------------------------------------


def _snapshot(engine) -> dict:
    return {
        "queued": len(engine.queue),
        "slots": [r is not None for r in engine.slots],
        "has_work": engine.has_work,
        "launches": dict(paged_attention.LAUNCHES),
        **{name: getattr(engine, name) for name in COUNTERS},
    }


def _describe(engine) -> dict:
    return {"block_size": getattr(engine, "block_size", None), "eos": engine.eos, "chunked": engine.chunked(),
            "has_prefix": engine.prefix is not None}


def _stop(engine) -> dict:
    engine.stop_followers()
    return engine.stats()


OPS = {
    "describe": _describe,
    "submit": lambda engine, prompt, kw: engine.submit(prompt, **kw).req_id,
    "step": lambda engine: engine.step(),
    "abort": lambda engine, req_id, reason: engine.abort(req_id, reason),
    "match": lambda engine, prompt: engine.prefix.match_tokens(prompt),
    "stats": lambda engine: engine.stats(),
    "stop": _stop,
}


def serve_remote(engine, group) -> int:
    """A lead's loop: apply each message from rank 0 (the router's) to ``engine``
    (this replica's rank-0 engine) and reply, until the stop message, after
    which the replica's followers are released.  Returns the messages
    served."""
    fired: list = []
    engine.on_token = lambda req, toks: fired.append(("token", req.req_id, list(toks)))
    engine.on_finish = lambda req: fired.append(("finish", req.req_id, (req.finish_reason, req.state.value)))
    served = 0
    while True:
        msg = _recv(0, group)
        for req_id, tokens in msg["seeds"]:
            req = engine.find_request(req_id)
            if req is not None:
                req.generated = list(tokens)
        try:
            result, error = OPS[msg["op"]](engine, *msg["args"]), None
        except Exception as e:  # raised again on the router's rank
            result, error = None, e
        reply = {"result": result, "error": error, "fired": fired[:], "state": _snapshot(engine)}
        fired.clear()
        _send(reply, 0, group)
        served += 1
        if msg["op"] == "stop":
            return served


# ---------------------------------------------------------------------------
# the router's side
# ---------------------------------------------------------------------------


class RemoteRequest:
    """Rank 0's mirror of a request on a remote lead's engine."""

    def __init__(self, engine: "RemoteEngine", req_id: int, prompt: list[int]):
        self._engine = engine
        self.req_id = req_id
        self.prompt = list(prompt)
        self._generated: list[int] = []
        self.finish_reason: Optional[str] = None
        self.state = RequestState.WAITING

    @property
    def generated(self) -> list[int]:
        return self._generated

    @generated.setter
    def generated(self, tokens) -> None:
        """The failover resume's seed: the mirror takes it now, the lead
        before it applies anything else of the next message."""
        self._generated = list(tokens)
        self._engine._seed(self.req_id, self._generated)



class _RemotePrefix:
    """``prefix.match_tokens`` of the lead's prefix index: a pure peek."""

    def __init__(self, engine: "RemoteEngine"):
        self._engine = engine

    def match_tokens(self, prompt: list[int]) -> int:
        return self._engine._call("match", list(prompt))


class RemoteEngine:
    """The engine surface of a replica led from another rank (module
    docstring).  ``lead``: the lead's global rank; ``group``: the leads'
    group (``fleet_group``)."""

    def __init__(self, lead: int, group):
        self.lead = lead
        self.group = group
        self._lock = threading.Lock()  # a stats read may come from another thread than the steps
        self._seeds: list = []
        self._requests: dict[int, RemoteRequest] = {}
        self._state: dict = {}
        self._final_stats: Optional[dict] = None
        self.on_token = None
        self.on_finish = None
        d = self._call("describe")
        self.block_size, self.eos, self._chunked = d["block_size"], d["eos"], d["chunked"]
        self.prefix = _RemotePrefix(self) if d["has_prefix"] else None

    # -- the wire --------------------------------------------------------
    def _seed(self, req_id: int, tokens: list[int]) -> None:
        self._seeds.append((req_id, list(tokens)))

    def _call(self, op: str, *args):
        if self._final_stats is not None:
            raise RuntimeError(f"replica led by rank {self.lead} was released (stop_followers)")
        with self._lock:
            seeds, self._seeds = self._seeds, []
            _send({"op": op, "args": args, "seeds": seeds}, self.lead, self.group)
            reply = _recv(self.lead, self.group)
        self._state = reply["state"]
        for event in reply["fired"]:
            self._replay(event)
        if reply["error"] is not None:
            raise reply["error"]
        return reply["result"]

    def _replay(self, event) -> None:
        kind, req_id, payload = event
        req = self._requests.get(req_id)
        if req is None:
            return
        if kind == "token":
            req._generated.extend(payload)
            if self.on_token is not None:
                self.on_token(req, payload)
        else:
            req.finish_reason, state = payload
            req.state = RequestState(state)
            del self._requests[req_id]
            if self.on_finish is not None:
                self.on_finish(req)

    # -- the engine surface ----------------------------------------------
    def submit(self, prompt: list[int], **kw) -> RemoteRequest:
        req = RemoteRequest(self, self._call("submit", list(prompt), kw), prompt)
        self._requests[req.req_id] = req
        return req

    def step(self) -> int:
        return self._call("step")

    def abort(self, req, reason: str = "aborted") -> bool:
        return self._call("abort", req if isinstance(req, int) else req.req_id, reason)

    def chunked(self) -> bool:
        return self._chunked

    def stats(self) -> dict:
        return self._final_stats if self._final_stats is not None else self._call("stats")

    def stop_followers(self) -> None:
        """Release the lead and its followers; ``stats()`` then reads the
        lead's final stats."""
        if self._final_stats is None:
            self._final_stats = self._call("stop")

    def launch_counts(self) -> dict:
        """The lead's cumulative kernel launch counts at its last reply."""
        return dict(self._state["launches"])

    @property
    def has_work(self) -> bool:
        return self._state["has_work"]

    @property
    def queue(self) -> list:
        return [None] * self._state["queued"]

    @property
    def slots(self) -> list:
        return [True if busy else None for busy in self._state["slots"]]

    @property
    def tokens_out(self) -> int:
        return self._state["tokens_out"]

    @property
    def prefill_tokens(self) -> int:
        return self._state["prefill_tokens"]

    @property
    def prefix_hit_tokens(self) -> int:
        return self._state["prefix_hit_tokens"]
