"""Device meshes over ``torch.distributed`` ranks, and the spawner of ranks.

The counterpart of the JAX package's ``launch/mesh.py``.  A mesh here is a
``torch.distributed`` ``DeviceMesh`` named ``("data", "model")`` over the
ranks of an initialized process group, one rank a process:

* ``make_serving_mesh(tp)``: the ``(data=1, model=tp)`` mesh one serving
  engine spans (``InferenceEngine(mesh=)``), over a world of ``tp`` ranks.
* ``make_local_mesh(data, model)``: any ``(data, model)`` shape over the
  world, the mesh of sharded and FSDP training.
* ``make_submesh(data, model)``: a ``(data, model)`` mesh over the first
  ranks of the world (``core.elastic``, ``core.tenancy``), None on the
  ranks outside it.
* ``make_replica_meshes(replicas, tp)``: ``replicas`` disjoint ``(1, tp)``
  meshes, replica ``i`` on ranks ``[i*tp, (i+1)*tp)``, with the
  reference's errors when ``replicas * tp`` exceeds the cards.
* ``make_production_mesh`` / ``make_mesh``: the 16x16 and 2x16x16 shapes
  as stubs with a ``.shape`` dict, for the sharding rule engine; they never
  start a rank.

**The backend is explicit** (``pick_backend``).  On the card it is
``"nccl"`` by default, which needs one card a rank: NCCL refuses two ranks
on one device, so with fewer cards than ranks the default raises, naming
the cause, unless the caller passes ``backend="gloo"``.  Gloo takes CUDA
tensors and stages each collective through host memory: exact, but slow,
and a CUDA graph cannot capture it.  On the CPU the backend is gloo.

``run_ranks(fn, tp)`` spawns ``tp`` rank processes (the ``spawn`` start
method; the parent holds the group's store on a loopback port the system
picks, so concurrent spawns cannot race for one), initializes the process
group in each, runs
``fn(rank, mesh, *args)`` on the ``(1, tp)`` serving mesh and returns every
rank's result in rank order; ``run_ranks(fn, (data, model))`` spawns
``data * model`` ranks and hands each the ``(data, model)`` mesh of
``make_local_mesh`` (sharded training: rank ``r`` sits at data ``r //
model``, model ``r % model``).
The ranks import ``torch`` and ``repro_torch`` (and ``fn``'s module); a rank
that raises fails the call with its traceback, after the other ranks are
stopped.  A rank asked for ``cuda`` on a host without a card raises.

A rank's result crosses to the parent **by value**: the rank moves every
tensor in it to the host (``.cpu()``, a view cut to its own bytes) and
pickles the whole result into bytes with the standard pickler before it
puts them on the queue.  The queue's own pickler would send a CPU tensor
as a shared-memory handle that the parent fetches from the rank, which
fails once the rank has exited (``FileNotFoundError``); bytes need no live
rank, and keep every dtype (bf16 and fp8 included) bit for bit.
"""

from __future__ import annotations

import copy
import datetime
import multiprocessing as mp
import os
import pickle
import queue
import signal
import socket
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.config import MeshConfig
from repro_torch.device import resolve_device

AXES = ("data", "model")
UNBOUNDED = datetime.timedelta(days=365)  # the collectives' timeout of a service that may idle
BACKENDS = ("nccl", "gloo")
POLL_S = 1.0  # run_ranks looks for ranks that died without a result this often
NCCL_ONE_RANK_A_CARD = (
    "NCCL refuses two ranks on one device; pass backend='gloo' to stage the collectives through host memory"
)


@dataclass(frozen=True)
class MeshShape:
    """A mesh's geometry alone: what the rule engine reads (``.shape``)."""

    shape: dict


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips).

    Axis semantics: "pod" is the DCN boundary (data-parallel across pods),
    "data" the intra-pod FSDP/DP axis, "model" the TP/EP/SP axis."""
    cfg = MeshConfig(multi_pod=multi_pod)
    return MeshShape(dict(zip(cfg.axis_names, cfg.shape)))


def make_mesh(cfg: MeshConfig) -> MeshShape:
    return make_production_mesh(multi_pod=cfg.multi_pod)


def _cards(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 0


def pick_backend(ranks: int, backend: str | None = None, device="cuda") -> str:
    """The process-group backend for ``ranks`` ranks on ``device``: gloo on
    the CPU; on the card NCCL by default, which needs a card a rank, or
    gloo when the caller names it."""
    device = resolve_device(device)
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend={backend!r} (choose from {BACKENDS})")
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("backend='nccl' needs CUDA devices; the CPU runs gloo")
        return "gloo"
    if backend == "gloo":
        return "gloo"
    if ranks > _cards(device):
        raise ValueError(f"{ranks} ranks on {_cards(device)} card(s): {NCCL_ONE_RANK_A_CARD}")
    return "nccl"


def _device_mesh(backend: str, shape: tuple, names=AXES):
    from torch.distributed.device_mesh import init_device_mesh

    # gloo runs its collectives on the host whatever the tensors' device
    return init_device_mesh("cuda" if backend == "nccl" else "cpu", shape, mesh_dim_names=names)


def _check_world(need: int, backend: str) -> None:
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with run_ranks or torch.distributed.init_process_group")
    if dist.get_world_size() != need:
        raise ValueError(f"the mesh needs {need} ranks, the process group has {dist.get_world_size()}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, the mesh asks for {backend!r}")


def make_serving_mesh(tp: int = 1, *, backend: str | None = None, device="cuda"):
    """The ``(data=1, model=tp)`` mesh of one tensor-parallel serving
    engine, over the initialized process group of ``tp`` ranks."""
    if tp < 1:
        raise ValueError(f"tp={tp} (need >= 1)")
    backend = pick_backend(tp, backend, device)
    _check_world(tp, backend)
    return _device_mesh(backend, (1, tp))


def make_local_mesh(data: int = 1, model: int = 1, *, backend: str | None = None, device="cpu"):
    """A ``(data, model)`` mesh over the whole process group: sharded
    training's (``train.step``), and the tests'."""
    backend = pick_backend(data * model, backend, device)
    _check_world(data * model, backend)
    return _device_mesh(backend, (data, model))


def make_submesh(data: int, model: int):
    """A ``(data, model)`` mesh over the first ``data * model`` ranks of
    the initialized process group (an elastic survivor mesh, a tenant's
    share), on the group's backend.  Every rank of the world calls it, as
    ``DeviceMesh`` makes its groups collectively; a rank outside the mesh
    gets None."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with run_ranks or torch.distributed.init_process_group")
    need = data * model
    if min(data, model) < 1 or need > dist.get_world_size():
        raise ValueError(f"a ({data}, {model}) mesh needs {need} ranks; the world has {dist.get_world_size()}")
    from torch.distributed.device_mesh import DeviceMesh

    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(kind, torch.arange(need).reshape(data, model), mesh_dim_names=AXES)
    return mesh if dist.get_rank() < need else None


def check_replica_devices(replicas: int, tp: int = 1, *, backend: str | None = None, device="cuda") -> int:
    """The ranks ``replicas`` disjoint ``(1, tp)`` meshes take, or the
    reference's error where they need more cards than there are (one a
    rank) and ``backend`` is not ``"gloo"``.  Needs no process group: a
    launcher checks before it spawns."""
    if replicas < 1:
        raise ValueError(f"replicas={replicas} (need >= 1)")
    if tp < 1:
        raise ValueError(f"tp={tp} (need >= 1)")
    need = replicas * tp
    device = resolve_device(device)
    if device.type == "cuda" and backend != "gloo" and need > _cards(device):
        raise ValueError(
            f"replicas={replicas} x tp={tp} needs {need} devices, have {_cards(device)}; {NCCL_ONE_RANK_A_CARD}"
        )
    return need


def make_replica_meshes(replicas: int, tp: int = 1, *, backend: str | None = None, device="cuda") -> list:
    """``replicas`` disjoint ``(data=1, model=tp)`` meshes: replica ``i``
    owns ranks ``[i*tp, (i+1)*tp)``.  Every rank of the world calls it, as
    ``DeviceMesh`` makes each group collectively.  On the card it needs
    ``replicas * tp`` cards (one a rank) unless ``backend="gloo"``."""
    need = check_replica_devices(replicas, tp, backend=backend, device=device)
    backend = pick_backend(need, backend, device)
    _check_world(need, backend)
    from torch.distributed.device_mesh import DeviceMesh

    kind = "cuda" if backend == "nccl" else "cpu"
    ranks = torch.arange(need).reshape(replicas, 1, tp)
    return [DeviceMesh(kind, ranks[i], mesh_dim_names=AXES) for i in range(replicas)]


# ---------------------------------------------------------------------------
# rank processes
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _timeout(timeout_s: float | None) -> datetime.timedelta:
    return datetime.timedelta(seconds=timeout_s) if timeout_s is not None else UNBOUNDED


def _to_host(obj):
    """``obj`` with every tensor in it (through dicts, lists and tuples,
    named tuples included) moved to the host and detached; a view keeps
    only its own bytes, so pickling it does not copy the whole storage."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.untyped_storage().nbytes() != t.numel() * t.element_size() or not t.is_contiguous():
            t = t.clone(memory_format=torch.contiguous_format)
        return t
    if isinstance(obj, dict):
        out = copy.copy(obj)  # a dict subclass keeps its type (and a defaultdict its factory)
        out.update((k, _to_host(v)) for k, v in obj.items())
        return out
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # a named tuple
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank, shape, backend, device, port, timeout_s, fn, args, out, quiet_followers) -> None:
    try:
        if quiet_followers and rank != 0:
            signal.signal(signal.SIGINT, signal.SIG_IGN)  # rank 0 drains, then releases this rank
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        world = shape[0] * shape[1]
        store = dist.TCPStore("127.0.0.1", port, world, is_master=False, timeout=_timeout(timeout_s))
        dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=_timeout(timeout_s))
        try:
            mesh = make_local_mesh(*shape, backend=backend, device=device)
            result = fn(rank, mesh, *args)
        finally:
            dist.destroy_process_group()
        # by value (module docstring): the parent may read it after this rank exits
        out.put((rank, True, pickle.dumps(_to_host(result), protocol=pickle.HIGHEST_PROTOCOL)))
    except BaseException:  # reported to the parent, which raises it
        out.put((rank, False, traceback.format_exc()))


def run_ranks(
    fn, tp: int | tuple, *, backend: str | None = None, device="cuda", args: tuple = (),
    timeout_s: float | None = 600.0, forward_signals: bool = False,
):
    """Run ``fn(rank, mesh, *args)`` on ``tp`` spawned ranks of one
    ``(1, tp)`` serving mesh, or on the ranks of a ``(data, model)`` mesh
    when ``tp`` is that pair; returns the ranks' results in rank order,
    each received by value with its tensors on the host (module docstring).
    ``fn`` and ``args`` must pickle (a module-level function).  Raises the
    first failing rank's traceback, or the exit code of a rank that died
    with no result; every rank is stopped before this returns or raises.  ``timeout_s`` bounds each collective and the wait
    for each result (None: unbounded, for a service that may idle).
    ``forward_signals`` (the main thread only): SIGTERM and SIGINT sent to
    this process go to rank 0 as SIGTERM, and the other ranks ignore
    SIGINT, so rank 0 can drain a service and then release them."""
    shape = tuple(tp) if isinstance(tp, tuple) else (1, tp)
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"mesh shape {tp} (need tp >= 1 or (data, model) >= (1, 1))")
    tp = shape[0] * shape[1]
    backend = pick_backend(tp, backend, device)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    # the group's store, held here (for as long as the ranks run) on a port
    # the system picks as it binds
    store = dist.TCPStore("127.0.0.1", 0, tp, is_master=True, wait_for_workers=False, timeout=_timeout(timeout_s))
    port = store.port
    procs = [
        ctx.Process(
            target=_rank_main, args=(r, shape, backend, str(device), port, timeout_s, fn, args, out, forward_signals),
            daemon=True,
        )
        for r in range(tp)
    ]
    for p in procs:
        p.start()
    previous = {}
    if forward_signals:
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, lambda *_: os.kill(procs[0].pid, signal.SIGTERM))
    results: dict = {}
    try:
        waited = 0.0
        while len(results) < tp:
            try:
                rank, ok, value = out.get(timeout=POLL_S)
            except queue.Empty:
                waited += POLL_S
                # a rank that died without a word (killed, or lost at start-up)
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in results]
                if dead and out.empty():
                    raise RuntimeError(f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} and no result")
                if timeout_s is not None and waited >= timeout_s:
                    raise TimeoutError(f"ranks {sorted(set(range(tp)) - set(results))} gave no result in {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = pickle.loads(value)
            waited = 0.0
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        for p in procs:
            p.join(timeout=30 if len(results) == tp else 1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [results[r] for r in range(tp)]
