"""The fused serving step as CUDA graphs: one replay a tick.

The JAX engine's ``fused=True`` turns each tick into one jitted dispatch,
and ``jax.jit``'s shape cache holds one compiled program per shape.
PyTorch runs eagerly, so the port's counterpart of one dispatch is one
replay of a captured ``torch.cuda.CUDAGraph``, and ``StepGraphs`` is the
shape cache: one graph per key, the decode graph keyed by the batch and
each mixed graph by its (rows, width) bucket; a mixed tick with
speculative verify rows is keyed apart by its drafter (``"spec"``: the
n-gram drafter; ``"draft"``: the draft model, whose (rows, spec_k, vocab)
proposal laws are a float input).

How a graph is fed and run:

* **Static inputs.**  Each graph owns one int32 device buffer that holds
  every input (fp32 inputs are stored by their bits) and one pinned host
  buffer of the same size.  A tick writes the host buffer and copies it in
  with one non-blocking copy before ``replay()``.
* **Capture** at a key's first use: one eager warm-up run of the step on a
  side stream (it builds the kernels' libraries and fills the kernels'
  host-side launch state, which must not be queried under capture), then
  the capture, in the default ``"global"`` error mode, then the replay
  that computes the tick.  All graphs share one memory pool: they never
  replay at once.  A failed capture raises; nothing falls back to the
  eager step.
* **Generator.**  The engine's ``torch.Generator`` is registered with
  every graph, so each replay advances its Philox offset.
* **Pointers.**  The graphs hold the addresses of the tensors the step
  reads and writes in place (the engine's K/V pools and block table):
  ``run`` raises if one of them was reallocated since the graphs were
  made.
* **Launches.**  The kernel wrappers count where they run, so a replay
  adds nothing to ``kernels.paged_attention.LAUNCHES``; the calls recorded
  at capture (the capture's delta of those counts) are added to
  ``launches`` at each replay.

On the CPU (the parity tests) ``run`` calls the step eagerly: no graphs.
That is a dispatch by device, not a fallback.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.kernels import paged_attention


class _Graph:
    """One captured step: its static input views, its output and its
    launches."""

    def __init__(self, layout: dict, n: int, device: torch.device):
        self.layout = layout  # name -> (offset, shape, numpy dtype)
        self.host = torch.empty((n,), dtype=torch.int32, pin_memory=True)
        self.dev = torch.zeros((n,), dtype=torch.int32, device=device)
        self.views = {}
        for name, (off, shape, dtype) in layout.items():
            flat = self.dev[off : off + int(np.prod(shape))]
            self.views[name] = (flat.view(torch.float32) if dtype == np.float32 else flat).view(shape)
        self.graph = torch.cuda.CUDAGraph()
        self.out = None
        self.launches: dict[str, int] = {}
        self.pool_bytes = 0  # the shared pool's bytes once this graph was captured


def _layout(inputs: dict) -> tuple[dict, int]:
    layout, off = {}, 0
    for name, a in inputs.items():
        if a.dtype not in (np.int32, np.float32):
            raise TypeError(f"input {name}: {a.dtype}; the staging buffer holds int32 and float32")
        layout[name] = (off, a.shape, a.dtype.type)
        off += a.size
    return layout, max(off, 1)


class StepGraphs:
    """One CUDA graph per shape key over fixed step functions.

    ``holds()`` returns the tensors, by name, that the steps update in place
    and the graphs keep the addresses of; ``generator`` is the generator
    the steps draw from."""

    def __init__(self, device: torch.device, generator: torch.Generator, holds):
        self.device = device
        self.generator = generator
        self.holds = holds
        self._ptrs = {name: t.data_ptr() for name, t in holds().items()}
        self._graphs: dict = {}
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.launches = {name: 0 for name in paged_attention.LAUNCHES}  # kernels run by replays

    def run(self, key, fn, inputs: dict) -> torch.Tensor:
        """Compute ``fn(**inputs)`` for this tick: on the CPU eagerly, on
        the card by replaying the key's graph (captured now if the key is
        new).  ``inputs`` maps names to int32 / float32 numpy arrays whose
        shapes the key fixes.  Returns ``fn``'s output tensor: on the card
        the graph's static output, valid until the next ``run``."""
        if self.device.type == "cpu":
            return fn(**{name: torch.from_numpy(a) for name, a in inputs.items()})
        for name, t in self.holds().items():
            if t.data_ptr() != self._ptrs.get(name):
                raise RuntimeError(f"{name} was reallocated after the step graphs captured its address")
        g = self._graphs.get(key)
        if g is None:
            layout, n = _layout(inputs)
            g = _Graph(layout, n, self.device)
            self._stage(g, inputs)
            self._capture(g, fn)
            self._graphs[key] = g
        else:
            self._stage(g, inputs)
        g.graph.replay()
        self.replays += 1
        for name, n in g.launches.items():
            self.launches[name] += n
        return g.out

    def _stage(self, g: _Graph, inputs: dict) -> None:
        host = g.host.numpy()
        for name, a in inputs.items():
            off, shape, dtype = g.layout[name]
            if a.shape != shape or a.dtype != dtype:
                raise ValueError(f"input {name}: {a.dtype}{a.shape}, the graph holds {np.dtype(dtype)}{shape}")
            host[off : off + a.size] = a.reshape(-1).view(np.int32)
        g.dev.copy_(g.host, non_blocking=True)

    def _capture(self, g: _Graph, fn) -> None:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn(**g.views)  # warm-up: builds the libraries, fills launch state
        current.wait_stream(side)
        g.graph.register_generator_state(self.generator)
        before = dict(paged_attention.LAUNCHES)
        with torch.cuda.graph(g.graph, pool=self.pool):
            g.out = fn(**g.views)
        g.launches = {name: paged_attention.LAUNCHES[name] - n for name, n in before.items()}
        g.pool_bytes = self.pool_bytes()
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def pool_bytes(self) -> int:
        """Device bytes reserved by the graphs' shared memory pool."""
        if self.pool is None:
            return 0
        return sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot() if tuple(seg.get("segment_pool_id", ())) == self.pool
        )
