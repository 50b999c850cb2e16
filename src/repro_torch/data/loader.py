"""Host-side sharded data loader with prefetch.

Each host feeds its slice of the global batch: the loader yields per-host
shards keyed by (step, host_id), so all hosts stay deterministic and
replay-identical after a flex-start restore.  A small background-thread
prefetch queue hides host-side generation latency behind device compute
(the training/storage overlap the paper's Lustre tier is sized for).

The JAX package's ``data/loader.py`` on torch batches: a shard is a slice
of every tensor of the batch dict along its leading axis, put on the
loader's ``device`` (the card unless the caller asks for the CPU).  A
batch the batch function made there already stays where it is; numpy
arrays and CPU tensors are copied over.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.utils.tree import tree_map


class ShardedLoader:
    def __init__(
        self,
        batch_fn: Callable[[int], dict],  # global step -> GLOBAL batch
        *,
        host_id: int = 0,
        num_hosts: int = 1,
        prefetch: int = 2,
        device="cuda",
    ):
        self.batch_fn = batch_fn
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------
    def host_shard(self, batch: dict) -> dict:
        """This host's contiguous slice of the global batch, on the loader's device."""

        def shard(x):
            x = torch.as_tensor(x)
            per = x.shape[0] // self.num_hosts
            lo = self.host_id * per
            return x[lo : lo + per].to(self.device)

        return tree_map(shard, batch)

    def get(self, step: int) -> dict:
        return self.host_shard(self.batch_fn(step))

    # ------------------------------------------------------------------
    def iterate(self, start_step: int, num_steps: int) -> Iterator[tuple[int, dict]]:
        """Prefetching iterator over [start_step, start_step + num_steps)."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        self._stop.clear()

        def producer():
            for s in range(start_step, start_step + num_steps):
                if self._stop.is_set():
                    return
                q.put((s, self.get(s)))
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        self._thread = t
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            self._stop.set()

    def close(self) -> None:
        self._stop.set()
