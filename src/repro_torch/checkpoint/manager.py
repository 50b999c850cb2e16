"""Async checkpoint manager with storage-tier awareness.

The flex-start guarantee (paper §IV.F) rests on periodic checkpoints being
cheap: saves run on a background thread (training never blocks on Lustre),
the newest-k retention policy garbage-collects, and the tier is picked per
QoS class (training -> lustre, fine-tuning/inference -> vast, scratch ->
node-local NVMe).  The manager also *models* what the save would cost on the
real facility tiers so the scheduler can reason about checkpoint cadence at
480 B-parameter scale.

The JAX package's ``checkpoint/manager.py`` on torch trees.  The port's
train step updates parameters and moments in place, so an asynchronous
save snapshots the tree to host memory before it returns, as the
reference's ``jax.device_get`` does: ``.cpu()`` copies a card tensor, and
a CPU tensor is cloned (``.cpu()`` would hand back the same tensor, which
the next step would rewrite while the thread saves it).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

from repro_torch.checkpoint.storage import QOS_TIER, TIERS
from repro_torch.checkpoint.tensorstore_lite import (
    available_steps,
    checkpoint_bytes,
    delete_step,
    restore_pytree,
    save_pytree,
)
from repro_torch.utils.tree import tree_map_with_path


@dataclass
class SaveRecord:
    step: int
    nbytes: int
    tier: str
    modeled_seconds: float  # what this save costs on the facility tier
    wall_seconds: float  # what it actually took locally
    path: str


class CheckpointManager:
    """Background-threaded, atomic, newest-k checkpointing."""

    def __init__(
        self,
        directory: str | Path,
        *,
        keep: int = 3,
        qos: str = "training",
        tier: Optional[str] = None,
        async_save: bool = True,
        nodes: int = 1,
    ):
        self.directory = Path(directory)
        self.keep = keep
        self.tier_name = tier or QOS_TIER.get(qos, "lustre")
        self.async_save = async_save
        self.nodes = nodes
        self.records: list[SaveRecord] = []
        self._q: queue.Queue = queue.Queue()
        self._error: Optional[BaseException] = None
        self._worker: Optional[threading.Thread] = None
        if async_save:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------
    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            tree, step, extra = item
            try:
                self._save_now(tree, step, extra)
            except BaseException as e:  # surfaced on next wait()/save()
                self._error = e
            finally:
                self._q.task_done()

    def _save_now(self, tree: Any, step: int, extra: dict) -> SaveRecord:
        nbytes = checkpoint_bytes(tree)
        tier = TIERS[self.tier_name]
        files = len(list(self.directory.glob("*"))) + 1
        modeled = tier.write_seconds(nbytes, files=max(files, 1))
        t0 = time.monotonic()
        path = save_pytree(tree, self.directory, step=step, extra=extra)
        wall = time.monotonic() - t0
        rec = SaveRecord(step, nbytes, self.tier_name, modeled, wall, str(path))
        self.records.append(rec)
        self._gc()
        return rec

    def _gc(self) -> None:
        steps = available_steps(self.directory)
        for s in steps[: -self.keep]:
            delete_step(self.directory, s)

    # ------------------------------------------------------------------
    def save(self, tree: Any, *, step: int, extra: dict | None = None, block: bool = False):
        if self._error is not None:
            e, self._error = self._error, None
            raise e
        extra = extra or {}
        if self.async_save and not block:
            # snapshot to host memory so training can mutate its tensors
            snap = tree_map_with_path(lambda _, x: x.detach().to("cpu", copy=True), tree)
            self._q.put((snap, step, extra))
            return None
        return self._save_now(tree, step, extra)

    def wait(self) -> None:
        if self.async_save:
            self._q.join()
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def restore(self, like: Any, *, step: int | None = None) -> tuple[Any, dict]:
        """New tensors shaped, typed and placed as ``like``'s."""
        self.wait()
        tree, extra = restore_pytree(like, self.directory, step=step)
        rd = TIERS[self.tier_name]
        extra["modeled_restore_seconds"] = rd.read_seconds(checkpoint_bytes(tree))
        return tree, extra

    def latest_step(self) -> Optional[int]:
        steps = available_steps(self.directory)
        return steps[-1] if steps else None

    def close(self) -> None:
        if self._worker is not None:
            self._q.put(None)
            self._worker.join(timeout=10)
            self._worker = None

    # ------------------------------------------------------------------
    def cadence_advice(self, *, step_seconds: float, nbytes: int, mtbf_node_hours: float = 50_000.0) -> dict:
        """Young/Daly-style optimal checkpoint interval for this tier.

        MTBF of the JOB = node MTBF / nodes (independent failures).  The
        paper-scale reference: 1,320 nodes at 50k-hour node MTBF -> ~38 h job
        MTBF; with Lustre-speed saves the optimal cadence comes out minutes.
        """
        import math

        tier = TIERS[self.tier_name]
        save_s = tier.write_seconds(nbytes)
        mtbf_s = mtbf_node_hours * 3600.0 / max(self.nodes, 1)
        opt = math.sqrt(2.0 * save_s * mtbf_s)  # Young's approximation
        return {
            "save_seconds_modeled": save_s,
            "job_mtbf_hours": mtbf_s / 3600.0,
            "optimal_interval_seconds": opt,
            "optimal_interval_steps": max(1, int(opt / max(step_seconds, 1e-9))),
            "overhead_fraction": save_s / max(opt, 1e-9),
        }
