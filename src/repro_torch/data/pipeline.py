"""Stateless, restart-exact batch pipeline with host prefetch (counterpart
of ``repro.data.pipeline``).

``BatchPipeline`` wraps a pure ``make_batch(step) -> tree`` function (a
dict, list or tuple of numpy arrays or tensors):

* **stateless** — the batch for step ``s`` depends only on ``(seed, s)``.
  Restarting from a checkpoint at step ``s`` replays the identical data
  stream (bitwise), which is what makes checkpoint/restart exact. No
  iterator state to snapshot.
* **prefetch** — a daemon thread keeps ``prefetch`` batches ahead of the
  consumer; generation overlaps the device step.
* **placement** — with ``device`` set, every array becomes a tensor
  copied ``.to(device, non_blocking=True)`` from pinned host memory
  (``repro`` places against the step's input shardings with
  ``jax.device_put``). The copy is issued on the worker thread's current
  stream, the default stream the consumer's step also runs on, so the
  step reads the batch after it has landed.
* **slicing** — ``process_slice(batch, rank, world)`` cuts a rank's own
  slice, the rank and world read from ``torch.distributed`` when a group
  is initialised (else 0 and 1).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch._tree import tree_map


def place(batch, device) -> dict:
    """Every array of ``batch`` as a tensor on ``device``: from pinned host
    memory with ``non_blocking=True`` when ``device`` is a CUDA device."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def one(x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if t.device == device:
            return t
        if pin and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    return tree_map(one, batch)


def _rank_world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class BatchPipeline:
    def __init__(
        self,
        make_batch: Callable[[int], dict],
        *,
        start_step: int = 0,
        prefetch: int = 2,
        device=None,
        process_slice: Optional[Callable[[dict, int, int], dict]] = None,
    ):
        self._make = make_batch
        self._device = device
        self._slice = process_slice
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._next
        while not self._stop.is_set():
            batch = self._make(step)
            if self._slice is not None:
                batch = self._slice(batch, *_rank_world())
            if self._device is not None:
                batch = place(batch, self._device)
            # block until the consumer drains; bounded queue = bounded memory
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self) -> tuple[int, dict]:
        """(step, batch) in order."""
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
