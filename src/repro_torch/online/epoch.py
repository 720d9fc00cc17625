"""Epoch handle — the read-copy-update glue between a mutable PDASC index
and its readers and writers (counterpart of ``repro.online.epoch``).

The handle owns one reference to the current index epoch. Readers take
``handle.current`` once per batch and run the whole batch on that snapshot;
writers go through :meth:`EpochHandle.apply_writes`, which applies a run of
ops to the live epoch under one lock and then runs the swap policy:

* no torn batches: a batch's queries all see one epoch (the snapshot);
* writes mutate only the delta and tombstone tiers of the live epoch;
* an epoch swap is one reference assignment: results computed on the old
  epoch stay valid, and the old index (never mutated by compaction) is
  freed when its last reader drops it.

:class:`WriteLog` is the shared, append-only, sequenced record of accepted
writes that a replicated deployment replays onto a lagging replica.

The handle reports its writes, write errors, swaps, compaction times and
tier gauges to the ``repro_torch.obs`` registry under ``repro``'s series.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

import numpy as np

from repro_torch import obs
from repro_torch.obs import names as mnames


class WriteLog:
    """Shared, append-only, monotonically sequenced write record: each
    accepted write is appended once (``append`` returns its sequence
    number), and a replica that missed ops catches up with ``since(seq)``.
    Entries are immutable tuples ``(seq, kind, payload)``."""

    def __init__(self):
        self._ops: list = []
        self._lock = threading.Lock()

    def append(self, kind: str, payload: Any) -> int:
        """Record one write; returns its sequence number (0-based)."""
        with self._lock:
            seq = len(self._ops)
            self._ops.append((seq, kind, payload))
            return seq

    def since(self, seq: int) -> list:
        """All entries with sequence number > ``seq`` (-1 for all)."""
        with self._lock:
            return self._ops[seq + 1:]  # seqs are dense indices

    @property
    def last_seq(self) -> int:
        with self._lock:
            return len(self._ops) - 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._ops)


class EpochHandle:
    """RCU reference to the live index + write application + swap policy."""

    def __init__(self, idx, *, delta_fill: float = 0.5,
                 tombstone_ratio: float = 0.2, scope: str = "affected",
                 compact_kwargs: Optional[dict] = None):
        self._current = idx
        self.delta_fill = float(delta_fill)
        self.tombstone_ratio = float(tombstone_ratio)
        self.scope = scope
        self.compact_kwargs = dict(compact_kwargs or {})
        self.swaps = 0
        # serialises writers; readers take the reference without it (one
        # attribute read, atomic under the GIL)
        self._write_lock = threading.Lock()

    @property
    def current(self):
        """The live epoch. Read it once per batch and keep the snapshot."""
        return self._current

    def apply_writes(self, ops) -> list:
        """Apply ``[(kind, payload), ...]`` in order to the live epoch
        (``"upsert"``: ``(vectors, ids)`` or bare vectors; ``"delete"``:
        ids), then run the swap policy once. Returns one result per op
        (the ids of an upsert, the count of a delete); a failing op gives
        its exception instead, and the ops before it stay applied. An
        upsert that the delta buffer cannot hold compacts first."""
        with self._write_lock:
            idx = self._current
            out = []
            for kind, payload in ops:
                try:
                    if kind == "upsert":
                        vectors, ids = (payload if isinstance(payload, tuple)
                                        else (payload, None))
                        if idx.delta is not None and idx.delta.free < len(
                                _rows(vectors)):
                            idx = self._swap(idx)  # make room first
                        out.append(idx.upsert(vectors, ids=ids))
                    elif kind == "delete":
                        out.append(idx.delete(payload))
                    else:
                        raise ValueError(f"unknown write kind {kind!r}")
                except Exception as e:  # per-op isolation
                    out.append(e)
                    obs.counter(mnames.ONLINE_WRITE_ERRORS, op=kind).inc()
                else:
                    obs.counter(mnames.ONLINE_WRITES, op=kind).inc()
            if idx.needs_compaction(delta_fill=self.delta_fill,
                                    tombstone_ratio=self.tombstone_ratio):
                idx = self._swap(idx)
            self._observe_tiers(idx)
            return out

    def maybe_compact(self) -> bool:
        """Run the swap policy outside a write run; True if it swapped."""
        with self._write_lock:
            idx = self._current
            if idx.needs_compaction(delta_fill=self.delta_fill,
                                    tombstone_ratio=self.tombstone_ratio):
                self._swap(idx)
                return True
            return False

    def _swap(self, idx):
        t0 = time.perf_counter()
        new = idx.compact(scope=self.scope, **self.compact_kwargs)
        self._current = new  # the RCU publish: one reference assignment
        self.swaps += 1
        obs.counter(mnames.ONLINE_EPOCH_SWAPS).inc()
        obs.histogram(mnames.ONLINE_COMPACTION_TIME).observe(
            time.perf_counter() - t0)
        return new

    def _observe_tiers(self, idx) -> None:
        """Gauge the online tiers after a write run (delta fill ratio,
        tombstoned slots): the feedback the swap policy acts on."""
        if idx.delta is not None and idx.delta.capacity:
            obs.gauge(mnames.ONLINE_DELTA_FILL).set(
                idx.delta.n_active / idx.delta.capacity)
        if idx.tombstones is not None:
            obs.gauge(mnames.ONLINE_TOMBSTONES).set(idx.tombstones.count)


def _rows(vectors) -> np.ndarray:
    v = np.asarray(vectors.cpu() if hasattr(vectors, "cpu") else vectors)
    return v.reshape(1, -1) if v.ndim == 1 else v
