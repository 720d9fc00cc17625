"""Replicated serving substrate: N independent replicas of one PDASC index
(counterpart of ``repro.serving.replicated``; DESIGN.md §3.10).

A :class:`Replica` is one full serving stack — its own
:class:`~repro_torch.serving.engine.BatchingEngine` worker, its own
:class:`~repro_torch.serving.engine.QueryHandler`, and its own
:class:`~repro_torch.online.EpochHandle` over an independently epoch-swapping
index copy. Replicas share the *immutable* build artifacts (level arrays,
payload store — read-only, so one host copy serves the fleet) but never a
mutable tier: each clone gets fresh delta/tombstone tiers and applies
writes through its own handle, swapping epochs on its own schedule. A
replica lagging an epoch behind its peers is fine by construction — RCU
means its readers see a slightly older, still-consistent snapshot.

Writes fan out through a shared :class:`~repro_torch.online.WriteLog`: the set
appends each accepted write once, then submits it to every live replica's
engine (FIFO per replica preserves apply order). Because every clone starts
from the same state and applies the same ordered log, id assignment is
deterministic and identical fleet-wide — which is what lets a crashed
replica *replay* the log suffix past its last applied sequence number on
restart and converge exactly.

Fault injection (``faults.FaultPlan``) wraps each replica's batch handler:
the injector decides per handler dispatch — deterministically, in dispatch
counts — whether the batch runs clean, slow, or dies. The
:class:`~repro_torch.serving.router.Router` above this layer turns those faults
into retries, hedges, ejections and readmissions.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from repro_torch.online import EpochHandle, WriteLog
from repro_torch.serving import faults as faults_lib
from repro_torch.serving.engine import BatchingEngine, QueryHandler, Request


class ReplicaDown(RuntimeError):
    """The replica's engine is not accepting requests (crashed / closed)."""


def clone_index(idx):
    """An independent serving copy of ``idx``.

    Immutable build artifacts (level tensors, payload store, radii) are
    shared by reference — they are read-only on every search path, so N
    replicas cost one resident copy on the device until a replica's first
    compaction publishes its own epoch. Mutable state is NOT shared: the
    clone starts with fresh (empty) online tiers and its own plan cache /
    id-slot table, so per-replica writes and epoch swaps never alias. The source
    index must have clean online tiers (compact first) — cloning a dirty
    index would silently drop its buffered writes from the clones.
    """
    if (idx.delta is not None and idx.delta.n_active) or (
            idx.tombstones is not None and idx.tombstones.count):
        raise ValueError(
            "clone_index needs clean online tiers (active delta entries or "
            "tombstones would not be replicated); compact() first"
        )
    return dataclasses.replace(
        idx, delta=None, tombstones=None,
        _id_slot=None, _plan_cache=None,
    )


class Replica:
    """One replica: engine + query handler + epoch handle + fault injector.

    ``applied_seq`` is the last :class:`WriteLog` sequence number whose
    write was submitted to this replica's engine (FIFO ⇒ it will be applied
    in order before any later submit). The set advances it under its write
    lock; a restart replays ``log.since(applied_seq)``.
    """

    def __init__(self, rid: int, index, query, *,
                 batch_size: int, max_wait_ms: float,
                 degraded_query=None,
                 injector: Optional[faults_lib.FaultInjector] = None,
                 delta_capacity: int = 4096,
                 epoch_kwargs: Optional[dict] = None):
        self.id = rid
        self.query = query
        self.degraded_query = degraded_query
        self.injector = injector
        self.batch_size = batch_size
        self.max_wait_ms = max_wait_ms
        idx = clone_index(index)
        idx.enable_mutations(delta_capacity=delta_capacity)
        self.handle = EpochHandle(idx, **(epoch_kwargs or {}))
        self.applied_seq = -1
        self.engine: Optional[BatchingEngine] = None
        self._dead_engine: Optional[BatchingEngine] = None
        self._out_lock = threading.Lock()
        self._outstanding = 0
        self._pad = np.zeros(idx._dim(), np.float32)
        self.start()

    # -- lifecycle ------------------------------------------------------------

    @property
    def alive(self) -> bool:
        return self.engine is not None

    def _wrap(self, handler):
        """Fault-inject ahead of the real handler: one injector dispatch per
        batch (probes included — they ride the same path)."""
        if self.injector is None:
            return handler

        def faulty(batch, n_valid):
            self.injector.on_dispatch()
            return handler(batch, n_valid)

        return faulty

    def start(self) -> None:
        if self.engine is not None:
            return
        if self._dead_engine is not None:
            # A restart must not overlap the old worker's drain: two workers
            # applying writes to the same handle could reorder ops across
            # the replay boundary. The queue is finite and wedge windows are
            # bounded, so this join terminates.
            self._dead_engine._thread.join(timeout=30.0)
            self._dead_engine = None
        extra = {}
        if self.degraded_query is not None:
            extra["degraded"] = self._wrap(
                QueryHandler(self.handle, self.degraded_query))
        self.engine = BatchingEngine(
            self._wrap(QueryHandler(self.handle, self.query)),
            batch_size=self.batch_size, max_wait_ms=self.max_wait_ms,
            pad_payload=self._pad,
            write_handler=self.handle.apply_writes,
            extra_handlers=extra or None,
            name=f"r{self.id}",  # labels this replica's series in repro_torch.obs
        )

    def kill(self) -> None:
        """Simulated process death: stop accepting, drain what's queued
        (writes already submitted stay durable — ``applied_seq`` was
        advanced for them), tear the engine down."""
        eng, self.engine = self.engine, None
        if eng is not None:
            eng.close()
            self._dead_engine = eng

    def close(self) -> None:
        self.kill()
        self._dead_engine = None

    # -- dispatch -------------------------------------------------------------

    @property
    def outstanding(self) -> int:
        return self._outstanding

    def _done(self, _req: Request) -> None:
        with self._out_lock:
            self._outstanding -= 1

    def submit(self, payload, *, kind: str = "search",
               deadline_s: Optional[float] = None,
               on_done=None, span=None) -> Request:
        """Submit a search-like request; raises :class:`ReplicaDown` when
        the replica is not serving. ``outstanding`` counts requests between
        here and their completion callback (the router's least-loaded
        signal); ``on_done`` chains the caller's completion hook after it;
        ``span`` is the tracing parent forwarded to the engine (a router
        attempt leg)."""
        eng = self.engine
        if eng is None:
            raise ReplicaDown(f"replica r{self.id} is down")
        with self._out_lock:
            self._outstanding += 1
        if on_done is None:
            cb = self._done
        else:
            def cb(req, _extra=on_done):
                self._done(req)
                _extra(req)
        try:
            return eng.submit(payload, kind=kind, deadline_s=deadline_s,
                              on_done=cb, span=span)
        except RuntimeError as e:  # closed between the check and the submit
            with self._out_lock:
                self._outstanding -= 1
            raise ReplicaDown(f"replica r{self.id} is down") from e

    def probe_payload(self):
        return self._pad


class ReplicaSet:
    """N replicas behind one write log.

    Searches go through the :class:`~repro_torch.serving.router.Router` (which
    picks replicas); writes go through :meth:`upsert` / :meth:`delete` here
    — appended to the shared log once, fanned out to every live replica's
    engine. ``restart()`` brings a dead replica back and replays the log
    suffix it missed before any new fan-out can interleave.
    """

    def __init__(self, index, query, *, n_replicas: int,
                 batch_size: int = 16, max_wait_ms: float = 2.0,
                 degraded_query=None,
                 fault_plan: Optional[faults_lib.FaultPlan] = None,
                 delta_capacity: int = 4096,
                 epoch_kwargs: Optional[dict] = None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.query = query
        self.degraded_query = degraded_query
        self.log = WriteLog()
        self._write_lock = threading.Lock()
        self.replicas = [
            Replica(
                rid, index, query,
                batch_size=batch_size, max_wait_ms=max_wait_ms,
                degraded_query=degraded_query,
                injector=(fault_plan.injector(rid)
                          if fault_plan is not None else None),
                delta_capacity=delta_capacity,
                epoch_kwargs=epoch_kwargs,
            )
            for rid in range(n_replicas)
        ]

    def __len__(self) -> int:
        return len(self.replicas)

    def live_index(self):
        """The current epoch's index from the first live replica (falling
        back to replica 0 if none is up) — the exact-reference source for
        the shadow recall estimator and the plan-describe resolver."""
        for r in self.replicas:
            if r.alive:
                return r.handle.current
        return self.replicas[0].handle.current

    # -- write fan-out --------------------------------------------------------

    def upsert(self, vectors, ids=None, *, timeout: float = 60.0):
        """Fan an upsert out to every live replica; returns the assigned ids
        (identical on every replica — same clone state, same ordered log).
        Raises if no replica could durably accept the write."""
        payload = (np.asarray(vectors, np.float32), ids) if ids is not None \
            else np.asarray(vectors, np.float32)
        return self._write("upsert", payload, timeout)

    def delete(self, ids, *, timeout: float = 60.0):
        """Fan a delete-by-ids out to every live replica; returns the
        deleted count (from the first replica to apply it)."""
        return self._write("delete", np.asarray(ids), timeout)

    def _write(self, kind: str, payload, timeout: float):
        with self._write_lock:
            seq = self.log.append(kind, payload)
            submitted = []
            for r in self.replicas:
                if r.engine is None:
                    continue  # down: will replay this seq on restart
                try:
                    if kind == "upsert":
                        req = r.engine.submit_upsert(payload)
                    else:
                        req = r.engine.submit_delete(payload)
                except RuntimeError:
                    continue  # died between the check and the submit
                # FIFO per engine: once submitted, this write applies before
                # any later one — safe to advance the replay cursor now.
                r.applied_seq = seq
                submitted.append(req)
        if not submitted:
            raise ReplicaDown(
                f"write seq={seq} accepted by no replica (all down); it "
                f"stays in the log and applies on the next restart"
            )
        # The write is applied per replica; surface the first result (ids /
        # deleted count agree fleet-wide by construction). Waiting on one
        # replica keeps write latency at min-replica, not max-replica — the
        # rest apply asynchronously but in order.
        first_err = None
        for req in submitted:
            try:
                return req.wait(timeout=timeout)
            except Exception as e:  # noqa: BLE001 — try the next replica
                first_err = e
        raise first_err

    # -- replica lifecycle (the router's prober drives these) ----------------

    def restart(self, rid: int) -> None:
        """Bring a dead replica back and replay the log suffix it missed.
        Holding the write lock across replay means no new fan-out write can
        land between the replayed backlog and live traffic — order is the
        log order, exactly."""
        r = self.replicas[rid]
        with self._write_lock:
            r.start()
            for seq, kind, payload in self.log.since(r.applied_seq):
                if kind == "upsert":
                    r.engine.submit_upsert(payload)
                else:
                    r.engine.submit_delete(payload)
                r.applied_seq = seq

    def kill(self, rid: int) -> None:
        self.replicas[rid].kill()

    def close(self) -> None:
        for r in self.replicas:
            r.close()
