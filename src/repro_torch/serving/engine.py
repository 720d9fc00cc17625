"""Batched request engine (counterpart of ``repro.serving.engine``).

Requests are queued and served in fixed-size batches (padded to the
batch size, so every call gives the kernels the same shapes). A worker
thread drains the queue with a max-wait deadline: a batch departs when
full OR when the oldest request has waited ``max_wait_ms`` (p99-friendly
batching).

``prefetch_fn`` hooks storage-aware serving (DESIGN.md §3.6): while the
worker runs the current batch, a helper thread receives a snapshot of the
payloads still queued — a tiered-store handler uses it to warm the leaf
store's granule cache so the next batch's exact-rerank fetches hit memory
instead of disk (or, behind a remote tier, instead of the network: a
``prefetch_fn`` may return an async ``PrefetchHandle``, which the helper
waits on with a bounded timeout). Prefetching is best-effort: snapshots
that arrive while the helper is busy are coalesced to the latest one, and
exceptions are swallowed (a cold cache is a latency miss, not an error).

``write_handler`` hooks the online substrate (DESIGN.md §3.7):
``submit_upsert`` / ``submit_delete`` enqueue *write* requests into the
same FIFO, and the worker hands consecutive runs of them to the handler
**between** search batches — writes and searches never interleave inside a
batch, and a search submitted after a write is batched after it (read-your-
writes). Because the single worker applies writes while no handler call is
in flight, an ``online.EpochHandle`` write handler can mutate the delta /
tombstone tiers and swap index epochs with no torn (mixed-epoch) batch ever
observable.

``QueryHandler`` adapts a declarative ``repro_torch.query.Query`` into a search
handler (DESIGN.md §3.8): it resolves the live index epoch once per batch
and executes the index's cached plan, so re-planning happens only when the
capability fingerprint changes (e.g. an epoch swap).

Robust serving hooks (DESIGN.md §3.10):

* **per-request deadlines** — ``submit(payload, deadline_s=...)`` stamps an
  absolute deadline from ``Request.enqueued_at``; ``_take_batch`` drops an
  expired request with :class:`DeadlineExceeded` instead of wasting a batch
  slot on a result nobody will read (writes are never dropped — they are
  durable once enqueued);
* **cancellation** — a ``Request.wait(timeout)`` that times out marks the
  request cancelled (so does an explicit ``cancel()``, e.g. a hedged
  router attempt losing the race); the worker skips cancelled requests at
  batch assembly, and a batch whose members all died is never dispatched;
* **extra handler kinds** — ``extra_handlers={"degraded": handler}`` adds
  search-like request kinds batched homogeneously with the same deadline
  logic but served by their own handler: the router's graceful-degradation
  ladder serves a cheaper plan through the same engine without mixing
  plans inside one batch;
* **completion callbacks** — ``Request.on_done`` fires exactly once when a
  request finishes (result, error, or drop); the replicated router uses it
  for least-outstanding load accounting.

Device results (DESIGN.md §3.9 on the card): a handler may return
tensors on the GPU. The worker moves each batch's results to the host
once (one copy per result tensor, after the handler returns) and hands
every request its numpy row, so callers get numpy as they do from
``repro``, and a batch costs no per-request device synchronisation. The
batch itself is stacked on the host (``np.stack`` of the payload rows,
padded to ``batch_size``) and uploaded once by the handler's plan.

Used by ``launch/serve.py`` for PDASC k-NN queries (handler =
QueryHandler over the live index).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch._tree import tree_map
from repro_torch.obs import names as mnames

# Sentinel pushed by close() to wake a worker blocked on the request queue.
_SHUTDOWN = object()

# Write kinds are durable once enqueued: never deadline-dropped or skipped.
_WRITE_KINDS = ("upsert", "delete")


def _to_host(a):
    """A result leaf as a host numpy array (one copy for a device
    tensor)."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before a worker picked it up."""


class Cancelled(RuntimeError):
    """The request was cancelled (waiter timed out / hedge twin won)."""


@dataclasses.dataclass
class Request:
    payload: Any  # one query row (pytree of arrays, leading dim absent)
    id: int = 0
    kind: str = "search"  # "search" | extra handler kinds | "upsert" | "delete"
    enqueued_at: float = 0.0
    # Absolute deadline (time.time()); None = no deadline. Search-kind
    # requests past it are dropped by _take_batch with DeadlineExceeded.
    deadline: Optional[float] = None
    _event: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    # Fired exactly once when the request finishes (result, error or drop).
    # Must be cheap and never raise (exceptions are swallowed) — the worker
    # thread calls it.
    on_done: Optional[Callable[["Request"], None]] = None
    _cancelled: bool = False
    # Tracing (DESIGN.md §3.11): the sampled request's parent span (a
    # router attempt leg, or a Trace root for bare submits). The worker
    # hangs queue_wait / batch_wait / execute children off it. None for
    # the unsampled 1-(1/N) of traffic.
    span: Optional[Any] = None
    _enqueued_pc: float = 0.0  # perf_counter twin of enqueued_at
    _taken_pc: float = 0.0  # stamped when the worker takes it into a batch

    def cancel(self) -> None:
        """Mark the request dead: a worker that has not yet taken it skips
        it instead of computing a result nobody will read. Best-effort — a
        request already inside a batch still computes (its result is simply
        never waited on)."""
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def done(self, timeout: Optional[float] = None) -> bool:
        """Wait up to ``timeout`` for completion WITHOUT cancelling on
        expiry (the router's hedge loop polls this while keeping both
        attempts alive)."""
        return self._event.wait(timeout)

    def wait(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            if self.kind not in _WRITE_KINDS:
                # nobody is left to read the result: let the worker skip it
                self.cancel()
            raise TimeoutError(f"request {self.id} timed out")
        if self.error is not None:
            raise self.error
        return self.result

    def _finish(self, *, result=None, error=None) -> None:
        """Worker-side completion: set outcome, fire the event, run the
        callback exactly once."""
        if error is not None:
            self.error = error
        else:
            self.result = result
        self._event.set()
        if self.on_done is not None:
            try:
                self.on_done(self)
            except Exception:
                pass  # accounting hook, never the worker's problem


class BatchingEngine:
    """handler(batch_pytree [B, ...], n_valid) -> batch results [B, ...]."""

    def __init__(
        self,
        handler: Callable[[Any, int], Any],
        *,
        batch_size: int,
        max_wait_ms: float = 5.0,
        pad_payload: Optional[Any] = None,
        prefetch_fn: Optional[Callable[[list], None]] = None,
        write_handler: Optional[Callable[[list], None]] = None,
        extra_handlers: Optional[dict] = None,
        name: str = "engine",
    ):
        self.handler = handler
        self.name = name  # the registry's `engine` label (replica id)
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1e3
        self.pad_payload = pad_payload
        self.prefetch_fn = prefetch_fn
        self.write_handler = write_handler
        # Search-like kinds beyond "search": batched homogeneously (one kind
        # per batch, same deadline batching) but served by their own handler
        # — e.g. the router's degraded-plan ladder (DESIGN.md §3.10).
        self.extra_handlers = dict(extra_handlers or {})
        bad = set(self.extra_handlers) & ({"search"} | set(_WRITE_KINDS))
        if bad:
            raise ValueError(f"extra_handlers may not shadow builtin "
                             f"request kinds: {sorted(bad)}")
        self._q: queue.Queue = queue.Queue()
        # Lookahead buffer: _take_batch stops a batch at a kind boundary and
        # parks the first request of the next batch here (worker-only).
        self._pending: collections.deque = collections.deque()
        self._ids = itertools.count()
        self._stop = threading.Event()
        # Serialises submit()'s closed-check+enqueue against close()'s
        # stop+sentinel: without it a submit could land in the queue after
        # the worker drained it, leaving a request whose wait() never fires.
        self._submit_lock = threading.Lock()
        # Worker-mutated counters live behind _stats_lock; the public
        # `stats` property returns an atomic copy (the bare-dict attribute
        # it replaces was read torn while the worker mutated it).
        self._stats_lock = threading.Lock()
        self._stats = dict(batches=0, requests=0, occupancy_sum=0.0,
                           prefetches=0, writes=0, write_batches=0,
                           deadline_drops=0, cancelled_skips=0)
        # Registry handles, pre-bound so the hot path pays one lock+add
        # per increment (no name/label lookup per event).
        self._m_requests = obs.counter(mnames.ENGINE_REQUESTS, engine=name)
        self._m_batches = obs.counter(mnames.ENGINE_BATCHES, engine=name)
        self._m_writes = obs.counter(mnames.ENGINE_WRITES, engine=name)
        self._m_write_batches = obs.counter(
            mnames.ENGINE_WRITE_BATCHES, engine=name)
        self._m_prefetches = obs.counter(
            mnames.ENGINE_PREFETCHES, engine=name)
        self._m_deadline_drops = obs.counter(
            mnames.ENGINE_DEADLINE_DROPS, engine=name)
        self._m_cancelled = obs.counter(
            mnames.ENGINE_CANCELLED_SKIPS, engine=name)
        self._m_handler_errors = obs.counter(
            mnames.ENGINE_HANDLER_ERRORS, engine=name)
        self._m_occupancy = obs.histogram(
            mnames.ENGINE_BATCH_OCCUPANCY, engine=name)
        self._m_queue_depth = obs.gauge(
            mnames.ENGINE_QUEUE_DEPTH, engine=name)
        self._m_queue_wait = obs.histogram(
            mnames.ENGINE_QUEUE_WAIT, engine=name)
        self._m_handler_time = obs.histogram(
            mnames.ENGINE_HANDLER_TIME, engine=name)
        self._prefetch_q: Optional[queue.Queue] = None
        self._prefetch_thread = None
        if prefetch_fn is not None:
            # maxsize=1 + drop-and-replace: only the freshest queue snapshot
            # is worth warming the cache for.
            self._prefetch_q = queue.Queue(maxsize=1)
            self._prefetch_thread = threading.Thread(
                target=self._prefetch_worker, daemon=True
            )
            self._prefetch_thread.start()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    @property
    def stats(self) -> dict:
        """Deprecated view (use ``repro_torch.obs``): an atomic snapshot of the
        legacy counter dict. Kept for callers that read e.g.
        ``engine.stats["writes"]``; unlike the bare dict it replaces, the
        copy is taken under the stats lock so a reader can never observe a
        torn multi-key update."""
        with self._stats_lock:
            return dict(self._stats)

    def _bump(self, **deltas) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self._stats[k] += v

    def submit(self, payload, *, kind: str = "search",
               deadline_s: Optional[float] = None,
               on_done: Optional[Callable[[Request], None]] = None,
               span=None) -> Request:
        """Enqueue a search-like request. ``kind`` picks the handler
        ("search", or a key of ``extra_handlers``); ``deadline_s`` is a
        per-request budget from enqueue time — a request still queued when
        it expires is dropped with :class:`DeadlineExceeded` instead of
        occupying a batch slot. ``on_done`` must be attached here (not
        after) so a fast worker can never complete the request first.
        ``span`` is an optional tracing parent (an ``obs.Span``): the
        worker records queue_wait / batch_wait / execute children under
        it for this request."""
        if kind != "search" and kind not in self.extra_handlers:
            raise ValueError(
                f"unknown request kind {kind!r}; registered extra kinds: "
                f"{sorted(self.extra_handlers)}"
            )
        return self._enqueue(payload, kind, deadline_s=deadline_s,
                             on_done=on_done, span=span)

    def submit_upsert(self, payload) -> Request:
        """Enqueue an upsert (payload: vectors, or ``(vectors, ids)``).
        Applied by ``write_handler`` between batches; ``wait()`` returns the
        handler's per-op result (the assigned ids for an ``EpochHandle``)."""
        return self._enqueue_write(payload, "upsert")

    def submit_delete(self, ids) -> Request:
        """Enqueue a delete-by-ids write (see :meth:`submit_upsert`)."""
        return self._enqueue_write(ids, "delete")

    def _enqueue_write(self, payload, kind: str) -> Request:
        if self.write_handler is None:
            raise RuntimeError(
                f"submit_{kind}() needs a write_handler (e.g. "
                f"online.EpochHandle.apply_writes)"
            )
        return self._enqueue(payload, kind)

    def _enqueue(self, payload, kind: str,
                 deadline_s: Optional[float] = None,
                 on_done=None, span=None) -> Request:
        with self._submit_lock:
            if self._stop.is_set():
                # Raise at the call site instead of enqueueing a request
                # whose event can never fire (the worker drains requests
                # enqueued before the shutdown sentinel, then exits).
                raise RuntimeError(
                    "BatchingEngine is closed; submit() rejected"
                )
            now = time.time()
            req = Request(payload=payload, id=next(self._ids), kind=kind,
                          enqueued_at=now,
                          deadline=(now + deadline_s
                                    if deadline_s is not None else None),
                          on_done=on_done, span=span,
                          _enqueued_pc=time.perf_counter())
            self._q.put(req)
        return req

    def _drop_dead(self, req: Request, now: Optional[float] = None) -> bool:
        """Drop a cancelled / deadline-expired search-kind request (its
        wait() fires with the drop error). Returns True when dropped.
        Writes are durable once enqueued and never dropped."""
        if req.kind in _WRITE_KINDS:
            return False
        if req.cancelled:
            self._bump(cancelled_skips=1)
            self._m_cancelled.inc()
            req._finish(error=Cancelled(f"request {req.id} cancelled"))
            return True
        if req.deadline is not None and (now or time.time()) > req.deadline:
            self._bump(deadline_drops=1)
            self._m_deadline_drops.inc()
            req._finish(error=DeadlineExceeded(
                f"request {req.id} missed its deadline before a worker "
                f"took it"))
            return True
        return False

    def _take_batch(self) -> list[Request]:
        # Block until traffic arrives — an idle worker parks on the queue
        # instead of spinning a poll loop; close() unblocks it via a
        # sentinel. Batches are kind-homogeneous: a batch ends at a
        # search/write boundary and the boundary request parks in _pending
        # (FIFO preserved — a search enqueued after a write runs after it).
        while True:  # loop past requests that died while queued
            if self._pending:
                first = self._pending.popleft()
            else:
                first = self._q.get()
            if first is _SHUTDOWN:
                return []
            if not self._drop_dead(first):
                break
        first._taken_pc = time.perf_counter()
        self._m_queue_depth.set(self._q.qsize())
        batch = [first]
        if first.kind in _WRITE_KINDS:
            # Writes batch without a deadline: take whatever writes are
            # already queued (arrival order) and apply them immediately.
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is _SHUTDOWN or item.kind not in _WRITE_KINDS:
                    self._pending.append(item)
                    break
                batch.append(item)
            return batch
        deadline = first.enqueued_at + self.max_wait
        while len(batch) < self.batch_size:
            remaining = deadline - time.time()
            if remaining <= 0:
                # deadline already expired (a backlog piled up behind a slow
                # write run / compaction swap): still drain what is already
                # queued — those requests cost nothing to include, and
                # serving the backlog as single-query batches would crater
                # throughput exactly when batching matters most
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
            else:
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
            if item is _SHUTDOWN:
                # close() raced the fill: serve what we have; the worker
                # loop re-checks _stop (already set) and exits after.
                break
            if self._drop_dead(item):
                continue  # expired while queued: its slot goes to a live one
            if item.kind != first.kind:
                # kind boundary (a write, or a different search handler):
                # close this batch, the boundary request opens the next one
                self._pending.append(item)
                break
            item._taken_pc = time.perf_counter()
            batch.append(item)
        return batch

    def _prefetch_worker(self):
        while True:
            snapshot = self._prefetch_q.get()
            if snapshot is _SHUTDOWN:
                return
            try:
                handle = self.prefetch_fn(snapshot)
                if hasattr(handle, "wait"):
                    # async warm-up (store.cache.PrefetchHandle, the remote
                    # tier): bound the wait so a slow/faulted remote only
                    # coalesces snapshots, never wedges this thread
                    handle.wait(timeout=30.0)
                self._bump(prefetches=1)
                self._m_prefetches.inc()
            except Exception:
                pass  # best-effort: a cold cache costs latency, not errors

    def _kick_prefetch(self):
        """Hand the still-queued payloads to the prefetch thread (so cache
        warming overlaps the handler call for the batch just taken)."""
        if self._stop.is_set():  # shutting down: nothing left worth warming
            return
        with self._q.mutex:
            snapshot = [r.payload for r in self._q.queue
                        if r is not _SHUTDOWN and r.kind not in _WRITE_KINDS
                        and not r.cancelled]
        if not snapshot:
            return
        try:
            self._prefetch_q.put_nowait(snapshot)
        except queue.Full:  # helper busy: drop the stale snapshot
            try:
                dropped = self._prefetch_q.get_nowait()
            except queue.Empty:
                dropped = None
            if dropped is _SHUTDOWN:
                # close() raced us: restore the sentinel, never swallow it
                # (the prefetch thread must still terminate).
                self._prefetch_q.put(dropped)
                return
            try:
                self._prefetch_q.put_nowait(snapshot)
            except queue.Full:
                pass

    def _apply_writes(self, batch: list[Request]) -> None:
        """Hand a run of write requests to the handler *between* batches —
        the only place the index may mutate or swap epochs, so no search
        batch ever straddles one. Per-op results may be exceptions (a
        handler like ``EpochHandle.apply_writes`` isolates op failures so an
        already-applied write is never reported as failed); a handler-level
        exception fails the whole run. Either way the worker survives and
        each request's wait() returns or re-raises accordingly."""
        ops = [(r.kind, r.payload) for r in batch]
        results = None
        err = None
        try:
            results = self.write_handler(ops)
            if results is not None:
                # normalise inside the try: a generator / wrong-length
                # return is a handler bug to report, never a dead worker
                # or a silent result=None for every waiter
                results = list(results)
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"write_handler returned {len(results)} results "
                        f"for {len(batch)} ops"
                    )
        except BaseException as e:  # noqa: BLE001 — reported via wait()
            err = e
        for i, r in enumerate(batch):
            if err is not None:
                r._finish(error=err)
            elif results is not None and isinstance(results[i], BaseException):
                r._finish(error=results[i])
            else:
                r._finish(result=results[i] if results is not None else None)
        self._bump(writes=len(batch), write_batches=1)
        self._m_writes.inc(len(batch))
        self._m_write_batches.inc()

    def _worker(self):
        # After close() the worker drains requests already enqueued (they
        # hold waiting callers) before exiting; _take_batch cannot block
        # here because a non-empty queue returns promptly.
        while (not self._stop.is_set() or not self._q.empty()
               or self._pending):
            batch = self._take_batch()
            if not batch:
                continue
            if batch[0].kind in _WRITE_KINDS:
                self._apply_writes(batch)
                continue
            # last-moment skip: a waiter may have timed out / a hedge twin
            # won between batch assembly and here — don't burn a handler
            # call on a batch nobody is waiting for
            batch = [r for r in batch if not self._drop_dead(r)]
            if not batch:
                continue
            if self._prefetch_q is not None:
                self._kick_prefetch()
            n = len(batch)
            handler = (self.handler if batch[0].kind == "search"
                       else self.extra_handlers[batch[0].kind])
            pad = self.pad_payload if self.pad_payload is not None else batch[0].payload
            rows = [r.payload for r in batch] + [pad] * (self.batch_size - n)
            stacked = tree_map(lambda *xs: np.stack(xs), *rows)
            # Tracing: a batch serves many requests, several of which may
            # be sampled. Each traced request gets queue_wait / batch_wait
            # children (backdated from its own stamps) plus an execute
            # span; the execute spans form the thread's active set around
            # the handler call, so stage spans recorded inside (plan,
            # scan, rerank, granule fetches) mirror into every sampled
            # request of the batch.
            exec_spans = []
            t_exec = time.perf_counter()
            for r in batch:
                if r.span is None:
                    continue
                qw = r.span.child("queue_wait")
                qw.t0, qw.t1 = r._enqueued_pc, r._taken_pc
                bw = r.span.child("batch_wait")
                bw.t0, bw.t1 = r._taken_pc, t_exec
                exec_spans.append(r.span.child(
                    "execute", kind=batch[0].kind, batch=n,
                    engine=self.name))
            # The results' copies to the host (one a result tensor, for the
            # whole batch; the first waits for the batch's device work) lie
            # inside the try, where a device error surfaces, and inside the
            # execute span, which so ends when they are read.
            try:
                if exec_spans:
                    with obs.activate(exec_spans):
                        host = tree_map(_to_host, handler(stacked, n))
                else:
                    host = tree_map(_to_host, handler(stacked, n))
            except BaseException as e:  # noqa: BLE001 — a handler failure
                # fails this batch (each wait() re-raises), never the worker:
                # a dead worker would silently hang every queued and future
                # request until TimeoutError
                for s in exec_spans:
                    s.end(error=type(e).__name__)
                for r in batch:
                    r._finish(error=e)
                self._bump(batches=1, requests=n,
                           occupancy_sum=n / self.batch_size)
                self._m_handler_errors.inc()
                self._finish_batch_metrics(batch, n, t_exec)
                continue
            for s in exec_spans:
                s.end()
            for i, r in enumerate(batch):
                r._finish(result=tree_map(lambda a: a[i], host))
            self._bump(batches=1, requests=n,
                       occupancy_sum=n / self.batch_size)
            self._finish_batch_metrics(batch, n, t_exec)

    def _finish_batch_metrics(self, batch, n, t_exec):
        self._m_batches.inc()
        self._m_requests.inc(n)
        self._m_occupancy.observe(n / self.batch_size)
        self._m_handler_time.observe(time.perf_counter() - t_exec)
        for r in batch:
            self._m_queue_wait.observe(r._taken_pc - r._enqueued_pc)

    def close(self):
        with self._submit_lock:
            self._stop.set()
            self._q.put(_SHUTDOWN)  # wake a worker parked on get(); any
            # request enqueued before the sentinel still gets served.
        self._thread.join(timeout=2.0)
        if self._prefetch_q is not None:
            try:  # drop any pending snapshot so the sentinel never blocks
                self._prefetch_q.get_nowait()
            except queue.Empty:
                pass
            self._prefetch_q.put(_SHUTDOWN)
            self._prefetch_thread.join(timeout=2.0)

    @property
    def mean_occupancy(self) -> float:
        snap = self.stats  # one atomic snapshot (not two racing reads)
        b = snap["batches"]
        return snap["occupancy_sum"] / b if b else 0.0


class QueryHandler:
    """Serve a declarative ``repro_torch.query.Query`` as the engine's search
    handler (DESIGN.md §3.8).

    ``source`` is where the live index comes from: a ``PDASCIndex``, an
    ``online.EpochHandle`` (anything with a ``.current`` epoch reference),
    or a zero-arg callable returning the index. Each batch resolves the
    epoch snapshot **once** and executes ``idx.plan(query)`` — the
    per-index plan cache keys on the capability fingerprint, so the plan is
    reused across batches and re-planning happens only when capabilities
    actually change (an epoch swap publishes a new index object with a
    fresh cache; a write dirtying a tier flips the fingerprint). Steady
    state is one cached plan, zero retraces.
    """

    def __init__(self, source, query):
        self.query = query
        if hasattr(source, "current"):  # EpochHandle-like (RCU reference)
            self._resolve = lambda: source.current
        elif callable(source) and not hasattr(source, "plan"):
            self._resolve = source
        else:  # a bare (frozen or manually-mutated) index
            self._resolve = lambda: source

    @property
    def current(self):
        """The index snapshot the next batch would serve against."""
        return self._resolve()

    def plan(self):
        """The plan the next batch would execute (for ``explain()``)."""
        return self.current.plan(self.query)

    def describe(self) -> dict:
        """Plan features for the next batch (``SearchPlan.describe()``) —
        what the cost log joins against measured span timings."""
        return self.plan().describe()

    def __call__(self, batch, n_valid):
        res = self.current.plan(self.query)(batch)
        return res.dists, res.ids
