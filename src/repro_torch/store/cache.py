"""Granule cache for the out-of-core exact payload (counterpart of
``repro.store.cache``).

* :class:`GranuleCache` — a bounded, thread-safe LRU of decoded granules
  keyed by granule index, with **in-flight dedup**: when two threads ask
  for the same missing granule, exactly one runs the fetch; the other
  blocks on it and then reads the inserted value. A fetch that raises
  releases its in-flight claim so waiters retry (or surface the error
  themselves): a failing fetch can never wedge the cache.
* :class:`PrefetchPool` — a small worker pool draining a depth-bounded
  queue of granule keys, warming the cache ahead of the exact rerank. Keys
  already resident, queued or being fetched are dropped at submit time; a
  full queue drops the overflow (counted) rather than blocking the
  submitter. Prefetch is advisory: worker errors leave the granule cold,
  and the synchronous fetch is the correctness path.

Both keep a plain ``stats`` dict and publish ``repro``'s series to the
``repro_torch.obs`` registry (the cache's labelled by ``tier=``).
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Optional, Sequence

from repro_torch import obs
from repro_torch.obs import names as mnames


class GranuleCache:
    """Bounded LRU of decoded granules with in-flight fetch dedup.

    ``get(key, fetch)`` is the only read path: a hit bumps recency; a miss
    claims the key, runs ``fetch(key)`` *outside* the lock, inserts the
    result and wakes any waiters. Values are treated as immutable.
    ``prefetch=True`` marks the insert as warm-up, so that a later real hit
    counts as "prefetch useful". ``tier`` labels the cache's series."""

    def __init__(self, capacity: int, *, tier: str = "host"):
        self.capacity = max(1, int(capacity))
        self.tier = tier
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._inflight: dict = {}  # key -> threading.Event
        self._prefetched: set = set()
        self._resident_bytes = 0
        self.stats = dict(hits=0, misses=0, evictions=0, inflight_waits=0,
                          prefetch_useful=0)
        self._m_hits = obs.counter(mnames.STORE_CACHE_HITS, tier=tier)
        self._m_misses = obs.counter(mnames.STORE_CACHE_MISSES, tier=tier)
        self._m_evictions = obs.counter(mnames.STORE_CACHE_EVICTIONS,
                                        tier=tier)
        self._m_resident = obs.gauge(mnames.STORE_CACHE_RESIDENT, tier=tier)
        self._m_hit_ratio = obs.gauge(mnames.STORE_CACHE_HIT_RATIO, tier=tier)
        self._m_dedup = obs.counter(mnames.STORE_CACHE_INFLIGHT_DEDUP,
                                    tier=tier)

    # -- internals (call with self._lock held) --------------------------------

    def _record_hit(self, key, *, prefetch: bool) -> None:
        self._entries.move_to_end(key)
        self.stats["hits"] += 1
        if not prefetch and key in self._prefetched:
            # first real hit on a warm-up insert: the prefetch saved one read
            self._prefetched.discard(key)
            self.stats["prefetch_useful"] += 1
        self._m_hits.inc()
        self._update_ratio()

    def _update_ratio(self) -> None:
        total = self.stats["hits"] + self.stats["misses"]
        if total:
            self._m_hit_ratio.set(self.stats["hits"] / total)

    def _insert(self, key, value, *, prefetch: bool) -> None:
        old = self._entries.pop(key, None)
        if old is not None:
            self._resident_bytes -= int(getattr(old, "nbytes", 0))
        self._entries[key] = value
        self._resident_bytes += int(getattr(value, "nbytes", 0))
        if prefetch:
            self._prefetched.add(key)
        else:
            # a real fetch of a granule prefetched but already evicted
            self._prefetched.discard(key)
        while len(self._entries) > self.capacity:
            k, v = self._entries.popitem(last=False)
            self._resident_bytes -= int(getattr(v, "nbytes", 0))
            self._prefetched.discard(k)
            self.stats["evictions"] += 1
            self._m_evictions.inc()
        self._m_resident.set(self._resident_bytes)

    # -- public ---------------------------------------------------------------

    def get(self, key, fetch: Callable, *, prefetch: bool = False):
        """The granule for ``key``, via LRU -> in-flight wait -> fetch."""
        while True:
            with self._lock:
                value = self._entries.get(key)
                if value is not None:
                    self._record_hit(key, prefetch=prefetch)
                    return value
                ev = self._inflight.get(key)
                owner = ev is None
                if owner:
                    ev = self._inflight[key] = threading.Event()
                else:
                    self.stats["inflight_waits"] += 1
                    self._m_dedup.inc()
            if not owner:
                ev.wait()
                # the owner inserted the value, or its fetch raised and the
                # key is absent: retry, fetching it ourselves if still missing
                with self._lock:
                    value = self._entries.get(key)
                    if value is not None:
                        self._record_hit(key, prefetch=prefetch)
                        return value
                continue
            try:
                value = fetch(key)
            except BaseException:
                # release the claim so waiters retry the fetch themselves
                with self._lock:
                    self._inflight.pop(key, None)
                ev.set()
                raise
            with self._lock:
                self.stats["misses"] += 1
                self._m_misses.inc()
                self._insert(key, value, prefetch=prefetch)
                self._inflight.pop(key, None)
                self._update_ratio()
            ev.set()
            return value

    def claimed(self, key) -> bool:
        """True if ``key`` is resident or currently being fetched."""
        with self._lock:
            return key in self._entries or key in self._inflight

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class PrefetchHandle:
    """Completion handle for one ``PrefetchPool.submit`` batch."""

    def __init__(self, n: int):
        self._remaining = n
        self._lock = threading.Lock()
        self._done = threading.Event()
        if n == 0:
            self._done.set()

    def _one_done(self) -> None:
        with self._lock:
            self._remaining -= 1
            if self._remaining <= 0:
                self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every accepted key was processed."""
        return self._done.wait(timeout)


class PrefetchPool:
    """Async granule warm-up: N daemon workers draining a depth-bounded
    queue.

    ``submit(keys)`` drops keys resident, in flight or already queued,
    enqueues the rest up to the depth bound, and returns a
    :class:`PrefetchHandle` over the *accepted* keys. Workers run
    ``cache.get(key, fetch, prefetch=True)``; a fetch error is counted and
    otherwise ignored (the granule stays cold)."""

    def __init__(self, cache: GranuleCache, fetch: Callable, *,
                 workers: int = 2, depth: int = 64):
        self.cache = cache
        self.fetch = fetch
        self.depth = max(1, int(depth))
        self._lock = threading.Lock()
        self._queued: set = set()
        self._q: collections.deque = collections.deque()
        self._have_work = threading.Condition(self._lock)
        self._closed = False
        self.stats = dict(submitted=0, accepted=0, dropped=0, errors=0)
        self._m_queue = obs.gauge(mnames.STORE_PREFETCH_QUEUE)
        self._m_drops = obs.counter(mnames.STORE_PREFETCH_DROPS)
        self._m_prefetched = obs.counter(mnames.STORE_PREFETCHED)
        self._workers = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"granule-prefetch-{i}")
            for i in range(max(1, int(workers)))
        ]
        for w in self._workers:
            w.start()

    def submit(self, keys: Sequence) -> PrefetchHandle:
        accepted = []
        with self._lock:
            if self._closed:
                return PrefetchHandle(0)
            for key in keys:
                self.stats["submitted"] += 1
                if key in self._queued or self.cache.claimed(key):
                    continue
                if len(self._q) + len(accepted) >= self.depth:
                    self.stats["dropped"] += 1
                    self._m_drops.inc()
                    continue
                accepted.append(key)
            if not accepted:
                return PrefetchHandle(0)
            handle = PrefetchHandle(len(accepted))
            for key in accepted:
                self._queued.add(key)
                self._q.append((key, handle))
            self.stats["accepted"] += len(accepted)
            self._m_queue.set(len(self._q))
            self._have_work.notify(len(accepted))
        return handle

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._q and not self._closed:
                    self._have_work.wait()
                if self._closed and not self._q:
                    return
                key, handle = self._q.popleft()
                self._m_queue.set(len(self._q))
            try:
                self.cache.get(key, self.fetch, prefetch=True)
                self._m_prefetched.inc()
            except Exception:  # noqa: BLE001 — advisory path, never wedge
                with self._lock:
                    self.stats["errors"] += 1
            finally:
                with self._lock:
                    self._queued.discard(key)
                handle._one_done()

    def close(self) -> None:
        """Drop what is queued; wake and join the workers."""
        with self._lock:
            self._closed = True
            for _, handle in self._q:
                handle._one_done()
            self._q.clear()
            self._queued.clear()
            self._m_queue.set(0)
            self._have_work.notify_all()
        for w in self._workers:
            w.join(timeout=5)
