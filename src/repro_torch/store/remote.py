"""Remote object-store payload tier (counterpart of ``repro.store.remote``).

The out-of-core exact payload past the host memmap: granules
(``block``-row slabs of the fp32 leaf table, the unit the memmap path
fetches and the distributed deployment places per shard) live as objects in
a :class:`RemoteStore`, fronted by the host LRU and the async prefetch pool
of ``repro_torch.store.cache``. A query sees

    device (codes + scales, resident)
      -> host LRU (decoded granules, bounded)
        -> remote store (the dataset; never resident)

Backends:

* :class:`LocalFSStore` — objects as files under a root directory; the
  durable form (save/load v5 reopens it from the manifest).
* :class:`SimulatedObjectStore` — in-memory objects behind a per-op
  latency, a bandwidth and a parallelism cap, plus a fault seam: any object
  with the ``FaultInjector`` protocol (``on_dispatch()``, as
  ``repro_torch.serving.faults`` hands out) runs at the top of every op, so
  the fault plans' windows in dispatch-count space drive remote outages
  deterministically; an injected error surfaces as
  :class:`RemoteStoreError`.
* anything else a deployment supplies: the interface is four methods.

:class:`RemoteSource` adapts a store + cache + pool to the exact-payload
interface ``LeafStore`` and ``two_stage`` use from ``ExactSource``
(``fetch_rows`` / ``prefetch`` / ``prefetch_async`` / ``read_all`` / ``n`` /
``d`` / ``nbytes`` / ``stats``), so two-stage search, serving prefetch and
persistence work unchanged on a remote tier. The tier emits ``repro``'s
``store_remote_*`` series (gets, puts, errors, fetch seconds and bytes)
beside the ``store_granule_*`` series the memmap path reports.
"""

from __future__ import annotations

import abc
import json
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.obs import names as mnames
from repro_torch.store.cache import GranuleCache, PrefetchHandle, PrefetchPool

MANIFEST_KEY = "manifest.json"


def granule_key(g: int, *, prefix: str = "") -> str:
    """Canonical object key of granule ``g`` (zero-padded: keys list in
    granule order)."""
    return f"{prefix}granule/{g:08d}"


class RemoteStoreError(RuntimeError):
    """A remote-store op failed (wraps backend and injected errors)."""


class RemoteStore(abc.ABC):
    """Pluggable object store: opaque bytes under string keys.

    Implementations are thread-safe (the prefetch pool and the synchronous
    fetch path issue concurrent ops). ``get_batch`` is the batched read;
    the default loops ``get``."""

    kind: str = "abstract"

    @abc.abstractmethod
    def get(self, key: str) -> bytes:
        """The object's bytes; raises ``KeyError`` when absent."""

    @abc.abstractmethod
    def put(self, key: str, data: bytes) -> None:
        """Write (or overwrite) one object."""

    @abc.abstractmethod
    def list_keys(self, prefix: str = "") -> list[str]:
        """Sorted keys under ``prefix``."""

    @abc.abstractmethod
    def delete(self, key: str) -> None:
        """Remove one object (absent keys are ignored)."""

    def get_batch(self, keys: Sequence[str]) -> list[bytes]:
        return [self.get(k) for k in keys]

    def exists(self, key: str) -> bool:
        try:
            self.get(key)
            return True
        except KeyError:
            return False

    def manifest(self) -> dict:
        """Reopen info for save/load v5."""
        return dict(kind=self.kind)


class LocalFSStore(RemoteStore):
    """Objects as files under ``root``: the durable local backend. Keys are
    slash-separated relative paths; writes are atomic (temp + rename)."""

    kind = "localfs"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        p = os.path.abspath(os.path.join(self.root, key))
        if not p.startswith(self.root + os.sep) and p != self.root:
            raise ValueError(f"object key {key!r} escapes the store root")
        return p

    def get(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key) from None

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def list_keys(self, prefix: str = "") -> list[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def manifest(self) -> dict:
        return dict(kind=self.kind, root=self.root)


class SimulatedObjectStore(RemoteStore):
    """In-memory object store with a configurable performance envelope.

    ``latency_ms`` sleeps per op, ``bandwidth_mbps`` adds a
    payload-proportional transfer time, and ``parallelism`` caps concurrent
    ops with a semaphore (``get_batch`` fans out up to that width).
    ``faults``: any object with ``on_dispatch()``, run at the top of every
    op; what it raises surfaces as :class:`RemoteStoreError` and counts in
    ``op_counts["errors"]`` and the ``store_remote_errors_total`` series."""

    kind = "sim"

    def __init__(self, *, latency_ms: float = 0.0,
                 bandwidth_mbps: Optional[float] = None,
                 parallelism: int = 8, faults=None):
        self.latency_s = max(0.0, latency_ms) / 1e3
        self.bandwidth_mbps = bandwidth_mbps
        self.parallelism = max(1, int(parallelism))
        self.faults = faults
        self._objects: dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._sem = threading.Semaphore(self.parallelism)
        self.op_counts = dict(get=0, put=0, list=0, delete=0, errors=0)
        self._m_errors = obs.counter(mnames.STORE_REMOTE_ERRORS)

    def _op(self, name: str, nbytes: int = 0) -> None:
        with self._lock:
            self.op_counts[name] += 1
        if self.faults is not None:
            try:
                self.faults.on_dispatch()
            except Exception as e:
                with self._lock:
                    self.op_counts["errors"] += 1
                self._m_errors.inc()
                raise RemoteStoreError(
                    f"remote {name} failed: {type(e).__name__}: {e}"
                ) from e
        delay = self.latency_s
        if self.bandwidth_mbps and nbytes:
            delay += nbytes / (self.bandwidth_mbps * 1e6)
        if delay:
            time.sleep(delay)

    def get(self, key: str) -> bytes:
        with self._lock:
            present = key in self._objects
            data = self._objects.get(key, b"")
        with self._sem:
            self._op("get", len(data))
        if not present:
            raise KeyError(key)
        return data

    def get_batch(self, keys: Sequence[str]) -> list[bytes]:
        if len(keys) <= 1:
            return [self.get(k) for k in keys]
        out: list = [None] * len(keys)
        errors: list = []

        def one(i, k):
            try:
                out[i] = self.get(k)
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i, k), daemon=True)
                   for i, k in enumerate(keys)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out

    def put(self, key: str, data: bytes) -> None:
        with self._sem:
            self._op("put", len(data))
        with self._lock:
            self._objects[key] = bytes(data)

    def list_keys(self, prefix: str = "") -> list[str]:
        self._op("list")
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def delete(self, key: str) -> None:
        self._op("delete")
        with self._lock:
            self._objects.pop(key, None)

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._objects.values())


def open_store(manifest: dict) -> RemoteStore:
    """Reopen a remote store from its save/load-v5 manifest entry. Only
    durable kinds reopen (``localfs``); a ``sim`` store is process-local,
    and the caller rebinds one through ``PDASCIndex.load(remote=...)``."""
    kind = manifest.get("kind")
    if kind == "localfs":
        return LocalFSStore(manifest["root"])
    raise ValueError(
        f"remote store kind {kind!r} cannot be reopened from a manifest; "
        f"pass a live store via PDASCIndex.load(path, remote=...)"
    )


class RemoteSource:
    """Exact fp32 payload served from a :class:`RemoteStore` through the
    host granule cache and the async prefetch pool.

    A drop-in for ``ExactSource`` (``LeafStore.exact``): the same ``block``
    granularity, ``fetch_rows`` / ``prefetch`` / ``prefetch_async`` /
    ``read_all`` and ``stats`` keys. ``on_disk`` is False, ``remote`` and
    ``wants_prefetch`` are True. ``fetch_rows`` groups the rows by granule
    with one sort, as ``ExactSource`` does (``repro`` masks once per
    granule); its outputs and cache counts are the same."""

    def __init__(self, store: RemoteStore, *, n: int, d: int, block: int,
                 prefix: str = "", cache_granules: int = 256,
                 prefetch_workers: int = 2,
                 prefetch_depth: Optional[int] = None):
        self.store = store
        self.n, self.d, self.block = int(n), int(d), int(block)
        self.prefix = prefix
        self.n_granules = -(-self.n // self.block)
        self.cache = GranuleCache(cache_granules, tier="host")
        self._m_gets = obs.counter(mnames.STORE_REMOTE_GETS)
        self._m_fetch_time = obs.histogram(mnames.STORE_REMOTE_FETCH_TIME)
        self._m_fetch_bytes = obs.counter(mnames.STORE_REMOTE_FETCH_BYTES)
        # the memmap path's store_granule_* series too, so dashboards keyed
        # on them read every backend
        self._m_fetches = obs.counter(mnames.STORE_FETCHES)
        self._m_hits = obs.counter(mnames.STORE_HITS)
        self._m_legacy_bytes = obs.counter(mnames.STORE_FETCH_BYTES)
        self._m_cached = obs.gauge(mnames.STORE_CACHE_GRANULES)
        self.pool = PrefetchPool(
            self.cache, self._fetch_granule, workers=prefetch_workers,
            depth=prefetch_depth if prefetch_depth is not None
            else max(8, cache_granules // 2),
        )

    # -- ExactSource-compatible surface ---------------------------------------

    @property
    def on_disk(self) -> bool:
        return False

    @property
    def remote(self) -> bool:
        return True

    @property
    def wants_prefetch(self) -> bool:
        return True

    @property
    def path(self) -> Optional[str]:
        return None

    @property
    def nbytes(self) -> int:
        """Exact payload bytes held by the remote tier."""
        return self.n * self.d * 4

    @property
    def cache_resident_bytes(self) -> int:
        return self.cache.resident_bytes

    @property
    def stats(self) -> dict:
        """Fetches (remote reads) and hits, as ``ExactSource.stats``."""
        c = self.cache.stats
        return dict(fetches=c["misses"], hits=c["hits"])

    def _rows_of(self, g: int) -> int:
        return min(self.block, self.n - g * self.block)

    def _decode(self, g: int, data: bytes) -> np.ndarray:
        rows = self._rows_of(g)
        arr = np.frombuffer(data, np.float32)
        if arr.size != rows * self.d:
            raise RemoteStoreError(
                f"granule {g} holds {arr.size} floats, expected "
                f"{rows}x{self.d} (corrupt object or wrong manifest)"
            )
        return arr.reshape(rows, self.d)

    def _fetch_granule(self, g: int) -> np.ndarray:
        t0 = time.perf_counter()
        data = self.store.get(granule_key(g, prefix=self.prefix))
        self._m_fetch_time.observe(time.perf_counter() - t0)
        self._m_gets.inc()
        self._m_fetch_bytes.inc(len(data))
        return self._decode(g, data)

    def _granule(self, g: int) -> np.ndarray:
        before = self.cache.stats["misses"]
        blk = self.cache.get(g, self._fetch_granule)
        if self.cache.stats["misses"] != before:
            self._m_fetches.inc()
            self._m_legacy_bytes.inc(blk.nbytes)
        else:
            self._m_hits.inc()
        self._m_cached.set(len(self.cache))
        return blk

    def fetch_rows(self, idx) -> np.ndarray:
        """Gather exact rows: ``idx [...]`` int -> ``[..., d]`` f32,
        granule-wise in ascending order. A missing granule resolves through
        the cache's in-flight dedup (a fetch racing a prefetch of the same
        granule reads the store once); remote errors, injected ones
        included, propagate to the caller."""
        idx = np.asarray(idx, np.int64)
        flat = np.clip(idx.reshape(-1), 0, self.n - 1)
        out = np.empty((flat.shape[0], self.d), np.float32)
        gran = flat // self.block
        order = np.argsort(gran, kind="stable")
        uniq, starts = np.unique(gran[order], return_index=True)
        ends = np.append(starts[1:], order.shape[0])
        with obs.span("granule_fetch", kind="remote",
                      granules=int(uniq.size), rows=int(flat.shape[0])):
            for g, lo, hi in zip(uniq.tolist(), starts.tolist(),
                                 ends.tolist()):
                sel = order[lo:hi]
                out[sel] = self._granule(g)[flat[sel] - g * self.block]
        return out.reshape(*idx.shape, self.d)

    def prefetch(self, granules) -> None:
        """Synchronous warm-up: enqueue on the pool and wait."""
        self.prefetch_async(granules).wait()

    def prefetch_async(self, granules) -> PrefetchHandle:
        gs = np.unique(np.asarray(granules, np.int64))
        gs = gs[(gs >= 0) & (gs < self.n_granules)][: self.cache.capacity]
        return self.pool.submit([int(g) for g in gs])

    def read_all(self) -> np.ndarray:
        """The whole exact payload, read at the store's parallelism width
        (the ∞ mode and the non-v5 save path; bypasses the LRU so a full
        read cannot evict the working set)."""
        out = np.empty((self.n, self.d), np.float32)
        keys = [granule_key(g, prefix=self.prefix)
                for g in range(self.n_granules)]
        width = getattr(self.store, "parallelism", 8)
        for lo in range(0, len(keys), width):
            datas = self.store.get_batch(keys[lo:lo + width])
            for off, data in enumerate(datas):
                g = lo + off
                r0 = g * self.block
                out[r0:r0 + self._rows_of(g)] = self._decode(g, data)
        self._m_gets.inc(len(keys))
        return out

    def close(self) -> None:
        self.pool.close()

    def manifest(self) -> dict:
        m = dict(self.store.manifest())
        m.update(n=self.n, d=self.d, block=self.block, prefix=self.prefix,
                 n_granules=self.n_granules)
        return m


def upload_payload(store: RemoteStore, points, block: int, *,
                   prefix: str = "") -> dict:
    """Flush a whole exact fp32 payload into ``store`` as ``block``-row
    granules plus a ``manifest.json`` object; returns the manifest (the
    migration path of an in-memory or memmapped index)."""
    pts = np.ascontiguousarray(np.asarray(points, np.float32))
    n, d = pts.shape
    upload_granules(store, pts, block, row_offset=0, prefix=prefix)
    manifest = dict(kind=store.kind, n=n, d=d, block=block, prefix=prefix,
                    n_granules=-(-n // block))
    store.put(prefix + MANIFEST_KEY, json.dumps(manifest).encode("utf-8"))
    return manifest


def upload_granules(store: RemoteStore, rows: np.ndarray, block: int, *,
                    row_offset: int, prefix: str = "") -> int:
    """Write ``rows`` (``[m, d]`` f32 at a granule-aligned ``row_offset``)
    as whole granules; the last may be short only when these are the
    payload's final rows. Returns the granule count written."""
    if row_offset % block:
        raise ValueError(
            f"row_offset={row_offset} is not aligned to block={block}; "
            f"granules cannot straddle shard boundaries"
        )
    rows = np.ascontiguousarray(np.asarray(rows, np.float32))
    m = rows.shape[0]
    g0 = row_offset // block
    n_g = -(-m // block)
    m_puts = obs.counter(mnames.STORE_REMOTE_PUTS)
    for j in range(n_g):
        blk = rows[j * block:(j + 1) * block]
        store.put(granule_key(g0 + j, prefix=prefix), blk.tobytes())
    m_puts.inc(n_g)
    return n_g


def make_remote(index, store: RemoteStore, *, cache_granules: int = 256,
                prefetch_workers: int = 2,
                prefetch_depth: Optional[int] = None) -> RemoteSource:
    """Move an index's exact payload to ``store`` and serve it remotely:
    upload the payload as granules, swap the leaf store's exact source for
    a :class:`RemoteSource`, and release the dense leaf array (remote
    serving is the released, two-stage form). The path ``--store remote``
    takes."""
    if index.store is None or index.store.backend == "fp32":
        raise ValueError(
            "make_remote needs a quantised store (attach_store first): the "
            "stage-1 scan is what keeps remote fetches off the descent path"
        )
    ls = index.store
    upload_payload(store, ls.exact.read_all(), ls.block)
    src = RemoteSource(
        store, n=ls.n, d=ls.d, block=ls.block,
        cache_granules=cache_granules, prefetch_workers=prefetch_workers,
        prefetch_depth=prefetch_depth,
    )
    ls.exact = src
    if not index._payload_released:
        index.release_dense_payload()
    index._plan_cache = None  # capability fingerprint changed (remote=True)
    return src
