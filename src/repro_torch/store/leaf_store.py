"""Tiered leaf store: the payload tier of the PDASC index (counterpart of
``repro.store.leaf_store``).

The index splits into a *navigation tier* (the prototype hierarchy, fp32 on
the device, touched by every query) and a *payload tier* (the leaf vectors,
touched only at the final ranking and only on the beam's candidate rows).
This module keeps the payload as symmetric-quantised codes with one fp32
scale per ``block`` rows on the index's device, and the exact fp32 vectors
*out of core*: a host array or an on-disk ``np.memmap`` read in
``block``-row granules through a small LRU cache.

Quantisation, per block of ``block`` rows (as ``repro``):

  int8:   scale_b = max|x_b| / 127 ; code = clip(round(x / scale_b), ±127)
  fp16:   code = fp16(x)           ; scale_b = 1.0
  int4:   scale_b = max|x_b| / 7   ; code = clip(round(x / scale_b), ±7),
          two codes per int8 byte (``ref.pack_int4``), width ceil(d / 2)
  binary: scale_b = mean|x_b|      ; code = sign bit, eight per uint8 byte
          (``ref.pack_binary``), width ceil(d / 8); rows dequantise to
          ±scale_b
  fp32:   no codes: the payload stays the dense resident leaf array.

Quantisation runs on the tensor's device. ``torch.round`` rounds half to
even as ``jnp.round`` does, so int8 / int4 / fp16 codes and the int8 / int4
scales (maxima) are bit-equal to ``repro``'s; binary scales are sums, taken
in another order, and agree to rounding.

``LeafStore.rebuild`` makes the next epoch's store after a compaction: it
re-quantises only the blocks that overlap changed rows (unchanged blocks
keep their codes and scales bit for bit) and backs the new exact payload
with a fresh file, never the old epoch's.

The exact source counts its granule fetches, hits, bytes and prefetches
in the ``repro_torch.obs`` registry under ``repro``'s series, and
``fetch_rows`` records a host ``granule_fetch`` span on a traced request.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.kernels import ref as kref
from repro_torch.obs import names as mnames
from repro_torch.store.cache import GranuleCache, PrefetchHandle, PrefetchPool

Tensor = torch.Tensor

BACKENDS = ("fp32", "fp16", "int8", "int4", "binary")

# LeafStore.backend -> the kernel layer's code format tag
_CODE_FORMAT = {"int4": "int4", "binary": "binary"}
_EPS = 1e-12


def quantize(x: Tensor, backend: str, block: int) -> tuple[Tensor, Tensor]:
    """Symmetric block quantisation on ``x``'s device: ``[n, d]`` f32 ->
    ``(codes [n, dc], scales [nb])``, ``nb = ceil(n / block)``.

    The last block may be short; its scale covers only its real rows.
    ``dc`` is ``d`` for int8 / fp16 and the packed width for int4
    (``ceil(d/2)``) and binary (``ceil(d/8)``)."""
    if backend not in BACKENDS[1:]:
        raise ValueError(
            f"quantize backend must be int8/fp16/int4/binary, got {backend!r}"
        )
    x = torch.as_tensor(x).to(torch.float32)
    n, d = x.shape
    nb = -(-n // block)
    if backend == "fp16":
        return x.to(torch.float16), torch.ones(nb, device=x.device)
    xb = torch.nn.functional.pad(x, (0, 0, 0, nb * block - n)).reshape(
        nb, block, d)
    if backend == "binary":
        # mean|x| over the block's real rows (zero padding adds nothing to
        # the numerator, so only the denominator needs the count)
        rows_b = torch.clamp(
            n - torch.arange(nb, device=x.device) * block, 0, block)
        scales = torch.clamp(
            xb.abs().sum((1, 2)) / torch.clamp(rows_b * d, min=1).float(),
            min=_EPS)
        return kref.pack_binary(x), scales
    qmax = 127.0 if backend == "int8" else 7.0
    scales = torch.clamp(xb.abs().amax((1, 2)) / qmax, min=_EPS)
    codes = torch.clamp(torch.round(xb / scales[:, None, None]), -qmax, qmax)
    codes = codes.reshape(nb * block, d)[:n]
    if backend == "int4":
        return kref.pack_int4(codes.to(torch.int32)), scales
    return codes.to(torch.int8), scales


def dequantize(codes: Tensor, scales: Tensor, block: int, *,
               code_format: str = "dense", d: Optional[int] = None) -> Tensor:
    """Inverse of :func:`quantize`: codes ``[n, dc]`` -> f32 ``[n, d]``.
    Packed codes need their format and the unpacked width ``d`` (the last
    byte may be padding)."""
    if code_format != "dense" and d is None:
        raise ValueError(f"dequantize of packed {code_format!r} codes needs d=")
    rows = torch.arange(codes.shape[0], device=codes.device)
    return kref.dequantize_rows(codes, scales, block, rows, code_format,
                                d or codes.shape[1])


def _exact_backing(pts: np.ndarray, path: Optional[str]):
    """Back an exact fp32 payload: a raw-bytes file and a read-only memmap
    when ``path`` is given (the out-of-core form), the host array
    otherwise."""
    if path is None:
        return pts
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(pts.tobytes())
    return np.memmap(path, dtype=np.float32, mode="r", shape=pts.shape)


class ExactSource:
    """Out-of-core exact fp32 payload: granule-wise fetch + LRU cache.

    Backed by a host ``np.ndarray`` or an on-disk ``np.memmap`` (the same
    interface; the memmap is the out-of-core form). Fetches always read
    whole ``block``-row granules; ``cache_granules`` bounds the host copies.
    Thread-safe: the async prefetch runs beside the caller."""

    def __init__(self, arr, block: int, cache_granules: int = 256):
        self._arr = arr  # np.ndarray or np.memmap, [n, d] f32
        self.block = block
        self.n, self.d = arr.shape
        self.cache = GranuleCache(cache_granules, tier="host")
        self._pool: Optional[PrefetchPool] = None
        self._pool_lock = threading.Lock()
        self._m_fetches = obs.counter(mnames.STORE_FETCHES)
        self._m_hits = obs.counter(mnames.STORE_HITS)
        self._m_fetch_bytes = obs.counter(mnames.STORE_FETCH_BYTES)
        self._m_prefetched = obs.counter(mnames.STORE_PREFETCHED)
        self._m_prefetch_useful = obs.counter(mnames.STORE_PREFETCH_USEFUL)
        self._m_cached = obs.gauge(mnames.STORE_CACHE_GRANULES)

    @property
    def on_disk(self) -> bool:
        return isinstance(self._arr, np.memmap)

    @property
    def path(self) -> Optional[str]:
        """The backing file of an on-disk payload, else None."""
        return os.fspath(self._arr.filename) if self.on_disk else None

    @property
    def wants_prefetch(self) -> bool:
        """Whether warming the cache ahead of the rerank pays: a memmap
        fetch is real I/O worth overlapping; a host array's is a slice."""
        return self.on_disk

    @property
    def nbytes(self) -> int:
        return self.n * self.d * 4

    @property
    def cache_resident_bytes(self) -> int:
        """Decoded granule bytes held by the host LRU."""
        return self.cache.resident_bytes

    @property
    def stats(self) -> dict:
        """Fetch / hit counters (fetches = backing-store granule reads)."""
        c = self.cache.stats
        return dict(fetches=c["misses"], hits=c["hits"])

    def _read_granule(self, g: int) -> np.ndarray:
        lo = g * self.block
        return np.asarray(self._arr[lo: lo + self.block], np.float32)

    def _granule(self, g: int, *, prefetch: bool = False) -> np.ndarray:
        before_m = self.cache.stats["misses"]
        before_u = self.cache.stats["prefetch_useful"]
        blk = self.cache.get(g, self._read_granule, prefetch=prefetch)
        if self.cache.stats["misses"] != before_m:
            self._m_fetches.inc()
            self._m_fetch_bytes.inc(blk.nbytes)
            if prefetch:
                self._m_prefetched.inc()
        else:
            self._m_hits.inc()
            if self.cache.stats["prefetch_useful"] != before_u:
                self._m_prefetch_useful.inc()
        self._m_cached.set(len(self.cache))
        return blk

    def read_all(self) -> np.ndarray:
        """A copy of the whole exact payload (save and ∞ paths; bypasses
        the cache)."""
        return np.array(self._arr, np.float32)

    def prefetch(self, granules) -> None:
        """Warm the cache synchronously, capped at its capacity (warming
        more would evict the warm-up's own inserts)."""
        gs = np.unique(np.asarray(granules, np.int64))[: self.cache.capacity]
        for g in gs:
            self._granule(int(g), prefetch=True)

    def prefetch_async(self, granules) -> PrefetchHandle:
        """Warm the cache on the prefetch pool (depth-bounded, deduped
        against resident and in-flight granules); returns a waitable
        handle."""
        with self._pool_lock:
            if self._pool is None:
                self._pool = PrefetchPool(
                    self.cache, self._read_granule, workers=2,
                    depth=max(8, self.cache.capacity // 2),
                )
        gs = np.unique(np.asarray(granules, np.int64))
        gs = gs[gs >= 0][: self.cache.capacity]
        return self._pool.submit([int(g) for g in gs])

    def fetch_rows(self, idx) -> np.ndarray:
        """Gather exact rows: ``idx [...]`` int -> ``[..., d]`` f32.

        Rows are grouped by granule with one sort, so the cost is
        O(rows log rows + granules); each granule is read (or hit) once,
        in ascending order."""
        idx = np.asarray(idx, np.int64)
        flat = np.clip(idx.reshape(-1), 0, self.n - 1)
        out = np.empty((flat.shape[0], self.d), np.float32)
        gran = flat // self.block
        order = np.argsort(gran, kind="stable")
        uniq, starts = np.unique(gran[order], return_index=True)
        ends = np.append(starts[1:], order.shape[0])
        with obs.span("granule_fetch", kind="host",
                      granules=int(uniq.size), rows=int(flat.shape[0])):
            for g, lo, hi in zip(uniq.tolist(), starts.tolist(),
                                 ends.tolist()):
                sel = order[lo:hi]
                out[sel] = self._granule(g)[flat[sel] - g * self.block]
        return out.reshape(*idx.shape, self.d)


@dataclasses.dataclass
class LeafStore:
    """The payload tier: device-resident codes + out-of-core exact rows."""

    backend: str  # "fp32" | "fp16" | "int8" | "int4" | "binary"
    block: int  # granule rows (quantisation block == fetch unit)
    codes: Optional[Tensor]  # [n, dc] on the index's device; None for fp32
    scales: Optional[Tensor]  # [nb] f32; None for fp32
    exact: ExactSource  # exact fp32 payload (host array or memmap)
    # {"blocks", "requantized"} of the rebuild that made this store
    last_rebuild: Optional[dict] = None

    @classmethod
    def create(cls, points, backend: str = "int8", *, block: int = 1024,
               path: Optional[str] = None, cache_granules: int = 256,
               device="cuda") -> "LeafStore":
        """A store over the leaf vectors (index slot layout), its codes
        made on ``device`` (CUDA unless ``device="cpu"``) and kept there.
        ``path`` writes the exact fp32 payload to ``<path>`` and backs it
        with a read-only memmap; None keeps a host copy."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown store backend {backend!r}; use {BACKENDS}")
        pts = torch.as_tensor(points, dtype=torch.float32).to(
            resolve_device(device))
        exact = ExactSource(_exact_backing(pts.cpu().numpy(), path), block,
                            cache_granules=cache_granules)
        if backend == "fp32":
            return cls(backend=backend, block=block, codes=None, scales=None,
                       exact=exact)
        codes, scales = quantize(pts, backend, block)
        return cls(backend=backend, block=block, codes=codes, scales=scales,
                   exact=exact)

    def rebuild(self, points, changed, *, path: Optional[str] = None,
                cache_granules: int = 256) -> "LeafStore":
        """The store over an updated payload (epoch-swap compaction),
        re-quantising only the blocks that overlap changed rows.

        ``points``: the new leaf payload ``[n', d]`` (rows may have been
        appended). ``changed``: ``bool[n']``, rows whose content or
        position differs from the old payload. A block whose rows are the
        old block's exact range and none of which changed keeps its codes
        and scale verbatim (quantisation is per block, so they are the
        same bits); the changed blocks are quantised together, on the
        codes' device, in one call. ``path`` backs the new exact payload
        with a fresh memmap file: never the old epoch's, whose granules
        readers of the old index may still fetch."""
        pts = torch.as_tensor(points, dtype=torch.float32)
        pts_np = pts.cpu().numpy()
        n, d = pts.shape
        changed = np.asarray(changed, bool)
        if changed.shape != (n,):
            raise ValueError(f"changed mask shape {changed.shape} != ({n},)")
        exact = ExactSource(_exact_backing(pts_np, path), self.block,
                            cache_granules=cache_granules)
        if self.backend == "fp32":
            return LeafStore(backend=self.backend, block=self.block,
                             codes=None, scales=None, exact=exact)
        block = self.block
        nb = -(-n // block)
        lo = np.arange(nb) * block
        hi = np.minimum(lo + block, n)
        hi_old = np.minimum(lo + block, self.n)
        dirty = np.logical_or.reduceat(changed, lo) if n else np.zeros(0, bool)
        keep = (hi_old == hi) & ~dirty
        dev = self.codes.device
        codes = self.codes.new_zeros((n, self.codes.shape[1]))
        scales = torch.ones(nb, device=dev)
        kept_rows = np.nonzero(np.repeat(keep, hi - lo))[0]
        if kept_rows.size:
            kr = torch.from_numpy(kept_rows).to(dev)
            codes[kr] = self.codes[kr]
            kb = torch.from_numpy(np.nonzero(keep)[0]).to(dev)
            scales[kb] = self.scales[kb]
        redo = np.nonzero(~keep)[0]
        if redo.size:
            # the changed blocks back to back: each starts at a multiple
            # of ``block``, and only the last block of all may be short
            rr = torch.from_numpy(
                np.nonzero(np.repeat(~keep, hi - lo))[0]).to(dev)
            c, sc = quantize(pts[rr].to(dev), self.backend, block)
            codes[rr] = c
            scales[torch.from_numpy(redo).to(dev)] = sc
        return LeafStore(backend=self.backend, block=block, codes=codes,
                         scales=scales, exact=exact,
                         last_rebuild=dict(blocks=int(nb),
                                           requantized=int(redo.size)))

    # -- geometry / accounting ------------------------------------------------

    @property
    def n(self) -> int:
        return self.exact.n

    @property
    def d(self) -> int:
        return self.exact.d

    @property
    def code_format(self) -> str:
        """The kernel layer's code format tag for this backend:
        ``"int4"`` / ``"binary"`` for the packed backends, else
        ``"dense"``."""
        return _CODE_FORMAT.get(self.backend, "dense")

    @property
    def resident_bytes(self) -> int:
        """Device-resident payload bytes: the dense leaf array for fp32,
        codes + scales otherwise."""
        if self.backend == "fp32":
            return self.n * self.d * 4
        return int(self.codes.numel() * self.codes.element_size()
                   + self.scales.numel() * 4)

    @property
    def out_of_core_bytes(self) -> int:
        """Exact payload bytes living off the device (0 for fp32)."""
        return 0 if self.backend == "fp32" else self.exact.nbytes

    # -- access ---------------------------------------------------------------

    def dequantized(self) -> Tensor:
        """The whole dequantised payload ``[n, d]`` f32 (small stores)."""
        if self.backend == "fp32":
            return torch.from_numpy(self.exact.fetch_rows(np.arange(self.n)))
        return dequantize(self.codes, self.scales, self.block,
                          code_format=self.code_format, d=self.d)

    def fetch_rows(self, idx) -> np.ndarray:
        """Exact fp32 rows from the out-of-core tier (granules + LRU)."""
        return self.exact.fetch_rows(idx)

    def prefetch_rows(self, idx) -> None:
        """Warm the granule cache for the rows ``idx`` (blocking)."""
        flat = np.clip(np.asarray(idx, np.int64).reshape(-1), 0, self.n - 1)
        self.exact.prefetch(flat // self.block)

    def prefetch_rows_async(self, idx) -> PrefetchHandle:
        """Warm the granule cache for ``idx`` on the async prefetch pool."""
        flat = np.clip(np.asarray(idx, np.int64).reshape(-1), 0, self.n - 1)
        return self.exact.prefetch_async(flat // self.block)
