"""Delta buffer — a capacity-bounded fp32 append tier for recent upserts
(counterpart of ``repro.online.delta``).

Writes never touch the frozen index: an upsert appends the vector here, and
at insert time the point is leaf-routed (``PDASCIndex._route_to_leaf``: the
beam descent at beam 1, then one k = 1 rank or scan) so that compaction
knows its destination group.

Search over the buffer is one ``ops.pairwise_distance`` call over the
fixed-capacity array (inactive slots mask to ``distances.BIG``) and a
stable top-k: exact, so a fresh upsert is visible to the very next search.
Its ``[B, k]`` result merges into the index's through :func:`merge_topk`.

The host arrays are the record (writes are row stores; save and compaction
read them). The device mirror the scan reads is updated in place, row by
row, as writes land: a search uploads nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import distances as dist_lib
from repro_torch.core.distances import BIG
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

Tensor = torch.Tensor


class DeltaScan(NamedTuple):
    dists: Tensor  # f32[B, k'] ascending; BIG for missing
    ids: Tensor  # int32[B, k']; -1 for missing


def _scan(Q: Tensor, vectors: Tensor, ids: Tensor, active: Tensor, *, dist,
          k: int, kernel: Optional[kops.KernelConfig]) -> DeltaScan:
    D = kops.pairwise_distance(Q, vectors, dist, config=kernel)
    D = torch.where(active[None, :], D, torch.full((), BIG, device=D.device))
    d, pos = kref.topk_smallest(D, k)
    out_ids = torch.where(d < BIG / 2, ids[pos.long()], -1)
    return DeltaScan(dists=d, ids=out_ids.to(torch.int32))


def merge_topk(d_a: Tensor, i_a: Tensor, d_b: Tensor, i_b: Tensor, k: int):
    """Two-way top-k merge of ``[..., k_a]`` / ``[..., k_b]`` result legs:
    a stable sort of the concatenation (leg a first, so ties keep ``repro``'s
    order), the first ``k``, padded with ``BIG`` / -1 when the pool is
    smaller than ``k``."""
    cd = torch.cat([d_a, d_b.to(d_a.dtype)], dim=-1)
    ci = torch.cat([i_a, i_b.to(i_a.dtype)], dim=-1)
    d, order = torch.sort(cd, dim=-1, stable=True)
    i = torch.gather(ci, -1, order)
    if cd.shape[-1] >= k:
        return d[..., :k], i[..., :k]
    pad = k - cd.shape[-1]
    return (torch.nn.functional.pad(d, (0, pad), value=BIG),
            torch.nn.functional.pad(i, (0, pad), value=-1))


class DeltaBuffer:
    """Fixed-capacity append buffer: vectors + ids + routed leaf slots."""

    def __init__(self, capacity: int, d: int, device="cuda"):
        if capacity < 1:
            raise ValueError(f"delta capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.d = int(d)
        self.device = resolve_device(device)
        self.vectors = np.zeros((self.capacity, self.d), np.float32)
        self.ids = np.full(self.capacity, -1, np.int32)
        self.leaf_slot = np.full(self.capacity, -1, np.int32)  # routed dest
        self.active = np.zeros(self.capacity, bool)
        self.size = 0  # append cursor (monotone until compaction resets)
        # the device mirror the scan reads, written row by row
        self._dev_vectors = torch.zeros((self.capacity, self.d),
                                        device=self.device)
        self._dev_ids = torch.full((self.capacity,), -1, dtype=torch.int32,
                                   device=self.device)
        self._dev_active = torch.zeros(self.capacity, dtype=torch.bool,
                                       device=self.device)

    # -- mutation -------------------------------------------------------------

    @property
    def n_active(self) -> int:
        return int(self.active[: self.size].sum())

    @property
    def free(self) -> int:
        return self.capacity - self.size

    def fill_ratio(self) -> float:
        """Append-cursor fill fraction (the compaction trigger metric:
        deactivated slots still use capacity until compaction)."""
        return self.size / self.capacity

    def load(self, vectors, ids, leaf_slots, active) -> None:
        """Restore the first ``len(ids)`` rows (an index load)."""
        n = len(ids)
        self.vectors[:n] = vectors
        self.ids[:n] = ids
        self.leaf_slot[:n] = leaf_slots
        self.active[:n] = active
        self.size = n
        self._upload(slice(0, n))

    def _upload(self, rows: slice) -> None:
        self._dev_vectors[rows] = torch.from_numpy(self.vectors[rows]).to(
            self.device)
        self._dev_ids[rows] = torch.from_numpy(self.ids[rows]).to(self.device)
        self._dev_active[rows] = torch.from_numpy(self.active[rows]).to(
            self.device)

    def append(self, vectors, ids, leaf_slots) -> np.ndarray:
        """Append routed rows; returns their buffer positions. Raises when
        the remaining capacity cannot hold the batch (callers compact)."""
        vectors = np.asarray(vectors, np.float32)
        ids = np.asarray(ids, np.int32).reshape(-1)
        leaf_slots = np.asarray(leaf_slots, np.int32).reshape(-1)
        m = vectors.shape[0]
        if vectors.shape != (m, self.d):
            raise ValueError(f"delta append expects [m, {self.d}] vectors, "
                             f"got {vectors.shape}")
        if not (m == ids.shape[0] == leaf_slots.shape[0]):
            raise ValueError("vectors / ids / leaf_slots length mismatch")
        if m > self.free:
            raise RuntimeError(
                f"delta buffer full ({self.size}/{self.capacity} used, {m} "
                f"requested); compact the index to drain it")
        rows = slice(self.size, self.size + m)
        self.vectors[rows] = vectors
        self.ids[rows] = ids
        self.leaf_slot[rows] = leaf_slots
        self.active[rows] = True
        self.size += m
        self._upload(rows)
        return np.arange(rows.start, rows.stop)

    def deactivate_ids(self, ids) -> int:
        """Mask out live entries whose id is in ``ids`` (a delete, or a
        re-upsert of a buffered point). Returns the number deactivated."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        if self.size == 0 or ids.size == 0:
            return 0
        hit = self.active[: self.size] & np.isin(self.ids[: self.size], ids)
        n = int(hit.sum())
        if n:
            pos = np.nonzero(hit)[0]
            self.active[pos] = False
            self._dev_active[torch.from_numpy(pos).to(self.device)] = False
        return n

    def contains_id(self, id_) -> bool:
        return bool(
            (self.active[: self.size] & (self.ids[: self.size] == id_)).any())

    def live_entries(self):
        """(vectors, ids, leaf_slots) of the active rows, insertion order:
        the compaction input."""
        live = self.active[: self.size]
        return (self.vectors[: self.size][live], self.ids[: self.size][live],
                self.leaf_slot[: self.size][live])

    # -- search ---------------------------------------------------------------

    def scan(self, Q: Tensor, dist, *, k: int,
             kernel: Optional[kops.KernelConfig] = None) -> DeltaScan:
        """Exact brute-force scan of the buffer: ``[B, min(k, capacity)]``
        ascending (dists, ids); inactive slots rank ``BIG`` / -1. ``Q``
        must lie on the buffer's device."""
        if Q.device.type != self.device.type or (
                self.device.index is not None
                and Q.device.index != self.device.index):
            raise ValueError(f"delta scan: queries on {Q.device}, buffer on "
                             f"{self.device}")
        return _scan(Q.to(dtype=torch.float32), self._dev_vectors,
                     self._dev_ids, self._dev_active, dist=dist_lib.get(dist),
                     k=min(k, self.capacity), kernel=kernel)

    @property
    def nbytes(self) -> int:
        return int(self.vectors.nbytes + self.ids.nbytes
                   + self.leaf_slot.nbytes + self.active.nbytes)

    def __repr__(self):
        return (f"DeltaBuffer(capacity={self.capacity}, d={self.d}, "
                f"size={self.size}, active={self.n_active})")
