"""IVF-Flat: a k-means inverted-file index, the FLANN stand-in (counterpart
of ``repro.baselines.ivf_flat``).

The coarse quantiser is k-means (Euclidean-rooted, like FLANN's trees);
a search probes the ``n_probe`` cells whose centroids lie nearest and scans
their points exactly. Like FLANN it *supports* only the metrics where a
centroid means something (``SUPPORTED``); it runs with others all the same.

On the card both steps are pairwise kernel launches: the queries against
the centroids, then each query against its probed cells' rows, gathered
into a padded ``[b, W, d]`` slab per chunk of queries (``W`` the largest
probed row count of the batch) and ranked by a stable sort, so equal
distances come back in probe order, as ``repro``'s per-query loop returns
them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import distances as dist_lib
from repro_torch.core.distances import BIG
from repro_torch.core.kmeans import kmeans
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

SUPPORTED = ("euclidean", "manhattan")  # FLANN-like coverage

_SLAB_BYTES = 1 << 29  # gathered cell rows per query chunk (512 MB)


@dataclasses.dataclass
class IVFFlatIndex:
    centroids: torch.Tensor  # [C, d] on the index's device
    lists: np.ndarray  # [n] point -> cell
    order: np.ndarray  # points sorted by cell
    offsets: np.ndarray  # [C+1]
    data: torch.Tensor  # [n, d] (reordered) on the index's device
    ids: np.ndarray  # [n] original rows (reordered)
    distance: str

    @classmethod
    def build(cls, data, *, n_cells: int = 64, distance: str = "euclidean",
              iters: int = 25, generator: Optional[torch.Generator] = None,
              init=None, device="cuda") -> "IVFFlatIndex":
        """Cluster ``data`` into ``n_cells`` cells on ``device`` (CUDA
        unless ``device="cpu"``). ``init [n_cells, d]``: initial centroids
        (else k-means++ from ``generator``, seed 0 when omitted)."""
        dev = resolve_device(device)
        X = torch.as_tensor(np.asarray(data, np.float32)).to(dev)
        res = kmeans(X, n_cells, generator=generator, init=init, iters=iters)
        labels = res.labels.cpu().numpy()
        order = np.argsort(labels, kind="stable")
        counts = np.bincount(labels, minlength=n_cells)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        return cls(
            centroids=res.centroids, lists=labels, order=order,
            offsets=offsets.astype(np.int64),
            data=X[torch.from_numpy(order).to(dev)].contiguous(),
            ids=order, distance=distance,
        )

    def search(self, queries, *, k: int = 10, n_probe: int = 8):
        """``(dists [q, k], ids [q, k] int64)`` as numpy arrays, ascending;
        missing entries hold ``inf`` / -1 (``repro``'s contract)."""
        dist = dist_lib.get(self.distance)
        dev = self.data.device
        Q = torch.as_tensor(np.asarray(
            queries.cpu() if isinstance(queries, torch.Tensor) else queries,
            np.float32)).to(dev)
        B, d = Q.shape
        C = self.centroids.shape[0]
        Dc = kops.pairwise_distance(Q, self.centroids, "euclidean")
        _, probe = kref.topk_smallest(Dc, min(n_probe, C))
        offsets = torch.from_numpy(self.offsets).to(dev)
        probe = probe.long()
        starts = offsets[probe]  # [B, P]
        counts = offsets[probe + 1] - starts
        ends = torch.cumsum(counts, 1)
        total = ends[:, -1]
        W = max(int(total.max()) if B else 0, 1)
        pos = torch.arange(W, device=dev)
        # the probed cells' rows, concatenated in probe order
        p = torch.searchsorted(ends, pos.expand(B, W).contiguous(), right=True)
        p = p.clamp(max=probe.shape[1] - 1)
        rows = torch.gather(starts, 1, p) + pos - (torch.gather(ends, 1, p)
                                                   - torch.gather(counts, 1, p))
        ok = pos[None, :] < total[:, None]
        rows = torch.where(ok, rows, torch.zeros_like(rows))

        kk = min(k, W)
        out_d = torch.empty((B, kk), device=dev)
        out_s = torch.empty((B, kk), device=dev, dtype=torch.long)
        step = max(1, _SLAB_BYTES // (4 * W * d))
        for q0 in range(0, B, step):
            q1 = min(q0 + step, B)
            D = kops.pairwise_distance(Q[q0:q1, None, :],
                                       self.data[rows[q0:q1]], dist)[:, 0]
            D = torch.where(ok[q0:q1], D, torch.full((), BIG, device=dev))
            vals, sel = kref.topk_smallest(D, kk)
            out_d[q0:q1] = vals
            out_s[q0:q1] = torch.gather(rows[q0:q1], 1, sel.long())
        found = (out_d < BIG / 2).cpu().numpy()
        dists = np.full((B, k), np.inf, np.float32)
        ids = np.full((B, k), -1, np.int64)
        dists[:, :kk] = np.where(found, out_d.cpu().numpy(), np.inf)
        ids[:, :kk] = np.where(found, self.ids[out_s.cpu().numpy()], -1)
        return dists, ids
