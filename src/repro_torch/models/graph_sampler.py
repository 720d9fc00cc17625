"""Neighbour sampling for large-graph minibatch training (``minibatch_lg``),
the counterpart of ``repro.models.graph_sampler``.

Two builders:

* :class:`CSRGraph` + :func:`sample_subgraph` — the GraphSAGE fan-out
  sampler. Host-side numpy, as ``repro``'s (sampling is control-flow heavy
  and runs in the input pipeline, not on the card): the same
  ``np.random.Generator`` gives the same subgraph in both packages. It
  emits fixed-shape padded subgraphs::

      seeds [B] -> hop 1 (fanout f1) -> hop 2 (fanout f2) ...
      output: node ids [N_max], feats gathered on host, edges [2, E_max],
      edge_mask, label_mask over the seeds.

  Static bounds: N_max = B * prod(1 + f_k cumulative), E_max = B * sum of
  fan-out products — computable from (B, fanouts) alone.

* :func:`knn_graph` — a k-NN edge list from point coordinates, exact
  through ``ops.knn`` (``csrc/knn.cu`` on the card) or through the PDASC
  index's dense plan (the paper's technique).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device

Array = np.ndarray

# the dense plan holds [queries, leaf slots] distance matrices: knn_graph's
# PDASC route sends its queries in chunks of at most this many entries
_DENSE_ENTRIES = 1 << 28


@dataclasses.dataclass
class CSRGraph:
    """Host-side CSR adjacency. indptr [N+1], indices [nnz]."""

    indptr: Array
    indices: Array

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    @classmethod
    def from_edge_list(cls, src: Array, dst: Array, n_nodes: int) -> "CSRGraph":
        """Edges grouped by ``src``, in their given order within a group
        (``repro``'s stable argsort). The order comes from one sort of the
        distinct keys ``src * 2^b + position``, which numpy's vectorised
        sort runs faster than a stable argsort of ``src``."""
        order, src_s = _group_by(np.asarray(src))
        dst_s = np.asarray(dst)[order]
        counts = np.bincount(src_s, minlength=n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return cls(indptr=indptr, indices=dst_s.astype(np.int32))

    def neighbours(self, u: int) -> Array:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]


def _group_by(src: Array) -> tuple[Array, Array]:
    """``(order, src[order])`` with ``order = np.argsort(src,
    kind="stable")``, for node ids ``src`` (non-negative, and below
    2^(63 - b) for ``b`` the bits of an edge position)."""
    bits = max(1, int(len(src) - 1).bit_length())
    key = np.sort((src.astype(np.int64) << bits)
                  | np.arange(len(src), dtype=np.int64))
    return key & ((1 << bits) - 1), (key >> bits).astype(src.dtype)


def subgraph_budget(batch_nodes: int, fanouts: Sequence[int]) -> tuple[int, int]:
    """Static (N_max, E_max) for a fan-out sampled subgraph."""
    n_max, e_max, frontier = batch_nodes, 0, batch_nodes
    for f in fanouts:
        e_max += frontier * f
        frontier = frontier * f
        n_max += frontier
    return n_max, e_max


def sample_subgraph(
    g: CSRGraph,
    seeds: Array,
    fanouts: Sequence[int],
    rng: np.random.Generator,
    *,
    feats: Optional[Array] = None,
    labels: Optional[Array] = None,
    coords: Optional[Array] = None,
) -> dict:
    """GraphSAGE fan-out sampling -> padded fixed-shape subgraph.

    Edges point child -> parent (messages flow towards the seeds). Seeds
    occupy slots [0, B); ``label_mask`` marks them for the loss."""
    B = len(seeds)
    n_max, e_max = subgraph_budget(B, fanouts)

    local_of = {int(u): i for i, u in enumerate(seeds)}
    nodes = list(int(u) for u in seeds)
    src_l, dst_l = [], []
    frontier = list(range(B))

    for f in fanouts:
        nxt = []
        for li in frontier:
            u = nodes[li]
            nbrs = g.neighbours(u)
            if len(nbrs) == 0:
                continue
            take = nbrs if len(nbrs) <= f else rng.choice(nbrs, f, replace=False)
            for v in take:
                v = int(v)
                if v not in local_of:
                    local_of[v] = len(nodes)
                    nodes.append(v)
                    nxt.append(local_of[v])
                src_l.append(local_of[v])  # child (message source)
                dst_l.append(li)  # parent (aggregates)
        frontier = nxt

    n, e = len(nodes), len(src_l)
    node_ids = np.full((n_max,), -1, np.int64)
    node_ids[:n] = nodes
    edges = np.zeros((2, e_max), np.int32)
    edges[0, :e] = src_l
    edges[1, :e] = dst_l
    edge_mask = np.zeros((e_max,), bool)
    edge_mask[:e] = True
    node_mask = np.zeros((n_max,), bool)
    node_mask[:n] = True
    label_mask = np.zeros((n_max,), bool)
    label_mask[:B] = True

    out = dict(
        node_ids=node_ids, edges=edges, edge_mask=edge_mask,
        node_mask=node_mask, label_mask=label_mask,
        n_nodes=n, n_edges=e,
    )
    safe = np.where(node_ids >= 0, node_ids, 0)
    if feats is not None:
        out["feats"] = feats[safe] * node_mask[:, None]
    if labels is not None:
        out["labels"] = np.where(node_mask, labels[safe], 0)
    if coords is not None:
        out["coords"] = coords[safe] * node_mask[:, None]
    return out


def drop_self_edges(ids: Array, k: int) -> Array:
    """``[n, m]`` neighbour ids (row i: point i's) -> ``[2, E]`` int32 edges
    (src = neighbour, dst = point): per row, the first ``k`` ids that are
    neither ``i`` nor negative, rows in order. ``repro``'s Python loop,
    vectorised."""
    ids = np.asarray(ids)
    n = len(ids)
    keep = (ids != np.arange(n)[:, None]) & (ids >= 0)
    counts = keep.sum(1)
    over = counts > k  # rows that keep only their first k usable ids
    if over.any():
        sub = keep[over]
        sub &= np.cumsum(sub, axis=1, dtype=np.int32) <= k
        keep[over] = sub
        counts[over] = k
    dst = np.repeat(np.arange(n, dtype=np.int32), counts)
    return np.stack([ids[keep].astype(np.int32), dst])


def knn_graph(
    coords: Array,
    k: int,
    *,
    distance: str = "euclidean",
    method: str = "exact",
    pdasc_kwargs: Optional[dict] = None,
    device="cuda",
) -> Array:
    """[n, d] points -> [2, n*k] kNN edge list (src=neighbour, dst=point),
    on ``device`` (CUDA unless ``device="cpu"``).

    ``method='exact'`` is one ``ops.knn`` of the points against themselves
    at k + 1. ``method='pdasc'`` routes the search through the paper's
    index: ``PDASCIndex.build`` (gl = max(8, min(64, n // 4))) and its
    dense plan at k + 1 and 4 x the default radius, the queries in chunks
    so that no distance matrix passes 2^28 entries."""
    dev = resolve_device(device)
    X = torch.from_numpy(np.ascontiguousarray(coords, np.float32)).to(dev)
    n = X.shape[0]
    if method == "pdasc":
        from repro_torch.core.index import PDASCIndex
        from repro_torch.query import Query

        kw = dict(gl=max(8, min(64, n // 4)), distance=distance, device=dev)
        kw.update(pdasc_kwargs or {})
        idx = PDASCIndex.build(np.asarray(coords), **kw)
        plan = idx.plan(Query(k=k + 1, execution="dense",
                              radius=float(idx.default_radius) * 4.0))
        chunk = max(1, _DENSE_ENTRIES // idx.data.levels[0].points.shape[0])
        ids = torch.cat([plan(X[i:i + chunk]).ids
                         for i in range(0, n, chunk)]).cpu().numpy()
    else:
        from repro_torch.kernels import ops

        _, ids = ops.knn(X, X, distance, k=k + 1)
        ids = ids.cpu().numpy()
    return drop_self_edges(ids, k)
