"""NN-Descent: graph-based ANN, the PyNNDescent stand-in (counterpart of
``repro.baselines.nndescent``).

Builds an approximate k-NN graph by iterative neighbour-of-neighbour
refinement (Dong et al., 2011), then answers queries by a greedy
best-first graph walk from random seeds. Like PyNNDescent it accepts any
registered distance (only pairwise evaluations are used) and has no
distributed story: the comparison point the paper draws in §4.4.

The build and search are ``repro``'s host-side numpy loops, their
``np.random.default_rng(seed)`` draws in the same order, so the two
packages build the same graph where their distances agree. The distance
blocks go through the registry's ``pairwise`` on the index's device (CUDA
unless ``device="cpu"``): graph construction is pointer-chasing, not a
kernel workload, and ``repro`` runs no Pallas kernel here either.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import distances as dist_lib


def _pair_dists(dist, A, B, device) -> np.ndarray:
    return dist.pairwise(torch.from_numpy(A).to(device),
                         torch.from_numpy(B).to(device)).cpu().numpy()


@dataclasses.dataclass
class NNDescentIndex:
    data: np.ndarray
    graph: np.ndarray  # [n, g] neighbour ids
    distance: str
    device: torch.device = dataclasses.field(
        default_factory=lambda: resolve_device("cuda"))

    @classmethod
    def build(cls, data, *, n_neighbors: int = 15, distance: str = "euclidean",
              iters: int = 6, sample: int = 8, seed: int = 0,
              device="cuda") -> "NNDescentIndex":
        """The graph over ``data``: ``n_neighbors`` per point, ``iters``
        rounds of ``sample`` sampled neighbours-of-neighbours, stopping
        early once a round changes no row. Raises where CUDA is asked for
        and absent."""
        dev = resolve_device(device)
        X = np.ascontiguousarray(data, np.float32)
        n = len(X)
        g = min(n_neighbors, n - 1)
        dist = dist_lib.get(distance)
        rng = np.random.default_rng(seed)
        # random init
        graph = np.stack([
            rng.choice(np.delete(np.arange(n), i), g, replace=False)
            if n <= 10000 else
            (lambda c: np.where(c == i, (i + 1) % n, c))(rng.integers(0, n, g))
            for i in range(n)
        ])
        gd = np.stack([_pair_dists(dist, X[i:i + 1], X[graph[i]], dev)[0]
                       for i in range(n)]).astype(np.float32)

        for _ in range(iters):
            changed = 0
            # candidate pool: sampled neighbours-of-neighbours
            cand = graph[graph[:, rng.integers(0, g, sample)].reshape(n, -1)]
            cand = cand.reshape(n, -1)
            for i in range(n):
                cs = np.unique(cand[i])
                cs = cs[cs != i]
                if cs.size == 0:
                    continue
                d = _pair_dists(dist, X[i:i + 1], X[cs], dev)[0]
                allc = np.concatenate([graph[i], cs])
                alld = np.concatenate([gd[i], d])
                _, keep = np.unique(allc, return_index=True)
                allc, alld = allc[keep], alld[keep]
                sel = np.argsort(alld, kind="stable")[:g]
                new = allc[sel]
                changed += int((new != graph[i]).any())
                graph[i], gd[i] = new, alld[sel]
            if changed == 0:
                break
        return cls(data=X, graph=graph, distance=distance, device=dev)

    def search(self, queries, *, k: int = 10, n_seeds: int = 10,
               max_steps: int = 30, seed: int = 0):
        """Greedy best-first walks from ``n_seeds`` random nodes, at most
        ``max_steps`` expansions a query. Returns ``(dists [q, k], ids [q,
        k] int64)``, ``inf`` / -1 where fewer than k were reached."""
        Q = np.ascontiguousarray(queries, np.float32)
        dist = dist_lib.get(self.distance)
        rng = np.random.default_rng(seed)
        n = len(self.data)
        out_d = np.full((len(Q), k), np.inf, np.float32)
        out_i = np.full((len(Q), k), -1, np.int64)
        for qi in range(len(Q)):
            visited = set()
            frontier = list(rng.integers(0, n, n_seeds))
            best: list[tuple[float, int]] = []
            for _ in range(max_steps):
                fresh = [i for i in frontier if i not in visited]
                if not fresh:
                    break
                visited.update(fresh)
                d = _pair_dists(dist, Q[qi:qi + 1],
                                self.data[np.asarray(fresh)], self.device)[0]
                best.extend(zip(d.tolist(), fresh))
                best = sorted(set(best))[:k]
                # expand from the current best unexpanded nodes
                frontier = list(self.graph[[i for _, i in best]].reshape(-1))
            for j, (d_, i_) in enumerate(best[:k]):
                out_d[qi, j], out_i[qi, j] = d_, i_
        return out_d, out_i
