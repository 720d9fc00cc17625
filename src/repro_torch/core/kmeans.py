"""Masked k-means (Lloyd), batched over a leading group axis — the
Euclidean-only baseline clusterer (counterpart of ``repro.core.kmeans``).

It clusters the groups of a ``method="kmeans"`` build (MSA snaps each
centroid to its nearest valid group point, so prototypes stay data points)
and is the coarse quantiser of the IVF-Flat baseline.

Precision. The squared distances ``|x|^2 + |c|^2 - 2 x.c`` and the centroid
sums are taken in fp64 whatever the caller's matmul settings: a TF32
product (PyTorch's ``allow_tf32``) moves Lloyd's argmin labels away from
the CPU's, so k-means fixes its own precision instead of inheriting it.
Centroids are kept in fp32 between iterations, as ``repro`` keeps them.
The centroid sums are segment sums over the rows sorted by label (a stable
sort and an fp64 prefix sum), not atomics, so a call gives the same
centroids every time. Large inputs stream through the distance matrix in
row and group chunks of at most ``_CHUNK_ELEMS`` entries.

Randomness. k-means++ draws its seeds by inverse-CDF sampling of uniforms
from an explicit CPU ``torch.Generator`` (seed 0 when omitted); its numbers
differ from ``jax.random.choice``'s for any key, so ``init=`` takes initial
centroids from elsewhere (tests feed ``repro``'s ``_plus_plus_init``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.distances import BIG

Tensor = torch.Tensor

_CHUNK_ELEMS = 1 << 25  # distance-matrix entries per chunk (256 MB in fp64)


class KMeansResult(NamedTuple):
    centroids: Tensor  # f32[..., k, d]
    labels: Tensor  # int32[..., g]  (-1 for invalid points)
    inertia: Tensor  # f32[...]
    snapped: Tensor  # int32[..., k] nearest valid point per centroid


def _tensor(x) -> Tensor:
    return x if isinstance(x, Tensor) else torch.from_numpy(
        np.array(x, np.float32))


def _sq_dists(X: Tensor, C: Tensor) -> Tensor:
    """``[B, r, d] x [B, k, d] -> [B, r, k]`` squared distances in fp64."""
    xx = (X * X).sum(-1)[:, :, None]
    cc = (C * C).sum(-1)[:, None, :]
    return torch.baddbmm(xx + cc, X, C.transpose(1, 2), alpha=-2.0)


def _chunks(B: int, g: int, k: int):
    """``(group slice, row slice)`` blocks covering ``[B, g]`` with at most
    ``_CHUNK_ELEMS`` distance entries each (at least one row)."""
    rows = max(1, min(g, _CHUNK_ELEMS // max(k, 1)))
    groups = max(1, _CHUNK_ELEMS // max(k * g, 1)) if rows == g else 1
    for b0 in range(0, B, groups):
        for r0 in range(0, g, rows):
            yield slice(b0, min(b0 + groups, B)), slice(r0, min(r0 + rows, g))


def _assign(X64: Tensor, C: Tensor, valid: Tensor, *, snap: bool = False):
    """Nearest centroid of every row: ``(labels [B, g] int64, min d2 [B, g]
    fp64)``, and with ``snap`` the nearest valid row of every centroid
    ``[B, k]`` (the first on ties, as ``argmin``)."""
    B, g, _ = X64.shape
    k = C.shape[1]
    C64 = C.double()
    labels = torch.empty((B, g), dtype=torch.long, device=X64.device)
    mind = torch.empty((B, g), dtype=torch.float64, device=X64.device)
    best = torch.full((B, k), float("inf"), dtype=torch.float64,
                      device=X64.device)
    arg = torch.zeros((B, k), dtype=torch.long, device=X64.device)
    for gs, rs in _chunks(B, g, k):
        d2 = _sq_dists(X64[gs, rs], C64[gs])
        lab = d2.argmin(-1)
        labels[gs, rs] = lab
        mind[gs, rs] = torch.gather(d2, -1, lab[..., None])[..., 0]
        if snap:
            dm = torch.where(valid[gs, rs, None], d2,
                             torch.full((), BIG, dtype=d2.dtype,
                                        device=d2.device))
            a = dm.argmin(-2)
            v = torch.gather(dm, -2, a[:, None, :])[:, 0, :]
            better = v < best[gs]  # strict: an earlier chunk keeps a tie
            best[gs] = torch.where(better, v, best[gs])
            arg[gs] = torch.where(better, a + rs.start, arg[gs])
    return labels, mind, arg


def _centroid_sums(X64: Tensor, labels: Tensor, valid: Tensor, k: int):
    """Per-cluster ``(sums [B, k, d] fp64, counts [B, k])`` of the valid
    rows: a stable sort by (group, label), an fp64 prefix sum along each
    column (rows on the last axis: a scan over the first axis of
    ``[rows, d]`` runs ~100x slower on the card), and the difference at
    each segment's bounds."""
    B, g, d = X64.shape
    seg = labels + (torch.arange(B, device=X64.device) * k)[:, None]
    seg = torch.where(valid, seg, torch.full_like(seg, B * k)).reshape(-1)
    order = torch.sort(seg, stable=True).indices
    seg = seg[order]
    cols = X64.reshape(-1, d)[order].T.contiguous()  # [d, rows]
    prefix = torch.cat([cols.new_zeros((d, 1)), torch.cumsum(cols, 1)], 1)
    bounds = torch.searchsorted(
        seg, torch.arange(B * k + 1, device=X64.device))
    sums = (prefix[:, bounds[1:]] - prefix[:, bounds[:-1]]).T
    counts = bounds[1:] - bounds[:-1]
    return sums.reshape(B, k, d), counts.reshape(B, k)


def _draw(p: Tensor, u: Tensor) -> Tensor:
    """One index per row of ``p [B, g]`` (unnormalised, >= 0) by the
    inverse CDF at the uniforms ``u [B]``."""
    cdf = torch.cumsum(p, -1)
    idx = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)[:, 0]
    return idx.clamp_(0, p.shape[1] - 1)


def plus_plus_init(X: Tensor, k: int, valid: Tensor,
                   generator: Optional[torch.Generator] = None) -> Tensor:
    """k-means++ seeding restricted to valid points, batched over groups:
    ``X [B, g, d]``, ``valid [B, g]`` -> centroids ``[B, k, d]`` f32. The
    first seed is uniform over a group's valid points, each next one drawn
    with probability proportional to the squared distance to the nearest
    seed so far (uniform again where every distance is zero)."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    B, g, d = X.shape
    X64 = X.double()
    xx = (X64 * X64).sum(-1)
    vf = valid.double()
    u = torch.rand((k, B), generator=gen, dtype=torch.float64).to(X.device)
    rows = torch.arange(B, device=X.device)
    cents = X.new_zeros((B, k, d))

    def seed(i, p):  # draw seed i; its squared distance to every row
        idx = _draw(p, u[i])
        cents[:, i] = X[rows, idx]
        c = X64[rows, idx]
        dot = torch.bmm(X64, c[:, :, None])[..., 0]
        return (xx + (c * c).sum(-1)[:, None] - 2.0 * dot).clamp_(min=0.0)

    d2 = seed(0, vf)
    for i in range(1, k):
        p = torch.where(valid, d2, torch.zeros_like(d2))
        p = torch.where(p.sum(-1, keepdim=True) > 0, p, vf)
        d2 = torch.minimum(d2, seed(i, p))
    return cents


def kmeans_grouped(Xg: Tensor, k: int, valid: Optional[Tensor] = None, *,
                   generator: Optional[torch.Generator] = None,
                   init: Optional[Tensor] = None,
                   iters: int = 25) -> KMeansResult:
    """Lloyd's algorithm on each group of ``Xg [B, g, d]`` (padded groups,
    ``valid [B, g]``). ``init [B, k, d]`` gives the initial centroids;
    omitted, :func:`plus_plus_init` draws them from ``generator``. Empty
    clusters keep their previous centroid."""
    B, g, d = Xg.shape
    X = Xg.to(torch.float32)
    if valid is None:
        valid = torch.ones((B, g), dtype=torch.bool, device=X.device)
    valid = valid.to(torch.bool)
    C = (plus_plus_init(X, k, valid, generator) if init is None
         else _tensor(init).to(X.device, torch.float32).clone())
    if C.shape != (B, k, d):
        raise ValueError(f"init must be [{B}, {k}, {d}], got {tuple(C.shape)}")
    X64 = X.double()
    for _ in range(iters):
        labels, _, _ = _assign(X64, C, valid)
        sums, counts = _centroid_sums(X64, labels, valid, k)
        new = (sums / counts.clamp(min=1)[..., None]).float()
        C = torch.where(counts[..., None] > 0, new, C)
    labels, mind, snapped = _assign(X64, C, valid, snap=True)
    inertia = torch.where(valid, mind, torch.zeros_like(mind)).sum(-1).float()
    labels = torch.where(valid, labels, torch.full_like(labels, -1))
    return KMeansResult(centroids=C, labels=labels.to(torch.int32),
                        inertia=inertia, snapped=snapped.to(torch.int32))


def kmeans(X: Tensor, k: int, valid: Optional[Tensor] = None, *,
           generator: Optional[torch.Generator] = None,
           init: Optional[Tensor] = None, iters: int = 25) -> KMeansResult:
    """Lloyd's algorithm on one (padded) group ``X [g, d]``; ``init
    [k, d]`` as in :func:`kmeans_grouped`."""
    res = kmeans_grouped(
        X[None], k, None if valid is None else valid[None],
        generator=generator, init=None if init is None else _tensor(init)[None],
        iters=iters)
    return KMeansResult(*(t[0] for t in res))
