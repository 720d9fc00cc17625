"""k-medoids clustering in PyTorch, batched over groups (counterpart of
``repro.core.kmedoids``).

Every function takes a leading group axis: ``D [G, g, g]`` dissimilarities,
``valid [G, g]`` point masks (groups are padded to one size), ``medoids
[G, k]`` slot indices (-1 = unused slot). ``repro`` writes the per-group
algorithms with ``jax.lax.while_loop`` and vmaps them over groups; here the
group axis is written out and every loop runs over the whole slab with a
per-group ``active`` mask, checked on the host once per sweep. The single-
group ``kmedoids`` is a batch of one.

Algorithms (see ``repro.core.kmedoids`` for the derivations):

* ``build_grouped`` — greedy PAM BUILD, k passes of one batched contraction.
* ``build_grouped_pruned`` — lazy-greedy BUILD (facility location is
  submodular, so stale gains bound current ones); seeds ``method="pam"``.
* ``swap`` — eager multi-swap FasterPAM. Each sweep prices every (slot i,
  candidate j) swap ``dTD(i, j) = S[j] + T[i, j]`` through the kernel layer
  (``ops.swap_deltas``, the CUDA swap-sweep kernel on the card), then every
  slot greedily takes its best improving candidate, best-delta-first. The
  batch is kept only if its exact TD beats the best single swap.
* ``swap_reference`` — the seed one-swap-per-sweep loop (the oracle).
* ``alternate`` — Voronoi iteration.

Small-group rule: a group with ``<= k`` valid points promotes all of them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.distances import BIG
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import topk_largest

Tensor = torch.Tensor
_INF = float("inf")


class KMedoidsResult(NamedTuple):
    medoids: Tensor  # int32[G, k] — indices into the group, -1 for unused slots
    labels: Tensor  # int32[G, g] — medoid slot per point, -1 invalid
    td: Tensor  # f32[G]       — total deviation over valid points
    n_swaps: Tensor  # int32[G]  — accepted swaps (diagnostics)


def _rows(G: int, device) -> Tensor:
    return torch.arange(G, device=device)


def _medoid_distance_columns(D: Tensor, medoids: Tensor) -> Tensor:
    """``D[:, :, medoids]`` ``[G, g, k]`` with unused (-1) slots as BIG."""
    G, g = D.shape[0], D.shape[1]
    safe = torch.clamp(medoids.long(), 0, g - 1)
    cols = torch.gather(D, 2, safe[:, None, :].expand(G, g, safe.shape[1]))
    return torch.where(medoids[:, None, :] >= 0, cols,
                       torch.full((), BIG, device=D.device))


def _nearest_caches(D: Tensor, medoids: Tensor, valid: Tensor):
    """``(d1, n1, d2)`` ``[G, g]``: nearest / second-nearest medoid
    distance and nearest medoid slot per point (the FasterPAM caches)."""
    cols = _medoid_distance_columns(D, medoids)  # [G, g, k]
    n1 = torch.argmin(cols, dim=2)
    d1 = torch.gather(cols, 2, n1[:, :, None])[:, :, 0]
    cols2 = cols.scatter(2, n1[:, :, None], BIG)
    d2 = cols2.amin(2)
    zero = torch.zeros((), device=D.device)
    d1 = torch.where(valid, d1, zero)
    d2 = torch.where(valid, d2, zero)
    return d1, n1.to(torch.int32), d2


def _labels_and_td(D: Tensor, medoids: Tensor, valid: Tensor):
    cols = _medoid_distance_columns(D, medoids)
    labels = torch.argmin(cols, dim=2)
    d1 = torch.gather(cols, 2, labels[:, :, None])[:, :, 0]
    labels = torch.where(valid, labels, -1).to(torch.int32)
    td = torch.where(valid, d1, torch.zeros((), device=D.device)).sum(1)
    return labels, td


def _is_medoid(medoids: Tensor, g: int) -> Tensor:
    """``bool[G, g]``: which points currently serve as a medoid."""
    G = medoids.shape[0]
    idx = torch.where(medoids >= 0, medoids.long(), g)  # unused -> spare column
    hits = torch.zeros((G, g + 1), dtype=torch.bool, device=medoids.device)
    return hits.scatter_(1, idx, True)[:, :g]


def build(D: Tensor, k: int, valid: Tensor) -> Tensor:
    """Greedy PAM BUILD for one group ``D [g, g]``: int32[k] medoids."""
    return build_grouped(D[None], k, valid[None])[0]


def build_grouped(Dg: Tensor, k: int, valid: Tensor) -> Tensor:
    """Greedy PAM BUILD over a batch of groups: int32[G, k] medoids (-1
    unused); each of the k passes is one batched ``[G, g, g]`` reduction."""
    G, g = Dg.shape[0], Dg.shape[1]
    dev = Dg.device
    n_valid = valid.sum(1)
    both = valid[:, :, None] & valid[:, None, :]
    zero = torch.zeros((), device=dev)
    Dm = torch.where(both, Dg, zero)  # invalid rows: no cost
    medoids = torch.full((G, k), -1, dtype=torch.int32, device=dev)
    d_near = torch.full((G, g), BIG, device=dev)
    chosen = torch.zeros((G, g), dtype=torch.bool, device=dev)
    cols = torch.arange(g, device=dev)[None, :]
    for i in range(k):
        # TD if candidate j became a medoid: sum_o min(d_near[o], D[o, j])
        cand_td = torch.where(valid[:, :, None],
                              torch.minimum(d_near[:, :, None], Dm), zero).sum(1)
        cand_td = torch.where(valid & ~chosen, cand_td,
                              torch.full((), _INF, device=dev))
        j = torch.argmin(cand_td, dim=1)
        ok = i < n_valid
        medoids[:, i] = torch.where(ok, j, -1).to(torch.int32)
        dj = torch.gather(Dm, 2, j[:, None, None].expand(G, g, 1))[:, :, 0]
        d_near = torch.where(ok[:, None], torch.minimum(d_near, dj), d_near)
        chosen = chosen | ((cols == j[:, None]) & ok[:, None])
    return medoids


def build_grouped_pruned(Dg: Tensor, k: int, valid: Tensor, *,
                         n_cands: int = 16) -> Tensor:
    """Candidate-pruned (lazy-greedy) BUILD: each pass re-evaluates exact
    gains only for the ``n_cands`` candidates with the best stale bounds.
    With ``n_cands >= g`` it is the exact greedy BUILD."""
    G, g = Dg.shape[0], Dg.shape[1]
    dev = Dg.device
    C = min(n_cands, g)
    n_valid = valid.sum(1)
    both = valid[:, :, None] & valid[:, None, :]
    zero = torch.zeros((), device=dev)
    Dm = torch.where(both, Dg, zero)
    neg = torch.full((), -BIG, device=dev)
    cols = torch.arange(g, device=dev)[None, :]

    # pass 0 exactly: the best first pick minimises the column sum
    ct0 = torch.where(valid, Dm.sum(1), torch.full((), _INF, device=dev))
    j0 = torch.argmin(ct0, dim=1)
    ok0 = n_valid > 0
    medoids = torch.full((G, k), -1, dtype=torch.int32, device=dev)
    medoids[:, 0] = torch.where(ok0, j0, -1).to(torch.int32)
    dn = torch.gather(Dm, 2, j0[:, None, None].expand(G, g, 1))[:, :, 0]
    dn = torch.where(valid & ok0[:, None], dn,
                     torch.where(valid, torch.full((), BIG, device=dev), zero))
    chosen = (cols == j0[:, None]) & ok0[:, None]
    # exact gains once: gain_j = sum_o relu(dn_o - D_oj)
    ub = torch.clamp(dn[:, :, None] - Dm, min=0.0).sum(1)  # [G, g]

    for i in range(1, k):
        mask = valid & ~chosen
        _, top = topk_largest(torch.where(mask, ub, neg), C)  # [G, C]
        top = top.long()
        cand = torch.gather(Dm, 2, top[:, None, :].expand(G, g, C))  # [G, g, C]
        e = torch.clamp(dn[:, :, None] - cand, min=0.0).sum(1)  # exact gains
        e = torch.where(torch.gather(mask, 1, top), e, neg)
        c = torch.argmax(e, dim=1)
        j = torch.gather(top, 1, c[:, None])[:, 0]
        ok = i < n_valid
        medoids[:, i] = torch.where(ok, j, -1).to(torch.int32)
        dj = torch.gather(Dm, 2, j[:, None, None].expand(G, g, 1))[:, :, 0]
        dn = torch.where(ok[:, None], torch.minimum(dn, dj), dn)
        chosen = chosen | ((cols == j[:, None]) & ok[:, None])
        ub = ub.scatter(1, top, e)  # refresh the evaluated bounds
    return medoids


def _swap_once(D: Tensor, valid: Tensor, medoids: Tensor):
    """One FasterPAM sweep priced in plain PyTorch (the oracle's step):
    ``(delta, i, j)`` of the best single swap per group."""
    G, g, k = D.shape[0], D.shape[1], medoids.shape[1]
    d1, n1, d2 = _nearest_caches(D, medoids, valid)
    vf = valid.float()[:, :, None]
    c1 = d1[:, :, None]
    S = (torch.clamp(D - c1, max=0.0) * vf).sum(1)  # [G, g]
    t = torch.where(D >= c1, torch.minimum(d2[:, :, None], D) - c1,
                    torch.zeros((), device=D.device)) * vf
    onehot = torch.nn.functional.one_hot(n1.long(), k).float() * vf  # [G, g, k]
    dTD = S[:, None, :] + onehot.transpose(1, 2) @ t  # [G, k, g]
    dTD = _mask_deltas(dTD, valid, medoids)
    flat = dTD.reshape(G, -1)
    best = torch.argmin(flat, dim=1)
    return flat.gather(1, best[:, None])[:, 0], best // g, best % g


def _mask_deltas(dTD: Tensor, valid: Tensor, medoids: Tensor) -> Tensor:
    """Candidate j must be a valid non-medoid point, slot i a real medoid."""
    g = dTD.shape[2]
    ok = ((valid & ~_is_medoid(medoids, g))[:, None, :]
          & (medoids >= 0)[:, :, None])
    return torch.where(ok, dTD, torch.full((), _INF, device=dTD.device))


def swap_reference(D: Tensor, valid: Tensor, medoids: Tensor, *,
                   max_swaps: int = 64, tol: float = 1e-6
                   ) -> tuple[Tensor, Tensor]:
    """Seed FasterPAM loop: one swap per sweep. Returns ``(medoids,
    n_swaps)``; the oracle for :func:`swap`."""
    G = D.shape[0]
    rows = _rows(G, D.device)
    medoids = medoids.clone()
    n = torch.zeros(G, dtype=torch.int32, device=D.device)
    improving = torch.ones(G, dtype=torch.bool, device=D.device)
    for _ in range(max_swaps):
        active = improving & (n < max_swaps)
        if not bool(active.any()):
            break
        delta, i, j = _swap_once(D, valid, medoids)
        do = active & (delta < -tol)
        medoids[rows, i] = torch.where(do, j.to(torch.int32), medoids[rows, i])
        n = n + do.to(torch.int32)
        improving = do
    return medoids, n


def _masked_swap_deltas(D: Tensor, valid: Tensor, medoids: Tensor) -> Tensor:
    """``[G, k, g]`` swap deltas from the kernel layer, with medoid columns,
    invalid columns and unused slots masked to +inf."""
    d1, n1, d2 = _nearest_caches(D, medoids, valid)
    dTD = kops.swap_deltas(D, d1, d2, n1, valid, k=medoids.shape[1])
    return _mask_deltas(dTD, valid, medoids)


def _eager_accept(dTD: Tensor, medoids: Tensor, tol: float,
                  active: Optional[Tensor] = None):
    """Greedy conflict-free multi-swap: every slot takes its best improving
    candidate, best-delta-first; a candidate column goes dark once claimed.
    Returns ``(medoids, n_accepted)``.

    ``repro`` runs this as a ``while_loop`` per group. Here each step runs
    over the whole slab: a group takes part while its best remaining
    pre-sweep delta improves (the loop condition), and the step count is
    the largest number of improving slots of any ``active`` group, read on
    the host once."""
    G, k, g = dTD.shape
    dev = dTD.device
    rows = _rows(G, dev)
    best0 = dTD.amin(2)  # [G, k] pre-sweep per-slot bests
    improving = best0 < -tol
    if active is not None:
        improving = improving & active[:, None]
    n_steps = int(improving.sum(1).max()) if G else 0
    medoids = medoids.clone()
    taken = torch.zeros((G, g), dtype=torch.bool, device=dev)
    done = torch.zeros((G, k), dtype=torch.bool, device=dev)
    n_acc = torch.zeros(G, dtype=torch.int32, device=dev)
    inf = torch.full((), _INF, device=dev)
    for _ in range(n_steps):
        pending, i = torch.where(done, inf, best0).min(1)
        live = pending < -tol
        row = torch.where(taken, inf, dTD[rows, i])  # earlier accepts masked
        val, j = row.min(1)
        do = live & (val < -tol)
        medoids[rows, i] = torch.where(do, j.to(torch.int32), medoids[rows, i])
        taken[rows, j] |= do
        done[rows, i] |= live  # each slot swaps at most once per sweep
        n_acc += do.to(torch.int32)
    return medoids, n_acc


def sweep_once(D: Tensor, valid: Tensor, medoids: Tensor, td: Tensor, *,
               tol: float = 1e-6, active: Optional[Tensor] = None):
    """One eager multi-swap sweep. Returns ``(medoids, td, n_accepted,
    improving)``, TD non-increasing; ``improving`` is False iff no single
    swap improves."""
    G, g = D.shape[0], D.shape[1]
    rows = _rows(G, D.device)
    dTD = _masked_swap_deltas(D, valid, medoids)
    flat = dTD.reshape(G, -1)
    delta1, best = flat.min(1)
    i1, j1 = best // g, best % g
    improving = delta1 < -tol

    batch_m, n_acc = _eager_accept(dTD, medoids, tol, active)
    _, batch_td = _labels_and_td(D, batch_m, valid)
    single_m = medoids.clone()
    single_m[rows, i1] = torch.where(improving, j1.to(torch.int32),
                                     medoids[rows, i1])
    single_td = td + delta1
    use_batch = improving & (batch_td <= single_td)

    medoids = torch.where(use_batch[:, None], batch_m,
                          torch.where(improving[:, None], single_m, medoids))
    td = torch.where(use_batch, batch_td, torch.where(improving, single_td, td))
    n_acc = torch.where(use_batch, n_acc, improving.to(torch.int32))
    return medoids, td, n_acc, improving


def swap(D: Tensor, valid: Tensor, medoids: Tensor, *, max_swaps: int = 64,
         tol: float = 1e-6, rel_tol: float = 0.0) -> tuple[Tensor, Tensor]:
    """Eager multi-swap FasterPAM loop over a slab of groups. Returns
    ``(medoids, n_swaps)``.

    A group sweeps until no single swap improves TD, a sweep improves it by
    less than ``rel_tol * TD``, or ``max_swaps`` sweeps ran; converged
    groups keep their state while the others go on."""
    _, td = _labels_and_td(D, medoids, valid)
    G = D.shape[0]
    active = torch.ones(G, dtype=torch.bool, device=D.device)
    n = torch.zeros(G, dtype=torch.int32, device=D.device)
    for _ in range(max_swaps):
        if not bool(active.any()):
            break
        new_m, new_td, n_acc, improving = sweep_once(
            D, valid, medoids, td, tol=tol, active=active)
        keep = improving & (td - new_td > rel_tol * torch.abs(new_td))
        medoids = torch.where(active[:, None], new_m, medoids)
        td = torch.where(active, new_td, td)
        n = n + torch.where(active, n_acc, 0).to(torch.int32)
        active = active & keep
    return medoids, n


def alternate(D: Tensor, valid: Tensor, medoids: Tensor, *,
              max_sweeps: int = 16) -> Tensor:
    """Voronoi-iteration k-medoids (assign / in-cluster re-pick)."""
    k = medoids.shape[1]
    both = valid[:, :, None] & valid[:, None, :]
    Dm = torch.where(both, D, torch.zeros((), device=D.device))
    inf = torch.full((), _INF, device=D.device)
    for _ in range(max_sweeps):
        labels = torch.argmin(_medoid_distance_columns(D, medoids), dim=2)
        onehot = (torch.nn.functional.one_hot(labels, k).float()
                  * valid.float()[:, :, None])  # [G, g, k]
        cost = Dm @ onehot  # cost[x, c] = sum_{y in cluster c} D[x, y]
        in_cluster = onehot > 0.5
        new = torch.argmin(torch.where(in_cluster, cost, inf), dim=1)
        nonempty = in_cluster.any(1)
        medoids = torch.where(nonempty & (medoids >= 0),
                              new.to(torch.int32), medoids)
    return medoids


def kmedoids(D: Tensor, k: int, valid: Optional[Tensor] = None, *,
             method: str = "pam", max_swaps: int = 64,
             rel_tol: float = 0.0) -> KMedoidsResult:
    """Cluster one (padded) group ``D [g, g]`` into ``k`` medoids: a batch
    of one through :func:`kmedoids_grouped`."""
    if valid is None:
        valid = torch.ones(D.shape[0], dtype=torch.bool, device=D.device)
    res = kmedoids_grouped(D[None], k, valid[None], method=method,
                           max_swaps=max_swaps, rel_tol=rel_tol)
    return KMedoidsResult(*(a[0] for a in res))


def kmedoids_grouped(Dg: Tensor, k: int, valid: Tensor, *, method: str = "pam",
                     max_swaps: int = 64, rel_tol: float = 0.0
                     ) -> KMedoidsResult:
    """Cluster a slab of groups ``Dg [G, g, g]``, ``valid [G, g]``.

    ``method``: "pam" (pruned BUILD + eager multi-swap FasterPAM),
    "pam_reference" (exact BUILD + the one-swap-per-sweep loop),
    "alternate" or "build" (BUILD only)."""
    Dg = Dg.float()
    n_swaps = torch.zeros(Dg.shape[0], dtype=torch.int32, device=Dg.device)
    if method == "pam":
        medoids = build_grouped_pruned(Dg, k, valid)
        medoids, n_swaps = swap(Dg, valid, medoids, max_swaps=max_swaps,
                                rel_tol=rel_tol)
    elif method == "pam_reference":
        medoids = build_grouped(Dg, k, valid)
        medoids, n_swaps = swap_reference(Dg, valid, medoids,
                                          max_swaps=max_swaps)
    elif method == "alternate":
        medoids = alternate(Dg, valid, build_grouped(Dg, k, valid),
                            max_sweeps=max_swaps)
    elif method == "build":
        medoids = build_grouped(Dg, k, valid)
    else:
        raise ValueError(f"unknown k-medoids method {method!r}")
    labels, td = _labels_and_td(Dg, medoids, valid)
    return KMedoidsResult(medoids=medoids, labels=labels, td=td,
                          n_swaps=n_swaps)
