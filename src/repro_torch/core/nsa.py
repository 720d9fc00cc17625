"""NSA — Neighbours Search Algorithm (paper Algorithm 2), in PyTorch
(counterpart of ``repro.core.nsa``).

Two modes over the same :class:`~repro_torch.core.msa.PDASCIndexData`, both
dispatching every distance evaluation and ranking step through the kernel
layer (``repro_torch.kernels.ops``):

``search_dense``
    The masked translation of Algorithm 2: per level one ``[B, n_l]``
    ``ops.pairwise_distance`` matrix, candidates as a boolean mask
    (``active[l] = active[l+1][parent] & valid & (d < r)``), the leaf level
    not radius-filtered unless ``leaf_radius_filter``, and a masked top-k.

``search_beam_vmap``
    The seed per-query beam (``repro``'s vmap of scalar searches), batched
    over queries here: every level gathers each query's candidate rows and
    scores them with the registry's ``dist.point``, never the kernel layer,
    so it stays an oracle independent of the kernels (and the benchmark
    baseline).

``search_beam``
    The pruned batched search: the top level is one cross
    ``ops.pairwise_distance``; every lower level is one fused
    ``ops.rank_gathered`` (the CUDA rank kernel gathers the candidate rows
    itself) keeping the ``beam`` best prototypes per query, whose
    sibling-contiguous child blocks form the next level's candidates; the
    leaf is one more ``rank_gathered``. A beam as wide as every level
    returns ``search_dense``'s results.

Results are ``(dists[k], ids[k])`` ascending; empty slots hold ``BIG`` / -1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import distances as dist_lib
from repro_torch.core.distances import BIG
from repro_torch.core.msa import PDASCIndexData
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

Tensor = torch.Tensor

_VMAP_QUERY_CHUNK = 256  # queries a search_beam_vmap gather holds at once


class SearchResult(NamedTuple):
    dists: Tensor  # f32[..., k] ascending; BIG for missing
    ids: Tensor  # int32[..., k] original dataset rows; -1 for missing
    n_candidates: Tensor  # int32[...] leaf candidates examined


def _per_level_radii(r, n_levels: int) -> tuple:
    """Broadcast a scalar to per-level values (``[0]`` = leaf, ``[-1]`` =
    top); a sequence is taken as given."""
    if isinstance(r, (list, tuple)):
        if len(r) != n_levels:
            raise ValueError(f"need {n_levels} radii, got {len(r)}")
        return tuple(r)
    return tuple([r] * n_levels)


def _squeezed(res: SearchResult) -> SearchResult:
    return SearchResult(*(a[0] for a in res))


def _big(t: Tensor) -> Tensor:
    return torch.full((), BIG, dtype=torch.float32, device=t.device)


# ---------------------------------------------------------------------------
# Dense-masked (faithful) mode
# ---------------------------------------------------------------------------


def _parent_active(active: Tensor, parent: Tensor) -> Tensor:
    """``active[:, parent]`` with the -1 parents of the top level False."""
    up_n = active.shape[1]
    got = active[:, torch.clamp(parent.long(), 0, up_n - 1)]
    return got & (parent >= 0)[None, :]


def _search_dense_batch(index: PDASCIndexData, dist: dist_lib.Distance,
                        Q: Tensor, k: int, radii: tuple,
                        leaf_radius_filter: bool, kernel: kops.KernelConfig,
                        with_stats: bool = True,
                        slot_valid: Optional[Tensor] = None) -> SearchResult:
    levels = index.levels
    L = len(levels) - 1

    def pw(pts):
        return kops.pairwise_distance(Q, pts, dist, config=kernel)

    top = levels[L]
    D = pw(top.points)
    active = top.valid[None, :] & (D < radii[L])
    for l in range(L - 1, 0, -1):
        lv = levels[l]
        D = pw(lv.points)
        active = _parent_active(active, lv.parent) & lv.valid[None, :] \
            & (D < radii[l])

    leaf = levels[0]
    D = pw(leaf.points)
    if L >= 1:
        cand = _parent_active(active, leaf.parent) & leaf.valid[None, :]
    else:
        cand = leaf.valid[None, :].expand(D.shape)
    if slot_valid is not None:
        cand = cand & slot_valid[None, :]
    if leaf_radius_filter:
        cand = cand & (D < radii[0])

    dists, slots = kref.topk_smallest(torch.where(cand, D, _big(D)), k)
    ids = torch.where(dists < BIG / 2, index.leaf_ids[slots.long()], -1)
    n_cand = (cand.sum(1, dtype=torch.int32) if with_stats
              else torch.zeros(D.shape[0], dtype=torch.int32, device=D.device))
    return SearchResult(dists=dists, ids=ids.to(torch.int32),
                        n_candidates=n_cand)


def search_dense(index: PDASCIndexData, Q: Tensor, *,
                 dist: dist_lib.Distance, k: int = 10, r,
                 leaf_radius_filter: bool = False, with_stats: bool = True,
                 kernel: Optional[kops.KernelConfig] = None,
                 slot_valid: Optional[Tensor] = None) -> SearchResult:
    """Batched faithful NSA. ``Q``: ``[B, d]`` (or ``[d]``)."""
    radii = _per_level_radii(r, len(index.levels))
    squeeze = Q.dim() == 1
    res = _search_dense_batch(
        index, dist, Q[None] if squeeze else Q, k=k, radii=radii,
        leaf_radius_filter=leaf_radius_filter, kernel=kernel or kops.DEFAULT,
        with_stats=with_stats, slot_valid=slot_valid,
    )
    return _squeezed(res) if squeeze else res


# ---------------------------------------------------------------------------
# Batched beam mode (the kernel-layer hot path)
# ---------------------------------------------------------------------------


def _descend_beam(index: PDASCIndexData, dist: dist_lib.Distance, Q: Tensor,
                  radii: tuple, beams: tuple, max_children: tuple,
                  kernel: kops.KernelConfig) -> tuple[Tensor, Tensor]:
    """Levels L..1 of the beam search: returns the leaf candidate table
    ``(cand_idx [B, W] int32, cand_ok [B, W] bool)``. The radius applies
    after the beam selection (candidates sort ascending, so post-filtering
    selects the identical beam). Needs a multi-level index."""
    levels = index.levels
    L = len(levels) - 1
    B = Q.shape[0]

    # every top-level prototype is a candidate for every query: one cross
    # pairwise call, no per-query gather
    top = levels[L]
    D_top = kops.pairwise_distance(Q, top.points, dist, config=kernel)
    D_top = torch.where(top.valid[None, :], D_top, _big(D_top))
    cand_idx = cand_ok = None

    for l in range(L, 0, -1):
        lv = levels[l]
        if l == L:
            d_sel, sel_idx = kref.topk_smallest(D_top, min(beams[l],
                                                           top.points.shape[0]))
        else:
            beam = min(beams[l], cand_idx.shape[1])
            d_sel, slot = kops.rank_gathered(
                Q, lv.points, lv.sq_norm, cand_idx, cand_ok, dist, k=beam)
            sel_idx = torch.gather(cand_idx, 1, slot.long())
        sel_ok = (d_sel < radii[l]) & (d_sel < BIG / 2)

        sel = sel_idx.long()
        starts = lv.child_start[sel]  # [B, beam]
        counts = lv.child_count[sel]
        mc = max_children[l]
        offs = torch.arange(mc, dtype=torch.int32, device=Q.device)
        grid = starts[:, :, None] + offs[None, None, :]
        gvalid = (offs[None, None, :] < counts[:, :, None]) & sel_ok[:, :, None]
        n_lower = levels[l - 1].points.shape[0]
        cand_idx = torch.clamp(grid.reshape(B, -1), 0, n_lower - 1)
        cand_ok = gvalid.reshape(B, -1)
    return cand_idx.to(torch.int32).contiguous(), cand_ok.contiguous()


def descend_beam(index: PDASCIndexData, Q: Tensor, *, dist: dist_lib.Distance,
                 r, beam, max_children: tuple,
                 kernel: Optional[kops.KernelConfig] = None
                 ) -> tuple[Tensor, Tensor]:
    """NSA levels L..1 without the leaf ranking: the leaf candidate rows
    ``(cand_idx [B, W], cand_ok [B, W])`` each query would rank."""
    n_levels = len(index.levels)
    radii = _per_level_radii(r, n_levels)
    beams = tuple(int(b) for b in _per_level_radii(beam, n_levels))
    if n_levels == 1:  # degenerate: every valid leaf slot is a candidate
        n0 = index.levels[0].points.shape[0]
        B = Q.shape[0]
        cand_idx = torch.arange(n0, dtype=torch.int32,
                                device=Q.device)[None].expand(B, n0)
        cand_ok = index.levels[0].valid[None].expand(B, n0)
        return cand_idx.contiguous(), cand_ok.contiguous()
    return _descend_beam(index, dist, Q, radii, beams, tuple(max_children),
                         kernel or kops.DEFAULT)


def assemble_result(index: PDASCIndexData, dists: Tensor, slots: Tensor,
                    ok: Tensor, *, k: int, leaf_radius: float,
                    leaf_radius_filter: bool) -> SearchResult:
    """Result tail shared by the leaf rankings: radius masking, slot -> id
    translation, candidate counting, and padding out to ``k``."""
    if leaf_radius_filter:
        dists = torch.where(dists < leaf_radius, dists, _big(dists))
    ids = torch.where(dists < BIG / 2, index.leaf_ids[slots.long()], -1)
    n_cand = ok.sum(1, dtype=torch.int32)
    k_eff = dists.shape[1]
    if k_eff < k:  # tiny index: fewer candidate slots than k
        pad = k - k_eff
        dists = torch.nn.functional.pad(dists, (0, pad), value=BIG)
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    return SearchResult(dists=dists, ids=ids.to(torch.int32),
                        n_candidates=n_cand)


def _search_beam_batch(index: PDASCIndexData, dist: dist_lib.Distance,
                       Q: Tensor, k: int, radii: tuple, beams: tuple,
                       max_children: tuple, leaf_radius_filter: bool,
                       kernel: kops.KernelConfig,
                       slot_valid: Optional[Tensor] = None) -> SearchResult:
    """The descent (:func:`_descend_beam`) followed by one fused leaf
    ranking; ``slot_valid`` masks leaf slots out of the ranking only."""
    levels = index.levels
    L = len(levels) - 1
    B = Q.shape[0]
    leaf = levels[0]
    if L == 0:  # degenerate single-level index: the leaf is the top
        W = leaf.points.shape[0]
        D = kops.pairwise_distance(Q, leaf.points, dist, config=kernel)
        live = leaf.valid if slot_valid is None else leaf.valid & slot_valid
        D = torch.where(live[None, :], D, _big(D))
        ok = live[None, :].expand(B, W)
        dists, slots = kref.topk_smallest(D, min(k, W))
    else:
        cand_idx, cand_ok = _descend_beam(index, dist, Q, radii, beams,
                                          max_children, kernel)
        ok = kref.fold_slot_valid(cand_idx, cand_ok, slot_valid)
        dists, slot = kops.rank_gathered(
            Q, leaf.points, leaf.sq_norm, cand_idx, ok, dist,
            k=min(k, cand_idx.shape[1]))
        slots = torch.gather(cand_idx, 1, slot.long())
    return assemble_result(index, dists, slots, ok, k=k, leaf_radius=radii[0],
                           leaf_radius_filter=leaf_radius_filter)


def search_beam(index: PDASCIndexData, Q: Tensor, *, dist: dist_lib.Distance,
                k: int = 10, r, beam, max_children: tuple,
                leaf_radius_filter: bool = False,
                kernel: Optional[kops.KernelConfig] = None,
                slot_valid: Optional[Tensor] = None) -> SearchResult:
    """Batched beam NSA — the serving hot path.

    ``beam``: int or per-level tuple of surviving prototypes per level;
    ``max_children``: per-level max cluster size (``msa.max_children``)."""
    n_levels = len(index.levels)
    radii = _per_level_radii(r, n_levels)
    beams = tuple(int(b) for b in _per_level_radii(beam, n_levels))
    squeeze = Q.dim() == 1
    res = _search_beam_batch(
        index, dist, Q[None] if squeeze else Q, k=k, radii=radii, beams=beams,
        max_children=tuple(max_children),
        leaf_radius_filter=leaf_radius_filter, kernel=kernel or kops.DEFAULT,
        slot_valid=slot_valid,
    )
    return _squeezed(res) if squeeze else res


# ---------------------------------------------------------------------------
# Per-query beam (seed baseline; kept for benchmarks and as an oracle)
# ---------------------------------------------------------------------------


def _search_beam_gathered(index: PDASCIndexData, dist: dist_lib.Distance,
                          Q: Tensor, k: int, radii: tuple, beams: tuple,
                          max_children: tuple,
                          leaf_radius_filter: bool) -> SearchResult:
    """``repro``'s ``_search_beam_single`` for a batch of queries: per level
    the candidates' rows are gathered ``[B, W, d]`` and scored by
    ``dist.point``; the radius masks before each level's stable top-k."""
    levels = index.levels
    L = len(levels) - 1
    B = Q.shape[0]
    q = Q[:, None, :]
    n_top = levels[L].points.shape[0]
    cand_idx = torch.arange(n_top, device=Q.device)[None].expand(B, n_top)
    cand_ok = levels[L].valid[None].expand(B, n_top)

    for l in range(L, 0, -1):
        lv = levels[l]
        d = dist.point(q, lv.points[cand_idx])
        ok = cand_ok & (d < radii[l])
        d_sel, sel = kref.topk_smallest(torch.where(ok, d, _big(d)),
                                          min(beams[l], cand_idx.shape[1]))
        sel_idx = torch.gather(cand_idx, 1, sel.long())
        sel_ok = d_sel < BIG / 2
        mc = max_children[l]
        offs = torch.arange(mc, device=Q.device)
        grid = lv.child_start[sel_idx].long()[:, :, None] + offs
        gvalid = (offs < lv.child_count[sel_idx][:, :, None]) \
            & sel_ok[:, :, None]
        n_lower = levels[l - 1].points.shape[0]
        cand_idx = grid.reshape(B, -1).clamp(0, n_lower - 1)
        cand_ok = gvalid.reshape(B, -1)

    d = dist.point(q, levels[0].points[cand_idx])
    ok = cand_ok & (d < radii[0]) if leaf_radius_filter else cand_ok
    dists, pos = kref.topk_smallest(torch.where(ok, d, _big(d)),
                                    min(k, d.shape[1]))
    slots = torch.gather(cand_idx, 1, pos.long())
    ids = torch.where(dists < BIG / 2, index.leaf_ids[slots], -1)
    if dists.shape[1] < k:  # tiny index edge case
        pad = k - dists.shape[1]
        dists = torch.nn.functional.pad(dists, (0, pad), value=BIG)
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    return SearchResult(dists=dists, ids=ids.to(torch.int32),
                        n_candidates=ok.sum(1, dtype=torch.int32))


def search_beam_vmap(index: PDASCIndexData, Q: Tensor, *,
                     dist: dist_lib.Distance, k: int = 10, r, beam,
                     max_children: tuple, leaf_radius_filter: bool = False
                     ) -> SearchResult:
    """The seed per-query beam NSA over ``Q [B, d]`` (or ``[d]``), in
    chunks of ``_VMAP_QUERY_CHUNK`` queries (each gathers ``[chunk, W,
    d]`` rows). Superseded by :func:`search_beam`; kept as the benchmark
    baseline and an oracle independent of the kernel layer."""
    dist = dist_lib.get(dist)
    n_levels = len(index.levels)
    radii = _per_level_radii(r, n_levels)
    beams = tuple(int(b) for b in _per_level_radii(beam, n_levels))
    squeeze = Q.dim() == 1
    Qb = Q[None] if squeeze else Q
    parts = [
        _search_beam_gathered(index, dist, Qb[i:i + _VMAP_QUERY_CHUNK], k,
                              radii, beams, tuple(max_children),
                              leaf_radius_filter)
        for i in range(0, Qb.shape[0], _VMAP_QUERY_CHUNK)
    ]
    res = SearchResult(*(torch.cat(t) for t in zip(*parts)))
    return _squeezed(res) if squeeze else res
