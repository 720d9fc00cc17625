"""MSA — Multilevel Structure Algorithm (paper Algorithm 1), in PyTorch
(counterpart of ``repro.core.msa``).

Bottom-up index construction:

  1. Permute the dataset (optionally) and split it into groups of ``gl``.
  2. Cluster every group into ``gl // 2`` medoids with k-medoids.
  3. The medoids become the next level's points; repeat until one group
     remains. Its medoids form the top level.

Every level is a fixed-shape tensor with a validity mask (groups are padded,
never ragged). After clustering, each level is reordered sibling-contiguous
(points sorted by cluster slot within each group), so the children of any
prototype occupy one slice ``[child_start, child_start + child_count)`` of
the level below — what lets the beam search gather fixed-shape candidate
blocks.

A level's groups are clustered in ``group_chunk``-sized slabs: each slab's
``[group_chunk, gl, gl]`` dissimilarities come from one launch of the
pairwise kernel and feed one batched k-medoids run, so the working set is
O(``group_chunk`` · gl²) however many groups the level has. The result does
not depend on ``group_chunk``.

``method="kmeans"`` clusters each group with Lloyd's k-means
(``core/kmeans.py``), snaps the centroids to group points and relabels the
group against them; its levels' TD is 0, as in ``repro``. Its k-means++
seeds come from the build's ``torch.Generator``, so a k-means build is not
id-equal to ``repro``'s: it is held to the index invariants and recall.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import distances as dist_lib
from repro_torch.core import kmeans as kmeans_lib
from repro_torch.core import kmedoids as km
from repro_torch.kernels import ops as kops

Tensor = torch.Tensor


class PDASCLevel(NamedTuple):
    """One level of the multilevel index (leaf = level 0), in the final
    (sibling-contiguous) layout."""

    points: Tensor  # f32[n_l, d]
    valid: Tensor  # bool[n_l]
    parent: Tensor  # int32[n_l] — slot in level l+1 (-1 at the top level)
    child_start: Tensor  # int32[n_l] — slice start into level l-1 (-1 at leaf)
    child_count: Tensor  # int32[n_l]
    sq_norm: Tensor  # f32[n_l] — cached ||p||^2 for the Gram-form rank kernel


class PDASCIndexData(NamedTuple):
    """The full index: levels[0] is the leaf (data) level, levels[-1] the top."""

    levels: tuple[PDASCLevel, ...]
    leaf_ids: Tensor  # int32[n_0] — original dataset row of each leaf slot


class BuildStats(NamedTuple):
    level_sizes: tuple[int, ...]  # valid item count per level
    level_td: tuple[float, ...]  # summed clustering TD per level
    n_levels: int


def _pad_to(x: Tensor, n: int, fill=0) -> Tensor:
    pad = n - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])


def _group_pairwise_dense(dist: dist_lib.Distance, grp_pts: Tensor,
                          grp_valid: Tensor, row_chunk: int) -> Tensor:
    """Masked per-group dissimilarities ``[B, g, g]`` for one slab of
    groups: one batched kernel-layer call, so the build shares the search
    path's distance arithmetic."""
    D = kops.pairwise_distance(grp_pts, grp_pts, dist, row_chunk=row_chunk)
    return dist_lib.mask_invalid(D, grp_valid, grp_valid)


def _cluster_groups(dist: dist_lib.Distance, gpts: Tensor, gvld: Tensor, *,
                    k: int, method: str, max_swaps: int, swap_tol: float,
                    row_chunk: int,
                    generator: Optional[torch.Generator] = None,
                    init: Optional[Tensor] = None, kb: int = 0):
    """Cluster one slab of groups ``gpts [B, g, d]`` -> ``(medoids [B, k],
    labels [B, g], td [B])``.

    ``method="kmeans"``: Lloyd's k-means per group (``init [B, k, d]``
    initial centroids, else k-means++ from ``generator``); each centroid
    snaps to its nearest valid point, slots past a group's valid count are
    -1, and labels are re-derived against the snapped points by one
    ``[B, g, k]`` ``ops.pairwise_distance`` (X not Y). Its TD is 0. Any
    other method: the masked ``[B, g, g]`` dissimilarities and batched
    k-medoids."""
    B, gl = gpts.shape[0], gpts.shape[1]
    if method == "kmeans":
        res = kmeans_lib.kmeans_grouped(gpts, k, gvld, generator=generator,
                                        init=init)
        n_valid = gvld.sum(1).clamp(max=k)
        medoids = torch.where(
            torch.arange(k, device=gpts.device)[None, :] < n_valid[:, None],
            res.snapped, -1).to(torch.int32)
        safe = medoids.long().clamp(0, gl - 1)
        mpts = torch.gather(gpts, 1, safe[:, :, None].expand(
            B, k, gpts.shape[2])).contiguous()
        cols = kops.pairwise_distance(gpts.contiguous(), mpts, dist,
                                      row_chunk=row_chunk)
        cols = torch.where(gvld[:, :, None] & (medoids[:, None, :] >= 0),
                           cols, torch.full((), dist_lib.BIG,
                                            device=cols.device))
        labels = torch.where(gvld, cols.argmin(-1).to(torch.int32), -1)
        return medoids, labels.to(torch.int32), gpts.new_zeros(B)
    Dg = _group_pairwise_dense(dist, gpts, gvld, row_chunk)
    res = km.kmedoids_grouped(Dg, k, gvld, method=method,
                              max_swaps=max_swaps, rel_tol=swap_tol, kb=kb)
    return res.medoids, res.labels, res.td


def _build_level(points: Tensor, valid: Tensor, carry_a: Tensor,
                 carry_b: Tensor, *, dist: dist_lib.Distance, gl: int, k: int,
                 method: str, max_swaps: int, swap_tol: float, row_chunk: int,
                 group_chunk: int, generator: Optional[torch.Generator] = None,
                 kb: int = 0):
    """Cluster one level. Returns the level's final-layout arrays, the
    next level's items (initial layout), the remap initial -> final slot
    for fixing the lower level's parents, and the level's summed TD."""
    n, d = points.shape
    G = -(-n // gl)
    n_pad = G * gl
    dev = points.device

    gpts = _pad_to(points, n_pad).reshape(G, gl, d)
    gvld = _pad_to(valid, n_pad, False).reshape(G, gl)
    ca = _pad_to(carry_a, n_pad, -1).reshape(G, gl)
    cb = _pad_to(carry_b, n_pad, 0).reshape(G, gl)

    step = group_chunk if 0 < group_chunk < G else G
    medoids, labels, td = [], [], []
    for s in range(0, G, step):
        m, lab, t = _cluster_groups(
            dist, gpts[s:s + step], gvld[s:s + step], k=k, method=method,
            max_swaps=max_swaps, swap_tol=swap_tol, row_chunk=row_chunk,
            generator=generator, kb=kb)
        medoids.append(m)
        labels.append(lab)
        td.append(t)
    medoids = torch.cat(medoids)
    labels = torch.cat(labels).long()
    td = torch.cat(td)

    # --- sibling-contiguous reorder within each group -----------------------
    sort_key = torch.where(labels >= 0, labels, k)  # invalid slots last
    order = torch.sort(sort_key, dim=1, stable=True).indices  # [G, gl]
    labels_f = torch.gather(labels, 1, order)
    gpts_f = torch.gather(gpts, 1, order[:, :, None].expand(G, gl, d))
    gvld_f = torch.gather(gvld, 1, order)
    ca_f = torch.gather(ca, 1, order)
    cb_f = torch.gather(cb, 1, order)

    # initial -> final remap: inv[g, j] is the new position of item j
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(gl, device=dev).expand(G, gl).contiguous())
    base = (torch.arange(G, device=dev) * gl)[:, None]
    remap = (base + inv).reshape(-1)

    # parent slot (next level's initial layout) of each final-layout item
    parent = torch.where(
        labels_f >= 0, (torch.arange(G, device=dev) * k)[:, None] + labels_f, -1
    ).to(torch.int32)

    # children bookkeeping: labels_f ascends within each group (invalid
    # last), so child counts / starts are searchsorted bounds
    sk_f = torch.where(labels_f >= 0, labels_f, k).contiguous()
    slots = torch.arange(k + 1, device=dev).expand(G, k + 1).contiguous()
    bounds = torch.searchsorted(sk_f, slots)  # [G, k+1]
    counts = (bounds[:, 1:] - bounds[:, :-1]).to(torch.int32)
    starts = (bounds[:, :k] + base).to(torch.int32)

    # next level items: the medoid points (initial layout)
    med_final = torch.gather(inv, 1, torch.clamp(medoids.long(), 0, gl - 1))
    next_pts = torch.gather(gpts_f, 1, med_final[:, :, None].expand(G, k, d))

    level_arrays = dict(
        points=gpts_f.reshape(n_pad, d),
        valid=gvld_f.reshape(n_pad),
        parent=parent.reshape(n_pad),
        carry_a=ca_f.reshape(n_pad),
        carry_b=cb_f.reshape(n_pad),
    )
    next_arrays = dict(
        points=next_pts.reshape(G * k, d),
        valid=(medoids >= 0).reshape(G * k),
        child_start=starts.reshape(G * k),
        child_count=counts.reshape(G * k),
    )
    return level_arrays, next_arrays, remap, td.sum()


def _check_level_convergence(n: int, gl: int, k: int) -> None:
    """Reject (gl, k) pairs whose level recursion never reaches one group:
    each level maps G groups to ceil(G*k/gl) groups, stuck at >= 2 whenever
    2*k > gl."""
    if n > gl and 2 * k > gl:
        raise ValueError(
            f"n_prototypes={k} with gl={gl} never reduces n={n} points to a "
            f"single group: each level maps G groups to ceil(G*{k}/{gl}) "
            f"groups, which is stuck at >= 2 groups whenever 2*n_prototypes "
            f"> gl. Use n_prototypes <= gl // 2 (the paper's 2:1 ratio)."
        )


def n_levels_for(n: int, gl: int, k: Optional[int] = None) -> int:
    """Number of clustered levels MSA will produce for ``n`` points."""
    k = k or gl // 2
    _check_level_convergence(n, gl, k)
    levels = 0
    while True:
        G = -(-n // gl)
        levels += 1
        n = G * k
        if G == 1:
            return levels


def _cluster_levels(points: Tensor, valid: Tensor, carry_a: Tensor,
                    carry_b: Tensor, *, dist: dist_lib.Distance, gl: int,
                    k: int, method: str, max_swaps: int, swap_tol: float,
                    row_chunk: int, group_chunk: int,
                    generator: Optional[torch.Generator] = None,
                    prev_levels: Optional[list] = None, kb: int = 0):
    """Bottom-up level loop shared by the build and the online compaction:
    cluster the items into groups of ``gl`` until one group remains.

    ``prev_levels`` (final-layout level dicts, leaf first) seeds the loop
    with lower levels already built: the first level clustered here is then
    an upper level (its items are medoids carrying child_start /
    child_count in ``carry_a`` / ``carry_b``), and its reorder fixes
    ``prev_levels[-1]``'s parents as every later level fixes its
    predecessor's. Returns ``(raw_levels, level_td, top)``: the
    final-layout level dicts (``prev_levels`` included), one TD per level
    clustered here, and the never-clustered top level."""
    raw_levels: list[dict] = list(prev_levels) if prev_levels else []
    level_td: list[Tensor] = []
    # child_start / child_count travelling with the items
    next_cs, next_cc = (carry_a, carry_b) if raw_levels else (None, None)
    while True:
        G = -(-points.shape[0] // gl)
        level_arrays, next_arrays, remap, td = _build_level(
            points, valid, carry_a, carry_b, dist=dist, gl=gl, k=k,
            method=method, max_swaps=max_swaps, swap_tol=swap_tol,
            row_chunk=row_chunk, group_chunk=group_chunk,
            generator=generator, kb=kb,
        )
        if raw_levels:  # fix the lower level's parents through the reorder
            p = raw_levels[-1]["parent"].long()
            raw_levels[-1]["parent"] = torch.where(
                p >= 0, remap[torch.clamp(p, 0, remap.shape[0] - 1)], -1)
        if next_cs is None:  # leaf level: ids in carry_a, no children
            level_arrays["child_start"] = torch.full_like(
                level_arrays["carry_a"], -1)
            level_arrays["child_count"] = torch.zeros_like(
                level_arrays["carry_a"])
            level_arrays["leaf_ids"] = level_arrays["carry_a"]
        else:
            level_arrays["child_start"] = level_arrays["carry_a"]
            level_arrays["child_count"] = level_arrays["carry_b"]
        raw_levels.append(level_arrays)
        level_td.append(td)

        points = next_arrays["points"]
        valid = next_arrays["valid"]
        carry_a = next_cs = next_arrays["child_start"]
        carry_b = next_cc = next_arrays["child_count"]
        if G == 1:
            break

    top = dict(
        points=points,
        valid=valid,
        parent=torch.full((points.shape[0],), -1, dtype=torch.int32,
                          device=points.device),
        child_start=next_cs,
        child_count=next_cc,
    )
    return raw_levels, level_td, top


def finalize_index(raw_levels: list, top: dict) -> PDASCIndexData:
    """Assemble the final-layout level dicts (+ the top) into
    ``PDASCIndexData``, computing the per-point norm cache."""
    levels = []
    for lv in list(raw_levels) + [top]:
        pts = lv["points"].float().contiguous()
        levels.append(PDASCLevel(
            points=pts,
            valid=lv["valid"].to(torch.bool),
            parent=lv["parent"].to(torch.int32),
            child_start=lv["child_start"].to(torch.int32),
            child_count=lv["child_count"].to(torch.int32),
            sq_norm=(pts * pts).sum(-1),
        ))
    return PDASCIndexData(levels=tuple(levels),
                          leaf_ids=raw_levels[0]["leaf_ids"].to(torch.int32))


def build_index_arrays(
    data, *, gl: int, n_prototypes: Optional[int] = None,
    distance="euclidean", method: str = "pam", max_swaps: int = 64,
    generator: Optional[torch.Generator] = None, row_chunk: int = 512,
    group_chunk: int = 8, swap_tol: float = 1e-3, kb: int = 0,
    shuffle: bool = True, device="cuda",
) -> tuple[PDASCIndexData, tuple[Tensor, ...]]:
    """MSA build: the index + per-level TD scalars (on ``device``: CUDA
    unless ``device="cpu"``; raises when CUDA is asked for and absent).

    ``generator`` (a CPU ``torch.Generator``, seed 0 when omitted) draws
    the shuffle and, with ``method="kmeans"``, the k-means++ seeds;
    ``shuffle=False`` with a k-medoids method draws nothing. ``group_chunk`` bounds the
    per-level working set at O(group_chunk · gl²) (0 = the whole level);
    ``swap_tol`` is the eager swap's relative-improvement cutoff; ``kb``
    the swap sweep kernel's slots a block on the card (``repro``'s row
    tile ``bg``; 0: the kernel's heuristic)."""
    dist = dist_lib.get(distance)
    k = n_prototypes or gl // 2
    if k < 1 or k > gl:
        raise ValueError(f"need 1 <= n_prototypes <= gl, got {k} vs gl={gl}")
    n, d = data.shape
    _check_level_convergence(n, gl, k)
    if dist.needs_dim is not None and d != dist.needs_dim:
        raise ValueError(
            f"distance {dist.name!r} needs d={dist.needs_dim}, got {d}")
    dev = resolve_device(device)
    if not isinstance(data, Tensor):
        data = torch.from_numpy(np.asarray(data, np.float32))
    data = data.to(dev, torch.float32)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    if shuffle:
        perm = torch.randperm(n, generator=gen).to(dev)
    else:
        perm = torch.arange(n, device=dev)
    raw_levels, level_td, top = _cluster_levels(
        data[perm], torch.ones(n, dtype=torch.bool, device=dev),
        perm.to(torch.int32), torch.full((n,), -1, dtype=torch.int32, device=dev),
        dist=dist, gl=gl, k=k, method=method, max_swaps=max_swaps,
        swap_tol=swap_tol, row_chunk=row_chunk, group_chunk=group_chunk,
        generator=gen, kb=kb,
    )
    index = finalize_index(raw_levels, top)
    return index, tuple(level_td) + (torch.zeros((), device=dev),)


def build_index(data, **kwargs) -> tuple[PDASCIndexData, BuildStats]:
    """Build the PDASC multilevel index (MSA, Algorithm 1); keyword
    arguments as :func:`build_index_arrays`. Returns the index and its
    build statistics (read back from the device once)."""
    index, level_td = build_index_arrays(data, **kwargs)
    sizes = torch.stack([lv.valid.sum() for lv in index.levels]).tolist()
    tds = torch.stack([t.float() for t in level_td]).tolist()
    stats = BuildStats(level_sizes=tuple(int(s) for s in sizes),
                       level_td=tuple(float(t) for t in tds),
                       n_levels=len(index.levels))
    return index, stats


def max_children(index: PDASCIndexData) -> tuple[int, ...]:
    """Per-level max cluster size (the beam search's gather width); entry
    0 is 0 (leaves have no children)."""
    counts = [lv.child_count.max() for lv in index.levels[1:]]
    return (0,) + tuple(int(c) for c in (torch.stack(counts).tolist()
                                         if counts else []))
