"""Epoch-swap compaction: fold the delta buffer and the tombstones back into
a frozen PDASC index (counterpart of ``repro.online.compact``).

Read-copy-update at the index level: compaction never mutates the serving
epoch. It materialises the live point set (leaf residents minus tombstones
plus routed delta points), rebuilds, and returns a *new* ``PDASCIndex``
with ``epoch + 1``, empty online tiers and a (partly) re-quantised payload
store. Searches keep reading the old epoch until the caller swaps
references (``online.EpochHandle``).

Two scopes:

``scope="affected"`` (default)
    Only the leaf groups that lost residents (tombstones) or gained
    arrivals (delta routing, or spill into fresh groups) are re-clustered,
    through the build's ``msa._cluster_groups`` in ``group_chunk`` slabs.
    Untouched groups keep their rows bit-identical and their clustering,
    recovered from the sibling-contiguous leaf layout (labels are the run
    indices of the parent pointers). The hierarchy above the leaf is
    regrown by the build's own level loop
    (``msa._cluster_levels(prev_levels=[leaf])``). Payload codes are
    re-quantised only for blocks that overlap changed rows
    (``LeafStore.rebuild``).

``scope="full"``
    A from-scratch build over the live set (the parity oracle, and the
    choice when nearly every group is dirty).

Arrivals go to their insert-time group while it has room (a group holds
``gl`` slots; deletions free slots); the rest spill into fresh groups
after the existing ones, clustered like any other affected group.

Randomness: the shuffle of a full rebuild and the k-means++ seeds come
from a CPU ``torch.Generator`` seeded from ``(0xC0, epoch + 1)`` when the
caller gives none (``repro`` folds the same pair into its PRNG key), so a
compaction that draws is not id-equal to ``repro``'s; a pam affected
compaction draws nothing.
"""

from __future__ import annotations

import re as _re
from typing import Optional

import numpy as np
import torch

from repro_torch.core import msa


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def default_generator(epoch: int) -> torch.Generator:
    """The generator of a compaction into epoch ``epoch + 1``."""
    return torch.Generator().manual_seed((0xC0 << 32) | (epoch + 1))


def live_dataset(idx) -> tuple[np.ndarray, np.ndarray]:
    """The live point set of a mutable index: ``(vectors [m, d] f32, ids
    [m] int32)``, surviving leaf residents in slot order, then active delta
    entries in insertion order (what a from-scratch rebuild is built on)."""
    pts = _leaf_points(idx)
    alive = _np(idx.data.levels[0].valid).copy()
    ids = _np(idx.data.leaf_ids)
    if idx.tombstones is not None and idx.tombstones.count:
        alive[idx.tombstones.dead_slots()] = False
    vecs, out_ids = [pts[alive]], [ids[alive]]
    if idx.delta is not None and idx.delta.n_active:
        d_vecs, d_ids, _ = idx.delta.live_entries()
        vecs.append(d_vecs)
        out_ids.append(d_ids)
    return (np.concatenate(vecs, axis=0).astype(np.float32),
            np.concatenate(out_ids, axis=0).astype(np.int32))


def _leaf_points(idx) -> np.ndarray:
    """Exact fp32 leaf vectors in slot layout, whether the dense copy is
    resident or released to the out-of-core payload tier."""
    pts = idx.data.levels[0].points
    if idx.store is not None and pts.shape[1] != idx.store.d:
        return idx.store.exact.read_all()  # released: the payload of record
    return _np(pts).astype(np.float32)


def _recover_group_clustering(parent, valid, G, gl, k, level1_pts):
    """Decode each group's frozen clustering from the sibling-contiguous
    leaf layout: labels are run indices of the parent pointer within the
    group's valid prefix, and medoid ``l`` of group ``g`` is the level-1
    point those runs point at (``msa._build_level``'s reorder, inverted;
    every valid medoid has at least one child, itself)."""
    pg = parent.reshape(G, gl)
    vg = valid.reshape(G, gl)
    change = np.ones((G, gl), bool)
    change[:, 1:] = pg[:, 1:] != pg[:, :-1]
    change &= vg
    labels = np.cumsum(change, axis=1) - 1
    labels = np.where(vg, labels, -1).astype(np.int32)

    med_parent = np.full((G, k), -1, np.int64)
    gi, ji = np.nonzero(change)
    li = labels[gi, ji]
    keep = li < k  # a malformed layout would overflow the slots
    med_parent[gi[keep], li[keep]] = pg[gi[keep], ji[keep]]
    med_valid = med_parent >= 0
    med_pts = level1_pts[np.clip(med_parent, 0, level1_pts.shape[0] - 1)]
    med_pts[~med_valid] = 0.0
    return labels, med_pts.astype(np.float32), med_valid


def _cluster_affected(idx, gpts, gvld, *, method, max_swaps, swap_tol,
                      row_chunk, group_chunk, generator):
    """Re-cluster the affected groups ``[A, gl, d]`` on the index's device
    through the build's ``msa._cluster_groups``, ``group_chunk`` groups a
    slab. Returns numpy ``(medoids [A, k], labels [A, gl])``."""
    A = gpts.shape[0]
    chunk = min(group_chunk, A) if group_chunk and group_chunk > 0 else A
    med, lab = [], []
    for lo in range(0, A, chunk):
        m, l, _ = msa._cluster_groups(
            idx.distance, torch.from_numpy(gpts[lo:lo + chunk]).to(idx.device),
            torch.from_numpy(gvld[lo:lo + chunk]).to(idx.device),
            k=idx.n_prototypes, method=method, max_swaps=max_swaps,
            swap_tol=swap_tol, row_chunk=row_chunk, generator=generator)
        med.append(_np(m))
        lab.append(_np(l))
    return np.concatenate(med, axis=0), np.concatenate(lab, axis=0)


def compact_index(idx, *, scope: str = "affected", method: str = "pam",
                  max_swaps: int = 64, swap_tol: float = 1e-3,
                  row_chunk: int = 512, group_chunk: int = 8,
                  generator: Optional[torch.Generator] = None,
                  store_path: Optional[str] = None):
    """Compact a mutable index into a fresh epoch (never mutates ``idx``).

    Returns a new ``PDASCIndex`` on ``idx``'s device: live points only, no
    online tiers, ``epoch = idx.epoch + 1``, the payload store rebuilt with
    its unchanged quantisation blocks reused. A memmapped exact payload
    gets a fresh per-epoch file (``<base>.epoch<N>``; ``store_path``
    overrides), never the old epoch's; retired files are the operator's to
    delete once no reader holds the old index. A released dense payload
    stays released. ``shuffle=False`` builds a full rebuild without its
    shuffle (the shuffle draws from ``generator``, else
    :func:`default_generator`)."""
    from repro_torch.core.index import PDASCIndex  # index imports us

    if scope not in ("affected", "full"):
        raise ValueError(f"unknown compaction scope {scope!r}")
    gen = generator if generator is not None else default_generator(idx.epoch)
    kw = dict(method=method, max_swaps=max_swaps, swap_tol=swap_tol,
              row_chunk=row_chunk, group_chunk=group_chunk, generator=gen)
    if scope == "full":
        data, stats = _rebuild_full(idx, **kw)
        changed = np.ones(data.levels[0].points.shape[0], bool)
    else:
        data, stats, changed = _rebuild_affected(idx, **kw)

    new_idx = PDASCIndex(
        data=data, stats=stats, distance=idx.distance, gl=idx.gl,
        n_prototypes=idx.n_prototypes, max_children=msa.max_children(data),
        default_radius=idx.default_radius, device=idx.device,
        epoch=idx.epoch + 1,
        # freed ids (deleted or deactivated) are never issued again: carry
        # the id ceiling across the epoch, not just the surviving ids
        _next_id=idx._seen_id_ceiling(),
    )
    if idx.store is not None:
        if store_path is None and idx.store.exact.on_disk:
            base = _re.sub(r"\.epoch\d+$", "", idx.store.exact.path)
            store_path = f"{base}.epoch{idx.epoch + 1}"
        new_idx.store = idx.store.rebuild(data.levels[0].points, changed,
                                          path=store_path)
        if idx._payload_released:
            new_idx.release_dense_payload()
    return new_idx


def _rebuild_full(idx, **kw):
    vecs, ids = live_dataset(idx)
    data, stats = msa.build_index(
        vecs, gl=idx.gl, n_prototypes=idx.n_prototypes, distance=idx.distance,
        device=idx.device, **kw)
    # the build numbers leaves by row of `vecs`; lift them to the live ids
    rows = _np(data.leaf_ids)
    leaf_ids = np.where(rows >= 0, ids[np.clip(rows, 0, len(ids) - 1)], -1)
    data = data._replace(leaf_ids=torch.from_numpy(
        leaf_ids.astype(np.int32)).to(idx.device))
    return data, stats


def _rebuild_affected(idx, *, method, max_swaps, swap_tol, row_chunk,
                      group_chunk, generator):
    gl, k = idx.gl, idx.n_prototypes
    dist, dev = idx.distance, idx.device
    leaf = idx.data.levels[0]
    pts = _leaf_points(idx)
    n_pad, d = pts.shape
    G = n_pad // gl
    valid = _np(leaf.valid)
    parent = _np(leaf.parent)
    leaf_ids = _np(idx.data.leaf_ids)

    dead = np.zeros(n_pad, bool)
    if idx.tombstones is not None and idx.tombstones.count:
        dead[idx.tombstones.dead_slots()] = True
    alive = valid & ~dead

    if idx.delta is not None and idx.delta.n_active:
        d_vecs, d_ids, d_slots = idx.delta.live_entries()
    else:
        d_vecs = np.zeros((0, d), np.float32)
        d_ids = d_slots = np.zeros((0,), np.int32)

    # --- route arrivals: insert-time group while it has room, else spill ----
    room = gl - alive.reshape(G, gl).sum(axis=1)
    target_g = np.clip(np.asarray(d_slots, np.int64) // gl, 0, max(G - 1, 0))
    arrivals: list[list[int]] = [[] for _ in range(G)]
    spill: list[int] = []
    for i, g in enumerate(target_g.tolist()):
        if G and room[g] > 0:
            arrivals[g].append(i)
            room[g] -= 1
        else:
            spill.append(i)
    n_spill_groups = -(-len(spill) // gl) if spill else 0
    G_new = G + n_spill_groups
    n_new = G_new * gl

    # --- assemble the new leaf groups ---------------------------------------
    new_pts = np.zeros((G_new, gl, d), np.float32)
    new_valid = np.zeros((G_new, gl), bool)
    new_ids = np.full((G_new, gl), -1, np.int32)
    affected = np.zeros(G_new, bool)
    new_pts[:G] = pts.reshape(G, gl, d)
    new_valid[:G] = alive.reshape(G, gl)
    new_ids[:G] = np.where(alive, leaf_ids, -1).reshape(G, gl)
    had_dead = (dead & valid).reshape(G, gl).any(axis=1)
    for g in np.nonzero(had_dead | np.array([bool(a) for a in arrivals],
                                            bool).reshape(G))[0]:
        arr = arrivals[g]
        affected[g] = True
        sel = new_valid[g]
        m = int(sel.sum())
        packed = np.zeros((gl, d), np.float32)
        packed_ids = np.full(gl, -1, np.int32)
        packed[:m] = new_pts[g][sel]
        packed_ids[:m] = new_ids[g][sel]
        if arr:
            packed[m:m + len(arr)] = d_vecs[arr]
            packed_ids[m:m + len(arr)] = d_ids[arr]
            m += len(arr)
        new_pts[g] = packed
        new_ids[g] = packed_ids
        new_valid[g] = np.arange(gl) < m
    for s in range(n_spill_groups):
        g = G + s
        affected[g] = True
        rows = spill[s * gl:(s + 1) * gl]
        new_pts[g, : len(rows)] = d_vecs[rows]
        new_ids[g, : len(rows)] = d_ids[rows]
        new_valid[g, : len(rows)] = True

    # --- per-group clustering: recover frozen groups, re-cluster the rest ---
    labels = np.full((G_new, gl), -1, np.int32)
    med_pts = np.zeros((G_new, k, d), np.float32)
    med_valid = np.zeros((G_new, k), bool)
    if G and not affected[:G].all():
        keep_lab, keep_mp, keep_mv = _recover_group_clustering(
            parent, valid, G, gl, k, _np(idx.data.levels[1].points))
        frozen = np.nonzero(~affected[:G])[0]
        labels[frozen] = keep_lab[frozen]
        med_pts[frozen] = keep_mp[frozen]
        med_valid[frozen] = keep_mv[frozen]
    aff = np.nonzero(affected)[0]
    if aff.size:
        med_idx, aff_lab = _cluster_affected(
            idx, new_pts[aff], new_valid[aff], method=method,
            max_swaps=max_swaps, swap_tol=swap_tol, row_chunk=row_chunk,
            group_chunk=group_chunk, generator=generator)
        labels[aff] = aff_lab
        mp = np.take_along_axis(new_pts[aff],
                                np.clip(med_idx, 0, gl - 1)[:, :, None], axis=1)
        mv = med_idx >= 0
        mp[~mv] = 0.0
        med_pts[aff] = mp
        med_valid[aff] = mv

    # --- sibling-contiguous reorder + child bookkeeping (all groups) --------
    order = np.argsort(np.where(labels >= 0, labels, k), axis=1,
                       kind="stable")  # the identity on a frozen group
    labels_f = np.take_along_axis(labels, order, axis=1)
    pts_f = np.take_along_axis(new_pts, order[:, :, None], axis=1)
    valid_f = np.take_along_axis(new_valid, order, axis=1)
    ids_f = np.take_along_axis(new_ids, order, axis=1)

    counts = np.zeros((G_new, k), np.int64)
    gi, ji = np.nonzero(labels_f >= 0)
    np.add.at(counts, (gi, labels_f[gi, ji]), 1)
    bounds = np.concatenate(
        [np.zeros((G_new, 1), np.int64), np.cumsum(counts, axis=1)], axis=1)
    starts = bounds[:, :k] + (np.arange(G_new) * gl)[:, None]
    parent_f = np.where(labels_f >= 0,
                        (np.arange(G_new) * k)[:, None] + labels_f, -1)

    def t(x, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        return x if dtype is None else x.to(dtype)

    leaf_dict = dict(
        points=t(pts_f.reshape(n_new, d)),
        valid=t(valid_f.reshape(n_new)),
        parent=t(parent_f.reshape(n_new), torch.int32),
        child_start=torch.full((n_new,), -1, dtype=torch.int32, device=dev),
        child_count=torch.zeros(n_new, dtype=torch.int32, device=dev),
        leaf_ids=t(ids_f.reshape(n_new)),
    )
    med_flat = t(med_pts.reshape(G_new * k, d))
    mv_flat = t(med_valid.reshape(G_new * k))
    cs_flat = t(starts.reshape(G_new * k), torch.int32)
    cc_flat = t(counts.reshape(G_new * k), torch.int32)

    # --- regrow the hierarchy above the leaf --------------------------------
    if G_new == 1:  # the single group's medoids are the top level
        raw_levels = [leaf_dict]
        top = dict(points=med_flat, valid=mv_flat,
                   parent=torch.full((k,), -1, dtype=torch.int32, device=dev),
                   child_start=cs_flat, child_count=cc_flat)
        upper_td: list = []
    else:
        raw_levels, upper_td, top = msa._cluster_levels(
            med_flat, mv_flat, cs_flat, cc_flat, dist=dist, gl=gl, k=k,
            method=method, max_swaps=max_swaps, swap_tol=swap_tol,
            row_chunk=row_chunk, group_chunk=group_chunk, generator=generator,
            prev_levels=[leaf_dict])
    data = msa.finalize_index(raw_levels, top)

    # exact leaf TD (each point's distance to its own medoid), one rowwise
    # pass instead of stale per-group numbers through the reshuffle
    leaf_new = data.levels[0]
    l1_pts = data.levels[1].points
    par = leaf_new.parent.long().clamp(0, l1_pts.shape[0] - 1)
    td0 = torch.where(leaf_new.valid,
                      dist.point(leaf_new.points, l1_pts[par]),
                      torch.zeros((), device=dev)).sum()
    sizes = [int(lv.valid.sum()) for lv in data.levels]
    tds = [float(td0)] + [float(x) for x in upper_td] + [0.0]
    stats = msa.BuildStats(level_sizes=tuple(sizes), level_td=tuple(tds),
                           n_levels=len(sizes))
    return data, stats, np.repeat(affected, gl)
