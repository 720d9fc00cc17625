"""Literal (numpy, recursive) transcription of the paper's Algorithm 2 —
NSA — and the structural invariants of an MSA index (the port's own copy
of ``repro.core.reference_impl``).

``nsa_reference`` is the faithfulness oracle: ragged candidate lists,
Python recursion, per-level radius filtering, unfiltered leaf expansion,
on the same built index as the batched searchers. ``check_index_invariants``
holds any built, loaded or compacted index to the layout the searchers
rely on. Both read the index back to the host once and run in numpy; the
distances come from the port's registry on CPU tensors.

Intentionally slow and simple; never used in the hot path.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import distances as dist_lib
from repro_torch.core.msa import PDASCIndexData


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _dist_np(dist: dist_lib.Distance, q: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return dist.point(torch.from_numpy(np.asarray(q, np.float32))[None, :],
                      torch.from_numpy(np.asarray(pts, np.float32))).numpy()


def nsa_reference(
    index: PDASCIndexData,
    q,
    *,
    dist,
    k: int = 10,
    r: float,
    leaf_radius_filter: bool = False,
):
    """Paper Algorithm 2 (NSA + ExploreCandidates), literally.

    Returns (dists[k], ids[k]) ascending, padded with (inf, -1).
    """
    dist = dist_lib.get(dist)
    q = np.asarray(q, np.float32)
    levels = [
        dict(
            points=_np(lv.points),
            valid=_np(lv.valid),
            child_start=_np(lv.child_start),
            child_count=_np(lv.child_count),
        )
        for lv in index.levels
    ]
    leaf_ids = _np(index.leaf_ids)
    L = len(levels) - 1

    # --- top level: prototypes within the search radius ---------------------
    top = levels[L]
    d_top = _dist_np(dist, q, top["points"])
    id_candidates = [
        int(i) for i in np.nonzero(top["valid"] & (d_top < r))[0]
    ]

    # --- ExploreCandidates: recursive descent --------------------------------
    def explore(id_candidates, level):
        """Returns leaf slot indices mapped by the selected prototypes."""
        out = []
        for pid in id_candidates:
            start = int(levels[level]["child_start"][pid])
            count = int(levels[level]["child_count"][pid])
            children = list(range(start, start + count))
            if level - 1 == 0:
                # "At the lowest level, return only the specific points mapped
                # by idCandidates" — no radius re-check on leaf data points.
                if leaf_radius_filter:
                    pts = levels[0]["points"][children]
                    dd = _dist_np(dist, q, pts)
                    children = [c for c, d_ in zip(children, dd) if d_ < r]
                out.extend(children)
            else:
                pts = levels[level - 1]["points"][children]
                dd = _dist_np(dist, q, pts)
                filtered = [c for c, d_ in zip(children, dd) if d_ < r]
                if filtered:
                    out.extend(explore(filtered, level - 1))
        return out

    if L == 0:
        candidates = [int(i) for i in np.nonzero(top["valid"])[0]]
    else:
        candidates = explore(id_candidates, L)

    # --- rank candidates, return k nearest -----------------------------------
    candidates = sorted(set(candidates))
    if not candidates:
        return np.full((k,), np.inf, np.float32), np.full((k,), -1, np.int64)
    pts = levels[0]["points"][candidates]
    dd = _dist_np(dist, q, pts)
    order = np.argsort(dd, kind="stable")[:k]
    dists = dd[order]
    ids = leaf_ids[np.asarray(candidates)[order]]
    if len(order) < k:
        pad = k - len(order)
        dists = np.concatenate([dists, np.full((pad,), np.inf, np.float32)])
        ids = np.concatenate([ids, np.full((pad,), -1, ids.dtype)])
    return dists, ids


def check_index_invariants(index: PDASCIndexData) -> list[str]:
    """Structural invariants of an MSA index; returns a list of violations
    (``repro``'s checks, vectorised over each level's prototypes)."""
    errs = []
    levels = index.levels
    for l, lv in enumerate(levels):
        valid = _np(lv.valid)
        parent = _np(lv.parent)
        if l < len(levels) - 1:
            n_up = levels[l + 1].points.shape[0]
            up_valid = _np(levels[l + 1].valid)
            bad = valid & ((parent < 0) | (parent >= n_up))
            if bad.any():
                errs.append(f"level {l}: {bad.sum()} valid items without parent")
            elif not up_valid[parent[valid]].all():
                errs.append(f"level {l}: some parents are invalid slots")
        if l > 0:
            cs = _np(lv.child_start).astype(np.int64)
            cc = _np(lv.child_count).astype(np.int64)
            n_dn = levels[l - 1].points.shape[0]
            dn_valid = _np(levels[l - 1].valid)
            dn_parent = _np(levels[l - 1].parent)
            protos = np.nonzero(valid)[0]
            oob = (cs[protos] < 0) | (cs[protos] + cc[protos] > n_dn)
            for p in protos[oob]:
                errs.append(f"level {l}: slot {p} child range out of bounds")
            protos = protos[~oob]
            owner = np.repeat(protos, np.maximum(cc[protos], 0))
            first = np.repeat(cs[protos] - np.concatenate(
                [[0], np.cumsum(np.maximum(cc[protos], 0))[:-1]]),
                np.maximum(cc[protos], 0))
            child = first + np.arange(owner.size)
            seen = np.bincount(child, minlength=n_dn)
            for p in np.unique(owner[~dn_valid[child]]):
                errs.append(f"level {l}: slot {p} has invalid children")
            for p in np.unique(owner[dn_parent[child] != owner]):
                errs.append(f"level {l}: slot {p} children disagree on parent")
            missing = dn_valid & (seen == 0)
            dup = seen > 1
            if missing.any():
                errs.append(f"level {l-1}: {missing.sum()} valid items unclaimed")
            if dup.any():
                errs.append(f"level {l-1}: {dup.sum()} items claimed twice")
    # Leaf ids form a permutation of the dataset rows.
    ids = _np(index.leaf_ids)[_np(levels[0].valid)]
    if len(np.unique(ids)) != len(ids):
        errs.append("leaf ids are not unique")
    return errs
