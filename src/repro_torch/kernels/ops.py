"""Dispatch over the CUDA kernels (counterpart of ``repro.kernels.ops``).

Public ops, the one execution substrate for every MSA and NSA distance
evaluation and ranking step:

  pairwise_distance(X, Y, distance)       -> [m, n]  (or [G, m, n])
  knn(Q, DB, distance, k)                 -> (dists[q, k], ids[q, k])
  rank_candidates(Q, C, ok, distance, k)  -> (dists[b, k], slots[b, k])
  rank_gathered(Q, points, sq_norms, cand_idx, cand_ok, distance, k)
                                          -> (dists[b, k], slots[b, k])
  swap_deltas(D, d1, d2, n1, valid, k)    -> [k, g]  (or [G, k, g])

``distance`` may be a kernel form (``ref.FORMS``), a registry name
(``repro_torch.core.distances``) or a ``Distance``. Dispatch:

* CUDA tensors, kernel form -> the CUDA kernel. If it is missing or fails,
  the op raises; it never falls back to the plain version.
* CPU tensors, kernel form  -> the plain PyTorch version in ``ref.py``.
* a form with no kernel (haversine, jaccard, fractional05, minkowski(p))
  -> the registry's plain PyTorch path, on either device.

Each kernel wrapper counts its launches (:func:`launch_counts`), so a run can
show that it went through the kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import kmedoids as _kmk
from repro_torch.kernels import pairwise as _pw
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import topk as _tk

Tensor = torch.Tensor


class KernelConfig(NamedTuple):
    """Knobs of the kernel layer that the port keeps (hashable)."""

    row_chunk: int = 1024  # streaming chunk of the plain broadcast forms


DEFAULT = KernelConfig()


def resolve_form(distance) -> Optional[str]:
    """Map a distance spec to a kernel form (None = no kernel)."""
    if isinstance(distance, str):
        if distance in _ref.FORMS:
            return distance
        return _ref.FORM_OF.get(distance)
    name = getattr(distance, "name", None)
    return _ref.FORM_OF.get(name) if name else None


def launch_counts() -> dict:
    """Kernel launches per CUDA kernel since the last reset."""
    return {
        "pairwise": _pw.launches,
        "rank": _tk.rank_launches,
        "knn": _tk.knn_launches,
        "swap_deltas": _kmk.launches,
    }


def reset_launch_counts() -> None:
    _pw.launches = 0
    _tk.rank_launches = 0
    _tk.knn_launches = 0
    _kmk.launches = 0


def _on_cuda(*tensors) -> bool:
    """True when every tensor is on a CUDA device, False when all are on
    the CPU; mixed placements raise."""
    cuda = {t.is_cuda for t in tensors if t is not None}
    if len(cuda) > 1:
        raise ValueError("ops inputs must all lie on one device")
    return cuda == {True}


def _f32(t: Tensor) -> Tensor:
    return t.to(torch.float32).contiguous()


def pairwise_distance(
    X: Tensor,
    Y: Tensor,
    distance="l2",
    *,
    row_chunk: Optional[int] = None,
    config: Optional[KernelConfig] = None,
) -> Tensor:
    """``[m, d] x [n, d] -> [m, n]`` distances, or batched over groups
    ``[G, m, d] x [G, n, d] -> [G, m, n]``.

    ``row_chunk`` bounds the peak memory of the plain broadcast forms (the
    cube streams in ``[row_chunk, row_chunk, d]`` slabs); the CUDA kernel
    never builds it."""
    if row_chunk is None:
        row_chunk = (config or DEFAULT).row_chunk
    form = resolve_form(distance)
    if form is None:
        from repro_torch.core import distances as dist_lib  # registry path

        if X.dim() == 3:  # one group at a time bounds the cube
            return torch.stack([
                dist_lib.pairwise_chunked(distance, x, y, chunk=row_chunk)
                for x, y in zip(X, Y)
            ])
        return dist_lib.pairwise_chunked(distance, X, Y, chunk=row_chunk)
    if _on_cuda(X, Y):
        return _pw.pairwise_cuda(_f32(X), _f32(Y), form)
    if form in _ref.VPU_FORMS:
        return _ref.pairwise_ref_chunked(X, Y, form, row_chunk)
    return _ref.pairwise_ref(X, Y, form)


def knn(Q: Tensor, DB: Tensor, distance="l2", *, k: int = 10
        ) -> tuple[Tensor, Tensor]:
    """Fused brute-force k-NN (ascending dists, int32 ids)."""
    form = resolve_form(distance)
    if form is None:
        from repro_torch.core import distances as dist_lib

        return _ref.topk_smallest(dist_lib.pairwise_chunked(distance, Q, DB), k)
    if _on_cuda(Q, DB):
        return _tk.knn_cuda(_f32(Q), _f32(DB), k, form)
    return _ref.knn_ref(Q, DB, k, form)


def rank_candidates(
    Q: Tensor,
    C: Tensor,
    ok: Tensor,
    distance="l2",
    *,
    k: int,
    c_sq_norms: Optional[Tensor] = None,
) -> tuple[Tensor, Tensor]:
    """Masked ranking of per-query gathered candidates ``C [b, w, d]``.

    Returns ``(dists[b, k] ascending, slots[b, k])``; masked slots rank as
    ``BIG``. On CUDA the cube is the rank kernel's point table and the
    candidate indices enumerate it."""
    form = resolve_form(distance)
    if form is None:
        return _registry_rank(Q, C, ok, distance, k)
    if _on_cuda(Q, C, ok):
        b, w, d = C.shape
        points = _f32(C).reshape(b * w, d)
        cc = None
        if form in _ref.NORM_FORMS:
            cc = (_f32(c_sq_norms).reshape(-1) if c_sq_norms is not None
                  else (points * points).sum(-1))
        idx = torch.arange(b * w, device=C.device, dtype=torch.int32)
        return _tk.rank_cuda(_f32(Q), points, cc, idx.reshape(b, w),
                             ok.to(torch.bool).contiguous(), k, form)
    return _ref.rank_ref(Q, C, ok, k, form, cc=c_sq_norms)


def _registry_rank(Q, C, ok, distance, k):
    from repro_torch.core import distances as dist_lib

    D = dist_lib.get(distance).point(Q[:, None, :], C)
    D = torch.where(ok, D, torch.full((), dist_lib.BIG, device=D.device))
    return _ref.topk_smallest(D, k)


def rank_gathered(
    Q: Tensor,
    points: Tensor,
    sq_norms: Optional[Tensor],
    cand_idx: Tensor,
    cand_ok: Tensor,
    distance="l2",
    *,
    k: int,
    slot_valid: Optional[Tensor] = None,
) -> tuple[Tensor, Tensor]:
    """Rank per-query candidates given as *indices* into a shared point
    table (the beam-search layout: ``cand_idx[b]`` indexes rows of
    ``points``). Returns ``(dists[b, k] ascending, slots[b, k])`` into the
    candidate axis.

    ``slot_valid``: optional ``bool[n]`` mask of live table rows, folded
    into ``cand_ok`` first. On CUDA the rank kernel gathers the rows
    itself, so the ``[b, w, d]`` cube never exists in device memory."""
    cand_ok = _ref.fold_slot_valid(cand_idx, cand_ok, slot_valid)
    form = resolve_form(distance)
    if form is None:
        rows = torch.clamp(cand_idx.long(), 0, points.shape[0] - 1)
        return _registry_rank(Q, points[rows], cand_ok, distance, k)
    if _on_cuda(Q, points, cand_idx, cand_ok):
        cc = None
        if form in _ref.NORM_FORMS:
            cc = (_f32(sq_norms) if sq_norms is not None
                  else (_f32(points) ** 2).sum(-1))
        return _tk.rank_cuda(
            _f32(Q), _f32(points), cc, cand_idx.to(torch.int32).contiguous(),
            cand_ok.to(torch.bool).contiguous(), k, form,
        )
    return _ref.rank_gathered_ref(Q, points, sq_norms, cand_idx, cand_ok, k, form)


def swap_deltas(
    D: Tensor, d1: Tensor, d2: Tensor, n1: Tensor, valid: Tensor, *, k: int,
) -> Tensor:
    """FasterPAM swap-sweep deltas ``[k, g]`` from ``D [g, g]`` and the
    ``[g]`` caches, or batched ``[G, k, g]`` from ``[G, g, g]`` and
    ``[G, g]``. Unmasked: callers mask medoid and invalid columns before
    taking argmins (``core.kmedoids``)."""
    if _on_cuda(D, d1, d2, n1, valid):
        batched = D.dim() == 3
        args = [_f32(D), _f32(d1), _f32(d2), n1.to(torch.int32).contiguous(),
                valid.to(torch.bool).contiguous()]
        if not batched:
            args = [a[None] for a in args]
        out = _kmk.swap_deltas_cuda(*args, k=k)
        return out if batched else out[0]
    return _ref.swap_deltas_ref(D, d1, d2, n1, valid, k)
