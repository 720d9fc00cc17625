"""CUDA fused distance + top-k kernels, the counterparts of
``repro.kernels.topk``'s ``rank_pallas`` (``csrc/rank.cu``) and
``knn_pallas`` (``csrc/knn.cu``).

* ``rank_cuda`` ranks per-query candidates given as row indices into a
  shared point table, gathering the rows inside the kernel. Plain version:
  ``ref.rank_gathered_ref``.
* ``knn_cuda`` is the brute-force k-NN over a shared database, the exact
  ground truth. Plain version: ``ref.knn_ref``.

Both return ascending distances with the lower index first among equal
distances, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import FORMS, NORM_FORMS

rank_launches = 0  # launches since the last ops.reset_launch_counts()
knn_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_RANK = {"rank_launch": [_P] * 7 + [_I] * 6 + [_P]}
_KNN = {"knn_launch": [_P] * 8 + [_I] * 7 + [_P]}

_SMEM_LIMIT = 227 * 1024  # shared memory one block may use on Hopper
_RANK_TILE = 128  # candidates per tile in rank.cu
_KNN_MAX_K = 1024  # knn.cu keeps 16 queries' states in shared memory
_KNN_BLOCKS = 4 * 132  # blocks to aim for: four per H100 SM
_KNN_MIN_SPLIT = 1024  # fewest DB rows a split is worth


def _check_cuda(*tensors) -> None:
    for t in tensors:
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError("the CUDA top-k kernels take contiguous CUDA tensors")


def rank_cuda(
    Q: torch.Tensor,
    points: torch.Tensor,
    sq_norm: Optional[torch.Tensor],
    cand_idx: torch.Tensor,
    ok: torch.Tensor,
    k: int,
    form: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``Q [b, d]`` fp32, ``points [n, d]`` fp32, ``sq_norm [n]`` fp32 (norm
    forms), ``cand_idx [b, w]`` int32, ``ok [b, w]`` bool. Returns
    ``(dists[b, k], slots[b, k] in [0, w))``."""
    global rank_launches
    if form not in FORMS:
        raise ValueError(f"unsupported form {form!r}")
    b, d = Q.shape
    n, d2 = points.shape
    if d != d2 or cand_idx.shape != ok.shape or cand_idx.shape[0] != b:
        raise ValueError("rank_cuda: shape mismatch")
    w = cand_idx.shape[1]
    if not 1 <= k <= w:
        raise ValueError(f"k={k} must lie in [1, w={w}]")
    if 4 * (d + 4 * k + 2 * _RANK_TILE) > _SMEM_LIMIT:
        raise ValueError(f"rank_cuda: k={k} at d={d} exceeds shared memory")
    if Q.dtype != torch.float32 or points.dtype != torch.float32 \
            or cand_idx.dtype != torch.int32 or ok.dtype != torch.bool:
        raise ValueError("rank_cuda: Q/points fp32, cand_idx int32, ok bool")
    norms = form in NORM_FORMS
    if norms and (sq_norm is None or sq_norm.shape != (n,)
                  or sq_norm.dtype != torch.float32):
        raise ValueError("rank_cuda: norm forms need sq_norm [n] fp32")
    _check_cuda(Q, points, cand_idx, ok, *((sq_norm,) if norms else ()))
    out_d = torch.empty((b, k), device=Q.device, dtype=torch.float32)
    out_s = torch.empty((b, k), device=Q.device, dtype=torch.int32)
    lib = _build.load("rank", _RANK)
    err = lib.rank_launch(
        Q.data_ptr(), points.data_ptr(), sq_norm.data_ptr() if norms else None,
        cand_idx.data_ptr(), ok.data_ptr(), out_d.data_ptr(), out_s.data_ptr(),
        b, n, d, w, k, FORMS.index(form),
        torch.cuda.current_stream(Q.device).cuda_stream,
    )
    _build.check(err, "rank")
    rank_launches += 1
    return out_d, out_s


def knn_splits(nq: int, n: int) -> tuple[int, int]:
    """``(chunk, splits)``: DB rows per split and the number of splits, so
    that query tiles x splits fill the card."""
    qtiles = _cdiv(nq, 16)
    splits = max(1, min(_cdiv(_KNN_BLOCKS, qtiles), _cdiv(n, _KNN_MIN_SPLIT)))
    chunk = _cdiv(_cdiv(n, splits), 128) * 128
    return chunk, _cdiv(n, chunk)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def knn_cuda(Q: torch.Tensor, DB: torch.Tensor, k: int, form: str
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``Q [q, d]``, ``DB [n, d]`` fp32 CUDA. Returns ``(dists[q, k],
    ids[q, k] int32)``."""
    global knn_launches
    if form not in FORMS:
        raise ValueError(f"unsupported form {form!r}")
    nq, d = Q.shape
    n, d2 = DB.shape
    if d != d2:
        raise ValueError(f"dim mismatch {d} vs {d2}")
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must lie in [1, n={n}]")
    if k > _KNN_MAX_K:
        raise ValueError(f"knn_cuda supports k <= {_KNN_MAX_K}, got {k}")
    if Q.dtype != torch.float32 or DB.dtype != torch.float32:
        raise ValueError("knn_cuda takes fp32 tensors")
    _check_cuda(Q, DB)
    chunk, splits = knn_splits(nq, n)
    norms = form in NORM_FORMS
    dev = Q.device
    qq = torch.empty(nq if norms else 0, device=dev)
    dd = torch.empty(n if norms else 0, device=dev)
    part_d = torch.empty((splits, nq, k), device=dev, dtype=torch.float32)
    part_i = torch.empty((splits, nq, k), device=dev, dtype=torch.int32)
    out_d = torch.empty((nq, k), device=dev, dtype=torch.float32)
    out_i = torch.empty((nq, k), device=dev, dtype=torch.int32)
    lib = _build.load("knn", _KNN)
    err = lib.knn_launch(
        Q.data_ptr(), DB.data_ptr(), qq.data_ptr(), dd.data_ptr(),
        part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), nq, n, d, k, chunk, splits, FORMS.index(form),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "knn")
    knn_launches += 1
    return out_d, out_i
