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
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ops as _ops
from repro_torch.kernels.ref import FORMS, NORM_FORMS, VPU_FORMS


_P, _I = ctypes.c_void_p, ctypes.c_int
_RANK = {"rank_launch": [_P] * 7 + [_I] * 8 + [_P]}
_KNN = {"knn_launch": [_P] * 9 + [_I] * 10 + [_P]}

_SMEM_LIMIT = 227 * 1024  # shared memory one block may use on Hopper
_RANK_CAP, _RANK_RING = 64, 64  # buffer entries, ring entries a warp (topk.cuh)
_RANK_THREADS = 256  # at most, a block of rank.cu
_RANK_MAX_WARPS = _RANK_THREADS // 32
_KNN_WGMMA_MAX_K = 1024
_KNN_TILES = (16, 32, 64, 128)  # knn.cu's query tiles (a template parameter)
_KNN_TN, _KNN_BK, _KNN_STAGES, _KNN_CAP = 128, 64, 2, 32  # as in knn.cu
_KNN_STREAM_BK, _KNN_STREAM_STAGES = 32, 3  # the streaming route's (knn.cu)
_KNN_MIN_SPLIT = 1024  # fewest DB rows a split is worth
H100_SMS = 132


class RankGeometry(NamedTuple):
    """A ``rank.cu`` launch: ``wpq`` warps a query, ``qpb`` queries a
    block, ``blocks`` blocks (block ``i`` ranks queries ``[i * qpb, (i +
    1) * qpb)``; warp ``j`` of a query takes its 32-slot tiles ``j, j +
    wpq, ...``)."""

    wpq: int
    qpb: int
    blocks: int


def rank_smem_bytes(d: int, k: int, wpq: int, qpb: int) -> int:
    """Shared memory of one ``rank.cu`` block: per query its row (padded
    to 4) and, per warp, a top-k state (k padded to 2), a CAP-entry buffer
    and a ring of compacted candidates, each as value and id."""
    warp = 2 * ((k + 1) // 2 * 2 + _RANK_CAP + _RANK_RING)
    return 4 * qpb * (_cdiv(d, 4) * 4 + wpq * warp)


def rank_geometry(b: int, d: int, w: int, k: int, what: str = "rank_cuda",
                  wpq: Optional[int] = None, qpb: Optional[int] = None
                  ) -> RankGeometry:
    """The heuristic: four warps a query where ``w`` has four 32-slot tiles
    (else two or one), as many queries as fill 8 warps; fewer queries a
    block, then fewer warps a query, where the states would not fit. It
    raises only where one warp's state for one query does not fit.
    (``scan.cu`` shares the layout, ``csrc/topk.cuh``; ``what`` names the
    caller.)

    An explicit ``wpq`` or ``qpb`` (a launch knob) is used as given; the
    one left unset is the heuristic's choice beside it. A geometry that
    cannot run raises ``ValueError`` naming the limit it breaks (a knob
    below 1, more than 8 warps a block, or shared memory past 227 KB); it
    is never adjusted."""
    for name, v in (("wpq", wpq), ("qpb", qpb)):
        if v is not None and v < 1:
            raise ValueError(f"{what}: {name}={v} must be at least 1")
    if wpq is None and qpb is None:
        tiles = _cdiv(w, 32)
        wpq = 4 if tiles >= 4 else 2 if tiles >= 2 else 1
        qpb = _RANK_MAX_WARPS // wpq
        while rank_smem_bytes(d, k, wpq, qpb) > _SMEM_LIMIT:
            if qpb > 1:
                qpb //= 2
            elif wpq > 1:
                wpq //= 2
            else:
                raise ValueError(
                    f"{what}: k={k} at d={d} exceeds shared memory (one "
                    f"query's state takes {rank_smem_bytes(d, k, 1, 1)} "
                    f"bytes, a block may use {_SMEM_LIMIT})")
        return RankGeometry(wpq, qpb, _cdiv(b, qpb))
    if wpq is None:  # the heuristic's warps a query, beside the given qpb
        tiles = _cdiv(w, 32)
        wpq = min(4 if tiles >= 4 else 2 if tiles >= 2 else 1,
                  max(1, _RANK_MAX_WARPS // qpb))
        while wpq > 1 and rank_smem_bytes(d, k, wpq, qpb) > _SMEM_LIMIT:
            wpq //= 2
    elif qpb is None:  # as many queries as fill 8 warps, where they fit
        qpb = max(1, _RANK_MAX_WARPS // wpq)
        while qpb > 1 and rank_smem_bytes(d, k, wpq, qpb) > _SMEM_LIMIT:
            qpb //= 2
    if wpq * qpb > _RANK_MAX_WARPS:
        raise ValueError(
            f"{what}: wpq*qpb = {wpq}*{qpb} warps exceed a block's "
            f"{_RANK_MAX_WARPS} warps ({_RANK_THREADS} threads)")
    smem = rank_smem_bytes(d, k, wpq, qpb)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"{what}: wpq={wpq}, qpb={qpb} at d={d}, k={k} need {smem} bytes "
            f"of shared memory a block, over the {_SMEM_LIMIT}-byte (227 KB) "
            f"limit")
    return RankGeometry(wpq, qpb, _cdiv(b, qpb))


class KnnGeometry(NamedTuple):
    """A ``knn.cu`` launch: ``bq`` queries per block, DB rows ``[s * chunk,
    (s + 1) * chunk)`` for split ``s < splits``, on ``route`` "wgmma" (the
    query tile's rows whole in shared memory) or "stream" (Q and DB in
    d-slices: any d). ``shared_states``: the block's top-k states in shared
    memory; else (stream only, large k) in the per-split lists in device
    memory."""

    bq: int
    chunk: int
    splits: int
    route: str = "wgmma"
    shared_states: bool = True


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
    wpq: Optional[int] = None,
    qpb: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``Q [b, d]`` fp32, ``points [n, d]`` fp32, ``sq_norm [n]`` fp32 (norm
    forms), ``cand_idx [b, w]`` int32, ``ok [b, w]`` bool. Returns
    ``(dists[b, k], slots[b, k] in [0, w))``. ``wpq`` / ``qpb``: the launch
    geometry (None: :func:`rank_geometry`'s heuristic)."""
    if form not in FORMS:
        raise ValueError(f"unsupported form {form!r}")
    b, d = Q.shape
    n, d2 = points.shape
    if d != d2 or cand_idx.shape != ok.shape or cand_idx.shape[0] != b:
        raise ValueError("rank_cuda: shape mismatch")
    w = cand_idx.shape[1]
    if not 1 <= k <= w:
        raise ValueError(f"k={k} must lie in [1, w={w}]")
    geo = rank_geometry(b, d, w, k, wpq=wpq, qpb=qpb)
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
        b, n, d, w, k, FORMS.index(form), geo.wpq, geo.qpb,
        torch.cuda.current_stream(Q.device).cuda_stream,
    )
    _build.check(err, "rank")
    _ops.count_launch("rank")
    return out_d, out_s


def knn_smem_bytes(bq: int, d: int, k: int, form: str) -> int:
    """Shared memory of one ``knn.cu`` block: Q (its TF32 hi and lo halves
    for the Gram forms, padded rows for l1 and chebyshev), the DB ring, the
    top-k states, the candidate buffers, the per-query k-th entries and the
    list of queries to merge."""
    dpad = _cdiv(d, 8) * 8
    q_row = dpad + 4 if form in VPU_FORMS else 2 * dpad
    return 4 * (q_row * bq + _KNN_STAGES * _KNN_TN * (_KNN_BK + 4)
                + 2 * bq * k + 2 * bq * _KNN_CAP + 5 * bq + 2)


def knn_stream_smem_bytes(bq: int, k: int, form: str,
                          shared_states: bool = True) -> int:
    """Shared memory of one block of ``knn.cu``'s streaming route: the
    stages' barriers and 1 KB to align the ring, the ring (a stage: the DB
    rows and the pre-split queries' TF32 hi and lo for the Gram forms, DB
    and query rows padded to 4 more columns for the others), the top-k
    states (unless they live in device memory), the candidate buffers, the
    per-query k-th entries and the list of queries to merge."""
    bk = _KNN_STREAM_BK
    stage = (_KNN_TN + bq) * (bk + 4) if form in VPU_FORMS \
        else (_KNN_TN + 2 * bq) * bk
    states = 2 * bq * k if shared_states else 0
    return 32 + 1024 + 4 * (_KNN_STREAM_STAGES * stage + states
                            + 2 * bq * _KNN_CAP + 5 * bq + 2)


def knn_merge_smem_bytes(k: int) -> int:
    """Shared memory of ``knn.cu``'s per-query merge of the split lists."""
    return 4 * 6 * k


def knn_max_k() -> int:
    """The largest k ``knn.cu`` takes at any d: the merge kernel's six
    k-vectors must fit in shared memory (the streaming route keeps states
    that do not fit there in device memory)."""
    k = _SMEM_LIMIT // 24
    while knn_merge_smem_bytes(k) > _SMEM_LIMIT:
        k -= 1
    return k


def knn_geometry(nq: int, n: int, d: int, k: int, form: str,
                 sms: int = H100_SMS, bq: Optional[int] = None,
                 splits: Optional[int] = None) -> KnnGeometry:
    """The launch of ``knn.cu``. The wgmma route where a query tile fits
    (k <= 1024): the smallest tile that covers ``nq`` among those that fit
    (else the largest that fits). Else the streaming route, which takes any
    d: its tiles chosen the same way among those whose states fit in shared
    memory, else the smallest tile with its states in device memory. Both
    take as many DB splits as fill one wave of one block per SM with the
    query tiles (long splits amortise the merges of their first tiles; one
    block a split and query tile). Raises only past :func:`knn_max_k`.

    An explicit ``bq`` or ``splits`` (a launch knob) is used as given; the
    route stays the heuristic's, and an unset knob is the heuristic's
    choice beside the other. A geometry that cannot run raises
    ``ValueError`` naming the limit it breaks (``bq`` outside the compiled
    tiles or the route's fitting set; a split left empty, that is
    ``chunk * (splits - 1) >= n`` with ``chunk`` the 128-row multiple that
    covers ``n / splits``; more than 65,535 splits); it is never
    adjusted."""
    if knn_merge_smem_bytes(k) > _SMEM_LIMIT:
        raise ValueError(f"knn_cuda takes k <= {knn_max_k()} (the per-query "
                         f"merge of the split lists in shared memory), got "
                         f"k={k}")
    route, shared = "wgmma", True
    fits = [] if k > _KNN_WGMMA_MAX_K else [
        b for b in _KNN_TILES if knn_smem_bytes(b, d, k, form) <= _SMEM_LIMIT]
    if not fits:
        route = "stream"
        fits = [b for b in _KNN_TILES
                if knn_stream_smem_bytes(b, k, form) <= _SMEM_LIMIT]
        if not fits:
            fits, shared = [_KNN_TILES[0]], False
    if bq is None:
        bq = next((b for b in fits if b >= nq), fits[-1])
    elif bq not in _KNN_TILES:
        raise ValueError(f"knn_cuda: bq={bq} is not one of knn.cu's compiled "
                         f"query tiles {_KNN_TILES}")
    elif bq not in fits:
        raise ValueError(
            f"knn_cuda: bq={bq} does not fit the {route} route at d={d}, "
            f"k={k} ({form}): the tiles whose shared memory fits 227 KB "
            f"there are {tuple(fits)}")
    if splits is None:
        splits = max(1, min(sms // max(1, _cdiv(nq, bq)),
                            _cdiv(n, _KNN_MIN_SPLIT), 65535))
        chunk = _cdiv(_cdiv(n, splits), _KNN_TN) * _KNN_TN
        return KnnGeometry(bq, chunk, _cdiv(n, chunk), route, shared)
    if splits < 1:
        raise ValueError(f"knn_cuda: splits={splits} must be at least 1")
    if splits > 65535:
        raise ValueError(f"knn_cuda: splits={splits} exceed 65,535 splits "
                         f"(a grid axis)")
    chunk = _cdiv(_cdiv(n, splits), _KNN_TN) * _KNN_TN
    if chunk * (splits - 1) >= n:
        raise ValueError(
            f"knn_cuda: splits={splits} over n={n} DB rows leave a split "
            f"empty: chunk * (splits - 1) = {chunk} * {splits - 1} >= n "
            f"(chunk, a multiple of {_KNN_TN} rows, covers n / splits)")
    return KnnGeometry(bq, chunk, splits, route, shared)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def knn_cuda(Q: torch.Tensor, DB: torch.Tensor, k: int, form: str,
             bq: Optional[int] = None, splits: Optional[int] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``Q [q, d]``, ``DB [n, d]`` fp32 CUDA. Returns ``(dists[q, k],
    ids[q, k] int32)``. ``bq`` / ``splits``: the launch geometry (None:
    :func:`knn_geometry`'s heuristic)."""
    if form not in FORMS:
        raise ValueError(f"unsupported form {form!r}")
    nq, d = Q.shape
    n, d2 = DB.shape
    if d != d2:
        raise ValueError(f"dim mismatch {d} vs {d2}")
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must lie in [1, n={n}]")
    if Q.dtype != torch.float32 or DB.dtype != torch.float32:
        raise ValueError("knn_cuda takes fp32 tensors")
    _check_cuda(Q, DB)
    geo = knn_geometry(
        nq, n, d, k, form,
        torch.cuda.get_device_properties(Q.device).multi_processor_count,
        bq=bq, splits=splits)
    chunk, splits = geo.chunk, geo.splits
    norms = form in NORM_FORMS
    dev = Q.device
    # the streaming route's Gram forms load the DB by TMA, whose row stride
    # must be a multiple of 16 bytes: zero columns change no Gram sum
    split = geo.route == "stream" and form not in VPU_FORMS
    if split and (d % 4 or DB.data_ptr() % 16):
        pad = _cdiv(d, 4) * 4 - d
        Q = torch.nn.functional.pad(Q, (0, pad))
        DB = torch.nn.functional.pad(DB, (0, pad))
        d += pad
    # ... and split Q once: [2][nq to a whole tile][d to 8]
    qsplit = torch.empty(2 * _cdiv(nq, geo.bq) * geo.bq * _cdiv(d, 8) * 8 if split else 0,
                         device=dev)
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
        out_i.data_ptr(), qsplit.data_ptr(), nq, n, d, k, chunk, splits, geo.bq,
        int(geo.route == "stream"), int(not geo.shared_states),
        FORMS.index(form),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "knn")
    _ops.count_launch("knn")
    return out_d, out_i
