"""The CUDA payload-tier scan (``csrc/scan.cu``), the counterpart of
``repro.kernels.quantized.scan_pallas``: stage 1 of the two-stage search.

``scan_cuda`` ranks per-query candidates, given as row indices into the
store's quantised code table, against the codes in their native container
(int8, fp16, two int4 nibbles per byte, eight sign bits per byte). It reads
each candidate's code row and block scale itself, unpacks and dequantises
in registers, and keeps a per-warp top-k, as ``rank_cuda`` does (the two
kernels share ``csrc/topk.cuh`` and the launch shape of
``topk.rank_geometry``). Plain version: ``ref.scan_gathered_ref``. It
returns ascending distances with the lower slot first among equal
distances, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, topk
from repro_torch.kernels import ops as _ops
from repro_torch.kernels.ref import CODE_FORMATS, FORMS, packed_width


_P, _I = ctypes.c_void_p, ctypes.c_int
_SCAN = {"scan_launch": [_P] * 7 + [_I] * 13 + [_P]}

# (code format, container dtype) -> the container code of scan.cu
_CONTAINERS = {
    ("dense", torch.int8): 0,
    ("dense", torch.float16): 1,
    ("int4", torch.int8): 2,
    ("binary", torch.uint8): 3,
}


def scan_geometry(b: int, d: int, w: int, k: int, wpq: Optional[int] = None,
                  qpb: Optional[int] = None) -> topk.RankGeometry:
    """The launch of ``scan.cu``: ``rank.cu``'s (the per-query shared
    memory of the two is one layout, ``csrc/topk.cuh``), its explicit
    ``wpq`` / ``qpb`` knobs and their limits included
    (:func:`topk.rank_geometry`)."""
    return topk.rank_geometry(b, d, w, k, "scan_cuda", wpq=wpq, qpb=qpb)


def load_width(row_bytes: int, address: int, widest: int = 16) -> int:
    """Bytes of one code load in ``scan.cu``: the largest of 16, 8, 4, 2 and
    1, at most ``widest``, that divides both the row stride and the table's
    address, so that no load straddles a row or is misaligned (rows are
    100, 50 or 13 bytes at d = 100 for int8, int4 and binary). Binary codes
    take at most 4 bytes (32 values) a load, as scan.cu unpacks a load's
    values in registers."""
    return next(v for v in (16, 8, 4, 2, 1)
                if v <= widest and row_bytes % v == 0 and address % v == 0)


def scan_cuda(
    Q: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    block: int,
    cand_idx: torch.Tensor,
    ok: torch.Tensor,
    k: int,
    form: str,
    fmt: str = "dense",
    wpq: Optional[int] = None,
    qpb: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``Q [b, d]`` fp32, ``codes [n, dc]`` (int8 / fp16 for ``"dense"``,
    int8 for ``"int4"``, uint8 for ``"binary"``), ``scales [nb]`` fp32 (row
    ``r`` takes ``scales[r // block]``), ``cand_idx [b, w]`` int32, ``ok
    [b, w]`` bool, all contiguous on one CUDA device. Returns ``(dists[b, k],
    slots[b, k] in [0, w))``. ``wpq`` / ``qpb``: the launch geometry (None:
    the heuristic, :func:`scan_geometry`)."""
    if form not in FORMS:
        raise ValueError(f"unsupported form {form!r}")
    if fmt not in CODE_FORMATS:
        raise ValueError(f"unknown code format {fmt!r}; use {CODE_FORMATS}")
    container = _CONTAINERS.get((fmt, codes.dtype))
    if container is None:
        raise ValueError(f"scan_cuda: {fmt!r} codes cannot be {codes.dtype}")
    b, d = Q.shape
    n, dc = codes.shape
    if dc != packed_width(d, fmt):
        raise ValueError(f"scan_cuda: {fmt!r} codes of d={d} need width "
                         f"{packed_width(d, fmt)}, got {dc}")
    if cand_idx.shape != ok.shape or cand_idx.shape[0] != b:
        raise ValueError("scan_cuda: shape mismatch")
    w = cand_idx.shape[1]
    if not 1 <= k <= w:
        raise ValueError(f"k={k} must lie in [1, w={w}]")
    if block < 1 or scales.dim() != 1 or scales.shape[0] < 1:
        raise ValueError("scan_cuda: needs block >= 1 and scales [nb >= 1]")
    geo = scan_geometry(b, d, w, k, wpq=wpq, qpb=qpb)
    if Q.dtype != torch.float32 or scales.dtype != torch.float32 \
            or cand_idx.dtype != torch.int32 or ok.dtype != torch.bool:
        raise ValueError("scan_cuda: Q/scales fp32, cand_idx int32, ok bool")
    for t in (Q, codes, scales, cand_idx, ok):
        if not (t.is_cuda and t.is_contiguous() and t.device == Q.device):
            raise ValueError("scan_cuda takes contiguous tensors on one CUDA "
                             "device")
    out_d = torch.empty((b, k), device=Q.device, dtype=torch.float32)
    out_s = torch.empty((b, k), device=Q.device, dtype=torch.int32)
    lib = _build.load("scan", _SCAN)
    err = lib.scan_launch(
        Q.data_ptr(), codes.data_ptr(), scales.data_ptr(), cand_idx.data_ptr(),
        ok.data_ptr(), out_d.data_ptr(), out_s.data_ptr(),
        b, n, scales.shape[0], block, d, dc, w, k, FORMS.index(form),
        container, geo.wpq, geo.qpb,
        load_width(dc * codes.element_size(), codes.data_ptr(),
                   4 if fmt == "binary" else 16),
        torch.cuda.current_stream(Q.device).cuda_stream,
    )
    _build.check(err, "scan")
    _ops.count_launch("scan")
    return out_d, out_s
