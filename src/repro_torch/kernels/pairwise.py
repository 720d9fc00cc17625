"""CUDA pairwise-distance kernel (``csrc/pairwise.cu``), the counterpart of
``repro.kernels.pairwise.pairwise_pallas``.

``pairwise_cuda(X, Y, form)`` maps ``[m, d] x [n, d] -> [m, n]`` or, batched
over groups, ``[G, m, d] x [G, n, d] -> [G, m, n]`` in one launch (the
build's ``group_chunk`` slabs). Its plain version is
``ref.pairwise_ref``; ``ops.pairwise_distance`` chooses between them by the
device of its inputs.

The kernel has no launch-time knob: its ``[128, 128]`` output tile is fixed
by the ``wgmma`` layout (two 64-row warpgroup products a tile, the
``[128, 136]`` output staging), so the block autotuner's grid for
``pairwise`` has one member, this launch (``kernels/autotune.py``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ops as _ops
from repro_torch.kernels.ref import FORMS


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"pairwise_launch": [_P] * 3 + [_I] * 6 + [_P]}

_SMEM_LIMIT = 227 * 1024  # shared memory one block may use on Hopper
_BM, _BN, _BK, _STAGES, _OS = 128, 128, 32, 2, 136  # as in pairwise.cu


class PairwiseGeometry(NamedTuple):
    """A ``pairwise.cu`` launch: ``tiles_m x tiles_n`` output tiles of
    ``[128, 128]`` per group, one block each in ``blockIdx.x``; with
    ``sym`` (X is Y) only the ``tiles_m (tiles_m + 1) / 2`` tiles on and
    above the diagonal, each off-diagonal one also written as its mirror."""

    tiles_m: int
    tiles_n: int
    sym: bool
    blocks: int

    def tiles(self, block: int) -> list:
        """The ``(group, row tile, column tile)`` outputs block ``block``
        writes, as the kernel maps it."""
        if not self.sym:
            rest, tc = divmod(block, self.tiles_n)
            grp, tr = divmod(rest, self.tiles_m)
            return [(grp, tr, tc)]
        grp, u = divmod(block, self.tiles_m * (self.tiles_m + 1) // 2)
        tr = 0
        while u >= self.tiles_m - tr:
            u -= self.tiles_m - tr
            tr += 1
        tc = tr + u
        return [(grp, tr, tc)] + ([(grp, tc, tr)] if tc != tr else [])


def pairwise_smem_bytes() -> int:
    """Shared memory of one ``pairwise.cu`` block: the two-stage ring of X
    and Y slices (``[128, 32 + 4]`` each), the TF32 hi and lo halves of the
    Y slice and the two norm vectors; the output staging ``[128, 136]``
    reuses the ring."""
    return 4 * (_STAGES * 2 * _BM * (_BK + 4) + 2 * _BN * _BK + _BM + _BN)


def pairwise_geometry(G: int, m: int, n: int, sym: bool = False
                      ) -> PairwiseGeometry:
    tm, tn = -(-m // _BM), -(-n // _BN)
    blocks = G * (tm * (tm + 1) // 2 if sym else tm * tn)
    if blocks > 2**31 - 1:
        raise ValueError(f"pairwise_cuda: {blocks} tiles exceed one grid")
    return PairwiseGeometry(tm, tn, sym, blocks)


def pairwise_cuda(X: torch.Tensor, Y: torch.Tensor, form: str) -> torch.Tensor:
    """Distances of every row of ``X`` to every row of ``Y`` (fp32 CUDA,
    contiguous, 2-D or batched 3-D; ``X`` may be ``Y``)."""
    if form not in FORMS:
        raise ValueError(f"unsupported form {form!r}; kernels support {FORMS}")
    batched = X.dim() == 3
    Xb, Yb = (X, Y) if batched else (X[None], Y[None])
    if Xb.dim() != 3 or Yb.dim() != 3 or Xb.shape[0] != Yb.shape[0] \
            or Xb.shape[2] != Yb.shape[2]:
        raise ValueError(f"shape mismatch {tuple(X.shape)} vs {tuple(Y.shape)}")
    for t in (Xb, Yb):
        if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()):
            raise ValueError("pairwise_cuda takes contiguous fp32 CUDA tensors")
    G, m, d = Xb.shape
    n = Yb.shape[1]
    if d < 1:
        raise ValueError("pairwise_cuda needs d >= 1")
    sym = Xb.data_ptr() == Yb.data_ptr() and m == n
    pairwise_geometry(G, m, n, sym)
    out = torch.empty((G, m, n), device=X.device, dtype=torch.float32)
    lib = _build.load("pairwise", _SIGNATURES)
    err = lib.pairwise_launch(
        Xb.data_ptr(), Yb.data_ptr(), out.data_ptr(), G, m, n, d,
        FORMS.index(form), int(sym),
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check(err, "pairwise")
    _ops.count_launch("pairwise")
    return out if batched else out[0]
