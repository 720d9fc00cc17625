"""CUDA FasterPAM swap-sweep kernel (``csrc/swap.cu``), the counterpart of
``repro.kernels.kmedoids.swap_deltas_pallas``.

``swap_deltas_cuda`` computes ``dTD[G, k, g] = S[G, None, g] + T[G, k, g]``
for a whole slab of groups in one launch; its plain version is
``ref.swap_deltas_ref``. The sum order is fixed, so the result is the same
from run to run.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last ops.reset_launch_counts()

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"swap_launch": [_P] * 6 + [_I] * 3 + [_P]}
_SMEM_LIMIT = 227 * 1024


def swap_deltas_cuda(
    D: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor, n1: torch.Tensor,
    valid: torch.Tensor, k: int,
) -> torch.Tensor:
    """``D [G, g, g]`` fp32, ``d1/d2 [G, g]`` fp32, ``n1 [G, g]`` int32,
    ``valid [G, g]`` bool, all contiguous CUDA. Returns ``[G, k, g]``."""
    global launches
    G, g, g2 = D.shape
    if g != g2:
        raise ValueError(f"D must be [G, g, g], got {tuple(D.shape)}")
    for t, dt in ((d1, torch.float32), (d2, torch.float32), (n1, torch.int32),
                  (valid, torch.bool)):
        if t.shape != (G, g) or t.dtype != dt:
            raise ValueError("swap_deltas_cuda: caches must be [G, g] "
                             "(d1/d2 fp32, n1 int32, valid bool)")
    for t in (D, d1, d2, n1, valid):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError("swap_deltas_cuda takes contiguous CUDA tensors")
    if D.dtype != torch.float32:
        raise ValueError("swap_deltas_cuda takes fp32 D")
    if 4 * (32 * g + 3 * g + 32 * k + 256) > _SMEM_LIMIT:
        raise ValueError(f"swap_deltas_cuda: g={g}, k={k} exceed shared memory")
    out = torch.empty((G, k, g), device=D.device, dtype=torch.float32)
    lib = _build.load("swap", _SIGNATURES)
    err = lib.swap_launch(
        D.data_ptr(), d1.data_ptr(), d2.data_ptr(), n1.data_ptr(),
        valid.data_ptr(), out.data_ptr(), G, g, k,
        torch.cuda.current_stream(D.device).cuda_stream,
    )
    _build.check(err, "swap")
    launches += 1
    return out
