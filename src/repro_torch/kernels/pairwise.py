"""CUDA pairwise-distance kernel (``csrc/pairwise.cu``), the counterpart of
``repro.kernels.pairwise.pairwise_pallas``.

``pairwise_cuda(X, Y, form)`` maps ``[m, d] x [n, d] -> [m, n]`` or, batched
over groups, ``[G, m, d] x [G, n, d] -> [G, m, n]`` in one launch (the
build's ``group_chunk`` slabs). Its plain version is
``ref.pairwise_ref``; ``ops.pairwise_distance`` chooses between them by the
device of its inputs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import FORMS, NORM_FORMS

launches = 0  # kernel launches since the last ops.reset_launch_counts()

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"pairwise_launch": [_P] * 5 + [_I] * 5 + [_P]}


def pairwise_cuda(X: torch.Tensor, Y: torch.Tensor, form: str) -> torch.Tensor:
    """Distances of every row of ``X`` to every row of ``Y`` (fp32 CUDA,
    contiguous, 2-D or batched 3-D)."""
    global launches
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
    out = torch.empty((G, m, n), device=X.device, dtype=torch.float32)
    norms = form in NORM_FORMS
    xx = torch.empty(G * m if norms else 0, device=X.device)
    yy = torch.empty(G * n if norms else 0, device=X.device)
    lib = _build.load("pairwise", _SIGNATURES)
    err = lib.pairwise_launch(
        Xb.data_ptr(), Yb.data_ptr(), xx.data_ptr(), yy.data_ptr(),
        out.data_ptr(), G, m, n, d, FORMS.index(form),
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check(err, "pairwise")
    launches += 1
    return out if batched else out[0]
