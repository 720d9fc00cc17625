"""Gradient compression for slow links, with error feedback (counterpart
of ``repro.optim.compression``).

* :func:`topk_compress` / :func:`topk_decompress` — per-tensor magnitude
  top-k sparsification (the lower index first among equal magnitudes, as
  ``jax.lax.top_k``). Wire format (values[k], int32 indices[k]).
* PowerSGD — rank-r low-rank approximation of 2D gradients (G ~= P Q^T)
  with a warm-started Q and one orthogonalisation per step. Wire bytes
  drop from ``m*n`` to ``r*(m+n)``. The initial Q is drawn from a
  ``torch.Generator``, or passed in (``q=``) to carry another one across.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.ref import topk_largest

Tensor = torch.Tensor


class TopKState(NamedTuple):
    error: Tensor  # residual feedback buffer, same shape as the tensor


def topk_init(x: Tensor) -> TopKState:
    return TopKState(error=torch.zeros(x.shape, dtype=torch.float32,
                                       device=x.device))


def topk_compress(g: Tensor, state: TopKState, k: int):
    """Returns ((values[k], idx[k]), new_state). Error feedback included."""
    flat = g.float().reshape(-1) + state.error.reshape(-1)
    _, idx = topk_largest(torch.abs(flat), k)
    vals = flat[idx.long()]
    kept = torch.zeros_like(flat).index_put_((idx.long(),), vals)
    err = (flat - kept).reshape(g.shape)
    return (vals, idx), TopKState(error=err)


def topk_decompress(vals: Tensor, idx: Tensor, shape) -> Tensor:
    n = 1
    for s in shape:
        n *= s
    out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
    return out.index_add_(0, idx.long(), vals.float()).reshape(shape)


class PowerSGDState(NamedTuple):
    q: Tensor  # [n, r] warm-started right factor
    error: Tensor  # [m, n] feedback


def powersgd_init(shape, rank: int, generator: Optional[torch.Generator] = None,
                  *, q: Optional[Tensor] = None, device="cuda") -> PowerSGDState:
    """Zero feedback and the initial ``Q [n, rank]``: ``q`` as given, else
    N(0, 1) from ``generator`` (seed 17 when omitted), on ``device``."""
    m, n = shape
    dev = resolve_device(device)
    if q is None:
        gen = generator if generator is not None else torch.Generator().manual_seed(17)
        q = torch.randn((n, rank), generator=gen, dtype=torch.float32,
                        device=gen.device)
    return PowerSGDState(q=q.to(dev, torch.float32),
                         error=torch.zeros((m, n), dtype=torch.float32,
                                           device=dev))


def _orthonormalise(m: Tensor) -> Tensor:
    q, _ = torch.linalg.qr(m)
    return q


def powersgd_compress(g: Tensor, state: PowerSGDState):
    """One PowerSGD round. Returns ((P [m,r], Q [n,r]), new_state).

    The caller all-reduces P (and optionally Q) over the slow axis; the
    reconstruction is ``P @ Q^T``."""
    gf = g.float() + state.error
    p = _orthonormalise(gf @ state.q)  # [m, r]
    q = gf.T @ p  # [n, r]
    recon = p @ q.T
    return (p, q), PowerSGDState(q=q, error=gf - recon)


def powersgd_decompress(p: Tensor, q: Tensor) -> Tensor:
    return p @ q.T
