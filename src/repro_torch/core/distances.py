"""Distance-function registry for PDASC (counterpart of
``repro.core.distances``).

Any dissimilarity that is non-negative, symmetric and zero on identical
points works: k-medoids only consumes pairwise dissimilarities. Every
distance is exposed in two forms:

* ``point(x, y)``    — ``[..., d] x [..., d] -> [...]``.
* ``pairwise(X, Y)`` — ``[m, d] x [n, d] -> [m, n]``.

The Gram-form distances (euclidean, cosine, dot) compute ``pairwise`` as a
matrix product. Euclidean, manhattan, chebyshev, cosine and dot also have
CUDA kernels (``repro_torch.kernels``), reached through ``kernels.ops`` by
kernel *form*; haversine, jaccard, fractional05 and ``minkowski(p)`` stay
plain PyTorch on every device, as they stay plain JAX in ``repro``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch

from repro_torch.kernels.ref import stream_blocks

Tensor = torch.Tensor

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Point-wise definitions
# ---------------------------------------------------------------------------


def _minkowski_point(x: Tensor, y: Tensor, p: float) -> Tensor:
    diff = torch.abs(x - y)
    if p == math.inf:
        return diff.amax(-1)
    if p == 1.0:
        return diff.sum(-1)
    if p == 2.0:
        return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    # generic p, fractional p < 1 included (not a metric; PDASC supports it)
    return torch.pow(torch.pow(diff, p).sum(-1), 1.0 / p)


def _cosine_point(x: Tensor, y: Tensor) -> Tensor:
    xn = torch.sqrt(torch.clamp((x * x).sum(-1), min=_EPS))
    yn = torch.sqrt(torch.clamp((y * y).sum(-1), min=_EPS))
    cos = (x * y).sum(-1) / (xn * yn)
    return 1.0 - torch.clamp(cos, -1.0, 1.0)


def _haversine_point(x: Tensor, y: Tensor) -> Tensor:
    # (lat, lon) in radians; unit-sphere great-circle angle
    lat1, lon1 = x[..., 0], x[..., 1]
    lat2, lon2 = y[..., 0], y[..., 1]
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = (torch.sin(dlat / 2.0) ** 2
         + torch.cos(lat1) * torch.cos(lat2) * torch.sin(dlon / 2.0) ** 2)
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def _jaccard_point(x: Tensor, y: Tensor) -> Tensor:
    # weighted (Ruzicka) Jaccard for non-negative vectors
    mn = torch.minimum(x, y).sum(-1)
    mx = torch.maximum(x, y).sum(-1)
    return 1.0 - mn / torch.clamp(mx, min=_EPS)


def _dot_point(x: Tensor, y: Tensor) -> Tensor:
    return -(x * y).sum(-1)


# ---------------------------------------------------------------------------
# Pairwise (cross-matrix) definitions
# ---------------------------------------------------------------------------


def _broadcast_pairwise(point_fn: Callable[[Tensor, Tensor], Tensor]):
    def pairwise(X: Tensor, Y: Tensor) -> Tensor:
        return point_fn(X[..., :, None, :], Y[..., None, :, :])

    return pairwise


def _sqeuclidean_gram(X: Tensor, Y: Tensor) -> Tensor:
    X = X.float()
    Y = Y.float()
    xx = (X * X).sum(-1)
    yy = (Y * Y).sum(-1)
    g = X @ Y.transpose(-1, -2)
    return torch.clamp(xx[..., :, None] + yy[..., None, :] - 2.0 * g, min=0.0)


def _euclidean_pairwise(X: Tensor, Y: Tensor) -> Tensor:
    return torch.sqrt(_sqeuclidean_gram(X, Y))


def _cosine_pairwise(X: Tensor, Y: Tensor) -> Tensor:
    X = X.float()
    Y = Y.float()
    xn = torch.sqrt(torch.clamp((X * X).sum(-1), min=_EPS))
    yn = torch.sqrt(torch.clamp((Y * Y).sum(-1), min=_EPS))
    cos = (X @ Y.transpose(-1, -2)) / (xn[..., :, None] * yn[..., None, :])
    return 1.0 - torch.clamp(cos, -1.0, 1.0)


def _dot_pairwise(X: Tensor, Y: Tensor) -> Tensor:
    return -(X @ Y.transpose(-1, -2))


def _minkowski_pairwise(p: float):
    def pairwise(X: Tensor, Y: Tensor) -> Tensor:
        if p == 2.0:
            return _euclidean_pairwise(X, Y)
        return _minkowski_point(X[..., :, None, :], Y[..., None, :, :], p)

    return pairwise


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Distance:
    """A registered dissimilarity function."""

    name: str
    point: Callable[[Tensor, Tensor], Tensor]
    pairwise: Callable[[Tensor, Tensor], Tensor]
    gram_form: bool = False
    is_metric: bool = True
    needs_dim: Optional[int] = None
    bound: Optional[float] = None  # upper bound of the range, if bounded

    def __call__(self, X: Tensor, Y: Tensor) -> Tensor:
        return self.pairwise(X, Y)


_REGISTRY: dict[str, Distance] = {}


def _state_eq(a, b) -> bool:
    """Equality for bound state that never lies towards True."""
    if a is b:
        return True
    if callable(a) and callable(b):
        return _fns_match(a, b)
    try:
        return bool(a == b)
    except Exception:
        return False


def _fns_match(f, g) -> bool:
    """Structural callable identity: same code location and the same bound
    state (``functools.partial`` arguments and closure cells)."""
    fb = gb = ()
    if isinstance(f, functools.partial):
        fb = f.args + tuple(sorted(f.keywords.items()))
        f = f.func
    if isinstance(g, functools.partial):
        gb = g.args + tuple(sorted(g.keywords.items()))
        g = g.func

    def _loc(fn):
        code = getattr(fn, "__code__", None)
        where = (code.co_filename, code.co_firstlineno) if code else None
        return (getattr(fn, "__module__", None),
                getattr(fn, "__qualname__", None), where)

    if _loc(f) != _loc(g):
        return False
    fc = tuple(c.cell_contents for c in (getattr(f, "__closure__", None) or ()))
    gc = tuple(c.cell_contents for c in (getattr(g, "__closure__", None) or ()))
    state_f, state_g = fb + fc, gb + gc
    return len(state_f) == len(state_g) and all(
        _state_eq(x, y) for x, y in zip(state_f, state_g)
    )


def _same_entry(a: Distance, b: Distance) -> bool:
    """Structural identity for re-registration (module re-import safe)."""
    return (
        a.name == b.name
        and (a.gram_form, a.is_metric, a.needs_dim, a.bound)
        == (b.gram_form, b.is_metric, b.needs_dim, b.bound)
        and _fns_match(a.point, b.point)
        and _fns_match(a.pairwise, b.pairwise)
    )


def register(dist: Distance, *, overwrite: bool = False) -> Distance:
    """Register ``dist`` under its name. Re-registering a structurally
    identical entry is a no-op; a different entry under an existing name
    raises unless ``overwrite=True``."""
    prev = _REGISTRY.get(dist.name)
    if prev is not None and not overwrite:
        if _same_entry(prev, dist):
            return prev
        raise ValueError(
            f"distance {dist.name!r} already registered with a different "
            f"definition; pass overwrite=True to replace it"
        )
    _REGISTRY[dist.name] = dist
    return dist


def get(name_or_dist) -> Distance:
    if isinstance(name_or_dist, Distance):
        return name_or_dist
    try:
        return _REGISTRY[name_or_dist]
    except KeyError:
        raise KeyError(
            f"unknown distance {name_or_dist!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def names() -> list[str]:
    return sorted(_REGISTRY)


register(Distance(name="manhattan",
                  point=functools.partial(_minkowski_point, p=1.0),
                  pairwise=_minkowski_pairwise(1.0)))
register(Distance(name="euclidean",
                  point=functools.partial(_minkowski_point, p=2.0),
                  pairwise=_euclidean_pairwise, gram_form=True))
register(Distance(name="chebyshev",
                  point=functools.partial(_minkowski_point, p=math.inf),
                  pairwise=_minkowski_pairwise(math.inf)))
register(Distance(name="fractional05",
                  point=functools.partial(_minkowski_point, p=0.5),
                  pairwise=_minkowski_pairwise(0.5), is_metric=False))
register(Distance(name="cosine", point=_cosine_point,
                  pairwise=_cosine_pairwise, gram_form=True, is_metric=False,
                  bound=2.0))
register(Distance(name="haversine", point=_haversine_point,
                  pairwise=_broadcast_pairwise(_haversine_point), needs_dim=2,
                  bound=math.pi))
register(Distance(name="jaccard", point=_jaccard_point,
                  pairwise=_broadcast_pairwise(_jaccard_point),
                  is_metric=False, bound=1.0))
register(Distance(name="dot", point=_dot_point, pairwise=_dot_pairwise,
                  gram_form=True, is_metric=False))


def minkowski(p: float) -> Distance:
    """Ad-hoc (unregistered) Minkowski distance for arbitrary ``p``."""
    return Distance(
        name=f"minkowski_{p}",
        point=functools.partial(_minkowski_point, p=p),
        pairwise=_minkowski_pairwise(p),
        is_metric=p >= 1.0,
    )


def pairwise_chunked(dist, X: Tensor, Y: Tensor, *, chunk: int = 4096) -> Tensor:
    """``dist.pairwise`` in bounded-memory blocks: the broadcast forms
    build at most a ``[chunk, chunk, d]`` cube; Gram forms never build one
    and run whole."""
    dist = get(dist)
    if dist.gram_form or (X.shape[-2] <= chunk and Y.shape[-2] <= chunk):
        return dist.pairwise(X, Y)
    return stream_blocks(dist.pairwise, X, Y, chunk)


BIG = 1e30  # sentinel for masked / invalid slots; above any real distance


def mask_invalid(D: Tensor, row_valid: Optional[Tensor],
                 col_valid: Optional[Tensor]) -> Tensor:
    """Replace distances involving invalid (padding) points with ``BIG``
    (leading batch axes allowed)."""
    big = torch.full((), BIG, dtype=D.dtype, device=D.device)
    if row_valid is not None:
        D = torch.where(row_valid[..., :, None], D, big)
    if col_valid is not None:
        D = torch.where(col_valid[..., None, :], D, big)
    return D
