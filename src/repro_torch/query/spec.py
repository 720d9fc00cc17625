"""The declarative :class:`Query` spec — *what* to retrieve, never *how*
(counterpart of ``repro.query.spec``).

A query names the result contract (``k``, ``radius``), the quality/cost
knobs (``beam`` schedule, ``leaf_radius_filter``) and at most a preference
for the execution pipeline (``execution``, default ``"auto"``). The planner
(``repro_torch.query.plan``) decides the rest from the index at plan time.
Queries are frozen and hashable: a ``Query`` keys the plan cache.
``rerank_width`` and ``exact_rerank`` are the two-stage knobs, read only by
the ``two_stage`` pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import distances as dist_lib
from repro_torch.kernels import ops as kops

# Execution preferences a Query may name (the same names as repro's).
# "auto" resolves to "beam", or to "two_stage" once the index has released
# its dense leaf payload; "sharded" is not yet ported and raises when the
# plan is compiled.
EXECUTIONS = ("auto", "dense", "beam", "beam_vmap", "two_stage", "sharded")

Radius = Union[None, float, tuple]
Beam = Union[int, tuple]


def _freeze_schedule(value, *, numeric=float):
    """Normalise a scalar-or-per-level schedule to a hashable value."""
    if value is None:
        return None
    if isinstance(value, (list, tuple)):
        return tuple(numeric(v) for v in value)
    return numeric(value)


@dataclasses.dataclass(frozen=True)
class Query:
    """Declarative k-ANN query spec (hashable).

    Attributes:
      k: neighbours to return.
      radius: scalar, per-level tuple (``radius[0]`` = leaf, ``radius[-1]``
        = top) or None for the index's ``default_radius``.
      execution: pipeline preference, one of :data:`EXECUTIONS`.
      beam: surviving prototypes per level — scalar or per-level schedule.
      rerank_width: two-stage only — survivors of the quantised scan that
        advance to the exact rerank (None / <= 0 = ∞, bit-identical to
        ``beam``).
      exact_rerank: two-stage only — False skips the exact rerank and ranks
        on the quantised scan's distances alone.
      leaf_radius_filter: apply the radius at the leaf ranking too.
      with_stats: include the candidate-count reduction.
      kernel: kernel-layer knobs (None = defaults).
    """

    k: int = 10
    radius: Radius = None
    execution: str = "auto"
    beam: Beam = 32
    rerank_width: Optional[int] = 128
    exact_rerank: bool = True
    leaf_radius_filter: bool = False
    with_stats: bool = True
    kernel: Optional[kops.KernelConfig] = None

    def __post_init__(self):
        if int(self.k) < 1:
            raise ValueError(f"query k must be >= 1, got {self.k}")
        object.__setattr__(self, "k", int(self.k))
        if self.execution not in EXECUTIONS:
            raise ValueError(
                f"unknown search mode {self.execution!r}; valid executions: "
                f"{EXECUTIONS}"
            )
        object.__setattr__(self, "radius", _freeze_schedule(self.radius))
        object.__setattr__(self, "beam",
                           _freeze_schedule(self.beam, numeric=int))
        if self.rerank_width is not None:
            object.__setattr__(self, "rerank_width", int(self.rerank_width))


def degraded(query: Query) -> Query:
    """The graceful-degradation rewrite of ``query`` (DESIGN.md §3.10).

    Under admission-control pressure the router serves this cheaper spec
    instead of rejecting: beam narrowed (halved, floor 8 per level), the
    exact rerank stage dropped (``exact_rerank=False`` — rank on quantised
    scan distances alone where the index stores codes; indices serving the
    exact payload just run the narrower beam), rerank width collapsed to
    ``k``, and stats off. Same ``k`` and radius — the result contract
    holds, only the quality/cost knobs move. Deterministic and frozen, so
    the degraded plan compiles once and caches like any other.
    """
    beam = query.beam
    if isinstance(beam, tuple):
        beam = tuple(max(8, b // 2) for b in beam)
    elif beam is not None:
        beam = max(8, int(beam) // 2)
    return dataclasses.replace(
        query,
        beam=beam,
        rerank_width=query.k,
        exact_rerank=False,
        with_stats=False,
    )


def validate_query_batch(Q, dist: dist_lib.Distance, *,
                         expect_dim: Optional[int] = None) -> None:
    """Search-time query validation: ``needs_dim`` distances reject wrong
    widths and non-finite rows fail loudly.

    Shape checks always run. The non-finite scan runs for host inputs
    (numpy arrays, lists, CPU tensors) only: for a tensor on the GPU it
    would force a device-to-host copy per call, so device tensors are
    trusted to have been checked when they were made."""
    on_device = isinstance(Q, torch.Tensor) and Q.is_cuda
    arr = None if on_device else (
        Q.numpy() if isinstance(Q, torch.Tensor) else np.asarray(Q))
    shape = tuple(Q.shape) if on_device else arr.shape
    if len(shape) not in (1, 2):
        raise ValueError(f"queries must be [d] or [B, d], got shape {shape}")
    d = shape[-1]
    if dist.needs_dim is not None and d != dist.needs_dim:
        raise ValueError(
            f"distance {dist.name!r} needs d={dist.needs_dim} queries, got "
            f"d={d} at search time"
        )
    if expect_dim is not None and d != expect_dim:
        raise ValueError(
            f"query dimensionality d={d} does not match the index (d="
            f"{expect_dim})"
        )
    if arr is None:
        return
    finite = np.isfinite(np.asarray(arr, np.float32))
    if not finite.all():
        bad = int((~np.atleast_1d(finite.all(axis=-1))).sum())
        raise ValueError(
            f"queries contain non-finite values ({bad} rows with NaN/inf); "
            f"clean the queries before searching"
        )
