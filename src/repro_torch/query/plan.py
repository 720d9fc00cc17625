"""The SearchPlan compiler — lower a :class:`~repro_torch.query.spec.Query`
onto the pipelines the port has (counterpart of ``repro.query.plan``).

=============  ==============================================================
pipeline       kernel-layer lowering
=============  ==============================================================
``dense``      per level one ``ops.pairwise_distance`` matrix + masked top-k
``beam``       beam descent (``ops.pairwise_distance`` top level, fused
               ``ops.rank_gathered`` per inner level) + one fused
               ``ops.rank_gathered`` leaf rank
=============  ==============================================================

``execution="auto"`` resolves to ``beam``: the dense leaf payload is always
resident in this slice. ``two_stage``, ``beam_vmap`` and ``sharded`` are not
yet ported and raise when the plan is compiled.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import nsa
from repro_torch.query.spec import Query, validate_query_batch

_NOT_PORTED = ("two_stage", "beam_vmap", "sharded")

_LOWERING = {
    "dense": "per level one ops.pairwise_distance [B, n_l] matrix + masked "
             "stable top-k",
    "beam": "nsa.descend_beam (ops.pairwise_distance top level + fused "
            "ops.rank_gathered per inner level) -> fused ops.rank_gathered "
            "leaf rank",
}


class Capabilities(NamedTuple):
    """The index fingerprint a plan binds against."""

    epoch: int
    n_levels: int
    device: str


def capabilities(index) -> Capabilities:
    return Capabilities(epoch=index.epoch, n_levels=len(index.data.levels),
                        device=str(index.device))


def _resolve_pipeline(query: Query) -> str:
    """Choose and validate the pipeline; conflicts raise at plan time."""
    execution = query.execution
    if execution in _NOT_PORTED:
        raise NotImplementedError(
            f"execution={execution!r} is not yet ported to repro_torch; "
            f"use 'auto', 'beam' or 'dense'"
        )
    return "beam" if execution == "auto" else execution


@dataclasses.dataclass(frozen=True, eq=False)
class SearchPlan:
    """An executable binding of (query, index) -> pipeline. Call it with a
    query batch ``[B, d]`` (or ``[d]``, which returns squeezed results)."""

    index: object  # PDASCIndex (duck-typed; no import cycle)
    query: Query
    caps: Capabilities
    pipeline: str
    radius: object  # resolved: query.radius or the index default

    def __call__(self, queries) -> nsa.SearchResult:
        idx = self.index
        validate_query_batch(queries, idx.distance, expect_dim=idx._dim())
        Q = torch.as_tensor(queries, dtype=torch.float32).to(idx.device)
        q = self.query
        if self.pipeline == "dense":
            return nsa.search_dense(
                idx.data, Q, dist=idx.distance, k=q.k, r=self.radius,
                leaf_radius_filter=q.leaf_radius_filter,
                with_stats=q.with_stats, kernel=q.kernel,
            )
        return nsa.search_beam(
            idx.data, Q, dist=idx.distance, k=q.k, r=self.radius, beam=q.beam,
            max_children=idx.max_children,
            leaf_radius_filter=q.leaf_radius_filter, kernel=q.kernel,
        )

    def describe(self) -> dict:
        """Structured plan description: pipeline, lowering, the resolved
        query fields and the capabilities bound against."""
        q = self.query
        return dict(
            pipeline=self.pipeline,
            lowering=_LOWERING[self.pipeline],
            query=dict(k=q.k, radius=self.radius, beam=q.beam,
                       leaf_radius_filter=q.leaf_radius_filter,
                       execution=q.execution),
            capabilities=self.caps._asdict(),
            kernel=q.kernel._asdict() if q.kernel is not None else None,
        )

    def explain(self) -> str:
        """Human-readable plan; formats :meth:`describe`."""
        d = self.describe()
        q, caps = d["query"], d["capabilities"]
        return "\n".join([
            f"SearchPlan[{d['pipeline']}] epoch={caps['epoch']} "
            f"levels={caps['n_levels']} device={caps['device']}",
            f"  query: k={q['k']} radius={q['radius']} beam={q['beam']} "
            f"leaf_radius_filter={q['leaf_radius_filter']}",
            f"  lowering: {d['lowering']}",
        ])


def compile_plan(index, query: Query) -> SearchPlan:
    """Bind ``query`` to ``index``. Callers usually go through
    ``PDASCIndex.plan`` (the cached surface)."""
    caps = capabilities(index)
    pipeline = _resolve_pipeline(query)
    radius = query.radius if query.radius is not None else index.default_radius
    return SearchPlan(index=index, query=query, caps=caps, pipeline=pipeline,
                      radius=radius)
