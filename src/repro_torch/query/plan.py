"""The SearchPlan compiler — lower a :class:`~repro_torch.query.spec.Query`
onto the pipelines the port has (counterpart of ``repro.query.plan``).

=============  ==============================================================
pipeline       kernel-layer lowering
=============  ==============================================================
``dense``      per level one ``ops.pairwise_distance`` matrix + masked top-k
``beam``       beam descent (``ops.pairwise_distance`` top level, fused
               ``ops.rank_gathered`` per inner level) + one fused
               ``ops.rank_gathered`` leaf rank
``two_stage``  beam descent -> ``ops.scan_quantized`` over the payload codes
               -> exact ``ops.rank_candidates`` rerank of the survivors
               (∞ rerank width: the same ``search_beam`` over the exact
               payload, bit-identical to ``beam``)
=============  ==============================================================

``execution="auto"`` resolves to ``beam``, or to ``two_stage`` once the
index has released its dense leaf payload. Capability conflicts
(``two_stage`` without a store, ``dense``/``beam`` after
``release_dense_payload``) raise at plan time. ``beam_vmap`` and
``sharded`` are not yet ported and raise too. A plan executed after its
index changed in place (a store attached, the payload released) re-plans
through the index's plan cache.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import nsa
from repro_torch.query.spec import Query, validate_query_batch

_NOT_PORTED = ("beam_vmap", "sharded")

_LOWERING = {
    "dense": "per level one ops.pairwise_distance [B, n_l] matrix + masked "
             "stable top-k",
    "beam": "nsa.descend_beam (ops.pairwise_distance top level + fused "
            "ops.rank_gathered per inner level) -> fused ops.rank_gathered "
            "leaf rank",
    "two_stage": "nsa.descend_beam -> ops.scan_quantized (native-container "
                 "payload scan) -> exact ops.rank_candidates rerank of the "
                 "top-R survivors",
    "two_stage_inf": "∞ rerank: the same nsa.search_beam over the exact "
                     "fp32 payload (bit-identical to 'beam')",
    "two_stage_scan": "scan-only: nsa.descend_beam -> ops.scan_quantized "
                      "ranked on code distances alone (no exact rerank)",
}


class Capabilities(NamedTuple):
    """The index fingerprint a plan binds against."""

    epoch: int
    n_levels: int
    device: str
    store: Optional[str]  # payload-tier backend; None = dense leaf payload
    payload_released: bool


def capabilities(index) -> Capabilities:
    return Capabilities(
        epoch=index.epoch, n_levels=len(index.data.levels),
        device=str(index.device),
        store=index.store.backend if index.store is not None else None,
        payload_released=bool(index._payload_released),
    )


def _resolve_pipeline(query: Query, caps: Capabilities) -> str:
    """Choose and validate the pipeline; conflicts raise at plan time."""
    execution = query.execution
    if execution in _NOT_PORTED:
        raise NotImplementedError(
            f"execution={execution!r} is not yet ported to repro_torch; "
            f"use 'auto', 'beam', 'dense' or 'two_stage'"
        )
    if execution == "auto":
        execution = "two_stage" if caps.payload_released else "beam"
    if execution == "two_stage":
        if caps.store is None:
            raise ValueError(
                "mode='two_stage' needs a leaf store: build with "
                "store='int8' or call attach_store()"
            )
    elif caps.payload_released:
        raise ValueError(
            f"mode={execution!r} needs the dense leaf payload, which was "
            "released (release_dense_payload); use mode='two_stage'"
        )
    return execution


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
        if capabilities(idx) != self.caps:
            # the index changed in place under this plan: re-plan (a
            # conflict with the new capabilities raises as plan() would)
            return idx.plan(self.query)(queries)
        validate_query_batch(queries, idx.distance, expect_dim=idx._dim())
        Q = torch.as_tensor(queries, dtype=torch.float32).to(idx.device)
        q = self.query
        if self.pipeline == "two_stage":
            from repro_torch.store import two_stage

            return two_stage.search_two_stage(
                idx.data, idx.store, Q, dist=idx.distance, k=q.k,
                r=self.radius, beam=q.beam, max_children=idx.max_children,
                rerank_width=q.rerank_width, exact_rerank=q.exact_rerank,
                leaf_radius_filter=q.leaf_radius_filter, kernel=q.kernel,
            )
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

    def effective_pipeline(self) -> str:
        """The pipeline with the two-stage refinements: ``two_stage_inf``
        (∞ rerank width or an fp32 store) and ``two_stage_scan``
        (``exact_rerank=False``)."""
        q = self.query
        if self.pipeline != "two_stage":
            return self.pipeline
        if q.rerank_width is None or q.rerank_width <= 0 \
                or self.caps.store == "fp32":
            return "two_stage_inf"
        return "two_stage" if q.exact_rerank else "two_stage_scan"

    def describe(self) -> dict:
        """Structured plan description: pipeline, effective pipeline,
        lowering, the resolved query fields and the capabilities bound
        against."""
        q = self.query
        effective = self.effective_pipeline()
        return dict(
            pipeline=self.pipeline,
            effective_pipeline=effective,
            lowering=_LOWERING[effective],
            query=dict(k=q.k, radius=self.radius, beam=q.beam,
                       rerank_width=q.rerank_width,
                       exact_rerank=q.exact_rerank,
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
            f"levels={caps['n_levels']} device={caps['device']} "
            f"store={caps['store'] or 'dense-resident'}"
            + (" (payload released)" if caps["payload_released"] else ""),
            f"  query: k={q['k']} radius={q['radius']} beam={q['beam']}"
            + (f" rerank_width={q['rerank_width']}"
               if d["pipeline"] == "two_stage" else "")
            + f" leaf_radius_filter={q['leaf_radius_filter']}",
            f"  lowering: {d['lowering']}",
        ])


def compile_plan(index, query: Query) -> SearchPlan:
    """Bind ``query`` to ``index``. Callers usually go through
    ``PDASCIndex.plan`` (the cached surface)."""
    caps = capabilities(index)
    pipeline = _resolve_pipeline(query, caps)
    radius = query.radius if query.radius is not None else index.default_radius
    return SearchPlan(index=index, query=query, caps=caps, pipeline=pipeline,
                      radius=radius)
