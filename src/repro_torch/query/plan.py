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
``beam_vmap``  the seed per-query beam (gathers + ``dist.point``, no kernel)
=============  ==============================================================

``execution="auto"`` resolves to ``beam``, or to ``two_stage`` once the
index has released its dense leaf payload. Capability conflicts
(``two_stage`` without a store, ``dense``/``beam``/``beam_vmap`` after
``release_dense_payload``, ``beam_vmap`` with dirty online tiers) raise at
plan time. ``sharded`` is not yet ported and raises too.

The online legs are bound at plan time: a plan compiled against a
tombstoned index passes ``TombstoneSet.valid_mask()`` (a cached device
array) to the leaf ranking, and one compiled against an active delta
buffer appends the delta scan and ``delta.merge_topk``. A plan executed
after its index changed in place (a write dirtied a tier, a store was
attached, the payload released) re-plans through the index's plan cache,
so a plan held across a write never serves without its delta leg. An
epoch swap is a new index object: a plan bound to the old one keeps
serving the old epoch.

``plan_stats()`` counts, per pipeline, the plans compiled, the plan-cache
hits, the re-plans of stale plans and the executions (``repro``'s counters,
without its metrics registry).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import nsa
from repro_torch.core.distances import BIG
from repro_torch.query.spec import Query, validate_query_batch

_NOT_PORTED = ("sharded",)

# a stale plan's execution outcome in plan_stats()
STALENESS_REPLAN = "replans"

_STATS: dict = collections.defaultdict(
    lambda: dict(compiles=0, cache_hits=0, replans=0, executions=0))


def plan_stats() -> dict:
    """Snapshot of the per-pipeline planner counters."""
    return {p: dict(v) for p, v in sorted(_STATS.items())}


def reset_plan_stats() -> None:
    _STATS.clear()


def record_cache_hit(pipeline: str) -> None:
    _STATS[pipeline]["cache_hits"] += 1

_LOWERING = {
    "dense": "per level one ops.pairwise_distance [B, n_l] matrix + masked "
             "stable top-k",
    "beam": "nsa.descend_beam (ops.pairwise_distance top level + fused "
            "ops.rank_gathered per inner level) -> fused ops.rank_gathered "
            "leaf rank",
    "beam_vmap": "seed baseline: per-query gathers of dist.point distances "
                 "+ per-level stable top-k",
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
    delta_dirty: bool  # active delta entries -> the delta scan + merge leg
    tombstones_dirty: bool  # dead slots -> the slot_valid mask


def capabilities(index) -> Capabilities:
    return Capabilities(
        epoch=index.epoch, n_levels=len(index.data.levels),
        device=str(index.device),
        store=index.store.backend if index.store is not None else None,
        payload_released=bool(index._payload_released),
        delta_dirty=bool(index.delta is not None and index.delta.n_active),
        tombstones_dirty=bool(index.tombstones is not None
                              and index.tombstones.count),
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
    elif execution == "beam_vmap" and (caps.delta_dirty
                                       or caps.tombstones_dirty):
        raise ValueError(
            "mode='beam_vmap' (the seed benchmark baseline) does not "
            "support the online tiers; use 'beam'/'dense'/'two_stage' or "
            "compact() first"
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
            _STATS[self.pipeline][STALENESS_REPLAN] += 1
            return idx.plan(self.query)(queries)
        _STATS[self.pipeline]["executions"] += 1
        validate_query_batch(queries, idx.distance, expect_dim=idx._dim())
        Q = torch.as_tensor(queries, dtype=torch.float32).to(idx.device)
        squeeze = Q.dim() == 1
        res = self._execute(Q[None] if squeeze else Q)
        return nsa.SearchResult(*(t[0] for t in res)) if squeeze else res

    def _execute(self, Q: torch.Tensor) -> nsa.SearchResult:
        idx, q = self.index, self.query
        # the mask leg is bound at plan time, its array fetched per call
        # (cached on the device until the next delete)
        slot_valid = (idx.tombstones.valid_mask() if self.caps.tombstones_dirty
                      else None)
        if self.pipeline == "two_stage":
            from repro_torch.store import two_stage

            res = two_stage.search_two_stage(
                idx.data, idx.store, Q, dist=idx.distance, k=q.k,
                r=self.radius, beam=q.beam, max_children=idx.max_children,
                rerank_width=q.rerank_width, exact_rerank=q.exact_rerank,
                leaf_radius_filter=q.leaf_radius_filter, kernel=q.kernel,
                slot_valid=slot_valid,
            )
        elif self.pipeline == "dense":
            res = nsa.search_dense(
                idx.data, Q, dist=idx.distance, k=q.k, r=self.radius,
                leaf_radius_filter=q.leaf_radius_filter,
                with_stats=q.with_stats, kernel=q.kernel,
                slot_valid=slot_valid,
            )
        elif self.pipeline == "beam":
            res = nsa.search_beam(
                idx.data, Q, dist=idx.distance, k=q.k, r=self.radius,
                beam=q.beam, max_children=idx.max_children,
                leaf_radius_filter=q.leaf_radius_filter, kernel=q.kernel,
                slot_valid=slot_valid,
            )
        else:  # beam_vmap: the seed baseline (clean tiers, by plan)
            res = nsa.search_beam_vmap(
                idx.data, Q, dist=idx.distance, k=q.k, r=self.radius,
                beam=q.beam, max_children=idx.max_children,
                leaf_radius_filter=q.leaf_radius_filter,
            )
        if self.caps.delta_dirty:
            res = self._merge_delta_leg(Q, res)
        return res

    def _merge_delta_leg(self, Q: torch.Tensor, res: nsa.SearchResult
                         ) -> nsa.SearchResult:
        """The delta buffer's exact scan, merged into the result."""
        from repro_torch.online import delta as delta_lib

        idx, q = self.index, self.query
        scan = idx.delta.scan(Q, idx.distance, k=q.k, kernel=q.kernel)
        sd, si = scan.dists, scan.ids
        if q.leaf_radius_filter:
            # the resident ranking's leaf radius rule, so a point filters
            # alike whether it is buffered or (after compaction) resident
            r0 = self.radius[0] if isinstance(self.radius, tuple) \
                else self.radius
            keep = sd < r0
            sd = torch.where(keep, sd, torch.full((), BIG, device=sd.device))
            si = torch.where(keep, si, -1)
        d_m, i_m = delta_lib.merge_topk(res.dists, res.ids, sd, si, q.k)
        return nsa.SearchResult(
            dists=d_m, ids=i_m,
            n_candidates=res.n_candidates + int(idx.delta.n_active))

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
            online_legs=dict(
                tombstone_mask=self.caps.tombstones_dirty,
                tombstone_lowering=(
                    "TombstoneSet.valid_mask() (cached device bool[n_0]) "
                    "folded into the leaf ranking via ref.fold_slot_valid"
                    if self.caps.tombstones_dirty else "none (no dead slots)"),
                delta=self.caps.delta_dirty,
                delta_lowering=(
                    "exact ops.pairwise_distance scan over the delta buffer "
                    "+ merge_topk into the result" if self.caps.delta_dirty
                    else "none (delta buffer empty)"),
            ),
            kernel=q.kernel._asdict() if q.kernel is not None else None,
        )

    def explain(self) -> str:
        """Human-readable plan; formats :meth:`describe`."""
        d = self.describe()
        q, caps, legs = d["query"], d["capabilities"], d["online_legs"]
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
            f"  tombstone mask: {legs['tombstone_lowering']}",
            f"  delta leg: {legs['delta_lowering']}",
        ])


def compile_plan(index, query: Query) -> SearchPlan:
    """Bind ``query`` to ``index``. Callers usually go through
    ``PDASCIndex.plan`` (the cached surface)."""
    caps = capabilities(index)
    pipeline = _resolve_pipeline(query, caps)
    radius = query.radius if query.radius is not None else index.default_radius
    _STATS[pipeline]["compiles"] += 1
    return SearchPlan(index=index, query=query, caps=caps, pipeline=pipeline,
                      radius=radius)
