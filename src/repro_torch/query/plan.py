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
``sharded``    per-rank dense/beam + butterfly/allgather top-k merge over a
               ``DeviceMesh`` (:func:`compile_sharded_plan`)
=============  ==============================================================

``execution="auto"`` resolves to ``beam``, or to ``two_stage`` once the
index has released its dense leaf payload. Capability conflicts
(``two_stage`` without a store, ``dense``/``beam``/``beam_vmap`` after
``release_dense_payload``, ``beam_vmap`` with dirty online tiers) raise at
plan time; ``sharded`` on a single index raises, pointing to
:func:`compile_sharded_plan`.

The online legs are bound at plan time: a plan compiled against a
tombstoned index passes ``TombstoneSet.valid_mask()`` (a cached device
array) to the leaf ranking, and one compiled against an active delta
buffer appends the delta scan and ``delta.merge_topk``. A plan executed
after its index changed in place (a write dirtied a tier, a store was
attached, the payload released) re-plans through the index's plan cache,
so a plan held across a write never serves without its delta leg. An
epoch swap is a new index object: a plan bound to the old one keeps
serving the old epoch.

A plan whose query asks for tuned kernel knobs (``KernelConfig(auto=True)``)
binds the autotuner's generation too (``Capabilities.tuned_gen``, stamped
into the kernel config it runs): a retune re-plans it, and plans of other
queries are untouched.

``plan_stats()`` counts, per pipeline, the plans compiled, the plan-cache
hits, the re-plans of stale plans and the executions; the same events go
to the ``repro_torch.obs`` registry under ``repro``'s series, and an
execution records a ``plan`` span (a ``delta_leg`` span inside it) on a
traced request.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.core import distances as dist_lib
from repro_torch.core import nsa
from repro_torch.core.distances import BIG
from repro_torch.kernels import autotune as _autotune
from repro_torch.obs import names as mnames
from repro_torch.query.spec import Query, validate_query_batch

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
    obs.counter(mnames.PLAN_CACHE_HITS, pipeline=pipeline).inc()

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
    remote: bool  # exact payload behind a remote store (fetch = network op)
    delta_dirty: bool  # active delta entries -> the delta scan + merge leg
    tombstones_dirty: bool  # dead slots -> the slot_valid mask
    tuned_gen: int = -1  # autotune generation (auto=True kernels), else -1


def capabilities(index, kernel=None) -> Capabilities:
    """The index's fingerprint; with an ``auto=True`` ``kernel`` config it
    also binds the autotuner's generation (-1 otherwise, so a retune
    leaves other plans alone)."""
    return Capabilities(
        epoch=index.epoch, n_levels=len(index.data.levels),
        device=str(index.device),
        store=index.store.backend if index.store is not None else None,
        payload_released=bool(index._payload_released),
        remote=bool(index.store is not None
                    and getattr(index.store.exact, "remote", False)),
        delta_dirty=bool(index.delta is not None and index.delta.n_active),
        tombstones_dirty=bool(index.tombstones is not None
                              and index.tombstones.count),
        tuned_gen=(_autotune.generation()
                   if kernel is not None and kernel.auto else -1),
    )


def _stamped_kernel(kernel, gen: Optional[int] = None):
    """Stamp an ``auto=True`` kernel config with the tuner generation, so
    the config a plan runs names the winners it resolves against; other
    configs pass through untouched."""
    if kernel is None or not kernel.auto:
        return kernel
    return kernel._replace(
        tuned_gen=_autotune.generation() if gen is None else gen)


def _resolve_pipeline(query: Query, caps: Capabilities) -> str:
    """Choose and validate the pipeline; conflicts raise at plan time."""
    execution = query.execution
    if execution == "sharded":
        raise ValueError(
            "execution='sharded' needs a mesh layout: compile with "
            "repro_torch.query.compile_sharded_plan(mesh, query, ...)"
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
    kernel: object = None  # query.kernel, generation-stamped when auto

    def __call__(self, queries) -> nsa.SearchResult:
        idx = self.index
        if capabilities(idx, self.query.kernel) != self.caps:
            # the index changed in place under this plan: re-plan (a
            # conflict with the new capabilities raises as plan() would)
            _STATS[self.pipeline][STALENESS_REPLAN] += 1
            obs.counter(mnames.PLAN_REPLANS, pipeline=self.pipeline).inc()
            return idx.plan(self.query)(queries)
        _STATS[self.pipeline]["executions"] += 1
        obs.counter(mnames.PLAN_EXECUTIONS, pipeline=self.pipeline).inc()
        validate_query_batch(queries, idx.distance, expect_dim=idx._dim())
        with obs.span("plan", pipeline=self.pipeline):
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
                leaf_radius_filter=q.leaf_radius_filter, kernel=self.kernel,
                slot_valid=slot_valid,
            )
        elif self.pipeline == "dense":
            res = nsa.search_dense(
                idx.data, Q, dist=idx.distance, k=q.k, r=self.radius,
                leaf_radius_filter=q.leaf_radius_filter,
                with_stats=q.with_stats, kernel=self.kernel,
                slot_valid=slot_valid,
            )
        elif self.pipeline == "beam":
            res = nsa.search_beam(
                idx.data, Q, dist=idx.distance, k=q.k, r=self.radius,
                beam=q.beam, max_children=idx.max_children,
                leaf_radius_filter=q.leaf_radius_filter, kernel=self.kernel,
                slot_valid=slot_valid,
            )
        else:  # beam_vmap: the seed baseline (clean tiers, by plan)
            res = nsa.search_beam_vmap(
                idx.data, Q, dist=idx.distance, k=q.k, r=self.radius,
                beam=q.beam, max_children=idx.max_children,
                leaf_radius_filter=q.leaf_radius_filter,
            )
        if self.caps.delta_dirty:
            with obs.span("delta_leg", n_active=int(idx.delta.n_active)):
                res = self._merge_delta_leg(Q, res)
        return res

    def _merge_delta_leg(self, Q: torch.Tensor, res: nsa.SearchResult
                         ) -> nsa.SearchResult:
        """The delta buffer's exact scan, merged into the result."""
        from repro_torch.online import delta as delta_lib

        idx, q = self.index, self.query
        scan = idx.delta.scan(Q, idx.distance, k=q.k, kernel=self.kernel)
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
        lowering, the resolved query fields, the capabilities bound
        against and the index's size and code format (what a cost record
        joins on)."""
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
            kernel=self.kernel._asdict() if self.kernel is not None else None,
            index=dict(
                n_points=getattr(self.index, "n_points", None),
                code_format=getattr(
                    getattr(self.index, "store", None), "code_format", None),
            ),
        )

    def explain(self) -> str:
        """Human-readable plan; formats :meth:`describe`."""
        d = self.describe()
        q, caps, legs = d["query"], d["capabilities"], d["online_legs"]
        return "\n".join([
            f"SearchPlan[{d['pipeline']}] epoch={caps['epoch']} "
            f"levels={caps['n_levels']} device={caps['device']} "
            f"store={caps['store'] or 'dense-resident'}"
            + (" (payload released)" if caps["payload_released"] else "")
            + (" (remote exact tier)" if caps["remote"] else ""),
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
    caps = capabilities(index, query.kernel)
    pipeline = _resolve_pipeline(query, caps)
    radius = query.radius if query.radius is not None else index.default_radius
    _STATS[pipeline]["compiles"] += 1
    obs.counter(mnames.PLAN_COMPILES, pipeline=pipeline).inc()
    return SearchPlan(index=index, query=query, caps=caps, pipeline=pipeline,
                      radius=radius,
                      kernel=_stamped_kernel(query.kernel, caps.tuned_gen))


# ---------------------------------------------------------------------------
# Sharded pipeline (plans over a mesh)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedPlan:
    """A :class:`Query` lowered onto a ``DeviceMesh``.

    The plan binds what is static (mesh, database axes, distance, radius,
    per-rank mode, merge, ``max_children``); each rank calls it with its
    own sub-index:

        plan = compile_sharded_plan(mesh, query, dist="cosine", ...)
        res = plan(local_index, Q)                 # identical on every rank
        res = plan(local_index, Q, slot_valid=sv)  # + this rank's tombstones

    Execution is one ``distributed.search_sharded`` call: the rank's search
    and the global top-k merge over the mesh's cached axis groups (a call
    creates no process group)."""

    query: Query
    mesh: object
    db_axes: tuple
    dist: dist_lib.Distance
    radius: object
    shard_mode: str  # per-rank pipeline: "dense" | "beam"
    max_children: Optional[tuple]
    merge: str
    pipeline: str = "sharded"
    kernel: object = None  # query.kernel, generation-stamped when auto

    def __call__(self, local_index, Q, *, slot_valid=None):
        from repro_torch.core import distributed as dd

        _STATS[self.pipeline]["executions"] += 1
        obs.counter(mnames.PLAN_EXECUTIONS, pipeline=self.pipeline).inc()
        validate_query_batch(Q, self.dist)
        q = self.query
        return dd.search_sharded(
            local_index, Q, self.mesh, db_axes=self.db_axes, dist=self.dist,
            k=q.k, r=self.radius, mode=self.shard_mode, beam=q.beam,
            max_children=self.max_children, merge=self.merge,
            leaf_radius_filter=q.leaf_radius_filter, with_stats=q.with_stats,
            kernel=self.kernel, slot_valid=slot_valid,
        )

    def describe(self) -> dict:
        """Structured counterpart of :meth:`explain` (``repro``'s fields)."""
        from repro_torch.core import distributed as dd

        q = self.query
        kernel = self.kernel
        return dict(
            pipeline=self.pipeline,
            effective_pipeline=f"sharded/{self.shard_mode}",
            lowering=_LOWERING[self.shard_mode],
            query=dict(
                k=q.k, radius=self.radius, beam=q.beam,
                leaf_radius_filter=q.leaf_radius_filter,
                execution=q.execution,
            ),
            mesh=dict(
                axes={a: dd.axis_size(self.mesh, a) for a in self.db_axes},
                merge=self.merge,
            ),
            online_legs=dict(
                tombstone_mask=None,  # per-rank slot_valid at call time
                tombstone_lowering=(
                    "per-shard slot_valid slices (passed at call time; "
                    "route_writes/local_slot_valid build them)"),
                delta=False,
                delta_lowering="none (sharded plans serve compacted tiers)",
            ),
            kernel=(kernel._asdict() if hasattr(kernel, "_asdict")
                    else kernel),
        )

    def explain(self) -> str:
        d = self.describe()
        q = d["query"]
        axes = "x".join(f"{a}={n}" for a, n in d["mesh"]["axes"].items())
        return "\n".join([
            f"ShardedPlan[sharded/{self.shard_mode}] mesh axes ({axes}), "
            f"merge={self.merge}",
            f"  query: k={q['k']} radius={q['radius']} "
            f"beam={q['beam']} "
            f"leaf_radius_filter={q['leaf_radius_filter']}",
            f"  per-shard lowering: {d['lowering']}",
            f"  merge: distributed.topk_merge_{self.merge} over "
            f"{tuple(self.db_axes)} (global ids = shard offset + local rows)",
            f"  tombstone mask: {d['online_legs']['tombstone_lowering']}",
        ])


def compile_sharded_plan(
    mesh,
    query: Query,
    *,
    dist,
    db_axes: Sequence[str] = ("data",),
    max_children: Optional[tuple] = None,
    merge: str = "butterfly",
    default_radius: Optional[float] = None,
) -> ShardedPlan:
    """Compile a :class:`Query` into a plan over a sharded deployment.

    ``query.execution`` selects the per-rank pipeline: ``"dense"`` or
    ``"beam"`` (``"auto"`` / ``"sharded"`` mean dense). ``"beam"`` needs
    ``max_children``, the per-level child bound over every shard
    (``distributed.max_children_sharded``). ``query.radius=None`` falls back
    to ``default_radius``."""
    shard_mode = query.execution
    if shard_mode in ("auto", "sharded"):
        shard_mode = "dense"
    if shard_mode not in ("dense", "beam"):
        raise ValueError(
            f"sharded plans run per-shard 'dense' or 'beam', not "
            f"{query.execution!r} (two_stage shards through "
            f"distributed.scan_quantized_sharded)"
        )
    if shard_mode == "beam" and max_children is None:
        raise ValueError(
            "per-shard 'beam' needs max_children (the static per-level "
            "child bound of the stacked sub-indexes)"
        )
    radius = query.radius if query.radius is not None else default_radius
    if radius is None:
        raise ValueError(
            "sharded plans need a radius: set Query.radius or pass "
            "default_radius="
        )
    plan = ShardedPlan(
        query=query, mesh=mesh, db_axes=tuple(db_axes),
        dist=dist_lib.get(dist), radius=radius, shard_mode=shard_mode,
        max_children=tuple(max_children) if max_children is not None
        else None, merge=merge, kernel=_stamped_kernel(query.kernel),
    )
    _STATS[plan.pipeline]["compiles"] += 1
    obs.counter(mnames.PLAN_COMPILES, pipeline=plan.pipeline).inc()
    return plan
